"""One reader a per-layer metric, named after it: ``read(ctx)`` returns
the metric's value, or None where the run holds nothing to read (the
harness then leaves the metric out of the result line).

``ctx`` (``harness/cell.py``'s ``context``) holds, over the traced run's
unprofiled streams: ``tasks``, ``wall_s``, ``flops`` (useful model
FLOPs, ``counts/model.py``), ``peak_flops`` (the card's bf16 peak),
``step`` (the step loop's ``StepStats`` counters summed) and ``kv``
(each page server's ``pool_pages`` and ``pages_highwater``); and over
the profiled stream, ``profile`` (``harness/trace.py``'s
``read_profile``, with ``tasks`` added) or None."""
