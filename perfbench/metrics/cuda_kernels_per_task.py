"""Device operations (kernels, copies, fills) a task, from the profiled
sub-window scaled to its whole stream by the step loop's own launch
count (``StepStats.launches``, a prefill chunk or a megastep each): the
sub-window's operations times the stream's launches over the
sub-window's, over the stream's tasks. A sub-window holds too few
retirements to divide by them."""


def read(ctx):
    p = ctx.get("profile")
    if not p or not p.get("launches") or not p.get("stream_tasks"):
        return None
    return (p["device_ops"] * p["stream_launches"] / p["launches"]
            / p["stream_tasks"])
