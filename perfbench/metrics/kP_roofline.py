"""Share of its roofline that P, the column-invariant projection
(``kernels/projection.py``) reached over the profiled stream: the sum
over its calls of each call's bound (``counts/projection.py``,
``counts/peaks.py``) over the device time of the kernels launched
inside its calls."""

WRAPPER = "projection"


def read(ctx):
    p = ctx.get("profile")
    k = p and p["kernels"].get(WRAPPER)
    if not k or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
