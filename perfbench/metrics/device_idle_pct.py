"""Share of the profiled stream's wall time with no operation on the
device (``busy_s`` is the union of every kernel, copy and fill)."""


def read(ctx):
    p = ctx.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
