"""Device programs the step loop launched (``StepStats.launches``: a
prefill chunk or a megastep each), a task retired."""


def read(ctx):
    st = ctx.get("step")
    if not st or not st["retired"]:
        return None
    return st["launches"] / st["retired"]
