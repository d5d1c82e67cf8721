"""Share of the megastep's decode ticks a lane sat masked, finished
before the megastep ended (``StepStats.masked_decode_steps`` over it
plus the live ``decode_tokens``)."""


def read(ctx):
    st = ctx.get("step")
    if not st:
        return None
    total = st["decode_tokens"] + st["masked_decode_steps"]
    return None if total == 0 else 100.0 * st["masked_decode_steps"] / total
