"""The served models' useful FLOPs (every prompt a server prefilled,
every token a lane decoded; ``counts/model.py``) over the unprofiled
streams' wall time at the card's bf16 peak."""


def read(ctx):
    if ctx.get("wall_s", 0) <= 0 or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["wall_s"] * ctx["peak_flops"])
