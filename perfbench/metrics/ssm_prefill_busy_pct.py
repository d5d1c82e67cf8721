"""Share of the profiled stream's device busy time spent in kernels
launched inside ``models.ssm.mamba_prefill``, the plain serving scan
of a Mamba model's prompt."""


def read(ctx):
    p = ctx.get("profile")
    s = p and p["scan_s"].get("mamba_prefill")
    if not s or p["busy_s"] <= 0:
        return None
    return 100.0 * s / p["busy_s"]
