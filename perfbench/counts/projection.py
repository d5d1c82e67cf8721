"""Kernel P, ``ops.projection(x, w)``: x (..., K) @ w (K, N)."""

WRAPPER = "projection"


def describe(x, w):
    """What the count needs of one call, taken when it is made."""
    k, n = w.shape
    return {"rows": x.numel() // k, "k": k, "n": n,
            "x_size": x.element_size(), "w_size": w.element_size(),
            "dtype": x.dtype}


def count(d):
    """(operations, bytes) of one call: 2 M K N multiply-adds; x and w
    read once, the (M, N) output written once in x's dtype."""
    m, k, n = d["rows"], d["k"], d["n"]
    flops = 2.0 * m * k * n
    nbytes = m * k * d["x_size"] + k * n * d["w_size"] + m * n * d["x_size"]
    return flops, nbytes
