"""Kernel 3, ``ops.fused_swiglu(x, w_gate, w_up, w_down)``:
(silu(x Wg) * (x Wu)) Wd over x (T, d), Wg / Wu (d, F), Wd (F, d)."""

WRAPPER = "fused_swiglu"


def describe(x, w_gate, w_up, w_down):
    d, f = w_gate.shape
    return {"rows": x.numel() // d, "d": d, "f": f,
            "x_size": x.element_size(), "w_size": w_gate.element_size(),
            "dtype": x.dtype}


def count(desc):
    """(operations, bytes): three products of 2 T d F each (the silu
    and the gating multiply, 5 T F, are kept too); x and the three
    weights read once, the (T, d) output written once. The hidden
    (T, F) is the kernel's own business and not counted."""
    t, d, f = desc["rows"], desc["d"], desc["f"]
    flops = 6.0 * t * d * f + 5.0 * t * f
    nbytes = 2 * t * d * desc["x_size"] + 3 * d * f * desc["w_size"]
    return flops, nbytes
