"""Kernel 2, ``ops.chunked_prefill_attention(q, k_pages, v_pages,
block_table, q_positions, *, prompt_len)``: each row's chunk of C
queries attends causally over the row's pages."""

WRAPPER = "chunked_prefill_attention"


def describe(q, k_pages, v_pages, block_table, q_positions, *,
             prompt_len):
    """Shapes, and the (B, C) positions tensor itself (small), which
    ``count`` reads once the window has closed, so the call is not
    held up by a copy to the host."""
    b, c, h, dk = q.shape
    return {"b": b, "c": c, "h": h, "kv": k_pages.shape[2], "dk": dk,
            "dv": v_pages.shape[-1], "size": q.element_size(),
            "positions": q_positions, "dtype": q.dtype}


def count(d):
    """(operations, bytes). A query at position p takes q.k and p.v
    over p + 1 keys: 2 (dk + dv) H (p + 1) operations. Bytes: q read
    and the output written once; each row's keys and values read once
    up to its last query's position."""
    pos = d["positions"].long().cpu()
    keys = int((pos + 1).sum())
    flops = 2.0 * (d["dk"] + d["dv"]) * d["h"] * keys
    per_row = int((pos.max(dim=1).values + 1).sum())
    nbytes = d["size"] * (
        d["b"] * d["c"] * d["h"] * (d["dk"] + d["dv"])
        + per_row * d["kv"] * (d["dk"] + d["dv"]))
    return flops, nbytes
