"""A model's FLOPs per token, from the widths in a configuration file
(``configs/<name>.json``'s ``models`` entries), for ``serve_mfu``.

Counted: every weight product a token takes (2 operations a weight),
attention's q.k and p.v over the keys a token sees, and a Mamba block's
convolution and recurrence. A prefill computes the logits of its last
position only, as the serving path does; a decode token computes its
own. Norms, rotary embeddings and softmax are left out: under 1% of a
token's work at these widths."""


def _head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def _ssm_dims(m: dict):
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    dt_rank = s.get("dt_rank") or -(-m["d_model"] // 16)
    return d_in, dt_rank, s["state_dim"], s["conv_width"]


def layer_weights(m: dict) -> int:
    """Weights of one layer's products."""
    d = m["d_model"]
    if m["family"] == "ssm":
        d_in, dt_rank, n, _ = _ssm_dims(m)
        return (2 * d * d_in + d_in * (dt_rank + 2 * n) + dt_rank * d_in
                + d_in * d)
    if m["family"] != "dense":
        raise ValueError(f"no count for family {m['family']!r}")
    hd = _head_dim(m)
    attn = d * hd * (2 * m["num_heads"] + 2 * m["num_kv_heads"])
    return attn + 3 * d * m["d_ff"]


def head_weights(m: dict) -> int:
    return m["d_model"] * m["vocab_size"]


def params_per_token(m: dict) -> int:
    """Weights a decode token multiplies: every layer and the head."""
    return m["num_layers"] * layer_weights(m) + head_weights(m)


def _mixer_flops(m: dict, keys: int) -> float:
    """One token's per-layer work outside the weight products: attention
    over ``keys`` keys, or the Mamba convolution and recurrence."""
    if m["family"] == "ssm":
        d_in, _, n, width = _ssm_dims(m)
        # exp(dt A), dt x B, h = a h + u, y = h . C: 8 per state element
        return 2.0 * width * d_in + 8.0 * d_in * n
    return 4.0 * _head_dim(m) * m["num_heads"] * keys


def prefill_flops(m: dict, s: int) -> float:
    """FLOPs of prefilling an ``s``-token prompt from position 0."""
    layers = m["num_layers"]
    total = 2.0 * layers * layer_weights(m) * s + 2.0 * head_weights(m)
    if m["family"] == "ssm":
        return total + layers * s * _mixer_flops(m, 0)
    # sum over positions p of p + 1 keys
    return total + layers * _mixer_flops(m, 1) * s * (s + 1) / 2


def decode_flops(m: dict, position: int) -> float:
    """FLOPs of one decode token at ``position`` (it sees position + 1
    keys)."""
    return (2.0 * params_per_token(m)
            + m["num_layers"] * _mixer_flops(m, position + 1))
