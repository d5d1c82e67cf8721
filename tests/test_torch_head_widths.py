"""Head widths past 128, key and value widths that differ, and state
sizes off the powers of two, on the CPU.

Rung 1: the plain versions of the decodes (kernels 1, 4, 5, 6) at
head_dim 256 (recurrentgemma-2b) and at dk 192 / dv 128 (DeepSeek's
split), and of the chunked prefill (kernel 2) there and at the
reference sweep's 32 and 96, against the reference's oracles on the
same numpy inputs; the selective scan through ``ops.selective_scan``,
which pads N to the next power of two, against the reference at N 12, 4
and 3. The wrappers' shape checks: each newly taken width reaches the
device check (``meta`` has no kernel) and the widths past the stated
limits raise before it. And ``projection_plan``, the column-invariant
projection's split of K: its ranges tile [0, K) in order, depend on K
alone, and give the grid sizes a decode needs. The Hopper kernels run
only on a card (``chip_smoke.py`` holds them against these plain
versions there)."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels.projection import projection_plan

# tests/test_kernels.py, tests/test_paged_attention.py and
# tests/test_chunked_prefill.py: attention 2e-5 in f32, 2e-2 in bf16;
# the selective scan's y at 5x that, its state at 1e-4 / 1e-3
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

J_DECODE = jax.jit(jref.decode_attention_ref)
J_PAGED = jax.jit(jref.paged_decode_attention_ref)
J_PAGED_QUANT = jax.jit(jref.paged_decode_attention_quant_ref)
J_DECODE_QUANT = jax.jit(jattn.decode_attention_quant)
J_QUANTIZE = jax.jit(jattn.quantize_kv)
J_PREFILL = jax.jit(jref.chunked_prefill_attention_ref,
                    static_argnames=("prompt_len",))
J_SCAN = jax.jit(jref.selective_scan_ref)

META = dict(device="meta")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(_TDT[dtype]) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a, _JDT[dtype]) if dtype else jnp.asarray(a)


def _close(got, want, atol, rtol=None):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(jnp.asarray(got, jnp.float32))
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=atol if rtol is None else rtol)


def _quantized(rng, shape):
    codes, scale = J_QUANTIZE(
        jnp.asarray(rng.normal(size=shape).astype(np.float32)))
    return np.array(codes), np.array(scale)


# (label, H, KV, dk, dv): recurrentgemma-2b's 256 at G 8 and G 1, and the
# split widths at G 4
WIDTHS = [("d256-G8", 8, 1, 256, 256), ("d256-G1", 4, 4, 256, 256),
          ("dk192-dv128", 8, 2, 192, 128)]
DTYPES = ["float32", "bfloat16"]


def _paged(rng, b, kv, dk, dv, ps, nb):
    kp = rng.normal(size=(b * nb, ps, kv, dk)).astype(np.float32)
    vp = rng.normal(size=(b * nb, ps, kv, dv)).astype(np.float32)
    table = rng.permutation(b * nb).astype(np.int32).reshape(b, nb)
    return kp, vp, table


# ----------------------------------------------------------------------
# rung 1: the plain versions against the reference's oracles
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WIDTHS, ids=[c[0] for c in WIDTHS])
def test_decodes_plain_match_reference(case, dtype):
    """Kernels 4 and 1 (contiguous and paged), bf16 or f32 caches."""
    _, h, kv, dk, dv = case
    rng = np.random.default_rng(h * 1000 + dk + dv)
    b, s, length = 3, 40, 37
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dv)).astype(np.float32)
    got = tref.decode_attention_ref(_t(q, dtype), _t(k, dtype),
                                    _t(v, dtype), length)
    want = J_DECODE(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                    jnp.int32(length))
    assert tuple(got.shape) == (b, h, dv) and got.dtype == _TDT[dtype]
    _close(got, want, TOL[dtype])

    kp, vp, table = _paged(rng, b, kv, dk, dv, 8, 5)
    lengths = np.asarray([1, 23, 40], np.int32)
    got = tref.paged_decode_attention_ref(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), _t(table),
        _t(lengths))
    want = J_PAGED(_j(q, dtype), _j(kp, dtype), _j(vp, dtype), _j(table),
                   _j(lengths))
    assert tuple(got.shape) == (b, h, dv)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WIDTHS, ids=[c[0] for c in WIDTHS])
def test_int8_decodes_plain_match_reference(case, dtype):
    """Kernels 6 and 5 over int8 codes: the contiguous one against the
    reference's jnp quant path, the paged one against its oracle."""
    _, h, kv, dk, dv = case
    rng = np.random.default_rng(h * 1000 + dk + dv + 1)
    b, s, length = 3, 40, 29
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    kq, ks = _quantized(rng, (b, s, kv, dk))
    vq, vs = _quantized(rng, (b, s, kv, dv))
    got = tref.decode_attention_quant_ref(
        _t(q, dtype), _t(kq), _t(ks), _t(vq), _t(vs), length)
    want = J_DECODE_QUANT(_j(q, dtype), _j(kq), _j(ks), _j(vq), _j(vs),
                          jnp.arange(s), jnp.int32(length - 1))
    assert tuple(got.shape) == (b, h, dv)
    _close(got, want, TOL[dtype])

    nb, ps = 5, 8
    kq, ks = _quantized(rng, (b * nb, ps, kv, dk))
    vq, vs = _quantized(rng, (b * nb, ps, kv, dv))
    table = rng.permutation(b * nb).astype(np.int32).reshape(b, nb)
    lengths = np.asarray([40, 9, 17], np.int32)
    got = tref.paged_decode_attention_quant_ref(
        _t(q, dtype), _t(kq), _t(ks), _t(vq), _t(vs), _t(table),
        _t(lengths))
    want = J_PAGED_QUANT(_j(q, dtype), _j(kq), _j(ks), _j(vq), _j(vs),
                         _j(table), _j(lengths))
    assert tuple(got.shape) == (b, h, dv)
    _close(got, want, TOL[dtype])


PREFILL_WIDTHS = [(32, 32), (96, 96), (256, 256), (192, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk,dv", PREFILL_WIDTHS,
                         ids=[f"dk{a}-dv{b}" for a, b in PREFILL_WIDTHS])
def test_chunked_prefill_plain_matches_reference(dk, dv, dtype):
    """Kernel 2 over rows at different depths of a 21-token prompt, a
    chunk of 7 positions."""
    rng = np.random.default_rng(dk + 7 * dv)
    b, c, h, kv, ps, nb, prompt = 3, 7, 8, 2, 8, 3, 21
    kp, vp, table = _paged(rng, b, kv, dk, dv, ps, nb)
    qpos = np.stack([np.arange(c) + s for s in (0, 7, 14)]).astype(
        np.int32)
    q = rng.normal(size=(b, c, h, dk)).astype(np.float32)
    got = tref.chunked_prefill_attention_ref(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), _t(table), _t(qpos),
        prompt_len=prompt)
    want = J_PREFILL(_j(q, dtype), _j(kp, dtype), _j(vp, dtype), _j(table),
                     _j(qpos), prompt_len=prompt)
    assert tuple(got.shape) == (b, c, h, dv)
    _close(got, want, TOL[dtype])


def _scan_inputs(rng, b, s, d, n):
    x = (rng.normal(size=(b, s, d)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(b, s, d)))) * 0.1).astype(
        np.float32)
    a_log = (rng.normal(size=(d, n)) * 0.3).astype(np.float32)
    b_in = rng.normal(size=(b, s, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a_log, b_in, c_in


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [12, 4, 3])
def test_selective_scan_padded_state_matches_reference(n, dtype):
    """``ops.selective_scan`` pads N (12 -> 16, 3 -> 4; 4 as it is):
    y and h_final of the N the caller gave, within the reference
    kernel test's tolerances of ``selective_scan_ref``."""
    rng = np.random.default_rng(n)
    arrs = _scan_inputs(rng, 2, 24, 16, n)
    x, dt, a_log, b_in, c_in = arrs
    y, h = ops.selective_scan(_t(x, dtype), _t(dt, dtype), _t(a_log),
                              _t(b_in, dtype), _t(c_in, dtype))
    yr, hr = J_SCAN(_j(x, dtype), _j(dt, dtype), _j(a_log),
                    _j(b_in, dtype), _j(c_in, dtype))
    assert tuple(h.shape) == (2, 16, n) and tuple(y.shape) == (2, 24, 16)
    _close(y, yr, TOL[dtype] * 5)
    _close(h, hr, 1e-4, 1e-3)


def test_selective_scan_padding_keeps_the_states_and_the_unpadded_bits():
    """Padded states stay 0, so h_final's N columns are the plain
    version's own bits at N 12; at a power of two (N 4) nothing is
    padded and y and h_final are the plain version's bits; the
    gradients of the padded call are the plain backward's at N 12."""
    rng = np.random.default_rng(5)
    for n in (12, 4):
        arrs = [_t(a) for a in _scan_inputs(rng, 2, 20, 8, n)]
        leaves = [a.clone().requires_grad_() for a in arrs]
        y, h = ops.selective_scan(*leaves)
        yp, hp = ss.selective_scan_plain(*arrs)
        assert torch.equal(h.detach(), hp)
        if n == 4:
            assert torch.equal(y.detach(), yp)
        else:
            _close(y.detach(), yp, 1e-6)
        dy = _t(rng.normal(size=y.shape).astype(np.float32))
        dh = _t(rng.normal(size=h.shape).astype(np.float32))
        got = torch.autograd.grad((y, h), leaves, (dy, dh))
        want = ss.selective_scan_bwd_plain(*arrs, dy, dh)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w, 1e-5, 1e-4)


# ----------------------------------------------------------------------
# the wrappers' shape checks: taken widths reach the device check
# ----------------------------------------------------------------------
def _decode_calls(dk, dv, dtype=torch.bfloat16):
    """The four decode wrappers on ``meta`` tensors of widths dk / dv."""
    i32 = dict(dtype=torch.int32, **META)
    q = torch.empty(2, 4, dk, dtype=dtype, **META)
    pages = (torch.empty(6, 8, 2, dk, dtype=dtype, **META),
             torch.empty(6, 8, 2, dv, dtype=dtype, **META))
    cache = (torch.empty(2, 16, 2, dk, dtype=dtype, **META),
             torch.empty(2, 16, 2, dv, dtype=dtype, **META))
    table, lengths = torch.empty(2, 3, **i32), torch.empty(2, **i32)
    codes = (torch.empty(6, 8, 2, dk, dtype=torch.int8, **META),
             torch.empty(6, 8, 2, dv, dtype=torch.int8, **META))
    cscale = torch.empty(6, 8, 2, **META)
    dcodes = (torch.empty(2, 16, 2, dk, dtype=torch.int8, **META),
              torch.empty(2, 16, 2, dv, dtype=torch.int8, **META))
    dscale = torch.empty(2, 16, 2, **META)
    return {
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q, *pages, table, lengths),
        "decode_attention": lambda: ops.decode_attention(q, *cache, 9),
        "paged_decode_attention_quant":
            lambda: ops.paged_decode_attention_quant(
                q, codes[0], cscale, codes[1], cscale, table, lengths),
        "decode_attention_quant": lambda: ops.decode_attention_quant(
            q, dcodes[0], dscale, dcodes[1], dscale, 9)}


@pytest.mark.parametrize("dk,dv", [(256, 256), (192, 128), (64, 136),
                                   (248, 248), (42, 42)])
@pytest.mark.parametrize("wrapper", ["paged_decode_attention",
                                     "decode_attention",
                                     "paged_decode_attention_quant",
                                     "decode_attention_quant"])
def test_decode_wrappers_take_the_new_widths(wrapper, dk, dv):
    with pytest.raises(ValueError, match="no kernel"):
        _decode_calls(dk, dv)[wrapper]()


@pytest.mark.parametrize("dk,dv", [(264, 264), (256, 260), (132, 128),
                                   (128, 300)])
@pytest.mark.parametrize("wrapper", ["paged_decode_attention",
                                     "decode_attention",
                                     "paged_decode_attention_quant",
                                     "decode_attention_quant"])
def test_decode_wrappers_raise_past_the_limits(wrapper, dk, dv):
    """Above 256, or above 128 off the grid of 8, before the device."""
    with pytest.raises(ValueError, match="multiples of 8 up to 256"):
        _decode_calls(dk, dv)[wrapper]()


def _prefill(dk, dv, dtype):
    i32 = dict(dtype=torch.int32, **META)
    return ops.chunked_prefill_attention(
        torch.empty(2, 4, 4, dk, dtype=dtype, **META),
        torch.empty(6, 8, 2, dk, dtype=dtype, **META),
        torch.empty(6, 8, 2, dv, dtype=dtype, **META),
        torch.empty(2, 3, **i32), torch.empty(2, 4, **i32), prompt_len=9)


@pytest.mark.parametrize("dtype,dk,dv,match", [
    (torch.bfloat16, 32, 32, "no kernel"),
    (torch.bfloat16, 96, 96, "no kernel"),
    (torch.bfloat16, 256, 256, "no kernel"),
    (torch.bfloat16, 192, 128, "no kernel"),
    (torch.float32, 256, 256, "no kernel"),
    (torch.float32, 20, 36, "no kernel"),     # f32: any width to 256
    (torch.bfloat16, 12, 12, "multiples of 8"),
    (torch.bfloat16, 64, 100, "multiples of 8"),
    (torch.bfloat16, 264, 264, "up to 256"),
    (torch.float32, 128, 300, "up to 256"),
])
def test_prefill_wrapper_checks_widths_before_the_device(dtype, dk, dv,
                                                         match):
    with pytest.raises(ValueError, match=match):
        _prefill(dk, dv, dtype)


@pytest.mark.parametrize("n,match", [(12, "no kernel"), (3, "no kernel"),
                                     (32, "no kernel"),
                                     (33, "power of two")])
def test_scan_wrapper_pads_to_the_kernel_or_raises(n, match):
    """N up to 32 is padded to a size the kernel takes and reaches the
    device check; N 33 (padded to nothing) raises on ``scan_plan``."""
    x = torch.empty(2, 5, 8, **META)
    with pytest.raises(ValueError, match=match):
        ops.selective_scan(x, torch.empty(2, 5, 8, **META),
                           torch.empty(8, n, **META),
                           torch.empty(2, 5, n, **META),
                           torch.empty(2, 5, n, **META))


def test_padded_state_sizes():
    assert [ss.padded_state_size(n) for n in range(1, 34)] == (
        [1, 2, 4, 4] + [8] * 4 + [16] * 8 + [32] * 16 + [33])


# ----------------------------------------------------------------------
# the projection's split of K
# ----------------------------------------------------------------------
K_SIZES = [1, 63, 64, 65, 192, 576, 1000, 4096, 4104, 5120, 14336]


@pytest.mark.parametrize("k", K_SIZES)
def test_projection_ranges_tile_k_in_order(k):
    p = projection_plan(k, 4096)
    assert len(p.ranges) == p.split == 8
    assert p.ranges[0][0] == 0 and p.ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(p.ranges, p.ranges[1:]):
        assert lo <= hi == lo2
    for lo, hi in p.ranges:
        # every range starts on the granule; only the last non-empty one
        # may end off it (at K)
        assert (lo % 64 == 0 or lo == k) and (hi % 64 == 0 or hi == k)
        assert hi - lo <= p.chunk
    assert p.chunk % 64 == 0 and p.chunk >= -(-k // 8)


@pytest.mark.parametrize("k", K_SIZES)
def test_projection_ranges_depend_on_k_alone(k):
    assert list(inspect.signature(projection_plan).parameters) == ["k",
                                                                   "n"]
    base = projection_plan(k, 4096)
    for n in (2048, 1024, 4096 // 3, 13, 128256):
        p = projection_plan(k, n)
        assert (p.ranges, p.chunk, p.cols, p.rows_bf16, p.rows_f32) == (
            base.ranges, base.chunk, base.cols, base.rows_bf16,
            base.rows_f32)
        assert p.col_tiles == -(-n // p.cols)
    # any M: the rows only add row tiles, never change a range
    for m in (1, 4, 8, 97, 256):
        for dtype, rows in ((torch.bfloat16, base.rows_bf16),
                            (torch.float32, base.rows_f32)):
            assert base.ctas(m, dtype) == (
                8 * base.col_tiles * -(-m // rows))


@pytest.mark.parametrize("k,n,least", [(4096, 4096, 128), (4096, 1024, 64),
                                       (4096, 512, 64), (4096, 2048, 64)])
def test_projection_grid_fills_the_card_at_a_decode(k, n, least):
    """A decode's 8 rows: at least 128 CTAs at (4096, 4096), 64 at the
    narrow and the mesh's local widths."""
    assert projection_plan(k, n).ctas(8, torch.bfloat16) >= least
