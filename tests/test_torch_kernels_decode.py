"""The port's decode kernels over contiguous caches and int8 pages, on the
CPU: the plain PyTorch versions of the dense-cache decode, the int8-cache
decode and the int8 paged decode held against the reference's oracles
and against its Pallas kernels in interpret mode, on the same numpy
inputs, plus ``quantize_kv`` code for code. The sweeps are the
reference's (``tests/test_kernels.py``) plus cache lengths off every
block grid, stale bytes past the valid prefix and the wave's serving
shapes (48 rows = 16 tasks x 3 samples, 105 cached positions, 9 query /
3 kv heads of 64). The Hopper kernels run only on a card
(``chip_smoke.py`` holds them against these plain versions there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    decode_attention as pallas_decode)
from repro.kernels.decode_attention_quant import (
    decode_attention_quant as pallas_decode_quant)
from repro.kernels.paged_decode_attention_quant import (
    paged_decode_attention_quant as pallas_paged_quant)
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

# tests/test_kernels.py: f32 attention 2e-5, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

J_DECODE = jax.jit(jref.decode_attention_ref)
J_DECODE_QUANT = jax.jit(jattn.decode_attention_quant)
J_PAGED_QUANT = jax.jit(jref.paged_decode_attention_quant_ref)
J_QUANTIZE = jax.jit(jattn.quantize_kv)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(_TDT[dtype]) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a, _JDT[dtype]) if dtype else jnp.asarray(a)


def _close(got, want, atol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32)) \
        if not isinstance(want, torch.Tensor) else want.float().numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


def _quantized(rng, shape):
    """int8 codes and f32 scales, quantised by the reference."""
    codes, scale = J_QUANTIZE(
        jnp.asarray(rng.normal(size=shape).astype(np.float32)))
    return np.array(codes), np.array(scale)


# ----------------------------------------------------------------------
# dense-cache decode (kernel 4)
# ----------------------------------------------------------------------
DECODE_CASES = [
    # (b, h, kv, dk, s, length)
    (1, 4, 4, 64, 256, 192),       # MHA
    (2, 8, 2, 128, 512, 384),      # GQA
    (2, 8, 1, 128, 512, 384),      # MQA
    (1, 16, 8, 64, 1024, 768),
    (3, 6, 3, 32, 384, 288),
    (48, 9, 3, 64, 105, 105),      # the wave's serving shape, full
    (48, 9, 3, 64, 105, 98),       # ... its first decode step
    # more than 8 query heads per kv head (the kernel's G-tiles):
    # granite-34b's G 48 and a ragged G 12, one kv head
    (2, 48, 1, 32, 64, 50),
    (3, 12, 1, 16, 48, 33),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"b{c[0]}h{c[1]}s{c[4]}l{c[5]}"
                              for c in DECODE_CASES])
def test_decode_plain_matches_reference(case, dtype):
    b, h, kv, dk, s, length = case
    rng = np.random.default_rng(b * s + h)
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dk)).astype(np.float32)
    got = tref.decode_attention_ref(_t(q, dtype), _t(k, dtype),
                                    _t(v, dtype), length)
    want = J_DECODE(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                    jnp.int32(length))
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (b, h, dk)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("s,blk,length", [
    (300, 128, 293),      # off the block grid: Pallas pads to 384
    (520, 512, 513),      # just past one block
    (129, 64, 122),       # one token over a block
    (96, 128, 89),        # shorter than a block
    (105, 512, 105),      # the wave's cache: prompt 97 + 8 new tokens
    (105, 512, 60),       # ... with a length below S
])
def test_decode_plain_matches_pallas_interpret_off_grid(s, blk, length):
    rng = np.random.default_rng(s + blk)
    q = rng.normal(size=(2, 6, 64)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 64)).astype(np.float32)
    got = tref.decode_attention_ref(_t(q), _t(k), _t(v), length)
    want = pallas_decode(_j(q), _j(k), _j(v), jnp.int32(length),
                         block_s=blk, interpret=True)
    _close(got, want, TOL["float32"])


def test_decode_plain_ignores_positions_past_length():
    rng = np.random.default_rng(3)
    q = _t(rng.normal(size=(2, 6, 64)).astype(np.float32))
    k = rng.normal(size=(2, 105, 3, 64)).astype(np.float32)
    v = rng.normal(size=(2, 105, 3, 64)).astype(np.float32)
    out1 = ops.decode_attention(q, _t(k), _t(v), 60)
    k[:, 60:], v[:, 60:] = 1e4, -1e4
    out2 = ops.decode_attention(q, _t(k), _t(v), 60)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


# ----------------------------------------------------------------------
# int8-cache decode (kernel 6)
# ----------------------------------------------------------------------
QUANT_CASES = [
    # (b, h, kv, dk, s, blk, length)
    (1, 4, 4, 64, 256, 128, 192),      # MHA
    (2, 8, 2, 128, 512, 128, 384),     # GQA
    (2, 8, 1, 64, 512, 256, 384),      # MQA
    (3, 6, 3, 32, 384, 384, 288),      # block = the whole cache
    (48, 9, 3, 64, 105, 512, 105),     # the wave's serving shape
    (48, 9, 3, 64, 105, 512, 98),
    (2, 48, 1, 32, 64, 64, 50),        # G 48 (G-tiles)
    (3, 12, 1, 16, 48, 16, 33),        # G 12, a ragged last tile
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QUANT_CASES,
                         ids=[f"b{c[0]}h{c[1]}s{c[4]}l{c[6]}"
                              for c in QUANT_CASES])
def test_decode_quant_plain_matches_reference(case, dtype):
    """Against what the reference's op runs off the TPU: its jnp quant
    path over the linear positions."""
    b, h, kv, dk, s, _, length = case
    rng = np.random.default_rng(b * s + h + 1)
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    kq, ks = _quantized(rng, (b, s, kv, dk))
    vq, vs = _quantized(rng, (b, s, kv, dk))
    got = tref.decode_attention_quant_ref(
        _t(q, dtype), _t(kq), _t(ks), _t(vq), _t(vs), length)
    want = J_DECODE_QUANT(_j(q, dtype), _j(kq), _j(ks), _j(vq), _j(vs),
                          jnp.arange(s), jnp.int32(length - 1))
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (b, h, dk)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("case", QUANT_CASES,
                         ids=[f"b{c[0]}h{c[1]}s{c[4]}l{c[6]}"
                              for c in QUANT_CASES])
def test_decode_quant_plain_matches_pallas_interpret(case):
    b, h, kv, dk, s, blk, length = case
    rng = np.random.default_rng(b * s + h + 2)
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    kq, ks = _quantized(rng, (b, s, kv, dk))
    vq, vs = _quantized(rng, (b, s, kv, dk))
    got = tref.decode_attention_quant_ref(_t(q), _t(kq), _t(ks), _t(vq),
                                          _t(vs), length)
    want = pallas_decode_quant(_j(q), _j(kq), _j(ks), _j(vq), _j(vs),
                               jnp.int32(length), block_s=blk,
                               interpret=True)
    _close(got, want, TOL["float32"])


def test_decode_quant_plain_ignores_stale_codes_past_length():
    rng = np.random.default_rng(2)
    q = _t(rng.normal(size=(1, 4, 64)).astype(np.float32))
    kq, ks = _quantized(rng, (1, 256, 2, 64))
    vq, vs = _quantized(rng, (1, 256, 2, 64))
    out1 = ops.decode_attention_quant(q, _t(kq), _t(ks), _t(vq), _t(vs),
                                      100)
    kq[:, 100:], ks[:, 100:] = 127, 1e6
    vq[:, 100:], vs[:, 100:] = -127, 1e6
    out2 = ops.decode_attention_quant(q, _t(kq), _t(ks), _t(vq), _t(vs),
                                      100)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


# ----------------------------------------------------------------------
# int8 paged decode (kernel 5)
# ----------------------------------------------------------------------
PAGED_CASES = [
    # (b, h, kv, dk, ps, nb)
    (1, 4, 4, 64, 16, 4),          # MHA
    (2, 8, 2, 128, 8, 6),          # GQA
    (2, 8, 1, 64, 32, 3),          # MQA
    (3, 6, 3, 32, 8, 5),
    (48, 9, 3, 64, 8, 14),         # the wave's serving shape
    (2, 48, 1, 32, 8, 4),          # G 48 (G-tiles)
    (3, 12, 1, 16, 8, 3),          # G 12, a ragged last tile
]


def _paged_quant_inputs(rng, b, h, kv, dk, ps, nb):
    """Pages of b * nb + 2 ids shuffled into the block tables (the 2
    spares stand in for scratch pages); lengths end mid-page and leave
    whole spare slots at the end of the table."""
    n_pages = b * nb + 2
    q = rng.normal(size=(b, h, dk)).astype(np.float32)
    kq, ks = _quantized(rng, (n_pages, ps, kv, dk))
    vq, vs = _quantized(rng, (n_pages, ps, kv, dk))
    table = rng.permutation(n_pages)[:b * nb].astype(np.int32).reshape(
        b, nb)
    lengths = (nb * ps - (np.arange(b) * 5) % (nb * ps - 1) - 1).astype(
        np.int32)
    return q, kq, ks, vq, vs, table, lengths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"b{c[0]}h{c[1]}ps{c[4]}nb{c[5]}"
                              for c in PAGED_CASES])
def test_paged_quant_plain_matches_reference(case, dtype):
    rng = np.random.default_rng(sum(case))
    q, kq, ks, vq, vs, table, lengths = _paged_quant_inputs(rng, *case)
    got = tref.paged_decode_attention_quant_ref(
        _t(q, dtype), _t(kq), _t(ks), _t(vq), _t(vs), _t(table),
        _t(lengths))
    want = J_PAGED_QUANT(_j(q, dtype), _j(kq), _j(ks), _j(vq), _j(vs),
                         _j(table), _j(lengths))
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == q.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"b{c[0]}h{c[1]}ps{c[4]}nb{c[5]}"
                              for c in PAGED_CASES])
def test_paged_quant_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(sum(case) + 1)
    q, kq, ks, vq, vs, table, lengths = _paged_quant_inputs(rng, *case)
    got = tref.paged_decode_attention_quant_ref(
        _t(q), _t(kq), _t(ks), _t(vq), _t(vs), _t(table), _t(lengths))
    want = pallas_paged_quant(_j(q), _j(kq), _j(ks), _j(vq), _j(vs),
                              _j(table), _j(lengths), interpret=True)
    _close(got, want, TOL["float32"])


def test_paged_quant_plain_masks_stale_pages():
    """Bytes past each row's length — whole spare pages the block
    table still references and the dead tail of a row's last page —
    do not reach the output (reference: test_kernels.py)."""
    rng = np.random.default_rng(7)
    b, h, kv, dk, ps, nb = 2, 4, 2, 64, 8, 4
    q = _t(rng.normal(size=(b, h, dk)).astype(np.float32))
    kq, ks = _quantized(rng, (b * nb, ps, kv, dk))
    vq, vs = _quantized(rng, (b * nb, ps, kv, dk))
    table = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    lengths = _t(np.asarray([ps + 3, 2 * ps], np.int32))
    out1 = ops.paged_decode_attention_quant(
        q, _t(kq), _t(ks), _t(vq), _t(vs), _t(table), lengths)
    stale = np.concatenate([table[0, 2:], table[1, 2:]])
    for a, val in ((kq, 127), (ks, 1e6), (vq, -127), (vs, 1e6)):
        a[stale] = val
        a[table[0, 1], 3:] = val
    out2 = ops.paged_decode_attention_quant(
        q, _t(kq), _t(ks), _t(vq), _t(vs), _t(table), lengths)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


# ----------------------------------------------------------------------
# quantize_kv
# ----------------------------------------------------------------------
def _assert_quantize_equal(x: np.ndarray) -> None:
    codes, scale = tattn.quantize_kv(torch.from_numpy(x))
    jcodes, jscale = J_QUANTIZE(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_codes_and_scales_equal_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 105, 3, 64))
         * rng.uniform(1e-3, 30, size=(4, 105, 3, 1))).astype(np.float32)
    x[0, :3] = 0.0                 # all-zero vectors: scale 1e-8/127
    _assert_quantize_equal(x)


def test_quantize_kv_rounding_ties_equal_reference():
    """Elements whose quotient by the scale is exactly n + 0.5 round
    half to even in both packages."""
    rng = np.random.default_rng(5)
    rows = []
    while len(rows) < 64:
        v = rng.normal(size=64).astype(np.float32)
        v[0] = np.float32(rng.uniform(0.5, 4.0))
        v[1:] = np.clip(v[1:], -abs(v[0]), abs(v[0]))
        scale = np.float32(np.abs(v).max()) * np.float32(1.0 / 127.0)
        n = rng.integers(-126, 126, size=63)
        ties = ((n + 0.5) * scale).astype(np.float32)
        exact = (ties / scale).astype(np.float32) == (n + 0.5)
        if exact.sum() >= 8:
            v[1:] = np.where(exact, ties, v[1:])
            rows.append(v)
    x = np.stack(rows)
    codes, _ = tattn.quantize_kv(torch.from_numpy(x))
    assert (np.abs(codes.numpy()[:, 1:]) % 2 == 0).any()
    _assert_quantize_equal(x)


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_decode_versions_without_launching():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(2, 4, 16)).astype(np.float32))
    k = _t(rng.normal(size=(2, 9, 2, 16)).astype(np.float32))
    np.testing.assert_array_equal(
        ops.decode_attention(q, k, k, 7).numpy(),
        tref.decode_attention_ref(q, k, k, 7).numpy())
    kq, ks = _quantized(rng, (2, 9, 2, 16))
    np.testing.assert_array_equal(
        ops.decode_attention_quant(q, _t(kq), _t(ks), _t(kq), _t(ks),
                                   7).numpy(),
        tref.decode_attention_quant_ref(q, _t(kq), _t(ks), _t(kq),
                                        _t(ks), 7).numpy())
    table, lengths = _t(np.asarray([[0], [1]], np.int32)), _t(
        np.asarray([5, 9], np.int32))
    np.testing.assert_array_equal(
        ops.paged_decode_attention_quant(q, _t(kq), _t(ks), _t(kq),
                                         _t(ks), table, lengths).numpy(),
        tref.paged_decode_attention_quant_ref(
            q, _t(kq), _t(ks), _t(kq), _t(ks), table, lengths).numpy())
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("h", [48, 12])
def test_decode_wrappers_take_more_than_8_heads_per_kv_head(h):
    """G 48 (granite-34b) and G 12 pass every wrapper's checks (the
    kernels run G-tiles of 8) and raise only because ``meta`` has no
    kernel."""
    m = dict(device="meta")
    i8 = dict(dtype=torch.int8, **m)
    i32 = dict(dtype=torch.int32, **m)
    q = torch.empty(2, h, 32, **m)
    for call in (
            lambda: ops.decode_attention(
                q, torch.empty(2, 9, 1, 32, **m),
                torch.empty(2, 9, 1, 32, **m), 5),
            lambda: ops.decode_attention_quant(
                q, torch.empty(2, 9, 1, 32, **i8), torch.empty(2, 9, 1, **m),
                torch.empty(2, 9, 1, 32, **i8), torch.empty(2, 9, 1, **m), 5),
            lambda: ops.paged_decode_attention(
                q, torch.empty(4, 8, 1, 32, **m),
                torch.empty(4, 8, 1, 32, **m), torch.empty(2, 2, **i32),
                torch.empty(2, **i32)),
            lambda: ops.paged_decode_attention_quant(
                q, torch.empty(4, 8, 1, 32, **i8), torch.empty(4, 8, 1, **m),
                torch.empty(4, 8, 1, 32, **i8), torch.empty(4, 8, 1, **m),
                torch.empty(2, 2, **i32), torch.empty(2, **i32))):
        with pytest.raises(ValueError, match="no kernel"):
            call()


def test_decode_wrappers_raise_off_the_cpu_instead_of_falling_back():
    m = dict(device="meta")
    i8 = dict(dtype=torch.int8, **m)
    i32 = dict(dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention(torch.empty(2, 3, 16, **m),
                             torch.empty(2, 9, 1, 16, **m),
                             torch.empty(2, 9, 1, 16, **m), 5)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention_quant(
            torch.empty(2, 3, 16, **m), torch.empty(2, 9, 1, 16, **i8),
            torch.empty(2, 9, 1, **m), torch.empty(2, 9, 1, 16, **i8),
            torch.empty(2, 9, 1, **m), 5)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode_attention_quant(
            torch.empty(2, 3, 16, **m), torch.empty(4, 8, 1, 16, **i8),
            torch.empty(4, 8, 1, **m), torch.empty(4, 8, 1, 16, **i8),
            torch.empty(4, 8, 1, **m), torch.empty(2, 2, **i32),
            torch.empty(2, **i32))
