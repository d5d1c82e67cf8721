"""The port's kernel modules on the CPU: each plain PyTorch version held
against the reference's oracle (``repro.kernels.ref``) and against the
reference's Pallas kernel run in interpret mode, on the same numpy
inputs. The sweeps cover rows at different depths, prompt lengths off
the page grid, spare block-table slots and bucket-padding rows pointing
at scratch pages. The Hopper kernels themselves run only on a card
(``chip_smoke.py`` holds them against these plain versions there); on a
CPU tensor the wrappers dispatch to the plain versions, and on any
other device they raise rather than fall back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.chunked_prefill_attention import (
    chunked_prefill_attention as pallas_chunked_prefill)
from repro.kernels.fused_swiglu import fused_swiglu as pallas_swiglu
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as pallas_paged_decode)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# f32 attention as tests/test_chunked_prefill.py and
# tests/test_paged_attention.py; bf16 and the SwiGLU as tests/test_kernels.py
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SWIGLU_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-1)}

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# the reference oracles, each compiled as one program (eager jnp would
# compile every op on its own)
J_PAGED_DECODE = jax.jit(jref.paged_decode_attention_ref)
J_CHUNKED_PREFILL = jax.jit(jref.chunked_prefill_attention_ref,
                            static_argnames=("prompt_len",))
J_SWIGLU = jax.jit(jref.fused_swiglu_ref)
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype=None):
    """numpy -> torch, optionally cast (bf16 via f32 so both packages
    round the same f32 values)."""
    t = torch.from_numpy(np.array(a))
    return t.to(_TDT[dtype]) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a, _JDT[dtype]) if dtype else jnp.asarray(a)


def _close(got, want, atol, rtol=None):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor)
                     else jnp.asarray(got, jnp.float32), np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor)
                      else jnp.asarray(want, jnp.float32), np.float32)
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=atol if rtol is None else rtol)


def _paged_inputs(rng, b, h, kv, d, ps, nb, extra_pages=0):
    """Random pages and per-row block tables of distinct page ids; the
    last ``extra_pages`` pages are a scratch region."""
    n_pages = b * nb + extra_pages
    kp = rng.normal(size=(n_pages, ps, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kv, d)).astype(np.float32)
    perm = rng.permutation(b * nb).astype(np.int32)
    table = perm.reshape(b, nb)
    return kp, vp, table


# ----------------------------------------------------------------------
# paged decode
# ----------------------------------------------------------------------
DECODE_CASES = [
    # (b, h, kv, d, page, nb, lengths)
    (4, 3, 1, 64, 8, 4, [1, 9, 24, 32]),            # depths incl. edges
    (3, 9, 3, 64, 8, 14, [98, 101, 105]),          # serving geometry
    (5, 6, 2, 32, 4, 6, [3, 4, 5, 17, 24]),        # page boundaries
    (2, 4, 4, 16, 16, 3, [33, 7]),                 # MHA, spare slots
    # more than 8 query heads per kv head (the kernel's G-tiles):
    # granite-34b's G 48 and a ragged G 12, one kv head
    (2, 48, 1, 32, 8, 4, [13, 32]),
    (3, 12, 1, 16, 8, 3, [5, 17, 24]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[f"b{c[0]}h{c[1]}kv{c[2]}" for c in
                              DECODE_CASES])
def test_paged_decode_plain_matches_reference(case, dtype):
    b, h, kv, d, ps, nb, lengths = case
    rng = np.random.default_rng(b * 100 + h)
    kp, vp, table = _paged_inputs(rng, b, h, kv, d, ps, nb)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    got = tref.paged_decode_attention_ref(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), _t(table),
        _t(lengths))
    want = J_PAGED_DECODE(
        _j(q, dtype), _j(kp, dtype), _j(vp, dtype), _j(table),
        _j(lengths))
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (b, h, d)
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("case", DECODE_CASES[:3],
                         ids=[f"b{c[0]}h{c[1]}kv{c[2]}" for c in
                              DECODE_CASES[:3]])
def test_paged_decode_plain_matches_pallas_interpret(case):
    b, h, kv, d, ps, nb, lengths = case
    rng = np.random.default_rng(b * 7 + nb)
    kp, vp, table = _paged_inputs(rng, b, h, kv, d, ps, nb)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    got = tref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp),
                                          _t(table), _t(lengths))
    want = pallas_paged_decode(_j(q), _j(kp), _j(vp), _j(table),
                               _j(lengths), interpret=True)
    _close(got, want, ATTN_TOL["float32"])


def test_paged_decode_masks_stale_pages_and_pad_rows():
    """Positions past a row's length hold garbage (stale bytes of a
    recycled page, or a pad row's scratch pages): the output must not
    depend on them."""
    rng = np.random.default_rng(3)
    b, h, kv, d, ps, nb = 3, 6, 2, 32, 8, 4
    kp, vp, table = _paged_inputs(rng, b, h, kv, d, ps, nb, extra_pages=nb)
    table[-1] = np.arange(b * nb, b * nb + nb)       # pad row on scratch
    lengths = np.asarray([5, 17, 17], np.int32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    out0 = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                      _t(lengths))
    kp2, vp2 = kp.copy(), vp.copy()
    for r in range(b):
        for pos in range(int(lengths[r]), nb * ps):
            page, slot = table[r, pos // ps], pos % ps
            kp2[page, slot] = 1e4
            vp2[page, slot] = -1e4
    out1 = ops.paged_decode_attention(_t(q), _t(kp2), _t(vp2), _t(table),
                                      _t(lengths))
    np.testing.assert_array_equal(out0.numpy(), out1.numpy())


# ----------------------------------------------------------------------
# chunked prefill
# ----------------------------------------------------------------------
PREFILL_CASES = [
    # (b, c, h, kv, d, page, prompt_len, starts)
    (3, 8, 3, 1, 64, 8, 21, [0, 8, 13]),           # off-grid prompt
    (2, 4, 4, 2, 16, 8, 21, [4, 12]),              # the reference's own
    (4, 5, 6, 3, 32, 4, 23, [0, 5, 10, 18]),       # page 4, odd chunk
    (2, 1, 9, 3, 64, 8, 97, [96, 40]),             # last 1-token chunk
    (2, 6, 8, 2, 128, 8, 29, [0, 23]),             # head_dim 128, G 4
    (2, 7, 4, 4, 128, 8, 31, [7, 24]),             # head_dim 128, G 1
]


def _prefill_inputs(case, seed, extra_pages=0):
    b, c, h, kv, d, ps, prompt_len, starts = case
    nb = -(-prompt_len // ps) + 1                  # one spare slot
    rng = np.random.default_rng(seed)
    kp, vp, table = _paged_inputs(rng, b, h, kv, d, ps, nb, extra_pages)
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    qpos = (np.asarray(starts)[:, None] + np.arange(c)[None]).astype(
        np.int32)
    return q, kp, vp, table, qpos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES,
                         ids=[f"b{c[0]}c{c[1]}s{c[6]}" for c in
                              PREFILL_CASES])
def test_chunked_prefill_plain_matches_reference(case, dtype):
    q, kp, vp, table, qpos = _prefill_inputs(case, case[6] + case[1])
    s = case[6]
    got = tref.chunked_prefill_attention_ref(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), _t(table), _t(qpos),
        prompt_len=s)
    want = J_CHUNKED_PREFILL(
        _j(q, dtype), _j(kp, dtype), _j(vp, dtype), _j(table), _j(qpos),
        prompt_len=s)
    assert got.dtype == _TDT[dtype] and got.shape == q.shape
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("case", PREFILL_CASES,
                         ids=[f"b{c[0]}c{c[1]}s{c[6]}" for c in
                              PREFILL_CASES])
def test_chunked_prefill_plain_matches_pallas_interpret(case):
    q, kp, vp, table, qpos = _prefill_inputs(case, case[6] * 3)
    s = case[6]
    got = tref.chunked_prefill_attention_ref(
        _t(q), _t(kp), _t(vp), _t(table), _t(qpos), prompt_len=s)
    want = pallas_chunked_prefill(_j(q), _j(kp), _j(vp), _j(table),
                                  _j(qpos), prompt_len=s, interpret=True)
    _close(got, want, ATTN_TOL["float32"])


def test_chunked_prefill_ignores_keys_past_the_query_and_prompt():
    """Keys after each query's position — the rest of the prompt, the
    spare block-table slot, a pad row's scratch pages — must not reach
    the output."""
    case = (3, 8, 3, 1, 64, 8, 21, [0, 8, 8])
    q, kp, vp, table, qpos = _prefill_inputs(case, 11, extra_pages=4)
    table[-1] = np.arange(table.size, table.size + table.shape[1])
    out0 = ops.chunked_prefill_attention(_t(q), _t(kp), _t(vp),
                                         _t(table), _t(qpos),
                                         prompt_len=21)
    kp2, vp2 = kp.copy(), vp.copy()
    ps = 8
    for r in range(3):
        last = int(qpos[r].max())
        for pos in range(last + 1, table.shape[1] * ps):
            page, slot = table[r, pos // ps], pos % ps
            kp2[page, slot] = 1e4
            vp2[page, slot] = -1e4
    out1 = ops.chunked_prefill_attention(_t(q), _t(kp2), _t(vp2),
                                         _t(table), _t(qpos),
                                         prompt_len=21)
    np.testing.assert_array_equal(out0.numpy(), out1.numpy())


def _pad_bucket(table, positions):
    """Pad the last row of a bucket as the step loop does: it repeats
    the previous row's positions and points at the scratch pages."""
    nb = table.shape[1]
    table[-1] = np.arange(table.size, table.size + nb)
    positions[-1] = positions[-2]


def test_pad_row_on_scratch_pages_matches_reference_and_pallas():
    """A bucket whose last row is a pad row on scratch pages (stale
    bytes) at a repeated depth, in both attention kernels: the plain
    versions agree with the oracles and the Pallas kernels."""
    rng = np.random.default_rng(21)
    # decode: 3 rows + 1 pad row, 9/3 heads, 14 pages
    b, h, kv, d, ps, nb = 4, 9, 3, 64, 8, 14
    kp, vp, table = _paged_inputs(rng, b, h, kv, d, ps, nb, extra_pages=nb)
    lengths = np.asarray([98, 103, 105, 0], np.int32)
    _pad_bucket(table, lengths)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(lengths))
    for want in (
            J_PAGED_DECODE(_j(q), _j(kp), _j(vp),
                                            _j(table), _j(lengths)),
            pallas_paged_decode(_j(q), _j(kp), _j(vp), _j(table),
                                _j(lengths), interpret=True)):
        _close(got, want, ATTN_TOL["float32"])
    # prefill: 3 rows at depths 0/32/64 of a 97-token prompt + 1 pad row
    b, c, s = 4, 32, 97
    nbp = -(-s // ps)
    kp, vp, table = _paged_inputs(rng, b, h, kv, d, ps, nbp,
                                  extra_pages=nbp)
    qpos = (np.asarray([0, 32, 64, 0])[:, None]
            + np.arange(c)[None]).astype(np.int32)
    _pad_bucket(table, qpos)
    q = rng.normal(size=(b, c, h, d)).astype(np.float32)
    got = ops.chunked_prefill_attention(_t(q), _t(kp), _t(vp), _t(table),
                                        _t(qpos), prompt_len=s)
    for want in (
            J_CHUNKED_PREFILL(
                _j(q), _j(kp), _j(vp), _j(table), _j(qpos), prompt_len=s),
            pallas_chunked_prefill(_j(q), _j(kp), _j(vp), _j(table),
                                   _j(qpos), prompt_len=s,
                                   interpret=True)):
        _close(got, want, ATTN_TOL["float32"])


# ----------------------------------------------------------------------
# fused SwiGLU
# ----------------------------------------------------------------------
SWIGLU_CASES = [(8, 64, 256), (24, 192, 512), (100, 64, 250),
                (256, 96, 192)]


def _swiglu_inputs(t, d, f):
    rng = np.random.default_rng(t + f)
    x = (rng.normal(size=(t, d)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32)
          for s in ((d, f), (d, f), (f, d))]
    return [x] + ws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,f", SWIGLU_CASES)
def test_fused_swiglu_plain_matches_reference(t, d, f, dtype):
    arrs = _swiglu_inputs(t, d, f)
    got = tref.fused_swiglu_ref(*[_t(a, dtype) for a in arrs])
    want = J_SWIGLU(*[_j(a, dtype) for a in arrs])
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (t, d)
    _close(got, want, *SWIGLU_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,f", [(8, 2560, 7680)])
def test_fused_swiglu_plain_matches_reference_at_full_width(t, d, f, dtype):
    """recurrentgemma-2b's MLP width, past the kernel's old d <= 1024.
    f32 at the tolerance above. In bf16 the outputs reach 17.4 here, and
    the two frameworks' bf16 roundings of g, u and h move them by up to
    0.125 (one bf16 step at 16), past the 2e-2 absolute tolerance sized
    for d <= 192; the bound is 2e-2 of the largest output (about five
    bf16 roundings of it)."""
    arrs = _swiglu_inputs(t, d, f)
    got = tref.fused_swiglu_ref(*[_t(a, dtype) for a in arrs])
    want = J_SWIGLU(*[_j(a, dtype) for a in arrs])
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (t, d)
    if dtype == "float32":
        _close(got, want, *SWIGLU_TOL[dtype])
    else:
        want = np.asarray(jnp.asarray(want, jnp.float32))
        _close(got, want, 2e-2 * float(np.abs(want).max()), 0.0)


@pytest.mark.parametrize("t,d,f", SWIGLU_CASES[:3])
def test_fused_swiglu_plain_matches_pallas_interpret(t, d, f):
    arrs = _swiglu_inputs(t, d, f)
    got = tref.fused_swiglu_ref(*[_t(a) for a in arrs])
    want = pallas_swiglu(*[_j(a) for a in arrs], block_t=8, block_f=f,
                         interpret=True)
    _close(got, want, *SWIGLU_TOL["float32"])


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions_without_launching():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    kp, vp, table = _paged_inputs(rng, 2, 3, 1, 16, 8, 2)
    q = _t(rng.normal(size=(2, 3, 16)).astype(np.float32))
    lengths = _t(np.asarray([3, 11], np.int32))
    got = ops.paged_decode_attention(q, _t(kp), _t(vp), _t(table),
                                     lengths)
    want = tref.paged_decode_attention_ref(q, _t(kp), _t(vp), _t(table),
                                           lengths)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    arrs = [_t(a) for a in _swiglu_inputs(8, 16, 32)]
    np.testing.assert_array_equal(ops.fused_swiglu(*arrs).numpy(),
                                  tref.fused_swiglu_ref(*arrs).numpy())
    assert ops.launch_counts() == {
        "paged_decode_attention": 0, "chunked_prefill_attention": 0,
        "fused_swiglu": 0, "decode_attention": 0,
        "paged_decode_attention_quant": 0, "decode_attention_quant": 0,
        "selective_scan": 0, "selective_scan_bwd": 0, "rglru_scan": 0,
        "rglru_scan_bwd": 0, "swiglu_gate_up": 0, "swiglu_down": 0,
        "projection": 0}


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    """A tensor on a device with no kernel (here ``meta``; the same
    path validates CUDA tensors) raises; it never reaches the plain
    version."""
    m = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode_attention(
            torch.empty(2, 3, 16, **m), torch.empty(4, 8, 1, 16, **m),
            torch.empty(4, 8, 1, 16, **m),
            torch.empty(2, 2, dtype=torch.int32, **m),
            torch.empty(2, dtype=torch.int32, **m))
    with pytest.raises(ValueError, match="no kernel"):
        ops.chunked_prefill_attention(
            torch.empty(2, 4, 3, 16, **m), torch.empty(4, 8, 1, 16, **m),
            torch.empty(4, 8, 1, 16, **m),
            torch.empty(2, 2, dtype=torch.int32, **m),
            torch.empty(2, 4, dtype=torch.int32, **m), prompt_len=9)
    with pytest.raises(ValueError, match="no kernel"):
        ops.fused_swiglu(torch.empty(8, 16, **m), torch.empty(16, 32, **m),
                         torch.empty(16, 32, **m), torch.empty(32, 16, **m))


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    """Each source names the Pallas kernel it replaces; the projection,
    which has no TPU counterpart, says so and why it is there."""
    from repro_torch.kernels import build
    for name in build.SOURCES:
        text = (build.CSRC / name).read_text()
        stem = name[:-3]
        if stem == "projection":
            assert "Replaces no TPU kernel" in text, name
        else:
            assert f"src/repro/kernels/{stem}.py::{stem}" in text, name
        assert "bounds it on the H100" in text, name
        assert 'extern "C"' in text and "cudaGetLastError" in text, name
