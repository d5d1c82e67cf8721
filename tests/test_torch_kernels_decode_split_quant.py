"""The split-KV arithmetic of the port's int8 decode kernels (the int8
paged decode and the int8 dense-cache decode, both on
``csrc/decode_split.cuh``), on the CPU.

The kernels split each row's positions over a cluster of CTAs by
``split_ranges(length)``, run an online softmax over each range in
16-key tiles with the int8 codes' per-vector scales folded in (the k
scale into a key's score, the v scale into its probability) and combine
the ranks' partial states in rank order. The CUDA kernels run only on a
card (``chip_smoke.py`` holds them against their plain versions there
and checks their rows bit for bit); here a torch emulation of the split,
the folded scales and the rank-order combine, kept in this file, is held
against the reference's Pallas int8 kernels in interpret mode, against
its oracle (``repro.kernels.ref.paged_decode_attention_quant_ref``) and
against its jnp quant path (``repro.models.attention
.decode_attention_quant``), on the same numpy codes and scales
(quantised by the reference's ``quantize_kv``), at the tolerances of
``tests/test_kernels.py`` and at the lengths of
``tests/test_torch_kernels_decode_split.py``: 1, ``SPLIT - 1``,
``SPLIT``, a granule's and a range's edges +-1, a page boundary, the
wave's 105 and a 2,048-token context.

The emulation models the split and the combine, not the kernel's inner
loop: within a range it takes a max per tile with natural exponentials,
where the kernel keeps a running max per warp step in base 2 with lane
partial sums, so its bits are not the kernel's. Its bitwise tests (a row
alone, beside a longer neighbour, with spare block-table slots onto
pages of NaN scales, in a longer cache with NaN scales past the length)
check that ``split_ranges`` makes a row's split a function of the row's
own length and that only positions below it are read, codes and scales
alike; the kernel's own rows are checked bit for bit on the card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention_quant import (
    decode_attention_quant as pallas_decode_quant)
from repro.kernels.paged_decode_attention_quant import (
    paged_decode_attention_quant as pallas_paged_quant)
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention_quant as dense_mod
from repro_torch.kernels import paged_decode_attention as split_mod
from repro_torch.kernels import paged_decode_attention_quant as paged_mod
from repro_torch.kernels.paged_decode_attention import (
    SPLIT, SPLIT_GRANULE, split_ranges)

# tests/test_kernels.py: f32 attention 2e-5, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TILE = 16              # keys a tile, as decode_split.cuh's kTile

# the lengths of tests/test_torch_kernels_decode_split.py
LENGTHS = [1, SPLIT - 1, SPLIT, SPLIT_GRANULE - 1, SPLIT_GRANULE,
           SPLIT_GRANULE + 1, 24, 25, 105, 127, 128, 129, 2048]
H, KV, D, PAGE = 6, 2, 32, 8
NB = -(-max(LENGTHS) // PAGE)

J_PAGED_QUANT = jax.jit(jref.paged_decode_attention_quant_ref)
J_DECODE_QUANT = jax.jit(jattn.decode_attention_quant)
J_QUANTIZE = jax.jit(jattn.quantize_kv)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(_TDT[dtype]) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a, _JDT[dtype]) if dtype else jnp.asarray(a)


def _close(got, want, atol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


def _quantized(rng, shape):
    """int8 codes and f32 scales, quantised by the reference."""
    codes, scale = J_QUANTIZE(
        jnp.asarray(rng.normal(size=shape).astype(np.float32)))
    return np.array(codes), np.array(scale)


# ----------------------------------------------------------------------
# the emulation: split_ranges, a per-rank online softmax over tiles with
# the scales folded in, the combine in rank order (not the kernel's inner
# loop, see above)
# ----------------------------------------------------------------------
def _row_split(q_row, key_rows, length):
    """One row: q_row (KV, G, D) f32, prescaled; key_rows(lo, hi) gives
    the codes (hi - lo, KV, D) as f32 and the scales (hi - lo, KV) of K
    and of V at positions [lo, hi). Returns (KV, G, D) f32."""
    kv, g, d = q_row.shape
    parts = []
    for lo, hi in split_ranges(length):
        m = torch.full((kv, g), float("-inf"))
        lsum = torch.zeros((kv, g))
        acc = torch.zeros((kv, g, d))
        for t0 in range(lo, hi, TILE):
            k, ks, v, vs = key_rows(t0, min(t0 + TILE, hi))
            s = torch.einsum("kgd,nkd->kgn", q_row, k) * ks.T[:, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.where(m == float("-inf"), 0.0,
                                torch.exp(m - m_new))
            p = torch.exp(s - m_new[..., None])
            lsum = lsum * alpha + p.sum(-1)
            pv = p * vs.T[:, None, :]
            acc = acc * alpha[..., None] + torch.einsum("kgn,nkd->kgd", pv, v)
            m = m_new
        parts.append((m, lsum, acc))
    mx = functools.reduce(torch.maximum, [p[0] for p in parts])
    lsum = torch.zeros((kv, g))
    acc = torch.zeros((kv, g, d))
    for m, ls, ac in parts:                          # rank order
        c = torch.where(m == float("-inf"), 0.0,
                        torch.exp(m - torch.where(mx == float("-inf"), 0.0,
                                                  mx)))
        lsum = lsum + ls * c
        acc = acc + ac * c[..., None]
    return acc / lsum.clamp_min(1e-30)[..., None]


def _scaled_q(q):
    b, h, d = q.shape
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    return q.float().reshape(b, KV, h // KV, d) * scale


def emulate_paged_quant(q, k_pages, k_scale, v_pages, v_scale, table,
                        lengths):
    """The int8 paged kernel's split and combine: only positions below
    each row's length are gathered through its block table, codes and
    scales alike."""
    b, h, d = q.shape
    ps = k_pages.shape[1]
    qs = _scaled_q(q)
    out = []
    for r in range(b):
        def rows(lo, hi, r=r):
            pos = torch.arange(lo, hi)
            pages, slots = table[r, pos // ps].long(), pos % ps
            return (k_pages[pages, slots].float(), k_scale[pages, slots],
                    v_pages[pages, slots].float(), v_scale[pages, slots])
        n = min(int(lengths[r]), table.shape[1] * ps)
        out.append(_row_split(qs[r], rows, n))
    return torch.stack(out).reshape(b, h, d).to(q.dtype)


def emulate_dense_quant(q, k_codes, k_scale, v_codes, v_scale, length):
    """The int8 dense-cache kernel's split and combine over [0, length)."""
    b, h, d = q.shape
    qs = _scaled_q(q)
    out = [_row_split(qs[r], lambda lo, hi, r=r: (
        k_codes[r, lo:hi].float(), k_scale[r, lo:hi],
        v_codes[r, lo:hi].float(), v_scale[r, lo:hi]), length)
        for r in range(b)]
    return torch.stack(out).reshape(b, h, d).to(q.dtype)


# ----------------------------------------------------------------------
# inputs: one row per length in LENGTHS
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _paged_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    n_pages = b * NB
    kc, ks = _quantized(rng, (n_pages, PAGE, KV, D))
    vc, vs = _quantized(rng, (n_pages, PAGE, KV, D))
    table = rng.permutation(n_pages).astype(np.int32).reshape(b, NB)
    q = rng.normal(size=(b, H, D)).astype(np.float32)
    return q, kc, ks, vc, vs, table, np.asarray(LENGTHS, np.int32)


def _paged_torch(dtype):
    q, kc, ks, vc, vs, table, lengths = _paged_inputs()
    return (_t(q, dtype), _t(kc), _t(ks), _t(vc), _t(vs), _t(table),
            _t(lengths))


@functools.lru_cache(maxsize=None)
def _paged_results(dtype):
    q, kc, ks, vc, vs, table, lengths = _paged_inputs()
    emu = emulate_paged_quant(*_paged_torch(dtype))
    args = (_j(q, dtype), _j(kc), _j(ks), _j(vc), _j(vs), _j(table),
            _j(lengths))
    return (emu, pallas_paged_quant(*args, interpret=True),
            J_PAGED_QUANT(*args))


@functools.lru_cache(maxsize=None)
def _dense_inputs(seed=1):
    rng = np.random.default_rng(seed)
    b, s = 3, max(LENGTHS)
    q = rng.normal(size=(b, H, D)).astype(np.float32)
    kc, ks = _quantized(rng, (b, s, KV, D))
    vc, vs = _quantized(rng, (b, s, KV, D))
    return q, kc, ks, vc, vs


def _dense_torch(dtype):
    q, kc, ks, vc, vs = _dense_inputs()
    return _t(q, dtype), _t(kc), _t(ks), _t(vc), _t(vs)


def test_int8_wrappers_share_the_split():
    assert paged_mod.split_ranges is split_mod.split_ranges
    assert dense_mod.split_ranges is split_mod.split_ranges


# ----------------------------------------------------------------------
# the int8 paged kernel's split
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", range(len(LENGTHS)),
                         ids=[f"len{n}" for n in LENGTHS])
def test_paged_quant_split_matches_pallas_interpret(row, dtype):
    emu, pallas, _ = _paged_results(dtype)
    assert emu.dtype == _TDT[dtype]
    _close(emu[row], pallas[row], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", range(len(LENGTHS)),
                         ids=[f"len{n}" for n in LENGTHS])
def test_paged_quant_split_matches_reference_oracle(row, dtype):
    emu, _, oracle = _paged_results(dtype)
    _close(emu[row], oracle[row], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_quant_split_rows_do_not_depend_on_the_batch(dtype):
    """The emulated row's bits (the split is the row's own): in the
    batch, alone, beside a longer neighbour, with codes of +-127 and NaN
    scales in every stale slot, and with the block table widened by
    spare slots onto pages of NaN scales."""
    q, kc, ks, vc, vs, table, lengths = _paged_torch(dtype)
    rows = [0, 2, 8]                                 # lengths 1, 8, 105
    short = lengths.clone()
    short[-1] = 64                                   # no row at 2,048
    base = emulate_paged_quant(q, kc, ks, vc, vs, table, short)
    for r in rows:
        alone = emulate_paged_quant(q[r:r + 1], kc, ks, vc, vs,
                                    table[r:r + 1], short[r:r + 1])
        assert torch.equal(alone[0], base[r])
    longer = emulate_paged_quant(q, kc, ks, vc, vs, table, lengths)
    # every slot the table reaches at or past a row's length (each page
    # belongs to one row)
    pos = torch.arange(NB * PAGE)
    stale = pos[None] >= short.long()[:, None]
    pages = table.long().repeat_interleave(PAGE, dim=1)[stale]
    slots = (pos % PAGE).expand_as(stale)[stale]
    kc2, ks2, vc2, vs2 = kc.clone(), ks.clone(), vc.clone(), vs.clone()
    kc2[pages, slots], vc2[pages, slots] = 127, -127
    ks2[pages, slots], vs2[pages, slots] = float("nan"), float("nan")
    poisoned = emulate_paged_quant(q, kc2, ks2, vc2, vs2, table, short)
    codes = torch.full((4, PAGE, KV, D), 127, dtype=torch.int8)
    nan = torch.full((4, PAGE, KV), float("nan"))
    spare = torch.arange(kc.shape[0], kc.shape[0] + 4, dtype=torch.int32)
    wide = torch.cat([table, spare.expand(table.shape[0], 4)], dim=1)
    widened = emulate_paged_quant(
        q, torch.cat([kc2, codes]), torch.cat([ks2, nan]),
        torch.cat([vc2, -codes]), torch.cat([vs2, nan]), wide, short)
    for r in rows:
        assert torch.equal(longer[r], base[r])
    assert torch.equal(poisoned, base)
    assert torch.equal(widened, base)


# ----------------------------------------------------------------------
# the int8 dense-cache kernel's split
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", LENGTHS, ids=[f"len{n}" for n in LENGTHS])
def test_dense_quant_split_matches_pallas_interpret(length, dtype):
    q, kc, ks, vc, vs = _dense_inputs()
    emu = emulate_dense_quant(*_dense_torch(dtype), length)
    want = pallas_decode_quant(_j(q, dtype), _j(kc), _j(ks), _j(vc), _j(vs),
                               jnp.int32(length), interpret=True)
    assert emu.dtype == _TDT[dtype]
    _close(emu, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", LENGTHS, ids=[f"len{n}" for n in LENGTHS])
def test_dense_quant_split_matches_reference_quant_path(length, dtype):
    """Against what the reference's op runs off the TPU: its jnp quant
    path over the linear positions."""
    q, kc, ks, vc, vs = _dense_inputs()
    emu = emulate_dense_quant(*_dense_torch(dtype), length)
    want = J_DECODE_QUANT(_j(q, dtype), _j(kc), _j(ks), _j(vc), _j(vs),
                          jnp.arange(kc.shape[1]), jnp.int32(length - 1))
    _close(emu, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_quant_split_rows_do_not_depend_on_the_batch(dtype):
    """The emulated row's bits (the split is the row's own): in the
    batch, alone, and in a longer cache whose positions past the length
    hold codes of +-127 and NaN scales."""
    q, kc, ks, vc, vs = _dense_torch(dtype)
    length = 105
    base = emulate_dense_quant(q, kc, ks, vc, vs, length)
    pad = (q.shape[0], 64, KV)
    codes = torch.full((*pad, D), 127, dtype=torch.int8)
    nan = torch.full(pad, float("nan"))
    longer = emulate_dense_quant(
        q, torch.cat([kc[:, :length], codes], dim=1),
        torch.cat([ks[:, :length], nan], dim=1),
        torch.cat([vc[:, :length], -codes], dim=1),
        torch.cat([vs[:, :length], nan], dim=1), length)
    assert torch.equal(longer, base)
    for r in range(q.shape[0]):
        alone = emulate_dense_quant(q[r:r + 1], kc[r:r + 1], ks[r:r + 1],
                                    vc[r:r + 1], vs[r:r + 1], length)
        assert torch.equal(alone[0], base[r])
