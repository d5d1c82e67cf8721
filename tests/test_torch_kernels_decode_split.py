"""The split-KV arithmetic of the port's paged decode and dense-cache
decode kernels (``csrc/decode_split.cuh``), on the CPU.

The kernels split each row's positions over a cluster of CTAs by
``split_ranges(length)``, run an online softmax over each range in tiles
and combine the ranks' partial states in rank order. The CUDA kernels run
only on a card (``chip_smoke.py`` holds them against their plain versions
there, checks their rows bit for bit and checks ``split_ranges`` against
the ranges the compiled kernels compute); here a torch emulation of the
split and the rank-order combine, kept in this file, is held against the
reference's Pallas kernels in interpret mode and against its oracles
(``repro.kernels.ref``) on the same numpy inputs, at the tolerances of
``tests/test_kernels.py``, over lengths at the edges of the split: 1,
``SPLIT - 1``, ``SPLIT``, a granule's and a range's edges +-1, a page
boundary, the wave's 105 and a 2,048-token context.

The emulation models the split and the combine, not the kernel's inner
loop: within a range it takes a max per tile with natural exponentials,
where the kernel keeps a running max per warp step in base 2 with lane
partial sums, so its bits are not the kernel's. Its bitwise tests (a row
alone, beside a longer neighbour, with spare block-table slots) check
that ``split_ranges`` makes a row's split a function of the row's own
length, which is what makes the kernel's rows independent of the batch;
the kernel's own rows are checked bit for bit on the card. It also
checks that the ranges tile every length exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    decode_attention as pallas_decode)
from repro.kernels.paged_decode_attention import (
    paged_decode_attention as pallas_paged_decode)
from repro_torch.kernels import decode_attention as dense_mod
from repro_torch.kernels import paged_decode_attention as paged_mod
from repro_torch.kernels.paged_decode_attention import (
    SPLIT, SPLIT_GRANULE, split_ranges)

# tests/test_kernels.py: f32 attention 2e-5, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TILE = 16              # keys a tile, as decode_split.cuh's kTile

# 1, SPLIT - 1, SPLIT; a granule edge (16) and a range edge (chunk 16 ->
# 32 at 129) +-1; a page boundary (page 8); the wave's 105; 2,048
LENGTHS = [1, SPLIT - 1, SPLIT, SPLIT_GRANULE - 1, SPLIT_GRANULE,
           SPLIT_GRANULE + 1, 24, 25, 105, 127, 128, 129, 2048]
H, KV, D, PAGE = 6, 2, 32, 8
NB = -(-max(LENGTHS) // PAGE)

J_PAGED = jax.jit(jref.paged_decode_attention_ref)
J_DENSE = jax.jit(jref.decode_attention_ref)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(_TDT[dtype]) if dtype else t


def _j(a, dtype=None):
    return jnp.asarray(a, _JDT[dtype]) if dtype else jnp.asarray(a)


def _close(got, want, atol):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


# ----------------------------------------------------------------------
# the emulation: split_ranges, a per-rank online softmax over tiles, the
# combine in rank order (not the kernel's inner loop, see above)
# ----------------------------------------------------------------------
def _row_split(q_row, key_rows, length):
    """One row: q_row (KV, G, D) f32, prescaled; key_rows(lo, hi) gives
    the (hi - lo, KV, D) f32 keys and values of positions [lo, hi).
    Returns (KV, G, D) f32."""
    kv, g, d = q_row.shape
    parts = []
    for lo, hi in split_ranges(length):
        m = torch.full((kv, g), float("-inf"))
        lsum = torch.zeros((kv, g))
        acc = torch.zeros((kv, g, d))
        for t0 in range(lo, hi, TILE):
            k, v = key_rows(t0, min(t0 + TILE, hi))
            s = torch.einsum("kgd,nkd->kgn", q_row, k)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.where(m == float("-inf"), 0.0,
                                torch.exp(m - m_new))
            p = torch.exp(s - m_new[..., None])
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("kgn,nkd->kgd", p, v)
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


def emulate_paged(q, k_pages, v_pages, table, lengths):
    """The paged kernel's split and combine: only positions below each
    row's length are gathered through its block table."""
    b, h, d = q.shape
    ps = k_pages.shape[1]
    qs = _scaled_q(q)
    out = []
    for r in range(b):
        def rows(lo, hi, r=r):
            pos = torch.arange(lo, hi)
            pages = table[r, pos // ps].long()
            return (k_pages[pages, pos % ps].float(),
                    v_pages[pages, pos % ps].float())
        n = min(int(lengths[r]), table.shape[1] * ps)
        out.append(_row_split(qs[r], rows, n))
    return torch.stack(out).reshape(b, h, d).to(q.dtype)


def emulate_dense(q, k_cache, v_cache, length):
    """The dense-cache kernel's split and combine over [0, length)."""
    b, h, d = q.shape
    qs = _scaled_q(q)
    out = [_row_split(qs[r], lambda lo, hi, r=r: (
        k_cache[r, lo:hi].float(), v_cache[r, lo:hi].float()), length)
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
    kp = rng.normal(size=(n_pages, PAGE, KV, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, PAGE, KV, D)).astype(np.float32)
    table = rng.permutation(n_pages).astype(np.int32).reshape(b, NB)
    q = rng.normal(size=(b, H, D)).astype(np.float32)
    return q, kp, vp, table, np.asarray(LENGTHS, np.int32)


@functools.lru_cache(maxsize=None)
def _paged_results(dtype):
    q, kp, vp, table, lengths = _paged_inputs()
    emu = emulate_paged(_t(q, dtype), _t(kp, dtype), _t(vp, dtype),
                        _t(table), _t(lengths))
    args = (_j(q, dtype), _j(kp, dtype), _j(vp, dtype), _j(table),
            _j(lengths))
    return emu, pallas_paged_decode(*args, interpret=True), J_PAGED(*args)


@functools.lru_cache(maxsize=None)
def _dense_inputs(seed=1):
    rng = np.random.default_rng(seed)
    b, s = 3, max(LENGTHS)
    q = rng.normal(size=(b, H, D)).astype(np.float32)
    k = rng.normal(size=(b, s, KV, D)).astype(np.float32)
    v = rng.normal(size=(b, s, KV, D)).astype(np.float32)
    return q, k, v


# ----------------------------------------------------------------------
# the ranges
# ----------------------------------------------------------------------
def test_split_ranges_tile_every_length_once_in_order():
    assert dense_mod.split_ranges is paged_mod.split_ranges
    for length in range(0, 2049):
        ranges = split_ranges(length)
        assert len(ranges) == SPLIT
        pos = 0
        for lo, hi in ranges:
            assert lo == pos and lo <= hi            # contiguous, in order
            pos = hi
        assert pos == length                         # covers [0, length)
        # ceil(length / SPLIT) rounded up to the granule a range, every
        # range full up to the last non-empty one
        per = -(-length // SPLIT)
        chunk = -(-per // SPLIT_GRANULE) * SPLIT_GRANULE
        assert per <= chunk < per + SPLIT_GRANULE
        sizes = [hi - lo for lo, hi in ranges]
        nonempty = [s for s in sizes if s]
        assert sizes[:len(nonempty)] == nonempty
        assert all(s == chunk for s in nonempty[:-1])
        assert nonempty[-1] <= chunk if nonempty else length == 0


# ----------------------------------------------------------------------
# the paged kernel's split
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", range(len(LENGTHS)),
                         ids=[f"len{n}" for n in LENGTHS])
def test_paged_split_matches_pallas_interpret(row, dtype):
    emu, pallas, _ = _paged_results(dtype)
    assert emu.dtype == _TDT[dtype]
    _close(emu[row], pallas[row], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", range(len(LENGTHS)),
                         ids=[f"len{n}" for n in LENGTHS])
def test_paged_split_matches_reference_oracle(row, dtype):
    emu, _, oracle = _paged_results(dtype)
    _close(emu[row], oracle[row], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_rows_do_not_depend_on_the_batch(dtype):
    """The emulated row's bits (the split is the row's own): in the
    batch, alone, beside a longer neighbour, and with the block table
    widened by spare slots onto NaN pages."""
    q, kp, vp, table, lengths = (_t(a) for a in _paged_inputs())
    q, kp, vp = q.to(_TDT[dtype]), kp.to(_TDT[dtype]), vp.to(_TDT[dtype])
    rows = [0, 2, 8]                                 # lengths 1, 8, 105
    short = lengths.clone()
    short[-1] = 64                                   # no row at 2,048
    base = emulate_paged(q, kp, vp, table, short)
    for r in rows:
        alone = emulate_paged(q[r:r + 1], kp, vp, table[r:r + 1],
                              short[r:r + 1])
        assert torch.equal(alone[0], base[r])
    longer = emulate_paged(q, kp, vp, table, lengths)   # row 12 at 2,048
    poison = torch.full((4, PAGE, KV, D), float("nan"), dtype=kp.dtype)
    kp2, vp2 = torch.cat([kp, poison]), torch.cat([vp, poison])
    spare = torch.arange(kp.shape[0], kp.shape[0] + 4, dtype=torch.int32)
    wide = torch.cat([table, spare.expand(table.shape[0], 4)], dim=1)
    widened = emulate_paged(q, kp2, vp2, wide, short)
    for r in rows:
        assert torch.equal(longer[r], base[r])
        assert torch.equal(widened[r], base[r])


# ----------------------------------------------------------------------
# the dense-cache kernel's split
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", LENGTHS, ids=[f"len{n}" for n in LENGTHS])
def test_dense_split_matches_pallas_interpret(length, dtype):
    q, k, v = _dense_inputs()
    emu = emulate_dense(_t(q, dtype), _t(k, dtype), _t(v, dtype), length)
    want = pallas_decode(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                         jnp.int32(length), interpret=True)
    assert emu.dtype == _TDT[dtype]
    _close(emu, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", LENGTHS, ids=[f"len{n}" for n in LENGTHS])
def test_dense_split_matches_reference_oracle(length, dtype):
    q, k, v = _dense_inputs()
    emu = emulate_dense(_t(q, dtype), _t(k, dtype), _t(v, dtype), length)
    want = J_DENSE(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                   jnp.int32(length))
    _close(emu, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_split_rows_do_not_depend_on_the_batch(dtype):
    """The emulated row's bits (the split is the row's own): in the
    batch, alone, and in a longer cache whose positions past the length
    hold NaN."""
    q, k, v = (_t(a, dtype) for a in _dense_inputs())
    length = 105
    base = emulate_dense(q, k, v, length)
    nan = torch.full((k.shape[0], 64, KV, D), float("nan"), dtype=k.dtype)
    k2 = torch.cat([k[:, :length], nan], dim=1)
    v2 = torch.cat([v[:, :length], nan], dim=1)
    longer = emulate_dense(q, k2, v2, length)
    for r in range(q.shape[0]):
        alone = emulate_dense(q[r:r + 1], k[r:r + 1], v[r:r + 1], length)
        assert torch.equal(alone[0], base[r])
        assert torch.equal(longer[r], base[r])
