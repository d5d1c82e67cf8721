"""The port's replica of jax's PRNG and its samplers, held bit for bit
against jax 0.9.0 (threefry2x32, ``jax_threefry_partitionable`` at its
default) and the reference's sampler on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sampling import sampler as JS
from repro_torch.sampling import prng
from repro_torch.sampling import sampler as TS

TINY = float(np.finfo(np.float32).tiny)


def _tkeys(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


def test_jax_config_is_the_one_replicated():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**31 - 1, -1, -5,
                                  2**32 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_fold_in_matches_jax_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    datas = [0, 1, 2, 77, 0x5052_4F42, 0x454D_4245, 2**31, 2**32 - 1]
    for d in datas:
        want = np.asarray(jax.random.fold_in(key, np.uint32(d)))
        got = prng.fold_in_np(np.asarray(key), d)
        np.testing.assert_array_equal(got, want, err_msg=str(d))
    # batched: one call over many (key, data) pairs
    keys = np.stack([np.asarray(jax.random.fold_in(key, i))
                     for i in range(16)])
    data = np.arange(16) * 1000 + 3
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k),
                                                   np.uint32(x)))
                     for k, x in zip(keys, data)])
    np.testing.assert_array_equal(prng.fold_in_np(keys, data), want)


def test_row_key_streams_match_jax_bitwise():
    for seed in (0, 5):
        base = jax.random.PRNGKey(seed)
        idx = [0, 1, 5, 17, 1000]
        np.testing.assert_array_equal(
            TS.probe_row_keys(prng.prng_key(seed), idx, 3),
            np.asarray(JS.probe_row_keys(base, idx, 3)))
        for mi in range(3):
            np.testing.assert_array_equal(
                TS.member_row_keys(prng.prng_key(seed), idx, mi),
                np.asarray(JS.member_row_keys(base, idx, mi)))


@pytest.mark.parametrize("n", [19, 64, 1001])
def test_uniform_bits_match_jax(n):
    keys = np.asarray(JS.probe_row_keys(jax.random.PRNGKey(4),
                                        range(6), 1))
    got = prng.uniform(_tkeys(keys), n).numpy()
    for i, k in enumerate(keys):
        want = np.asarray(jax.random.uniform(
            jnp.asarray(k), (n,), jnp.float32, minval=TINY, maxval=1.0))
        np.testing.assert_array_equal(got[i], want)


def test_gumbel_matches_jax_to_float_rounding():
    """Uniform bits agree exactly; the two ``log`` implementations may
    round differently in the last place."""
    keys = np.asarray(JS.probe_row_keys(jax.random.PRNGKey(2), range(4), 1))
    got = prng.gumbel(_tkeys(keys), 4096).numpy()
    want = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (4096,)))
                     for k in keys])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature", [0.9, 0.7, 0.0])
def test_sample_token_rows_draws_the_reference_tokens(temperature):
    """>= 256 (row, step) pairs at per-row steps: the same logits and
    key streams draw the same tokens."""
    rng = np.random.default_rng(11)
    rows, vocab = 48, 19
    keys = np.asarray(JS.probe_row_keys(jax.random.PRNGKey(0),
                                        range(rows // 3), 3))
    n_pairs = 0
    for t in range(8):
        logits = (rng.normal(size=(rows, vocab)) * 2.0).astype(np.float32)
        steps = (rng.integers(0, 8, size=rows) + t).astype(np.int32)
        want = np.asarray(JS.sample_token_rows(
            jnp.asarray(logits), temperature, jnp.asarray(keys),
            jnp.asarray(steps)))
        got = TS.sample_token_rows(torch.from_numpy(logits), temperature,
                                   _tkeys(keys), torch.from_numpy(steps))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        n_pairs += rows
    assert n_pairs >= 256


def test_sample_token_rows_is_batch_composition_invariant():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(8, 19)).astype(np.float32))
    keys = _tkeys(TS.probe_row_keys(prng.prng_key(0), range(8), 1))
    steps = torch.arange(8, dtype=torch.int32)
    full = TS.sample_token_rows(logits, 0.9, keys, steps)
    for r in range(8):
        alone = TS.sample_token_rows(logits[r:r + 1], 0.9, keys[r:r + 1],
                                     steps[r:r + 1])
        assert int(alone[0]) == int(full[r])
