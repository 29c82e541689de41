"""The port's threefry generator (``repro_torch.streams.prng``) against
``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable=True``): keys,
splits and 32-bit random bits bitwise equal, uniforms bitwise equal,
normals within the stated tolerance, and draws independent of the padded
length."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.streams import prng

SEEDS = [0, 1, 3, 7, 12345, -1, 2**31 - 1, 2**32 - 1]
#: torch's float32 ``erfinv`` against the one XLA compiles into
#: ``jax.random.normal``: measured up to 5.8e-6 relative (largest in the
#: tails, |z| > 3.5) over 204 seeds x 50,000 draws; the bits and the
#: uniform they make are exact.  The gap is relative at every |z|, so no
#: absolute term is needed.
NORMAL_RTOL = 1e-5


def assert_normals_close(got, want, label=""):
    """``got`` within :data:`NORMAL_RTOL` of ``want``, elementwise; a
    failure names the worst element and JAX's state (both must be float32
    draws of 32-bit partitionable threefry)."""
    assert got.dtype == np.float32 and want.dtype == np.float32, (got.dtype, want.dtype)
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want.astype(np.float64))
    i = int(np.argmax(rel))
    assert rel[i] <= NORMAL_RTOL, (
        f"{label}: element {i}: torch {got.flat[i]!r} jax {want.flat[i]!r} "
        f"(rel {rel.flat[i]:.3e}); jax_enable_x64={jax.config.jax_enable_x64} "
        f"jax_threefry_partitionable={jax.config.jax_threefry_partitionable}"
    )


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_are_bitwise_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key([seed])
    assert tkey.dtype == torch.int64 and tkey.shape == (1, 2)
    assert tkey[0].tolist() == _np(key).tolist()
    keys = _np(jax.random.split(key, 300))
    np.testing.assert_array_equal(prng.split(tkey, 0, 300)[0].numpy(), keys)
    # a window of ticks is the same slice of any longer split
    np.testing.assert_array_equal(prng.split(tkey, 125, 25)[0].numpy(), keys[125:150])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 7, 128, 1025])
def test_random_bits_and_uniform_are_bitwise_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key([seed])
    bits = prng.random_bits(tkey, n)[0]
    np.testing.assert_array_equal(bits.numpy(), _np(jax.random.bits(key, (n,))))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    want = np.asarray(jax.random.uniform(key, (n,), minval=lo, maxval=1.0))
    got = prng.uniform_from_bits(bits).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax_within_tolerance(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(key, (4096,)))
    got = prng.normal(prng.prng_key([seed]), 4096)[0].numpy()
    assert_normals_close(got, want, f"seed {seed}")


def test_batched_keys_and_ticks_match_per_row_draws():
    """What the simulator draws for a window: (B, ticks, I) normals from
    each row's seed, equal to jax's per-row, per-tick draws."""
    seeds, n_ticks, n = [0, 5, 1000], 50, 16
    tkeys = prng.split(prng.prng_key(seeds), 25, 25)          # ticks 25..49
    z = prng.normal(tkeys, n)
    assert z.shape == (3, 25, n)
    for b, seed in enumerate(seeds):
        keys = jax.random.split(jax.random.PRNGKey(seed), n_ticks)
        for t in (25, 31, 49):
            want = np.asarray(jax.random.normal(keys[t], (n,)))
            assert_normals_close(z[b, t - 25].numpy(), want, f"seed {seed} tick {t}")


@pytest.mark.parametrize("n,m", [(8, 32), (5, 128), (642, 1024)])
def test_draws_do_not_depend_on_the_padded_length(n, m):
    keys = prng.split(prng.prng_key([3, 4]), 0, 10)
    assert torch.equal(prng.random_bits(keys, m)[..., :n], prng.random_bits(keys, n))
    assert torch.equal(prng.normal(keys, m)[..., :n], prng.normal(keys, n))


def test_seed_outside_32_bits_raises():
    with pytest.raises(ValueError, match="32-bit"):
        prng.prng_key([2**32])
    with pytest.raises(ValueError, match="32-bit"):
        prng.prng_key([-(2**31) - 1])
