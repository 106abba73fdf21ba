"""The port's counter-based RNG against the JAX package's, bit for bit:
pcg4d / uniform4, and jax.random's threefry PRNGKey / fold_in / uniform
(partitionable layout), which the light paths and jitter draw from.
Tolerance: none (array_equal), since every later comparison relies on both
packages drawing the same numbers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evplp_tpu.core import rng as jrng
from evplp_tpu.core.sampling import iteration_key as jax_iteration_key
from evplp_tpu_torch.core import rng
from evplp_tpu_torch.core.sampling import iteration_key


def _key_words(k):
    if not jnp.issubdtype(k.dtype, jnp.integer):
        k = jax.random.key_data(k)
    return np.asarray(k).astype(np.int64)


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


def test_pcg4d_and_uniform4_bit_exact():
    x = np.random.default_rng(0).integers(0, 2**32, (4, 4096),
                                          dtype=np.uint64)
    ja = jrng.pcg4d(*(jnp.asarray(v.astype(np.uint32)) for v in x))
    ta = rng.pcg4d(*(torch.from_numpy(v.astype(np.int64)) for v in x))
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())
    ju = jrng.uniform4(*(jnp.asarray(v.astype(np.uint32)) for v in x))
    tu = rng.uniform4(*(torch.from_numpy(v.astype(np.int64)) for v in x))
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_prng_key_and_fold_in_bit_exact(seed):
    np.testing.assert_array_equal(_key_words(jax.random.PRNGKey(seed)),
                                  rng.prng_key(seed, "cpu").numpy())
    k = jax.random.PRNGKey(seed)
    kt = rng.prng_key(seed, "cpu")
    for data in (0, 1, 999, 2**31 - 1):
        np.testing.assert_array_equal(
            _key_words(jax.random.fold_in(k, data)),
            rng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("shape", [(), (2,), (3,), (5, 7), (1000,)])
def test_uniform_bit_exact(shape):
    jk = jax_iteration_key(0, 7)
    tk = iteration_key(0, 7, "cpu")
    np.testing.assert_array_equal(_key_words(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  rng.uniform(tk, shape).numpy())


def test_batched_per_path_draws_bit_exact():
    """The light tracer's draws: vmapped fold_in over path ids, then a
    per-site fold_in and a uniform of width 3."""
    jk = jax.random.fold_in(jax_iteration_key(0, 3), 1)
    tk = rng.fold_in(iteration_key(0, 3, "cpu"), 1)
    ids = np.arange(5, 517, dtype=np.int32)
    jp = jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.asarray(ids))
    tp = rng.fold_in(tk, torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_array_equal(_key_words(jp), tp.numpy())
    ju = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 4),
                                               (3,)))(jp)
    tu = rng.uniform(rng.fold_in(tp, 4), (3,))
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
