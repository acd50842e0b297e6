"""multinn_torch Threefry stream and keys against the JAX package: the
kernel stream (ops/kernel_prng.py) and the raw-key functions
(ops/sampling.py) must give the same bits as their JAX counterparts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.ops import kernel_prng as jax_prng  # noqa: E402
from multinn_tpu.ops import sampling as jax_sampling  # noqa: E402
from multinn_torch.ops import kernel_prng, sampling  # noqa: E402

torch.set_num_threads(1)


SEEDS = [(0, 0), (1, 2), (12345, -7), (-5, -123456789),
         (2 ** 31 - 1, -2 ** 31)]


@pytest.mark.parametrize("shape", [(1, 1), (4, 5), (7, 3), (16, 750),
                                   (2, 3, 4)])
@pytest.mark.parametrize("seed,salt", SEEDS)
def test_random_bits_and_uniform_bit_equal(shape, seed, salt):
    want = np.asarray(jax_prng.random_bits(shape, jnp.int32(seed),
                                           jnp.int32(salt))).view(np.int32)
    got = kernel_prng.random_bits(shape, seed, salt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(jax_prng.random_uniform(shape, jnp.int32(seed),
                                                 jnp.int32(salt)))
    got_u = kernel_prng.random_uniform(shape, seed, salt).numpy()
    assert got_u.dtype == np.float32
    np.testing.assert_array_equal(got_u, want_u)
    assert got_u.min() >= 0.0 and got_u.max() < 1.0


def test_threefry2x32_block_bit_equal():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    x0, x1 = (rng.integers(0, 2 ** 32, size=64, dtype=np.uint32)
              for _ in range(2))
    w0, w1 = jax_prng.threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                   jnp.asarray(x0), jnp.asarray(x1))
    key = torch.from_numpy(k.view(np.int32)).view(torch.uint32)
    y0, y1 = kernel_prng.threefry2x32(
        key, torch.from_numpy(x0.view(np.int32)),
        torch.from_numpy(x1.view(np.int32)))
    np.testing.assert_array_equal(y0.numpy().view(np.uint32), np.asarray(w0))
    np.testing.assert_array_equal(y1.numpy().view(np.uint32), np.asarray(w1))


@pytest.mark.parametrize("seed", [0, 3, 42, -1, -123456, 2 ** 31 - 1])
def test_keys_match_jax_random(seed):
    jkey, tkey = jax.random.PRNGKey(seed), sampling.PRNGKey(seed)
    assert tkey.dtype == torch.uint32 and tkey.shape == (2,)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    for data in (0, 1, 7, 2 ** 31 + 3):
        np.testing.assert_array_equal(
            sampling.fold_in(tkey, data).numpy(),
            np.asarray(jax.random.fold_in(jkey, data)))
    for num in (2, 3, 5, 16):
        np.testing.assert_array_equal(
            sampling.split(tkey, num).numpy(),
            np.asarray(jax.random.split(jkey, num)))
    seeds = sampling.key_to_seeds(tkey)
    assert seeds.dtype == torch.int32
    np.testing.assert_array_equal(
        seeds.numpy(), np.asarray(jax_sampling.key_to_seeds(jkey)))


def test_split_uses_the_partitionable_layout():
    """The port follows the installed JAX's threefry_partitionable default;
    with it, split(key, n)[i] == fold_in(key, i)."""
    assert jax.config.jax_threefry_partitionable
    key = sampling.PRNGKey(9)
    ks = sampling.split(key, 4)
    for i in range(4):
        np.testing.assert_array_equal(ks[i].numpy(),
                                      sampling.fold_in(key, i).numpy())


def test_prngkey_rejects_seeds_outside_int32():
    with pytest.raises(ValueError):
        sampling.PRNGKey(2 ** 31)


def test_cuda_impl_needs_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernel_prng.random_bits((2, 2), 0, 0, impl="cuda")
