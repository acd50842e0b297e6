"""multinn_torch Gibbs chain (ops/gibbs.py, ops/gibbs_cuda.py) against the
JAX Pallas kernel gibbs_pallas.gibbs_chain run in interpret mode: the plain
version must draw the same stream bit for bit, including the row-block
tiling (N=20 gives two blocks of 16 rows, the second padded)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multinn_tpu.ops import gibbs_pallas  # noqa: E402
from multinn_torch.ops import gibbs, gibbs_cuda, sampling  # noqa: E402

torch.set_num_threads(1)


def _inputs(n, d=8, h=6, seed=0):
    rng = np.random.default_rng(seed)
    v0 = (rng.random((n, d)) < 0.4).astype(np.float32)
    w = rng.normal(0.0, 0.8, (d, h)).astype(np.float32)
    bv = rng.normal(0.0, 0.5, (n, d)).astype(np.float32)
    bh = rng.normal(0.0, 0.5, (n, h)).astype(np.float32)
    return v0, w, bv, bh


def test_block_rows_matches_pallas_tiling():
    for n, d, h in [(20, 8, 6), (1040, 84, 150), (4096, 84, 150), (3, 8, 6),
                    (100000, 88, 150)]:
        assert gibbs_cuda.block_rows(n, d, h) == gibbs_pallas._block_b(n, d, h)
    assert gibbs_cuda.block_rows(20, 8, 6) == 16


@pytest.mark.parametrize("seed,k", [(0, 1), (7, 3), (-3, 2)])
def test_plain_chain_bit_equal_to_pallas_interpret(seed, k):
    v0, w, bv, bh = _inputs(20, seed=abs(seed))
    want = gibbs_pallas.gibbs_chain(
        jax.random.PRNGKey(seed), jnp.asarray(v0), jnp.asarray(w),
        jnp.asarray(bv), jnp.asarray(bh), k, interpret=True)
    got = gibbs.gibbs_chain(sampling.PRNGKey(seed), torch.from_numpy(v0),
                            torch.from_numpy(w), torch.from_numpy(bv),
                            torch.from_numpy(bh), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_broadcast_biases_and_leading_dims():
    """v0 (T, B, D) with (D,) / (H,) biases: broadcast as the JAX wrapper."""
    rng = np.random.default_rng(3)
    v0 = (rng.random((2, 5, 8)) < 0.5).astype(np.float32)
    w = rng.normal(0.0, 0.8, (8, 6)).astype(np.float32)
    bv = rng.normal(0.0, 0.5, 8).astype(np.float32)
    bh = rng.normal(0.0, 0.5, 6).astype(np.float32)
    want = gibbs_pallas.gibbs_chain(
        jax.random.PRNGKey(1), jnp.asarray(v0), jnp.asarray(w),
        jnp.asarray(bv), jnp.asarray(bh), 2, interpret=True)
    got = gibbs.gibbs_chain(sampling.PRNGKey(1), torch.from_numpy(v0),
                            torch.from_numpy(w), torch.from_numpy(bv),
                            torch.from_numpy(bh), 2)
    assert got.shape == (2, 5, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_takes_plain_on_cpu_and_refuses_cuda_there():
    v0, w, bv, bh = (torch.from_numpy(x) for x in _inputs(4))
    key = sampling.PRNGKey(0)
    np.testing.assert_array_equal(
        gibbs.gibbs_chain(key, v0, w, bv, bh, 2).numpy(),
        gibbs.gibbs_chain(key, v0, w, bv, bh, 2, impl="plain").numpy())
    with pytest.raises(ValueError, match="CUDA"):
        gibbs.gibbs_chain(key, v0, w, bv, bh, 2, impl="cuda")
