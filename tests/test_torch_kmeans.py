"""The port's SH k-means (``io/kmeans.py``) vs the JAX package's.

The JAX package draws its seedings and mini-batches from ``jax.random``;
the port from a ``torch.Generator``.  So the fit is held to JAX's by feeding
``fit_kmeans_from_draws`` JAX's own draws, rebuilt here with ``jax.random``
exactly as ``unitygaussiansplatting_tpu/io/kmeans.py:85-117`` splits its
keys: centers within 1e-4 of the largest, >= 99.9% of the final assignments
equal.  ``assign_clusters`` on the same centers equals JAX's except on
near-ties (a float64 recompute puts the two choices' distances within 1e-5
of ``|x|^2 + |c|^2`` of each other).  ``cluster_sh`` gives the same palette bit for bit for a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from unitygaussiansplatting_torch.io import kmeans as tk  # noqa: E402
from unitygaussiansplatting_torch.utils.synthetic import captured_scene  # noqa: E402
from unitygaussiansplatting_tpu.io import kmeans as jk  # noqa: E402

torch.set_num_threads(2)

CENTER_RTOL = 1e-4  # of the largest center coordinate
ASSIGN_AGREE = 0.999
NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def sh_rows():
    """Spatially correlated SH of a capture-like scene, (N, 45)."""
    return captured_scene(n=6000, seed=3).sh.reshape(-1, 45).numpy()


def jax_draws(key, n, k, iters, batch, init_attempts=3):
    """The row indices JAX's ``fit_kmeans`` draws from ``key``."""
    key_init, key_probe, key_iter = jax.random.split(key, 3)
    probe = jax.random.randint(key_probe, (min(4096, n),), 0, n)
    init = [jax.random.choice(ak, n, shape=(k,), replace=n < k) for ak in jax.random.split(key_init, init_attempts)]
    batches = [jax.random.randint(ik, (batch,), 0, n) for ik in jax.random.split(key_iter, iters)]
    return tuple(torch.from_numpy(np.asarray(a).astype(np.int64)) for a in (jnp.stack(init), probe, jnp.stack(batches)))


def near_ties(data, centers, got, want):
    """Rows where two assignments differ must be near-ties: by float64, the
    two centers' distances within NEAR_TIE of ``|x|^2 + |c|^2``, the
    magnitude the float32 formula cancels from.  Returns their count."""
    x, c = data.astype(np.float64), centers.astype(np.float64)
    x_sq, c_sq = np.sum(x * x, 1), np.sum(c * c, 1)
    d = x_sq[:, None] + c_sq[None] - 2.0 * x @ c.T
    r = np.nonzero(got != want)[0]
    gap = np.abs(d[r, got[r]] - d[r, want[r]]) / (x_sq[r] + np.maximum(c_sq[got[r]], c_sq[want[r]]))
    assert np.all(gap <= NEAR_TIE), gap.max()
    return len(r)


@pytest.mark.parametrize("k, k_chunk", [(256, 64), (300, 128), (64, 4096)])
def test_assign_clusters_matches_jax(sh_rows, k, k_chunk):
    centers = sh_rows[np.random.default_rng(k).choice(len(sh_rows), k, replace=False)] * 0.9
    got = tk.assign_clusters(torch.from_numpy(sh_rows), torch.from_numpy(centers), k_chunk=k_chunk,
                             n_chunk=1000).numpy()
    want = np.asarray(jk.assign_clusters(jnp.asarray(sh_rows), jnp.asarray(centers), k_chunk=k_chunk, n_chunk=1000))
    assert near_ties(sh_rows, centers, got, want) <= len(sh_rows) * (1 - ASSIGN_AGREE)


@pytest.mark.parametrize("n, k, iters, batch, k_chunk", [(6000, 128, 12, 1024, 64), (100, 256, 4, 256, 128)])
def test_fit_from_jax_draws_matches_jax(sh_rows, n, k, iters, batch, k_chunk):
    data = sh_rows[:n]
    key = jax.random.PRNGKey(n)
    want = np.asarray(jk.fit_kmeans(jnp.asarray(data), key, k=k, iters=iters, batch=batch, k_chunk=k_chunk))
    got = tk.fit_kmeans_from_draws(torch.from_numpy(data), *jax_draws(key, n, k, iters, batch), k=k,
                                   k_chunk=k_chunk).numpy()
    assert got.shape == want.shape == (k, 45)
    np.testing.assert_allclose(got, want, rtol=0, atol=CENTER_RTOL * np.abs(want).max())
    a = tk.assign_clusters(torch.from_numpy(data), torch.from_numpy(got)).numpy()
    b = np.asarray(jk.assign_clusters(jnp.asarray(data), jnp.asarray(want)))
    near_ties(data, want, a, b)
    if n >= k:  # with n < k the seeding repeats rows: equal centers tie exactly
        assert np.mean(a == b) >= ASSIGN_AGREE


def test_cluster_sh_is_deterministic(sh_rows):
    sh = sh_rows.reshape(-1, 15, 3)
    table, idx = tk.cluster_sh(sh, k=64, seed=5, iters=10, batch=512, device="cpu")
    again, idx_again = tk.cluster_sh(sh, k=64, seed=5, iters=10, batch=512, device="cpu")
    assert table.shape == (64, 15, 3) and idx.shape == (len(sh),) and idx.dtype == torch.int64
    assert torch.equal(table, again) and torch.equal(idx, idx_again)
    other, _ = tk.cluster_sh(sh, k=64, seed=6, iters=10, batch=512, device="cpu")
    assert not torch.equal(table, other)
    # Every row's index is its nearest center, but for near-ties.
    centers = table.reshape(64, 45).numpy()
    nearest = np.argmin(((sh_rows[:, None].astype(np.float64) - centers[None]) ** 2).sum(-1), axis=1)
    near_ties(sh_rows, centers, idx.numpy(), nearest)


def test_segment_sums_are_the_batch_sums():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(500, 45)).astype(np.float32))
    assign = torch.from_numpy(rng.integers(0, 40, 500))
    sums, counts = tk._segment_sums(x, assign, 48)
    want = torch.zeros(48, 45, dtype=torch.float64).index_add_(0, assign, x.double())
    torch.testing.assert_close(sums, want.float(), rtol=1e-6, atol=1e-6)
    assert torch.equal(counts, torch.bincount(assign, minlength=48).float())
