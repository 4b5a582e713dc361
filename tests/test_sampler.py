"""Direction sampling: uniformity of the stratified/Morton samplers and the
coherence property the GPU traversal relies on (rfx.ops.gpu_trace:
consecutive rays must form tight direction cones)."""

import numpy as np

import jax

from rfx import sampler


def _uniformity_checks(d):
    d = np.asarray(d)
    n = d.shape[0]
    # unit vectors
    assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    # mean direction ~ 0 (isotropy); se of each component is ~1/sqrt(3n)
    assert np.all(np.abs(d.mean(axis=0)) < 5.0 / np.sqrt(3 * n))
    # z marginal uniform on [-1, 1]: mean 0, var 1/3
    z = d[:, 2]
    assert abs(z.mean()) < 5.0 / np.sqrt(n)
    assert abs(z.var() - 1.0 / 3.0) < 0.02
    # octant occupancy balanced within 3x Poisson noise
    oct_id = (d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)
    counts = np.bincount(oct_id, minlength=8)
    assert np.all(np.abs(counts - n / 8) < 5 * np.sqrt(n / 8) + 10)


def test_sphere_directions_uniform():
    _uniformity_checks(sampler.sphere_directions(jax.random.PRNGKey(0), 40_000))


def test_stratified_directions_uniform():
    _uniformity_checks(sampler.stratified_sphere_directions(jax.random.PRNGKey(1), 40_000))


def test_morton_directions_uniform_and_coherent():
    d = sampler.morton_sphere_directions(jax.random.PRNGKey(2), 40_960)
    _uniformity_checks(d)
    # Coherence: consecutive 1024-ray tiles must be tight cones. Mean cosine
    # between each tile's rays and its mean direction should be close to 1,
    # vastly above the unsorted sampler's (~0 for isotropic tiles).
    dn = np.asarray(d).reshape(-1, 1024, 3)
    m = dn.mean(axis=1)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    cos = np.einsum("tj,tkj->tk", m, dn).mean()
    # 40 tiles cover the whole sphere, so each cone spans ~1/40 of it — mean
    # cos ~0.95 here; tiles tighten as ray count grows (1/tiles solid angle).
    assert cos > 0.9, f"morton tiles not coherent: mean cos {cos}"
    d_plain = np.asarray(sampler.sphere_directions(jax.random.PRNGKey(2), 40_960))
    dp = d_plain.reshape(-1, 1024, 3)
    mp = dp.mean(axis=1)
    mp /= np.maximum(np.linalg.norm(mp, axis=1, keepdims=True), 1e-9)
    cos_plain = np.einsum("tj,tkj->tk", mp, dp).mean()
    assert cos_plain < 0.5  # sanity: unsorted tiles are incoherent
