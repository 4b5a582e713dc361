"""Ray direction sampling.

Replacement for warp's per-thread counter-based PRNG + unit-sphere sampling
(ref kernel.py:51-52): a threefry key folded over the ray batch, with the
standard (z, phi) uniform-sphere construction. Explicit direction arrays can
always be injected instead, so oracle and device runs trace identical rays
(SURVEY.md 2.2: the Warp PRNG is deliberately not replicated bit-exactly).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("n",))
def sphere_directions(key: jax.Array, n: int) -> jnp.ndarray:
    """(n, 3) float32 directions uniform on the unit sphere."""
    kz, kp = jax.random.split(key)
    z = jax.random.uniform(kz, (n,), minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(kp, (n,), minval=0.0, maxval=2.0 * jnp.pi)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=1).astype(jnp.float32)


@partial(jax.jit, static_argnames=("n",))
def stratified_sphere_directions(key: jax.Array, n: int) -> jnp.ndarray:
    """Stratified (z, phi) sampling: jitter within an (n_z x n_phi) lattice.

    Variance-reduction upgrade over the reference's unstratified sampler
    (ref kernel.py:51-52 has no stratification); same uniform marginal law.
    """
    m = int(n**0.5)
    while n % m:
        m -= 1
    nz, nphi = m, n // m
    kz, kp = jax.random.split(key)
    iz = jnp.arange(nz, dtype=jnp.float32)
    ip = jnp.arange(nphi, dtype=jnp.float32)
    z = (iz[:, None] + jax.random.uniform(kz, (nz, nphi))) / nz * 2.0 - 1.0
    phi = (ip[None, :] + jax.random.uniform(kp, (nz, nphi))) / nphi * 2.0 * jnp.pi
    z = z.reshape(-1)
    phi = phi.reshape(-1)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=1).astype(jnp.float32)


def _morton_interleave_16(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Interleave two 16-bit ints into a 32-bit Morton code (uint32)."""
    def spread(v):
        v = v.astype(jnp.uint32)
        v = (v | (v << 8)) & jnp.uint32(0x00FF00FF)
        v = (v | (v << 4)) & jnp.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & jnp.uint32(0x33333333)
        v = (v | (v << 1)) & jnp.uint32(0x55555555)
        return v

    return spread(x) | (spread(y) << 1)


def direction_morton_keys(directions: jnp.ndarray, bits: int = 10) -> jnp.ndarray:
    """Morton code of each direction's (z, phi) cell on a 2^bits lattice.

    Sorting rays by this key makes consecutive rays point into the same small
    solid-angle cone, so the rays of one block of the GPU traversal kernel
    (rfx.ops.gpu_trace) walk nearly the same nodes and their lanes diverge
    less.
    """
    res = 1 << bits
    z = jnp.clip(directions[:, 2], -1.0, 1.0)
    phi = jnp.arctan2(directions[:, 1], directions[:, 0])  # [-pi, pi]
    zi = jnp.clip(((z + 1.0) * 0.5 * res).astype(jnp.int32), 0, res - 1)
    pi_ = jnp.clip(((phi / (2.0 * jnp.pi) + 0.5) * res).astype(jnp.int32), 0, res - 1)
    return _morton_interleave_16(zi, pi_)


@partial(jax.jit, static_argnames=("n",))
def morton_sphere_directions(key: jax.Array, n: int) -> jnp.ndarray:
    """Stratified uniform sphere directions, reordered along a (z, phi) Morton
    curve. Same law as `stratified_sphere_directions`; the ordering is pure
    variance-free bookkeeping that turns each contiguous ray tile into a tight
    direction cone (see `direction_morton_keys`)."""
    d = stratified_sphere_directions(key, n)
    order = jnp.argsort(direction_morton_keys(d))
    return d[order]
