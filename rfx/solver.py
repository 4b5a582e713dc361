"""Differentiable inverse solve: optimize TX pose + material refractive index
against a target coverage map (BASELINE.json config 5).

The loss runs the full tracer (soft delay binning so delay gradients flow,
rfx.cir.bin_impulse_response) optionally under shard_map on a ('rays', 'rx')
device mesh; jax.grad differentiates through the trace scan and the psum
collectives, so parameter gradients all-reduce as part of the backward pass.

The reference has no counterpart (no optimization, no gradients anywhere) —
this subsystem exists because differentiability is the point of the rebuild
(BASELINE.json north star).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from rfx.coverage import coverage_irs
from rfx.tracer import Scene

__all__ = ["InverseParams", "coverage_irs_soft", "make_inverse_solver"]


class InverseParams(NamedTuple):
    tx_pos: jnp.ndarray  # (3,)
    log_n1: jnp.ndarray  # scalar; n1 = exp(log_n1) keeps the index positive
    vertices: jnp.ndarray | None = None  # (V, 3) optional geometry leaf


def coverage_irs_soft(
    vertices,
    faces,
    tx_pos,
    n1,
    directions,
    rx_centers,
    rx_radius,
    *,
    num_rays: int,
    max_bounces: int,
    nbins: int,
    light_speed_mps: float,
    sample_rate_hz: float,
    n2=1.0,
    env_hit=None,
):
    """(M, nbins) soft-binned impulse responses, normalised by the *global*
    ray count (`num_rays` may exceed directions.shape[0] under sharding, where
    each shard produces a partial IR that sums across shards).

    Thin wrapper over the coverage engine's soft mode (rfx.coverage) — the
    engine is the single implementation of the segments->IR reduction."""
    return coverage_irs(
        Scene(vertices, faces), tx_pos, directions, rx_centers, rx_radius,
        max_bounces=max_bounces, nbins=nbins, num_rays=num_rays,
        light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
        n1=n1, n2=n2, env_hit=env_hit, soft=True,
    )


def make_inverse_solver(
    scene: Scene,
    directions,
    rx_centers,
    rx_radius,
    target_energy,
    *,
    max_bounces: int,
    nbins: int,
    light_speed_mps: float = 2.998e8,
    sample_rate_hz: float = 100e9,
    learning_rate: float = 0.05,
    mesh=None,
    env_hit=None,
):
    """Returns (init_fn, step_fn) for the inverse solve.

    step_fn(params, opt_state) -> (params, opt_state, loss). The loss is the
    mean squared error of the receiver energies relative to the target's mean
    energy. IR bins carry 1/num_rays each, so raw energies shrink with the
    ray count (~1e-7 at a million rays on the terrain); unscaled, their
    squared error has gradients far below Adam's eps and a step moves
    nothing. A target of all zeros has no scale and is compared unscaled.

    When `mesh` (with axes 'rays' and 'rx') is given, rays shard over 'rays'
    and receivers over 'rx'; per-shard partial IRs psum over 'rays' *before*
    the energy square (IR energy is quadratic in the ray sum, so shards must
    combine first), and the loss psums over 'rx'.
    """
    opt = optax.adam(learning_rate)
    num_rays = int(directions.shape[0])
    num_rx = int(rx_centers.shape[0])
    # A host float, so the step traces it as a constant (no collective).
    scale = float(jnp.mean(target_energy))
    inv_scale = 1.0 / scale if scale > 0.0 else 1.0

    def irs_fn(params: InverseParams, dirs, centers):
        verts = scene.vertices if params.vertices is None else params.vertices
        return coverage_irs_soft(
            verts, scene.faces, params.tx_pos, jnp.exp(params.log_n1),
            dirs, centers, rx_radius,
            num_rays=num_rays, max_bounces=max_bounces, nbins=nbins,
            light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
            env_hit=env_hit,
        )

    if mesh is None:
        def loss_fn(params, dirs, centers, tgt):
            irs = irs_fn(params, dirs, centers)
            energy = jnp.sum(irs * irs, axis=1)
            return jnp.mean(((energy - tgt) * inv_scale) ** 2)
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def local_loss(params, dirs, centers, tgt):
            partial_irs = irs_fn(params, dirs, centers)  # (M/rx, nbins) partial
            irs = jax.lax.psum(partial_irs, "rays")  # complete each receiver
            energy = jnp.sum(irs * irs, axis=1)
            se = jnp.sum(((energy - tgt) * inv_scale) ** 2)
            return jax.lax.psum(se, "rx") / num_rx

        # check_vma=False: the VMA checker rejects the *backward* scan (rx-
        # varying cotangents meet a rays-varying forward carry) even though the
        # per-device computation and the psum transposes are correct — the
        # error message itself names this workaround.
        sharded = shard_map(
            local_loss,
            mesh=mesh,
            in_specs=(P(), P("rays"), P("rx"), P("rx")),
            out_specs=P(),
            check_vma=False,
        )

        def loss_fn(params, dirs, centers, tgt):
            return sharded(params, dirs, centers, tgt)

    # Data arrays ride as jit ARGUMENTS, not closures: under a multi-process
    # mesh, closing over an array that spans non-addressable devices is a
    # RuntimeError at trace time (jax refuses to constant-fold it).
    @jax.jit
    def _step(params, opt_state, dirs, centers, tgt):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p, dirs, centers, tgt)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def step_fn(params, opt_state):
        return _step(params, opt_state, directions, rx_centers, target_energy)

    def init_fn(tx0, n1_0=5.0, vertices0=None):
        """vertices0: optional (V, 3) starting geometry — adds the scene
        vertices as an optimizable leaf (BASELINE.md vertex-gradient target).
        Use the brute backend (env_hit=None on small scenes) or a
        differentiable-tris BVH backend (bvh or triton) so geometry gradients
        flow."""
        params = InverseParams(
            tx_pos=jnp.asarray(tx0, jnp.float32),
            log_n1=jnp.log(jnp.asarray(n1_0, jnp.float32)),
            vertices=None if vertices0 is None else jnp.asarray(vertices0, jnp.float32),
        )
        return params, opt.init(params)

    return init_fn, step_fn
