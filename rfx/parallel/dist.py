"""Distribution over device meshes (shard_map + XLA collectives).

The reference has exactly one parallelism strategy: one CUDA thread per ray on
a single GPU (ref tracer.py:75-79); there is no NCCL/MPI layer (SURVEY.md
2.3). Here:

- Ray data parallelism: the ray batch shards over a 'rays' mesh axis; scene
  geometry is replicated per device. Each shard traces independently (Monte
  Carlo rays never communicate), then per-shard impulse-response histograms
  `psum` (NCCL on GPUs) — the only cross-device traffic is one (nbins,)
  vector. All cards of a host reach each other at one rate (NVLink), so the
  mesh is flat and follows the algorithm alone.
- Coverage grid parallelism: a second 'rx' axis shards receiver tiles; a
  device computes partial IRs for its RX tile from its ray shard, and psum
  over 'rays' completes each receiver. Output IRs stay sharded over 'rx'.
- Multi-host: `jax.distributed.initialize` + the same mesh spanning all
  processes; Monte-Carlo sums are order-independent so chunk re-execution is
  safe recovery (see rfx.utils.checkpoint).

Gradients: jax.grad differentiates straight through shard_map/psum, so the
parameter all-reduce (tx pose, n1, vertices) rides the same collectives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from rfx.cir import cir_from_trace
from rfx.coverage import _rx_ir_from_segments
from rfx.tracer import Scene, trace_env, trace_to_rx

__all__ = ["initialize_multihost", "make_mesh", "sharded_cir", "sharded_coverage_irs"]

# Compiled shard_map callables, keyed by their static configuration. The jit
# wrapper below must be REUSED across calls or every invocation re-traces
# (jit caches by function identity, and the closure is fresh each time).
# Bounded LRU: keys include the env_hit object's identity, so callers that
# construct a fresh intersector per call would otherwise grow this without
# limit.
from collections import OrderedDict

_FN_CACHE: OrderedDict = OrderedDict()
_FN_CACHE_MAX = 32


def _cache_put(key, fn):
    _FN_CACHE[key] = fn
    while len(_FN_CACHE) > _FN_CACHE_MAX:
        _FN_CACHE.popitem(last=False)


def _cache_get(key):
    fn = _FN_CACHE.get(key)
    if fn is not None:
        _FN_CACHE.move_to_end(key)  # true LRU: hits refresh recency
    return fn


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host bring-up (no-op in single-process runs)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a device mesh. Default: all devices on a flat ('rays',) axis."""
    if devices is None:
        devices = jax.devices()
    if axes is None:
        axes = {"rays": len(devices)}
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh axes {axes} do not cover {len(devices)} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axes.keys()))


def sharded_cir(
    scene: Scene,
    tx_pos,
    directions,
    rx_pos,
    rx_radius,
    mesh: Mesh,
    *,
    max_bounces: int,
    nbins: int,
    tx_power=1.0,
    light_speed_mps: float = 2.998e8,
    sample_rate_hz: float = 100e9,
    n1=5.0,
    n2=1.0,
    rx_mode: str = "analytic",
    env_hit=None,
    active=None,
    soft: bool = False,
):
    """CIR with the ray batch sharded over mesh axis 'rays'.

    Equals the single-device result up to f32 summation order: the
    per-shard histograms are disjoint partial sums (and GPU scatter-add is
    atomic, so compare with a tolerance).
    """
    n = directions.shape[0]
    nd = mesh.shape["rays"]
    if n % nd:
        raise ValueError(f"ray count {n} not divisible by {nd} devices")
    if active is None:
        active = jnp.ones((n,), bool)

    # Cache the jitted shard_map callable: jit caches by function identity,
    # so a fresh closure per call would re-trace (and recompile) every
    # invocation.
    key = ("cir", mesh, max_bounces, nbins, float(tx_power), float(light_speed_mps),
           float(sample_rate_hz), float(n1), float(n2), rx_mode, env_hit,
           float(rx_radius), n, soft)
    fn = _cache_get(key)
    if fn is None:
        def local(dirs_shard, active_shard, tx, rx, verts, faces):
            result = trace_to_rx(
                Scene(verts, faces), tx, dirs_shard, rx, rx_radius,
                max_bounces=max_bounces, n1=n1, n2=n2, rx_mode=rx_mode,
                env_hit=env_hit, active=active_shard,
            )
            ir_local = cir_from_trace(
                result, tx_power=tx_power, num_rays=n, nbins=nbins,
                light_speed_mps=light_speed_mps, sample_rate_hz=sample_rate_hz,
                soft=soft,
            )
            return jax.lax.psum(ir_local, "rays")

        # check_vma=False: the traversal kernel's outputs carry no varying-
        # mesh-axis annotation, which the VMA checker rejects inside
        # shard_map even though the per-device computation is correct (see
        # also rfx.solver). jit: one compiled program, not eager dispatch.
        fn = jax.jit(shard_map(
            local,
            mesh=mesh,
            in_specs=(P("rays"), P("rays"), P(), P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        ))
        _cache_put(key, fn)
    return fn(
        directions, active, jnp.asarray(tx_pos, jnp.float32),
        jnp.asarray(rx_pos, jnp.float32), scene.vertices, scene.faces,
    )


def sharded_coverage_irs(
    scene: Scene,
    tx_pos,
    directions,
    rx_centers,
    rx_radius,
    mesh: Mesh,
    *,
    max_bounces: int,
    nbins: int,
    tx_power=1.0,
    light_speed_mps: float = 2.998e8,
    sample_rate_hz: float = 100e9,
    n1=5.0,
    n2=1.0,
    env_hit=None,
    rx_batch: int = 8,
):
    """Coverage IRs on a ('rays', 'rx') mesh.

    Each device traces its ray shard once, intersects its RX tile against the
    shared segments, and psums partial IRs over 'rays'. Output: (M, nbins)
    sharded over 'rx' on the first axis (replicated along 'rays').
    """
    n = directions.shape[0]
    m = rx_centers.shape[0]
    if n % mesh.shape["rays"]:
        raise ValueError("ray count not divisible over 'rays' axis")
    if m % mesh.shape["rx"]:
        raise ValueError("receiver count not divisible over 'rx' axis")

    key = ("cov", mesh, max_bounces, nbins, float(tx_power), float(light_speed_mps),
           float(sample_rate_hz), float(n1), float(n2), env_hit, float(rx_radius),
           rx_batch, n, m)
    fn = _cache_get(key)
    if fn is None:
        def local(dirs_shard, centers_shard, tx, verts, faces):
            segs = trace_env(
                Scene(verts, faces), tx, dirs_shard,
                max_bounces=max_bounces, n1=n1, n2=n2, env_hit=env_hit,
            )
            rx_fn = partial(
                _rx_ir_from_segments, segs, rx_radius=rx_radius, tx_power=tx_power,
                num_rays=n, nbins=nbins, light_speed_mps=light_speed_mps,
                sample_rate_hz=sample_rate_hz,
            )
            mc = centers_shard.shape[0]
            pad = (-mc) % rx_batch
            padded = jnp.concatenate([centers_shard, jnp.zeros((pad, 3), centers_shard.dtype)]) if pad else centers_shard
            irs = jax.lax.map(jax.vmap(rx_fn), padded.reshape(-1, rx_batch, 3)).reshape(-1, nbins)[:mc]
            return jax.lax.psum(irs, "rays")

        fn = jax.jit(shard_map(
            local,
            mesh=mesh,
            in_specs=(P("rays"), P("rx"), P(), P(), P()),
            out_specs=P("rx"),
            check_vma=False,  # see sharded_cir
        ))
        _cache_put(key, fn)
    return fn(
        directions, rx_centers, jnp.asarray(tx_pos, jnp.float32),
        scene.vertices, scene.faces,
    )
