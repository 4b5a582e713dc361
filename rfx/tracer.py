"""Bounce-loop tracer core (JAX, on-device, differentiable).

A redesign of the reference's CUDA kernel + host physics split
(ref kernel.py:38-98 traces on-GPU, ref tracer.py:102-117 then re-walks every
path on the host). Here a single `lax.scan` over a fixed bounce count carries
per-ray state (position, direction, alive mask, running amplitude and path
length), so the Fresnel factors and delays accumulate on-device as the rays
bounce — no (N, B+1, 3) path buffers, no device->host copy (the reference
round-trips ~360 MB per call, ref tracer.py:67-84).

Termination uses a persistent per-ray alive mask (the *intended* semantics;
the reference's per-iteration `ray_finished` reset, ref kernel.py:58-59, is a
documented quirk we do not reproduce — SURVEY.md 2.2).

Capture semantics per bounce match ref kernel.py:71-98 exactly: query the
receiver and the environment; the receiver wins iff hit AND (env missed OR
t_env > t_rx); on env hit advance + specular reflect; on double miss the ray
escapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rfx import physics
from rfx.geometry import icosphere
from rfx.ops.intersect import (
    T_MIN_EPS,
    is_hit,
    make_env_intersector,
    mesh_soa,
    ray_mesh_closest_hit_brute,
    ray_sphere_hit,
)

__all__ = ["Scene", "TraceResult", "EnvSegments", "trace_to_rx", "trace_env", "unit_icosphere_soa"]


class Scene(NamedTuple):
    """Device-side scene pytree. Vertices are a differentiable leaf."""

    vertices: jnp.ndarray  # (V, 3) float32
    faces: jnp.ndarray  # (F, 3) int32

    @classmethod
    def from_mesh(cls, mesh) -> "Scene":
        return cls(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces))


class TraceResult(NamedTuple):
    captured: jnp.ndarray  # (N,) bool — ray reached the receiver
    amplitude: jnp.ndarray  # (N,) relative amplitude (product of Fresnel factors)
    distance: jnp.ndarray  # (N,) total path length TX -> RX-sphere hit
    num_bounces: jnp.ndarray  # (N,) int32 env bounces before capture/death
    path_vertices: jnp.ndarray | None = None  # (B, N, 3) when record_paths


class EnvSegments(NamedTuple):
    """Per-bounce segment records from an env-only trace (coverage engine)."""

    origin: jnp.ndarray  # (B, N, 3) segment start
    direction: jnp.ndarray  # (B, N, 3) unit direction
    t_env: jnp.ndarray  # (B, N) env-hit distance (inf if the segment escapes)
    amplitude: jnp.ndarray  # (B, N) relative amplitude at segment start
    distance: jnp.ndarray  # (B, N) path length at segment start
    alive: jnp.ndarray  # (B, N) bool — segment exists


# Unit icosphere (42 verts / 80 faces) matching the reference receiver
# tessellation (ref tracer.py:27, trimesh Sphere(subdivisions=1)).
_UNIT_ICO = icosphere(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=1)
_UNIT_ICO_TRI = _UNIT_ICO.triangles()  # (80, 3, 3) numpy


def unit_icosphere_soa():
    tri = jnp.asarray(_UNIT_ICO_TRI)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    return v0, e1, e2


def _make_rx_query(rx_pos, rx_radius, rx_mode: str):
    if rx_mode == "analytic":
        def rx_query(o, d):
            return ray_sphere_hit(o, d, rx_pos, rx_radius)

        return rx_query
    if rx_mode == "icosphere":
        uv0, ue1, ue2 = unit_icosphere_soa()
        v0 = uv0 * rx_radius + rx_pos[None, :]
        e1 = ue1 * rx_radius
        e2 = ue2 * rx_radius

        def rx_query(o, d):
            t, _ = ray_mesh_closest_hit_brute(o, d, v0, e1, e2)
            return t

        return rx_query
    raise ValueError(f"unknown rx_mode: {rx_mode}")


def trace_to_rx(
    scene: Scene,
    tx_pos: jnp.ndarray,
    directions: jnp.ndarray,
    rx_pos: jnp.ndarray,
    rx_radius,
    *,
    max_bounces: int,
    n1=5.0,
    n2=1.0,
    rx_mode: str = "icosphere",
    env_hit=None,
    record_paths: bool = False,
    active: jnp.ndarray | None = None,
    warp_quirk_compat: bool = False,
) -> TraceResult:
    """Trace N rays from tx_pos; return per-ray capture/amplitude/distance.

    `env_hit(o, d, v0, e1, e2, normals) -> (t, face, nrm)` selects the
    intersector backend (default: brute-force Moller-Trumbore). `active`
    optionally masks out padding rays (tile-alignment padding never
    contributes).

    `warp_quirk_compat=True` reproduces the reference KERNEL's latent
    per-iteration `ray_finished` reset (ref kernel.py:58-59; SURVEY.md 2.2):
    capture does not terminate the ray — it keeps tracing from the RX-sphere
    surface with the same direction (typically re-capturing at the sphere's
    exit point), and a later capture OVERWRITES the recorded amplitude/
    distance with the longer path's values. Each pass-through capture vertex
    contributes a bend-angle-0 Fresnel factor, exactly as the reference host
    loop would when walking the overwritten path (ref tracer.py:102-117).
    Escaped rays re-issue missing queries in the reference — observationally
    a no-op, so they still die here. Matches oracle.OracleTracer's flag.
    """
    if env_hit is None:
        env_hit = make_env_intersector("brute")
    v0, e1, e2, normals = mesh_soa(scene.vertices, scene.faces)
    rx_query = _make_rx_query(jnp.asarray(rx_pos, jnp.float32), rx_radius, rx_mode)

    f32 = jnp.float32
    dir0 = directions.astype(f32)
    # Derive the carry from `directions` so every leaf inherits its sharding
    # (shard_map tracks varying mesh axes; literal zeros would be unvarying).
    zeros = jnp.zeros_like(dir0[:, 0])
    tx = jnp.asarray(tx_pos, f32)
    # tx_pos may be (3,) — the reference's single emitter (ref kernel.py:50)
    # — or (N, 3) per-ray origins (distributed emitters; also the round-5
    # per-ray gradient decomposition, scripts/exp_r5_grad.py).
    pos0 = tx + zeros[:, None] if tx.ndim == 2 else tx[None, :] + zeros[:, None]
    carry0 = dict(
        pos=pos0,
        dir=dir0,
        alive=(zeros == 0.0) if active is None else active.astype(bool),
        amp=zeros + 1.0,
        dist=zeros,
        captured=zeros > 0.0,
        cap_amp=zeros,
        cap_dist=zeros,
        nb=zeros.astype(jnp.int32),
    )

    def step(c, _):
        t_rx = rx_query(c["pos"], c["dir"])
        t_env, face, nrm = env_hit(c["pos"], c["dir"], v0, e1, e2, normals)
        env_hit_mask = is_hit(t_env)
        # Receiver wins iff hit AND (env missed OR t_env > t_rx); with finite
        # miss sentinels this is just t_env > t_rx (miss compares as huge).
        rx_win = c["alive"] & is_hit(t_rx) & (t_env > t_rx)
        env_bounce = c["alive"] & ~rx_win & env_hit_mask

        captured = c["captured"] | rx_win
        # In default mode rx_win fires at most once per ray (capture kills the
        # ray); in quirk-compat mode this same overwrite implements the
        # reference's latest-capture-wins behavior.
        cap_amp = jnp.where(rx_win, c["amp"], c["cap_amp"])
        cap_dist = jnp.where(rx_win, c["dist"] + t_rx, c["cap_dist"])

        t_adv = jnp.where(env_bounce, t_env, 0.0)
        # Park rays that die this bounce (captured or escaped) far outside the
        # scene: their AABB tests then miss at the BVH root, so a dead ray's
        # walk ends after one node instead of re-walking the tree (the
        # reference keeps re-querying dead rays, ref kernel.py:58-59).
        new_pos = jnp.where(
            env_bounce[:, None], c["pos"] + c["dir"] * t_adv[:, None], jnp.float32(1e9)
        )
        # Double-where sanitization (round-5 NaN fix): lanes that do NOT
        # env-bounce may carry garbage normals/intermediates (parked rays,
        # backend-dependent miss fills). Their fres VALUE is discarded by the
        # where below, but reverse-mode where-grads still multiply a ZERO
        # cotangent by the branch's derivative — 0 x inf/NaN = NaN — which
        # poisoned the whole n1/material gradient at flagship scale (clean
        # under jax_debug_nans' unfused execution, NaN when jitted). Feeding
        # the unselected lanes a benign normal kills the poison at the source.
        nrm_safe = jnp.where(env_bounce[:, None], nrm, jnp.float32(0.0))
        d_out = physics.reflect(c["dir"], nrm_safe)
        fres = physics.fresnel_bounce_amplitude(physics.bend_angle(c["dir"], d_out), n1, n2)
        amp = jnp.where(env_bounce, c["amp"] * fres, c["amp"])
        dist = c["dist"] + t_adv
        new_dir = jnp.where(env_bounce[:, None], d_out, c["dir"])
        nb = c["nb"] + env_bounce.astype(jnp.int32)
        alive_next = env_bounce

        if warp_quirk_compat:
            # Captured rays pass through the RX surface and keep going: advance
            # to the hit point (same direction), stay alive, and fold in the
            # bend-angle-0 Fresnel factor the host loop applies at the
            # pass-through vertex of any LATER recorded capture.
            f0 = physics.fresnel_bounce_amplitude(jnp.float32(0.0), n1, n2)
            rx_pt = c["pos"] + c["dir"] * jnp.where(rx_win, t_rx, 0.0)[:, None]
            new_pos = jnp.where(rx_win[:, None], rx_pt, new_pos)
            amp = jnp.where(rx_win, c["amp"] * f0, amp)
            dist = jnp.where(rx_win, c["dist"] + t_rx, dist)
            alive_next = env_bounce | rx_win

        out = None
        if record_paths:
            # Vertex appended this bounce: RX hit point, env hit point, or NaN.
            rx_pt = c["pos"] + c["dir"] * jnp.where(is_hit(t_rx), t_rx, 0.0)[:, None]
            vert = jnp.where(
                rx_win[:, None], rx_pt, jnp.where(env_bounce[:, None], new_pos, jnp.nan)
            )
            out = vert

        c2 = dict(
            pos=new_pos,
            dir=new_dir,
            alive=alive_next,
            amp=amp,
            dist=dist,
            captured=captured,
            cap_amp=cap_amp,
            cap_dist=cap_dist,
            nb=nb,
        )
        return c2, out

    # unroll=True (miscompile workaround): with the rolled scan, the
    # accelerator compiler this code was first built for produced garbage in the BACKWARD
    # of this loop through a differentiable-tris intersector (non-captured
    # rays got large nonzero material gradients that are mathematically
    # zero); CPU and the unrolled form were correct. Whether the GPU needs
    # it is open (ROADMAP C3). max_bounces is small (<= 4 on every reference
    # workload), so unrolling costs only compile time.
    carry, ys = jax.lax.scan(step, carry0, None, length=max_bounces, unroll=True)
    return TraceResult(
        captured=carry["captured"],
        amplitude=carry["cap_amp"],
        distance=carry["cap_dist"],
        num_bounces=carry["nb"],
        path_vertices=ys if record_paths else None,
    )


def trace_env(
    scene: Scene,
    tx_pos: jnp.ndarray,
    directions: jnp.ndarray,
    *,
    max_bounces: int,
    n1=5.0,
    n2=1.0,
    env_hit=None,
    active: jnp.ndarray | None = None,
) -> EnvSegments:
    """Environment-only trace recording per-bounce segments.

    The coverage engine intersects these segments against *all* receiver
    spheres afterwards — one trace serves every RX point, replacing the
    reference's re-trace-per-receiver sweep (ref coverage.py:38-43). Exact
    per-receiver equivalence holds because a receiver never alters the
    environment path; capture only truncates that receiver's own view of it.
    """
    if env_hit is None:
        env_hit = make_env_intersector("brute")
    v0, e1, e2, normals = mesh_soa(scene.vertices, scene.faces)

    f32 = jnp.float32
    dir0 = directions.astype(f32)
    zeros = jnp.zeros_like(dir0[:, 0])  # sharding-inheriting init (see trace_to_rx)
    carry0 = dict(
        pos=jnp.asarray(tx_pos, f32)[None, :] + zeros[:, None],
        dir=dir0,
        alive=(zeros == 0.0) if active is None else active.astype(bool),
        amp=zeros + 1.0,
        dist=zeros,
    )

    def step(c, _):
        t_env, face, nrm = env_hit(c["pos"], c["dir"], v0, e1, e2, normals)
        env_hit_mask = is_hit(t_env)
        seg = dict(
            origin=c["pos"],
            direction=c["dir"],
            t_env=t_env,
            amplitude=c["amp"],
            distance=c["dist"],
            alive=c["alive"],
        )
        env_bounce = c["alive"] & env_hit_mask
        t_adv = jnp.where(env_bounce, t_env, 0.0)
        # Park rays that die this bounce far outside the scene (see
        # trace_to_rx).
        new_pos = jnp.where(
            env_bounce[:, None], c["pos"] + c["dir"] * t_adv[:, None], jnp.float32(1e9)
        )
        d_out = physics.reflect(c["dir"], nrm)
        fres = physics.fresnel_bounce_amplitude(physics.bend_angle(c["dir"], d_out), n1, n2)
        c2 = dict(
            pos=new_pos,
            dir=jnp.where(env_bounce[:, None], d_out, c["dir"]),
            alive=env_bounce,
            amp=jnp.where(env_bounce, c["amp"] * fres, c["amp"]),
            dist=c["dist"] + t_adv,
        )
        return c2, seg

    _, segs = jax.lax.scan(step, carry0, None, length=max_bounces)
    return EnvSegments(
        origin=segs["origin"],
        direction=segs["direction"],
        t_env=segs["t_env"],
        amplitude=segs["amplitude"],
        distance=segs["distance"],
        alive=segs["alive"],
    )


def extract_paths(
    tx_pos: np.ndarray,
    result: TraceResult,
    max_paths: int = 10_000,
) -> list[np.ndarray]:
    """Host-side compaction of recorded paths for visualization.

    Returns up to max_paths received paths as (k, 3) vertex arrays (TX first),
    mirroring the reference's cleaned_paths output (ref tracer.py:90-97) but
    transferring only captured rows instead of the full (N, B+1, 3) buffer.
    """
    if result.path_vertices is None:
        raise ValueError("trace was run without record_paths=True")
    captured = np.asarray(result.captured)
    idx = np.nonzero(captured)[0][:max_paths]
    verts = np.asarray(result.path_vertices[:, idx, :])  # (B, K, 3)
    tx = np.asarray(tx_pos, np.float32)
    paths = []
    for k in range(idx.shape[0]):
        col = verts[:, k, :]
        keep = ~np.isnan(col[:, 0])
        # Vertices up to and including the RX hit (NaNs appear after death).
        stop = np.argmin(keep) if not keep.all() else col.shape[0]
        paths.append(np.concatenate([tx[None, :], col[:stop]], axis=0))
    return paths
