"""Ray-primitive intersection ops (JAX/XLA compute path).

Replacement for warp's `wp.mesh_query_ray` (ref kernel.py:71,82), which on
the reference stack is a CUDA BVH traversal + watertight Moller-Trumbore
inside the warp-lang dependency. Here:

- `ray_mesh_closest_hit_brute`: fully vectorised Moller-Trumbore over all
  triangles, chunked over rays so the (rays x tris) intermediates stay inside
  a bounded footprint. This is the gold path (small meshes: room = 44 tris)
  and the differentiable reference for the BVH backends.
- `ray_sphere_hit`: closed-form sphere intersection for the receiver in
  "analytic" RX mode (the reference tessellates an 80-face icosphere,
  ref tracer.py:26-30; we keep that mode for parity and offer the exact
  sphere as the fast default).

All hit queries use an explicit `t_min` epsilon for self-intersection
avoidance (the reference delegates this to warp internals; SURVEY.md 2.2).

Every contraction asks for Precision.HIGHEST: XLA may hand an einsum to
cuBLAS, which would otherwise be free to run f32 in TF32 and flip hits near
triangle edges.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST
T_MIN_EPS = 1e-4  # must match oracle.oracle.T_MIN_EPS
T_MAX = 1.0e6
# Finite miss sentinel: inf arithmetic under XLA's fused/optimized backward
# passes produced NaNs under the accelerator compiler this code was first
# built for (jit(grad(trace)) NaN while the de-optimized path was clean), so
# misses are a large finite t instead.
MISS = jnp.float32(1e30)
MISS_THRESHOLD = 1e29


def is_hit(t):
    """True where a query returned a real intersection (t below the miss
    sentinel)."""
    return t < MISS_THRESHOLD


def hit_normal_from_edges(e1, e2, face):
    """Unit geometric normal of each ray's hit face, derived per-ray from the
    gathered edge vectors: unit(cross(e1[f], e2[f])).

    Deliberately NOT `normals[face]` on a precomputed normal table: when the
    normal table is itself a traced value (vertices differentiable, so
    mesh_soa runs inside jit), the accelerator compiler this code was first
    built for miscompiled the gather-of-computed-normals inside a scan body (about
    20x the true capture count on a grid-48 terrain; CPU was clean).
    Deriving the normal from the gathered edges is correct everywhere, costs
    one cross + rsqrt per ray, and keeps vertex gradients flowing. Whether
    the GPU needs it is open (ROADMAP C3).
    """
    f = jnp.clip(face, 0, None)
    n = jnp.cross(e1[f], e2[f])
    return n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True), 1e-30)


def mesh_soa(vertices: jnp.ndarray, faces: jnp.ndarray):
    """Derive triangle SoA (v0, e1, e2, unit normals) from indexed mesh.

    Computed inside jit from `vertices` so vertex gradients flow.
    """
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    n = jnp.cross(e1, e2)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    return v0, e1, e2, n


def _mt_chunk(o, d, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore closest hit: (C, 3) rays vs (T, 3) triangle SoA.

    Returns (t_best (C,), face (C,) int32); misses get t=inf, face=-1.
    """
    # (C, T, 3) intermediates; caller bounds C*T.
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = jnp.einsum("tj,ctj->ct", e1, pvec, precision=HIGHEST)
    # Near-parallel guard with a finite threshold, not det != 0: for tiny
    # nonzero dets the VJP of 1/det is -1/det^2, which overflows f32 to inf
    # and poisons the (zero) cotangent with NaN under jit. 1e-12 keeps
    # 1/det^2 <= 1e24, comfortably finite.
    valid_det = jnp.abs(det) > 1e-12
    det_safe = jnp.where(valid_det, det, 1.0)
    inv_det = jnp.where(valid_det, 1.0 / det_safe, 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = jnp.einsum("ctj,ctj->ct", tvec, pvec, precision=HIGHEST) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.einsum("cj,ctj->ct", d, qvec, precision=HIGHEST) * inv_det
    t = jnp.einsum("tj,ctj->ct", e2, qvec, precision=HIGHEST) * inv_det
    ok = valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    ok &= (t > t_min) & (t < t_max)
    t = jnp.where(ok, t, MISS)
    face = jnp.argmin(t, axis=1).astype(jnp.int32)
    t_best = jnp.min(t, axis=1)
    face = jnp.where(is_hit(t_best), face, -1)
    return t_best, face


def _brute_fwd_only(o, d, v0, e1, e2, t_min, t_max, ray_chunk):
    if ray_chunk and o.shape[0] > ray_chunk:
        n = o.shape[0]
        if n % ray_chunk:
            raise ValueError(f"N={n} not a multiple of ray_chunk={ray_chunk}")
        oc = o.reshape(-1, ray_chunk, 3)
        dc = d.reshape(-1, ray_chunk, 3)
        t, f = jax.lax.map(lambda args: _mt_chunk(args[0], args[1], v0, e1, e2, t_min, t_max), (oc, dc))
        return t.reshape(n), f.reshape(n)
    return _mt_chunk(o, d, v0, e1, e2, t_min, t_max)


def closed_form_t(o, d, v0, e1, e2):
    """Differentiable Moller-Trumbore t for known (ray, triangle) pairs, all
    (N, 3). Used by intersector backward passes: hit *selection* is
    straight-through, t is exact for the selected face."""
    pvec = jnp.cross(d, e2)
    det = jnp.einsum("nj,nj->n", e1, pvec, precision=HIGHEST)
    det_safe = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    qvec = jnp.cross(o - v0, e1)
    return jnp.einsum("nj,nj->n", e2, qvec, precision=HIGHEST) / det_safe


@partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7))
def _brute_custom(o, d, v0, e1, e2, t_min, t_max, ray_chunk):
    return _brute_fwd_only(o, d, v0, e1, e2, t_min, t_max, ray_chunk)


def ray_mesh_closest_hit_brute(
    o: jnp.ndarray,
    d: jnp.ndarray,
    v0: jnp.ndarray,
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    t_min: float = T_MIN_EPS,
    t_max: float = T_MAX,
    ray_chunk: int = 0,
):
    """Closest hit of (N, 3) rays against all T triangles.

    ray_chunk > 0 processes rays in fixed-size chunks via lax.map to bound the
    (chunk x T) intermediate; N must then be a multiple of ray_chunk (callers
    pad with dead rays).

    Carries a custom VJP: the forward picks the face (non-differentiable
    argmin selection, straight-through), the backward re-evaluates the
    selected face's t in closed form and scatters cotangents to the ray and
    triangle arrays — far cheaper than rematerialising the (rays x tris)
    intermediates.
    """
    return _brute_custom(o, d, v0, e1, e2, float(t_min), float(t_max), int(ray_chunk))


def _brute_fwd(o, d, v0, e1, e2, t_min, t_max, ray_chunk):
    t, face = _brute_fwd_only(o, d, v0, e1, e2, t_min, t_max, ray_chunk)
    return (t, face), (o, d, v0, e1, e2, face, t)


def _brute_bwd(t_min, t_max, ray_chunk, res, cotangents):
    o, d, v0, e1, e2, face, t = res
    g_t, _ = cotangents  # face cotangent is symbolic zero (int output)
    sel = jnp.maximum(face, 0)
    hit = (face >= 0) & is_hit(t)
    g = jnp.where(hit, g_t, 0.0)
    # Evaluate the VJP at sanitized non-hit lanes: parked rays (|o| ~ 1e9)
    # overflow the derivative's intermediates to inf and 0 x inf = NaN.
    o_s = jnp.where(hit[:, None], o, 0.0)
    d_s = jnp.where(hit[:, None], d, 1.0)

    def t_of(o_, d_, fv0, fe1, fe2):
        return closed_form_t(o_, d_, fv0, fe1, fe2)

    _, vjp = jax.vjp(t_of, o_s, d_s, v0[sel], e1[sel], e2[sel])
    go, gd, gv0, ge1, ge2 = vjp(g)
    zero_pad = jnp.where(hit[:, None], 1.0, 0.0)
    gv0_full = jnp.zeros_like(v0).at[sel].add(gv0 * zero_pad)
    ge1_full = jnp.zeros_like(e1).at[sel].add(ge1 * zero_pad)
    ge2_full = jnp.zeros_like(e2).at[sel].add(ge2 * zero_pad)
    return go, gd, gv0_full, ge1_full, ge2_full


_brute_custom.defvjp(_brute_fwd, _brute_bwd)


def _sphere_hit_fwd_only(o, d, center, radius, t_min):
    oc = o - center[None, :]
    b = jnp.einsum("nj,nj->n", oc, d, precision=HIGHEST)
    c = jnp.einsum("nj,nj->n", oc, oc, precision=HIGHEST) - radius * radius
    disc = b * b - c
    # Double-where: sqrt'(0) is inf; keep the miss branch out of the VJP.
    # Exact tangent hits (disc == 0) count as misses — measure-zero set.
    hit = disc > 0.0
    s = jnp.sqrt(jnp.where(hit, disc, 1.0))
    t0 = -b - s
    t1 = -b + s
    t = jnp.where(t0 > t_min, t0, jnp.where(t1 > t_min, t1, MISS))
    return jnp.where(hit, t, MISS)


@partial(jax.custom_vjp, nondiff_argnums=(4,))
def _sphere_custom(o, d, center, radius, t_min):
    return _sphere_hit_fwd_only(o, d, center, radius, t_min)


def ray_sphere_hit(o, d, center, radius, t_min=T_MIN_EPS):
    """Smallest positive intersection parameter of unit-direction rays with a
    sphere; MISS sentinel on miss. (N, 3) rays, (3,) center. Matches the
    oracle's analytic RX mode.

    Custom VJP via the implicit function theorem on |o + t d - C|^2 = r^2:
    with p = o + t d and q = p - C,
        dt/do = -q / (q.d),  dt/dd = -t q / (q.d),  dt/dC = q / (q.d),
        dt/dr = r / (q.d).
    The q.d denominator is clamped away from zero (near-tangent hits), and the
    backward never touches the sqrt/discriminant graph."""
    return _sphere_custom(
        o, d, jnp.asarray(center), jnp.asarray(radius, jnp.float32), float(t_min)
    )


def _sphere_fwd(o, d, center, radius, t_min):
    t = _sphere_hit_fwd_only(o, d, center, radius, t_min)
    return t, (o, d, center, radius, t)


def _sphere_bwd(t_min, res, g):
    o, d, center, radius, t = res
    hit = is_hit(t)
    t_safe = jnp.where(hit, t, 0.0)
    q = o + t_safe[:, None] * d - center[None, :]
    qd = jnp.einsum("nj,nj->n", q, d, precision=HIGHEST)
    # |q.d| = r*|cos(theta_inc)| at a hit; clamp for grazing incidence.
    mag = jnp.maximum(jnp.abs(qd), 1e-6 * jnp.maximum(radius, 1e-6))
    qd_safe = jnp.where(qd < 0.0, -mag, mag)
    gg = jnp.where(hit, g, 0.0) / qd_safe
    go = -gg[:, None] * q
    gd = -(gg * t_safe)[:, None] * q
    gc = -jnp.sum(go, axis=0)
    gr = jnp.sum(gg) * radius
    return go, gd, gc, gr


_sphere_custom.defvjp(_sphere_fwd, _sphere_bwd)


# Rays x triangles elements per brute-force chunk: bounds the (chunk, T, 3)
# Moller-Trumbore intermediates at a few hundred MB whatever the mesh size.
BRUTE_CHUNK_ELEMS = 1 << 25


def brute_ray_chunk(n_rays: int, n_tris: int) -> int:
    """Ray chunk for the brute intersector: the largest power of two with
    chunk * n_tris <= BRUTE_CHUNK_ELEMS, or 0 (no chunking) when the whole
    batch fits."""
    chunk = max(1, BRUTE_CHUNK_ELEMS // max(n_tris, 1))
    chunk = 1 << (chunk.bit_length() - 1)
    return 0 if n_rays <= chunk else chunk


def _brute_env_hit(o, d, v0, e1, e2, normals):
    n = o.shape[0]
    chunk = brute_ray_chunk(n, v0.shape[0])
    pad = (-n) % chunk if chunk else 0
    if pad:
        # Dead padding rays, sliced off below.
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], d.dtype), (pad, 3))])
    # positional: custom_vjp functions reject keyword arguments
    t, face = ray_mesh_closest_hit_brute(o, d, v0, e1, e2, T_MIN_EPS, T_MAX, chunk)
    t, face = t[:n], face[:n]
    return t, face, hit_normal_from_edges(e1, e2, face)


BACKENDS = ("brute", "bvh", "triton")


def make_env_intersector(backend: str = "brute", *, mesh=None, flat_bvh=None,
                         differentiable_tris: bool = False, interpret: bool = False):
    """Factory: returns env_hit(o, d, v0, e1, e2, normals) -> (t, face, nrm).

    `nrm` is the unit geometric normal of the hit face ((N, 3); zeros on
    miss are NOT guaranteed — callers mask by hit). The GPU kernel folds it
    in-kernel; the jnp backends rebuild it from the hit face's edges.

    backend:
      'brute'  — jnp Moller-Trumbore over all triangles (gold path, small meshes)
      'bvh'    — flat skip-pointer BVH, jnp while_loop traversal (needs mesh=)
      'triton' — the same BVH walked one lane per ray by a Pallas-Triton GPU
                 kernel (needs mesh=; `interpret=True` runs it on the CPU)

    `differentiable_tris=True` (BVH backends) re-derives the leaf triangles
    from the live scene arrays so vertex gradients flow.
    """
    if backend == "brute":
        return _brute_env_hit
    if backend not in BACKENDS:
        raise ValueError(f"unknown intersector backend: {backend}")
    if mesh is None and flat_bvh is None:
        raise ValueError(f"backend '{backend}' requires mesh=TriangleMesh")
    from rfx.bvh import build_bvh

    flat = flat_bvh or build_bvh(mesh)
    if backend == "bvh":
        from rfx.ops.bvh_traverse import make_bvh_env_hit

        return make_bvh_env_hit(flat, differentiable_tris=differentiable_tris)
    from rfx.ops.gpu_trace import make_triton_env_hit

    return make_triton_env_hit(flat, differentiable_tris=differentiable_tris,
                               interpret=interpret)
