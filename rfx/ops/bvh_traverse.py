"""BVH traversal on device (jnp while_loop, vectorised over rays).

The plain-XLA equivalent of warp's `wp.mesh_query_ray` BVH walk
(ref kernel.py:71,82 -> CUDA traversal inside warp-lang), and the CPU
reference for the GPU kernel in rfx.ops.gpu_trace. All rays advance in
lockstep through the flat skip-pointer layout built by rfx.bvh: each ray keeps
its own node cursor; internal nodes descend on AABB hit (cursor+1) or jump the
skip pointer; leaves vector-test a fixed LEAF_SIZE padded triangle block.

`lax.while_loop` is not reverse-differentiable, so the public entry
`bvh_closest_hit` carries a custom VJP with straight-through hit selection
(SURVEY.md 7 step 6): the traversal picks the face, and the backward pass
re-evaluates the Moller-Trumbore t of that face in closed form, scattering
cotangents to the ray and to the (differentiable, vertex-derived) triangle
arrays.

Caveat: node AABBs are host-built constants. If vertices move (inverse solve
over geometry), hit *selection* uses the stale bounds while t stays exact for
the selected face; rebuild the BVH per outer step when vertex updates are
large. The brute backend remains the fully differentiable gold path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rfx.bvh import LEAF_SIZE, FlatBVH
from rfx.ops.intersect import (
    HIGHEST, MISS, T_MIN_EPS, closed_form_t, hit_normal_from_edges, is_hit,
)

__all__ = ["DeviceBVH", "device_bvh", "bvh_closest_hit", "closest_hit_vjp", "live_bvh"]


class DeviceBVH(NamedTuple):
    aabb_min: jnp.ndarray  # (n_nodes, 3)
    aabb_max: jnp.ndarray  # (n_nodes, 3)
    tri_start: jnp.ndarray  # (n_nodes,)
    tri_count: jnp.ndarray  # (n_nodes,)
    skip: jnp.ndarray  # (n_nodes,)
    tri_v0: jnp.ndarray  # (P, 3)
    tri_e1: jnp.ndarray  # (P, 3)
    tri_e2: jnp.ndarray  # (P, 3)
    tri_face: jnp.ndarray  # (P,) original face id, -1 padding


def device_bvh(flat: FlatBVH) -> DeviceBVH:
    """Upload a host FlatBVH (see `live_bvh` for vertex-derived leaves)."""
    return DeviceBVH(
        aabb_min=jnp.asarray(flat.aabb_min),
        aabb_max=jnp.asarray(flat.aabb_max),
        tri_start=jnp.asarray(flat.tri_start),
        tri_count=jnp.asarray(flat.tri_count),
        skip=jnp.asarray(flat.skip),
        tri_v0=jnp.asarray(flat.tri_v0),
        tri_e1=jnp.asarray(flat.tri_e1),
        tri_e2=jnp.asarray(flat.tri_e2),
        tri_face=jnp.asarray(flat.tri_face),
    )


def _leaf_mt(o, d, v0, e1, e2, t_min):
    """Moller-Trumbore for (N, L, 3) leaf blocks against (N, 3) rays.
    Returns (N, L) t values (MISS where no hit)."""
    pvec = jnp.cross(d[:, None, :], e2)
    det = jnp.einsum("nlj,nlj->nl", e1, pvec, precision=HIGHEST)
    valid_det = jnp.abs(det) > 1e-12  # see _mt_chunk: avoid 1/det^2 overflow
    inv_det = jnp.where(valid_det, 1.0 / jnp.where(valid_det, det, 1.0), 0.0)
    tvec = o[:, None, :] - v0
    u = jnp.einsum("nlj,nlj->nl", tvec, pvec, precision=HIGHEST) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.einsum("nj,nlj->nl", d, qvec, precision=HIGHEST) * inv_det
    t = jnp.einsum("nlj,nlj->nl", e2, qvec, precision=HIGHEST) * inv_det
    ok = valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return jnp.where(ok, t, MISS)


def _traverse(bvh: DeviceBVH, o, d, t_min, leaf_size=LEAF_SIZE):
    n = o.shape[0]
    n_nodes = bvh.aabb_min.shape[0]
    inv_d = jnp.where(jnp.abs(d) > 1e-30, 1.0 / jnp.where(jnp.abs(d) > 1e-30, d, 1.0), 1e30)

    def cond(state):
        cursor, _, _ = state
        return jnp.any(cursor < n_nodes)

    def body(state):
        cursor, t_best, tri_best = state
        active = cursor < n_nodes
        ni = jnp.where(active, cursor, 0)
        bmin = bvh.aabb_min[ni]  # (N, 3)
        bmax = bvh.aabb_max[ni]
        # Slab test against current best t.
        lo = (bmin - o) * inv_d
        hi = (bmax - o) * inv_d
        t_near = jnp.max(jnp.minimum(lo, hi), axis=1)
        t_far = jnp.min(jnp.maximum(lo, hi), axis=1)
        box_hit = (t_near <= jnp.minimum(t_far, t_best)) & (t_far >= t_min)

        count = bvh.tri_count[ni]
        leaf = count > 0
        start = bvh.tri_start[ni]

        # Fixed-size leaf block (padding rows are degenerate -> never hit).
        gather = start[:, None] + jnp.arange(leaf_size)[None, :]
        gather = jnp.clip(gather, 0, bvh.tri_v0.shape[0] - 1)
        lv0 = bvh.tri_v0[gather]
        le1 = bvh.tri_e1[gather]
        le2 = bvh.tri_e2[gather]
        t_leaf = _leaf_mt(o, d, lv0, le1, le2, t_min)  # (N, L)
        in_count = jnp.arange(leaf_size)[None, :] < count[:, None]
        use = (active & box_hit & leaf)[:, None] & in_count
        t_leaf = jnp.where(use, t_leaf, MISS)
        l_arg = jnp.argmin(t_leaf, axis=1)
        l_t = jnp.min(t_leaf, axis=1)
        better = l_t < t_best
        t_best = jnp.where(better, l_t, t_best)
        tri_best = jnp.where(better, gather[jnp.arange(n), l_arg], tri_best)

        descend = box_hit & ~leaf
        nxt = jnp.where(descend, ni + 1, bvh.skip[ni])
        cursor = jnp.where(active, nxt, cursor)
        return cursor, t_best, tri_best

    cursor0 = jnp.zeros((n,), jnp.int32)
    t0 = jnp.full((n,), MISS, jnp.float32)
    tri0 = jnp.full((n,), -1, jnp.int32)
    _, t_best, tri_best = jax.lax.while_loop(cond, body, (cursor0, t0, tri0))
    face = jnp.where(tri_best >= 0, bvh.tri_face[jnp.maximum(tri_best, 0)], -1)
    return t_best, face, tri_best


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def bvh_closest_hit(o, d, bvh: DeviceBVH, t_min=T_MIN_EPS, leaf_size=LEAF_SIZE):
    t, face, _ = _traverse(bvh, o, d, t_min, leaf_size)
    return t, face


def _bvh_hit_fwd(o, d, bvh, t_min, leaf_size):
    t, face, tri_idx = _traverse(bvh, o, d, t_min, leaf_size)
    return (t, face), (o, d, bvh, tri_idx, t)


def closest_hit_vjp(o, d, bvh: DeviceBVH, tri_idx, t, g_t):
    """Straight-through backward of a BVH closest-hit query: the VJP of the
    closed-form t of each ray's selected (padded-index) triangle. Returns
    (go, gd, g_bvh) with triangle cotangents scattered into the BVH's leaf
    SoA. Shared by every traversal that reports `tri_idx`."""
    gather = jnp.maximum(tri_idx, 0)
    v0 = bvh.tri_v0[gather]
    e1 = bvh.tri_e1[gather]
    e2 = bvh.tri_e2[gather]
    hit = (tri_idx >= 0) & is_hit(t)
    g = jnp.where(hit, g_t, 0.0)
    # Sanitized non-hit lanes: parked rays (|o| ~ 1e9) overflow the t-VJP's
    # intermediates to inf and 0 x inf = NaN.
    o_s = jnp.where(hit[:, None], o, 0.0)
    d_s = jnp.where(hit[:, None], d, 1.0)
    _, vjp = jax.vjp(closed_form_t, o_s, d_s, v0, e1, e2)
    go, gd, gv0, ge1, ge2 = vjp(g)

    # Scatter triangle cotangents back into the flat SoA (padding rows dropped
    # via `hit`).
    def scat(target_shape, idx, val):
        return jnp.zeros(target_shape, val.dtype).at[idx].add(
            jnp.where(hit[:, None], val, 0.0)
        )

    p = bvh.tri_v0.shape[0]
    g_bvh = DeviceBVH(
        aabb_min=jnp.zeros_like(bvh.aabb_min),
        aabb_max=jnp.zeros_like(bvh.aabb_max),
        tri_start=None,
        tri_count=None,
        skip=None,
        tri_v0=scat((p, 3), gather, gv0),
        tri_e1=scat((p, 3), gather, ge1),
        tri_e2=scat((p, 3), gather, ge2),
        tri_face=None,
    )
    return go, gd, g_bvh


def _bvh_hit_bwd(t_min, leaf_size, res, cotangents):
    o, d, bvh, tri_idx, t = res
    g_t, _ = cotangents  # face cotangent is symbolic-zero (int)
    return closest_hit_vjp(o, d, bvh, tri_idx, t, g_t)


bvh_closest_hit.defvjp(_bvh_hit_fwd, _bvh_hit_bwd)


def live_bvh(flat: FlatBVH, base: DeviceBVH, v0, e1, e2) -> DeviceBVH:
    """`base` with its leaf triangle SoA re-gathered from live (original
    face order) triangle arrays, so vertex gradients reach the leaves. The
    leaf permutation is static; node boxes stay host-built (see the module
    caveat)."""
    face_idx = np.maximum(flat.tri_face, 0)
    padj = jnp.asarray(flat.tri_face < 0)[:, None]
    zero = jnp.float32(0.0)
    return base._replace(
        tri_v0=jnp.where(padj, zero, v0[face_idx]),
        tri_e1=jnp.where(padj, zero, e1[face_idx]),
        tri_e2=jnp.where(padj, zero, e2[face_idx]),
    )


def make_bvh_env_hit(flat: FlatBVH, differentiable_tris: bool = False):
    """Returns env_hit(o, d, v0, e1, e2, normals) -> (t, face, nrm) using BVH
    traversal (nrm rebuilt from the hit face's edges).

    The (v0, e1, e2) args of the intersector interface are ignored for hit
    *selection* (the BVH carries its own leaf-reordered copy); pass
    differentiable_tris=True to re-derive leaf triangles from scene vertices
    at call time (costlier; for vertex-gradient workloads).
    """
    base = device_bvh(flat)

    def env_hit(o, d, v0, e1, e2, normals):
        bvh = live_bvh(flat, base, v0, e1, e2) if differentiable_tris else base
        t, face = bvh_closest_hit(o, d, bvh, T_MIN_EPS, flat.leaf_size)
        # hit_normal_from_edges, NOT normals[face]: see its docstring.
        return t, face, hit_normal_from_edges(e1, e2, face)

    return env_hit
