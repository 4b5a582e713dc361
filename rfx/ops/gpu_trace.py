"""BVH closest-hit as a GPU kernel: one lane per ray (Pallas, Triton route).

The form of warp's `wp.mesh_query_ray` (ref kernel.py:71,82): every ray walks
the flat skip-pointer BVH of rfx.bvh with its own cursor, its own slab test
against its own best t, and a Moller-Trumbore loop over the <= LEAF_SIZE
triangles of each leaf it reaches. The cursor, t_best and the hit index live
in registers for the whole walk; node and triangle rows are gathered from
device memory, where a 32k-triangle scene (~2 MB) stays resident in L2.
Compared with the plain-XLA walk (rfx.ops.bvh_traverse), nothing N-sized
round-trips device memory per step, no step gathers a leaf block for rays
that are not at a leaf, and a block stops when its own deepest ray does,
not the batch's.

- A block of BLOCK_RAYS consecutive rays runs the walk together; Morton-
  ordered spawn (rfx.sampler.morton_sphere_directions) keeps a block's rays
  on nearby paths, so their cursors agree most steps.
- The leaf loop runs only in steps where some ray of the block is at a
  box-hit leaf (a scalar branch), with masked loads.
- t, the original face id and the unit normal of the winner are folded in
  the kernel: the bounce loop never gathers an N-sized normal table.
- Ties keep the first triangle met in preorder/leaf order (strict `<`), the
  rule of the jnp walk, so the two agree bit for bit on selection.

Gradients use the straight-through rule shared with the jnp walk
(rfx.ops.bvh_traverse.closest_hit_vjp): the kernel picks the triangle, the
backward differentiates its closed-form t in jnp.

`interpret=True` runs the same kernel through the Pallas interpreter, which
is how the CPU tests reach it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rfx.bvh import FlatBVH
from rfx.ops.bvh_traverse import DeviceBVH, closest_hit_vjp, device_bvh, live_bvh
from rfx.ops.intersect import T_MIN_EPS, hit_normal_from_edges

__all__ = ["BLOCK_RAYS", "make_triton_env_hit", "kernel_closest_hit", "pack_tables"]

BLOCK_RAYS = 64  # rays per program: two warps
NODE_F = 8  # floats per node row: aabb min xyz, aabb max xyz, 2 pad
NODE_I = 4  # ints per node row: leaf tri start, tri count (0 = internal), skip, pad
TRI_F = 16  # floats per triangle row: v0, e1, e2, unit normal, 4 pad
PARK = 1e9  # origin of padding rays: misses the root box, exits at once
_MISS = 1e30  # == intersect.MISS as a literal (no captured traced constants)


def pack_tables(bvh: DeviceBVH):
    """Flat row-major kernel tables from a DeviceBVH (jnp, so a live BVH
    repacks inside jit): (nodef (n*8,) f32, nodei (n*4,) i32, tri (P*16,) f32,
    face (P,) i32)."""
    n = bvh.aabb_min.shape[0]
    p = bvh.tri_v0.shape[0]
    nodef = jnp.concatenate(
        [bvh.aabb_min, bvh.aabb_max, jnp.zeros((n, NODE_F - 6), jnp.float32)], axis=1)
    nodei = jnp.stack(
        [bvh.tri_start, bvh.tri_count, bvh.skip, jnp.zeros((n,), jnp.int32)], axis=1)
    nrm = jnp.cross(bvh.tri_e1, bvh.tri_e2)
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    tri = jnp.concatenate(
        [bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, nrm, jnp.zeros((p, TRI_F - 12), jnp.float32)],
        axis=1)
    return (nodef.reshape(-1), nodei.astype(jnp.int32).reshape(-1), tri.reshape(-1),
            bvh.tri_face.astype(jnp.int32))


def _kernel(nodef_ref, nodei_ref, tri_ref, face_ref,
            ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            t_ref, fc_ref, idx_ref, nx_ref, ny_ref, nz_ref, *, n_nodes, leaf_size):
    from jax.experimental.pallas import triton as plgpu

    def gather(ref, idx, mask=None):
        return plgpu.load(ref.at[idx], mask=mask, other=0 if mask is not None else None)

    t_min = jnp.float32(T_MIN_EPS)
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]

    def inv(v):
        ok = jnp.abs(v) > 1e-30
        return jnp.where(ok, 1.0 / jnp.where(ok, v, 1.0), jnp.float32(1e30))

    ix, iy, iz = inv(dx), inv(dy), inv(dz)

    def leaf_pass(carry, test, start, count):
        t_best, tri_best = carry
        for k in range(leaf_size):
            m = test & (k < count)
            j = start + k
            r = jnp.where(m, j, 0) * TRI_F
            v0x, v0y, v0z = (gather(tri_ref, r + c, m) for c in range(0, 3))
            e1x, e1y, e1z = (gather(tri_ref, r + c, m) for c in range(3, 6))
            e2x, e2y, e2z = (gather(tri_ref, r + c, m) for c in range(6, 9))
            px = dy * e2z - dz * e2y  # pvec = d x e2
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            valid = jnp.abs(det) > 1e-12
            inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y  # qvec = tvec x e1
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            ok = m & valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
            better = ok & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            tri_best = jnp.where(better, j, tri_best)
        return t_best, tri_best

    def cond(state):
        return jnp.max((state[0] < n_nodes).astype(jnp.int32)) > 0

    def body(state):
        cursor, t_best, tri_best = state
        active = cursor < n_nodes
        ni = jnp.where(active, cursor, 0)
        fb = ni * NODE_F
        lox = (gather(nodef_ref, fb + 0) - ox) * ix
        loy = (gather(nodef_ref, fb + 1) - oy) * iy
        loz = (gather(nodef_ref, fb + 2) - oz) * iz
        hix = (gather(nodef_ref, fb + 3) - ox) * ix
        hiy = (gather(nodef_ref, fb + 4) - oy) * iy
        hiz = (gather(nodef_ref, fb + 5) - oz) * iz
        t_near = jnp.maximum(jnp.maximum(jnp.minimum(lox, hix), jnp.minimum(loy, hiy)),
                             jnp.minimum(loz, hiz))
        t_far = jnp.minimum(jnp.minimum(jnp.maximum(lox, hix), jnp.maximum(loy, hiy)),
                            jnp.maximum(loz, hiz))
        box_hit = active & (t_near <= jnp.minimum(t_far, t_best)) & (t_far >= t_min)
        ib = ni * NODE_I
        start = gather(nodei_ref, ib + 0)
        count = gather(nodei_ref, ib + 1)
        skip = gather(nodei_ref, ib + 2)
        leaf = count > 0
        test = box_hit & leaf
        t_best, tri_best = jax.lax.cond(
            jnp.max(test.astype(jnp.int32)) > 0,
            partial(leaf_pass, test=test, start=start, count=count),
            lambda c: c,
            (t_best, tri_best),
        )
        nxt = jnp.where(box_hit & ~leaf, ni + 1, skip)
        return jnp.where(active, nxt, cursor), t_best, tri_best

    b = ox.shape[0]
    _, t_best, tri_best = jax.lax.while_loop(
        cond, body,
        (jnp.zeros((b,), jnp.int32), jnp.full((b,), _MISS, jnp.float32),
         jnp.full((b,), -1, jnp.int32)),
    )
    hit = tri_best >= 0
    r = jnp.where(hit, tri_best, 0)
    t_ref[...] = t_best
    idx_ref[...] = tri_best
    fc_ref[...] = jnp.where(hit, gather(face_ref, r, hit), -1)
    nx_ref[...] = jnp.where(hit, gather(tri_ref, r * TRI_F + 9, hit), 0.0)
    ny_ref[...] = jnp.where(hit, gather(tri_ref, r * TRI_F + 10, hit), 0.0)
    nz_ref[...] = jnp.where(hit, gather(tri_ref, r * TRI_F + 11, hit), 0.0)


@partial(jax.jit, static_argnames=("n_nodes", "leaf_size", "interpret"))
def _walk(tables, o, d, *, n_nodes, leaf_size, interpret):
    """(N, 3) rays -> (t, face, tri_idx, nrm). Pads the batch to a whole
    number of blocks with parked rays and slices them off."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = o.shape[0]
    pad = (-n) % BLOCK_RAYS
    if pad:
        o = jnp.concatenate([o, jnp.full((pad, 3), PARK, o.dtype)])
        d = jnp.concatenate([d, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], d.dtype), (pad, 3))])
    m = n + pad
    ray = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    table = pl.BlockSpec(memory_space=pl.ANY)
    plane = lambda dt: jax.ShapeDtypeStruct((m,), dt)
    t, face, idx, nx, ny, nz = pl.pallas_call(
        partial(_kernel, n_nodes=n_nodes, leaf_size=leaf_size),
        grid=(m // BLOCK_RAYS,),
        in_specs=[table] * 4 + [ray] * 6,
        out_specs=[ray] * 6,
        out_shape=[plane(jnp.float32), plane(jnp.int32), plane(jnp.int32),
                   plane(jnp.float32), plane(jnp.float32), plane(jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=BLOCK_RAYS // 32, num_stages=1),
        interpret=interpret,
        name="rfx_bvh_closest_hit",
    )(*tables, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    nrm = jnp.stack([nx, ny, nz], axis=1)
    return t[:n], face[:n], idx[:n], nrm[:n]


def _walk_bvh(o, d, bvh, leaf_size, interpret):
    return _walk(pack_tables(bvh), o, d, n_nodes=bvh.aabb_min.shape[0],
                 leaf_size=leaf_size, interpret=interpret)


@partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def kernel_closest_hit(o, d, bvh: DeviceBVH, leaf_size, interpret):
    """(t, face, nrm) of each ray's closest hit. Straight-through custom VJP:
    cotangents reach o, d and the BVH's leaf triangles through the selected
    triangle's closed-form t; the folded normal is piecewise constant in
    (o, d) and carries none."""
    t, face, _, nrm = _walk_bvh(o, d, bvh, leaf_size, interpret)
    return t, face, nrm


def _kernel_fwd(o, d, bvh, leaf_size, interpret):
    t, face, idx, nrm = _walk_bvh(o, d, bvh, leaf_size, interpret)
    return (t, face, nrm), (o, d, bvh, idx, t)


def _kernel_bwd(leaf_size, interpret, res, cotangents):
    o, d, bvh, idx, t = res
    return closest_hit_vjp(o, d, bvh, idx, t, cotangents[0])


kernel_closest_hit.defvjp(_kernel_fwd, _kernel_bwd)


def make_triton_env_hit(flat: FlatBVH, differentiable_tris: bool = False,
                        interpret: bool = False):
    """env_hit(o, d, v0, e1, e2, normals) -> (t, face, nrm) through the GPU
    kernel.

    Default: the normal comes from the in-kernel fold (`normals` is ignored).
    differentiable_tris=True walks leaf triangles re-gathered from the live
    (v0, e1, e2) and rebuilds the normal from the hit face's edges, so vertex
    gradients flow through both t and the reflection direction; node boxes
    stay host-built (rebuild the BVH when vertices move materially, as for
    the jnp walk).
    """
    base = device_bvh(flat)
    cfg = (flat.leaf_size, interpret)

    if differentiable_tris:
        def env_hit(o, d, v0, e1, e2, normals):
            bvh = live_bvh(flat, base, v0, e1, e2)
            t, face, _ = kernel_closest_hit(o, d, bvh, *cfg)
            return t, face, hit_normal_from_edges(e1, e2, face)

        return env_hit

    def env_hit(o, d, v0, e1, e2, normals):
        return kernel_closest_hit(o, d, base, *cfg)

    return env_hit
