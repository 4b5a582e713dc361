"""GPU traversal kernel (rfx.ops.gpu_trace): the kernel through the Pallas
interpreter against the brute intersector and the jnp walk, its wrapper's
padding and shapes, its gradient rule, and the facade's backend decision.
The compiled kernel is checked on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rfx.api import BRUTE_MAX_FACES, choose_backend
from rfx.geometry import make_terrain
from rfx.ops.gpu_trace import BLOCK_RAYS
from rfx.ops.intersect import is_hit, make_env_intersector, mesh_soa

TERRAIN = make_terrain(grid=16, extent=30.0, seed=7)


def _rays(n, seed, lo=(-15, -15, 0), hi=(15, 15, 15)):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _tris(mesh):
    return mesh_soa(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces))


@pytest.mark.parametrize("scene", ["room", "terrain"])
def test_kernel_interpret_matches_brute(scene, box_room):
    mesh = box_room if scene == "room" else TERRAIN
    tris = _tris(mesh)
    o, d = _rays(1024, 0, (-14, -14, 0.5), (14, 14, 14))
    tk, fk, nk = make_env_intersector("triton", mesh=mesh, interpret=True)(o, d, *tris)
    tb, fb, nb = make_env_intersector("brute")(o, d, *tris)
    hit = is_hit(tb)
    assert bool(jnp.all(is_hit(tk) == hit)) and int(hit.sum()) > 100
    assert bool(jnp.all(jnp.where(hit, fk, -1) == jnp.where(hit, fb, -1)))
    np.testing.assert_allclose(np.where(hit, tk, 0), np.where(hit, tb, 0), rtol=1e-5, atol=1e-5)
    # the in-kernel normal fold equals the brute path's edge-derived normal
    np.testing.assert_allclose(np.where(hit[:, None], nk, 0), np.where(hit[:, None], nb, 0),
                               atol=1e-6)


def test_kernel_selects_as_jnp_walk():
    """Same tree, same strict-< selection rule: identical faces; t to f32
    rounding (the jnp walk contracts with einsum, the kernel in scalar
    arithmetic)."""
    tris = _tris(TERRAIN)
    o, d = _rays(2048, 1)
    tk, fk, _ = make_env_intersector("triton", mesh=TERRAIN, interpret=True)(o, d, *tris)
    tv, fv, _ = make_env_intersector("bvh", mesh=TERRAIN)(o, d, *tris)
    np.testing.assert_array_equal(np.asarray(fk), np.asarray(fv))
    np.testing.assert_allclose(np.asarray(tk), np.asarray(tv), rtol=1e-6)


@pytest.mark.parametrize("n", [777, 33, 200, BLOCK_RAYS])
def test_wrapper_pads_and_slices(n):
    """Any batch size: padding rays up to a whole block are parked (miss)
    and sliced off."""
    tris = _tris(TERRAIN)
    o, d = _rays(n, 2)
    t, f, nrm = make_env_intersector("triton", mesh=TERRAIN, interpret=True)(o, d, *tris)
    assert t.shape == (n,) and f.shape == (n,) and nrm.shape == (n, 3)
    assert t.dtype == jnp.float32 and f.dtype == jnp.int32
    tb, fb, _ = make_env_intersector("brute")(o, d, *tris)
    np.testing.assert_array_equal(np.asarray(f), np.asarray(fb))


def test_kernel_multibounce_trace_matches_brute():
    """The bounce loop over the kernel (parked dead rays, re-queries from
    reflected states) reproduces the brute trace."""
    from rfx import sampler
    from rfx.tracer import Scene, trace_to_rx

    mesh = make_terrain(grid=16, extent=30.0, seed=3)
    scene = Scene.from_mesh(mesh)
    dirs = sampler.morton_sphere_directions(jax.random.PRNGKey(4), 2048)
    tx = jnp.asarray([2.0, 1.0, 9.0], jnp.float32)
    rx = jnp.asarray([-5.0, 2.0, 6.0], jnp.float32)
    kw = dict(max_bounces=3, rx_mode="analytic")
    rk = trace_to_rx(scene, tx, dirs, rx, 1.0,
                     env_hit=make_env_intersector("triton", mesh=mesh, interpret=True), **kw)
    rb = trace_to_rx(scene, tx, dirs, rx, 1.0, **kw)
    assert int(rb.captured.sum()) > 0
    assert bool(jnp.all(rk.captured == rb.captured))
    assert bool(jnp.all(rk.num_bounces == rb.num_bounces))
    np.testing.assert_allclose(rk.amplitude, rb.amplitude, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rk.distance, rb.distance, rtol=1e-5, atol=1e-4)


def test_kernel_vjp_matches_finite_difference():
    """Straight-through rule: d(t)/d(origin) through the kernel's custom VJP
    equals a central difference of the kernel's own forward."""
    env = make_env_intersector("triton", mesh=TERRAIN, interpret=True)
    tris = _tris(TERRAIN)
    o, d = _rays(256, 3, (-10, -10, 8), (10, 10, 12))
    d = d.at[:, 2].set(-jnp.abs(d[:, 2]) - 0.5)  # downward: most rays hit
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    w = jnp.asarray(np.random.default_rng(4).normal(size=256), jnp.float32)

    def loss(o_):
        t, _, _ = env(o_, d, *tris)
        return jnp.sum(jnp.where(is_hit(t), w * t, 0.0))

    g = np.asarray(jax.grad(loss)(o))
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    for a in range(3):
        e = jnp.zeros_like(o).at[:, a].set(1e-3)
        fd = (float(loss(o + e)) - float(loss(o - e))) / 2e-3
        assert abs(g[:, a].sum() - fd) < 0.02 * max(abs(fd), 1e-3), (a, g[:, a].sum(), fd)


@pytest.mark.parametrize("platform,faces,want", [
    ("cpu", BRUTE_MAX_FACES, "brute"),
    ("gpu", 44, "brute"),
    ("cpu", BRUTE_MAX_FACES + 1, "bvh"),
    ("gpu", 32_258, "triton"),
])
def test_choose_backend(platform, faces, want):
    assert choose_backend(platform, faces) == want


@pytest.fixture
def gpu_device():
    """The first GPU, decided at test time (never at import)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU visible (chip_smoke.py runs this check on the card)")
    return devs[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_brute_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        tris = _tris(TERRAIN)
        o, d = _rays(4096, 5)
        tk, fk, _ = jax.jit(make_env_intersector("triton", mesh=TERRAIN))(o, d, *tris)
        tb, fb, _ = jax.jit(make_env_intersector("brute"))(o, d, *tris)
        np.testing.assert_array_equal(np.asarray(fk), np.asarray(fb))
        np.testing.assert_allclose(np.asarray(tk), np.asarray(tb), rtol=1e-5)
