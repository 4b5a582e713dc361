"""Gradient correctness: finite-difference checks (BASELINE.md: gradients of
TX pose / material index vs finite differences) and solver convergence."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx.ops.intersect import is_hit, ray_sphere_hit
from rfx.solver import InverseParams, coverage_irs_soft, make_inverse_solver
from rfx.tracer import Scene


def _scene(box_room):
    return Scene.from_mesh(box_room)


def test_sphere_hit_fd_origin_and_center(box_room, rng):
    n = 128
    c = np.asarray([-8.0, 0.0, 5.0])
    o = rng.uniform(-14, 14, (n, 3))
    # Aim well inside the sphere so no ray sits near the tangent boundary
    # (hit-set flips under FD steps would swamp the derivative).
    tgt = c + rng.normal(size=(n, 3)) * 0.35
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)

    def hits(c_):
        return np.asarray(is_hit(ray_sphere_hit(o, d, jnp.asarray(c_, jnp.float32), 1.3)))

    def f(o_, c_):
        t = ray_sphere_hit(o_, d, c_, 1.3)
        return jnp.sum(jnp.where(is_hit(t), t, 0.0))

    go, gc = jax.grad(f, argnums=(0, 1))(o, jnp.asarray(c, jnp.float32))
    eps = 1e-3
    for idx in [(0, 0), (17, 1), (90, 2)]:
        op = np.asarray(o).copy(); op[idx] += eps
        om = np.asarray(o).copy(); om[idx] -= eps
        fd = (f(jnp.asarray(op), jnp.asarray(c, jnp.float32))
              - f(jnp.asarray(om), jnp.asarray(c, jnp.float32))) / (2 * eps)
        # f32 forward + central differences: ~1e-2 relative noise floor
        assert abs(float(go[idx]) - float(fd)) < 6e-2 * max(abs(float(fd)), 1.0)
    for a in range(3):
        cp = c.copy(); cp[a] += eps
        cm = c.copy(); cm[a] -= eps
        assert (hits(cp) == hits(cm)).all(), "tangent flip — test setup invalid"
        fd = (f(o, jnp.asarray(cp, jnp.float32)) - f(o, jnp.asarray(cm, jnp.float32))) / (2 * eps)
        assert abs(float(gc[a]) - float(fd)) < 6e-2 * max(abs(float(fd)), 1.0)


def test_coverage_energy_tx_gradient_fd(box_room):
    """d(IR energy)/d(tx_pos) vs central differences through the full
    soft-binned trace (selection held fixed across the FD step by using a
    smooth region: the box room with a generous receiver)."""
    scene = _scene(box_room)
    dirs = jnp.asarray(sample_sphere_directions(2048, seed=11))
    rxc = jnp.asarray([[-6.0, -4.0, 5.0]], jnp.float32)

    def energy(tx):
        irs = coverage_irs_soft(
            scene.vertices, scene.faces, tx, 5.0, dirs, rxc, 2.0,
            num_rays=2048, max_bounces=2, nbins=512,
            light_speed_mps=2.998e8, sample_rate_hz=10e9,
        )
        return jnp.sum(irs * irs) * 1e12

    tx0 = jnp.asarray([4.0, 3.0, 6.0], jnp.float32)
    energy = jax.jit(energy)
    g = jax.jit(jax.grad(energy))(tx0)
    assert np.all(np.isfinite(np.asarray(g)))
    # eps must stay below the capture-set flip scale (~1e-2 here): the energy
    # is piecewise-smooth in tx and autodiff gives the fixed-capture-set
    # derivative. At eps=1e-3 the capture set is stable and FD agrees to a few
    # percent (f32 forward).
    eps = 1e-3
    for a in range(3):
        tp = np.asarray(tx0).copy(); tp[a] += eps
        tm = np.asarray(tx0).copy(); tm[a] -= eps
        fd = (float(energy(jnp.asarray(tp))) - float(energy(jnp.asarray(tm)))) / (2 * eps)
        ga = float(g[a])
        assert abs(ga - fd) < 0.08 * max(abs(fd), abs(ga)), (a, ga, fd)


def test_material_n1_gradient_fd(box_room):
    scene = _scene(box_room)
    dirs = jnp.asarray(sample_sphere_directions(2048, seed=12))
    rxc = jnp.asarray([[-6.0, -4.0, 5.0]], jnp.float32)

    def energy(n1):
        irs = coverage_irs_soft(
            scene.vertices, scene.faces, jnp.asarray([4.0, 3.0, 6.0]), n1,
            dirs, rxc, 2.0, num_rays=2048, max_bounces=2, nbins=512,
            light_speed_mps=2.998e8, sample_rate_hz=10e9,
        )
        return jnp.sum(irs * irs) * 1e12

    g = float(jax.grad(energy)(jnp.asarray(5.0)))
    eps = 1e-2
    fd = (float(energy(jnp.asarray(5.0 + eps))) - float(energy(jnp.asarray(5.0 - eps)))) / (2 * eps)
    # n1 only enters through the smooth Fresnel factor — selection never moves.
    assert np.isfinite(g) and abs(g - fd) < 0.05 * max(abs(fd), 1e-6), (g, fd)


def test_inverse_solver_reduces_loss(box_room):
    scene = _scene(box_room)
    dirs = jnp.asarray(sample_sphere_directions(4096, seed=13))
    rxc = jnp.asarray([[-6.0, 0.0, 5.0], [6.0, 0.0, 5.0]], jnp.float32)

    # Target: energies produced by tx at the true position
    true_tx = jnp.asarray([3.0, 0.0, 5.0])
    irs = coverage_irs_soft(
        scene.vertices, scene.faces, true_tx, 5.0, dirs, rxc, 2.5,
        num_rays=4096, max_bounces=2, nbins=512,
        light_speed_mps=2.998e8, sample_rate_hz=10e9,
    )
    target = jnp.sum(irs * irs, axis=1)

    # Adam's steps are ~lr each. Along the 3.3 m from tx0 to the true TX the
    # loss is flat for the first metre (1.90 -> 1.82) and steep near the
    # target, so 20 steps of 0.1 end on the plateau, where whether the last
    # sample lands above the first is ULP-sensitive. 40 steps of 0.25 reach
    # the steep part (the loss falls below 0.3 of its start).
    init_fn, step_fn = make_inverse_solver(
        scene, dirs, rxc, 2.5, target, max_bounces=2, nbins=512,
        sample_rate_hz=10e9, learning_rate=0.25,
    )
    params, opt_state = init_fn(tx0=[0.0, 1.0, 6.0])
    losses = []
    for _ in range(40):
        params, opt_state, loss = step_fn(params, opt_state)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.99 * losses[0], losses


@pytest.mark.parametrize("target_kind", ["traced", "zeros"])
def test_inverse_loss_scale(box_room, target_kind):
    """The loss is the energies' squared error relative to the target's mean
    energy (a zero target: unscaled), so its gradient does not shrink with
    the ray count and Adam's first step moves every TX component by ~lr."""
    scene = _scene(box_room)
    n = 1024
    dirs = jnp.asarray(sample_sphere_directions(n, seed=13))
    rxc = jnp.asarray([[-6.0, 0.0, 5.0], [6.0, 0.0, 5.0]], jnp.float32)
    kw = dict(num_rays=n, max_bounces=2, nbins=512, light_speed_mps=2.998e8,
              sample_rate_hz=10e9)

    def energies(tx):
        irs = coverage_irs_soft(scene.vertices, scene.faces, jnp.asarray(tx, jnp.float32), 4.0,
                                dirs, rxc, 2.5, **kw)
        return np.asarray(jnp.sum(irs * irs, axis=1), np.float64)

    target = energies([3.0, 0.0, 5.0]) if target_kind == "traced" else np.zeros(2)
    init_fn, step_fn = make_inverse_solver(
        scene, dirs, rxc, 2.5, jnp.asarray(target, jnp.float32), max_bounces=2, nbins=512,
        sample_rate_hz=10e9, learning_rate=0.05,
    )
    tx0 = [0.0, 1.0, 6.0]
    params, opt_state = init_fn(tx0=tx0, n1_0=4.0)
    new, _, loss = step_fn(params, opt_state)
    scale = target.mean() if target.any() else 1.0
    want = np.mean(((energies(tx0) - target) / scale) ** 2)
    np.testing.assert_allclose(float(loss), want, rtol=1e-4)
    if target_kind == "traced":
        assert 0.1 < float(loss) < 100.0, float(loss)
        np.testing.assert_allclose(np.abs(np.asarray(new.tx_pos - params.tx_pos)), 0.05,
                                   rtol=1e-3)


@pytest.mark.parametrize("backend", ["brute", "bvh", "triton"])
def test_vertex_gradient_fd(box_room, backend):
    """d(loss)/d(vertices) vs a central-difference directional derivative
    through every intersector backend (BASELINE.md: vertex-position gradients
    allclose to finite differences; ref tracer.py:22-24 geometry-as-data).

    Loss = sum over captured rays of amplitude * distance: distance exercises
    the closed-form-t vertex VJP, amplitude (Fresnel of the bend angle)
    exercises the hit-normal vertex VJP. The box room keeps FD honest: rays
    crossing a moved edge flip between coplanar wall triangles, which leaves
    the path unchanged.
    """
    from rfx.ops.intersect import make_env_intersector
    from rfx.tracer import trace_to_rx

    scene = _scene(box_room)
    if backend == "brute":
        env_hit = make_env_intersector("brute")
    elif backend == "bvh":
        env_hit = make_env_intersector("bvh", mesh=box_room, differentiable_tris=True)
    else:
        env_hit = make_env_intersector(
            "triton", mesh=box_room, differentiable_tris=True, interpret=True
        )

    n = 2048
    dirs = jnp.asarray(sample_sphere_directions(n, seed=21))
    tx = jnp.asarray([4.0, 3.0, 6.0], jnp.float32)
    rxp = jnp.asarray([-6.0, -4.0, 5.0], jnp.float32)

    def loss(vertices):
        r = trace_to_rx(
            Scene(vertices, scene.faces), tx, dirs, rxp, 2.0,
            max_bounces=2, rx_mode="analytic", env_hit=env_hit,
        )
        return jnp.sum(jnp.where(r.captured, r.amplitude * r.distance, 0.0))

    v0 = scene.vertices
    g = jax.jit(jax.grad(loss))(v0)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.sum(jnp.abs(g))) > 0.0, "vertex gradient is identically zero"

    # Directional derivative along a fixed random perturbation of ALL
    # vertices vs <grad, u>.
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.normal(size=v0.shape), jnp.float32)
    u = u / jnp.linalg.norm(u)
    eps = 2e-3
    lp = float(loss(v0 + eps * u))
    lm = float(loss(v0 - eps * u))
    fd = (lp - lm) / (2 * eps)
    ad = float(jnp.vdot(g, u))
    assert abs(ad - fd) < 0.08 * max(abs(fd), abs(ad), 1e-3), (backend, ad, fd)


def test_inverse_solver_vertex_leaf_descends(box_room):
    """Geometry as an optimizable leaf (InverseParams.vertices): the solver
    loss must be differentiable in the vertices, and a line-searched step
    along -grad must reduce it (optimizer-free check — Adam dynamics at
    tiny loss scales oscillate and would make the assertion flaky)."""
    scene = _scene(box_room)
    dirs = jnp.asarray(sample_sphere_directions(2048, seed=15))
    rxc = jnp.asarray([[-6.0, 0.0, 5.0], [6.0, 0.0, 5.0]], jnp.float32)

    from rfx.solver import coverage_irs_soft as cis

    def energies(verts):
        irs = cis(
            verts, scene.faces, jnp.asarray([3.0, 0.0, 5.0]), 5.0,
            dirs, rxc, 2.5, num_rays=2048, max_bounces=2, nbins=512,
            light_speed_mps=2.998e8, sample_rate_hz=10e9,
        )
        return jnp.sum(irs * irs, axis=1)

    target = energies(scene.vertices)

    @jax.jit
    def loss(verts):
        return jnp.mean((energies(verts) - target) ** 2) * 1e18  # scale out of denormals

    rng = np.random.default_rng(7)
    v0 = jnp.asarray(
        np.asarray(scene.vertices) + rng.normal(scale=0.4, size=scene.vertices.shape),
        jnp.float32,
    )
    l0, g = jax.value_and_grad(loss)(v0)
    assert np.isfinite(float(l0)) and float(l0) > 0
    assert np.all(np.isfinite(np.asarray(g))) and float(jnp.sum(jnp.abs(g))) > 0
    # line search along -grad: some step size must descend
    descended = False
    gn = g / jnp.linalg.norm(g)
    for eta in (1e-3, 1e-2, 1e-1):
        if float(loss(v0 - eta * gn)) < float(l0):
            descended = True
            break
    assert descended, float(l0)

    # smoke: the optimizer path accepts and updates the vertex leaf
    init_fn, step_fn = make_inverse_solver(
        scene, dirs, rxc, 2.5, target, max_bounces=2, nbins=512,
        sample_rate_hz=10e9, learning_rate=0.01,
    )
    params, opt_state = init_fn(tx0=[3.0, 0.0, 5.0], vertices0=v0)
    params, opt_state, l = step_fn(params, opt_state)
    assert np.isfinite(float(l))
    assert float(jnp.max(jnp.abs(params.vertices - v0))) > 0
