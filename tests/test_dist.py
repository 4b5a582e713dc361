"""Sharded == single-device, bit-for-bit where possible (SURVEY.md 4,
"Distributed without a cluster": 8 fake CPU devices from conftest)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx.cir import cir_from_trace
from rfx.coverage import coverage_irs, make_grid
from rfx.parallel import make_mesh, sharded_cir, sharded_coverage_irs
from rfx.tracer import Scene, trace_to_rx

C = 2.998e8
RATE = 100e9
NBINS = int(100e-9 * RATE)
TX = np.array([5.0, 0.0, 5.0], np.float32)
RX = np.array([-8.0, 2.0, 4.0], np.float32)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (fake) devices")
    return jax.devices()[:8]


def test_sharded_cir_matches_single_device(box_room, eight_devices):
    dirs = jnp.asarray(sample_sphere_directions(4096, seed=31))
    scene = Scene.from_mesh(box_room)
    mesh = make_mesh({"rays": 8}, eight_devices)
    ir_sharded = sharded_cir(
        scene, TX, dirs, RX, 0.8, mesh,
        max_bounces=3, nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE,
    )
    result = trace_to_rx(scene, jnp.asarray(TX), dirs, jnp.asarray(RX), 0.8,
                         max_bounces=3, rx_mode="analytic")
    ir_single = cir_from_trace(result, tx_power=1.0, num_rays=4096, nbins=NBINS,
                               light_speed_mps=C, sample_rate_hz=RATE)
    np.testing.assert_allclose(np.asarray(ir_sharded), np.asarray(ir_single), rtol=1e-6, atol=1e-15)


def test_sharded_coverage_matches_single_device(box_room, eight_devices):
    dirs = jnp.asarray(sample_sphere_directions(2048, seed=13))
    scene = Scene.from_mesh(box_room)
    centers = jnp.asarray(make_grid(range(-12, 13, 6), [-6, 6], [2, 8]))  # 20 -> pad
    centers = centers[:16]
    mesh = make_mesh({"rays": 4, "rx": 2}, jax.devices()[:8])
    irs_sharded = sharded_coverage_irs(
        scene, TX, dirs, centers, 0.8, mesh,
        max_bounces=2, nbins=NBINS, light_speed_mps=C, sample_rate_hz=RATE, rx_batch=4,
    )
    irs_single = coverage_irs(
        scene, jnp.asarray(TX), dirs, centers, jnp.float32(0.8),
        max_bounces=2, nbins=NBINS, num_rays=2048,
        light_speed_mps=C, sample_rate_hz=RATE, rx_batch=4,
    )
    np.testing.assert_allclose(np.asarray(irs_sharded), np.asarray(irs_single), rtol=1e-6, atol=1e-15)


def test_determinism_two_runs_bit_identical(box_room):
    """SURVEY.md 5: determinism test instead of a sanitizer — scatter-adds via
    .at[].add are deterministic under XLA."""
    dirs = jnp.asarray(sample_sphere_directions(2000, seed=77))
    scene = Scene.from_mesh(box_room)

    def run():
        r = trace_to_rx(scene, jnp.asarray(TX), dirs, jnp.asarray(RX), 0.5,
                        max_bounces=4, rx_mode="analytic")
        return np.asarray(cir_from_trace(r, tx_power=1.0, num_rays=2000, nbins=NBINS,
                                         light_speed_mps=C, sample_rate_hz=RATE))

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)


def test_gradients_flow_through_shard_map(box_room, eight_devices):
    """Soft binning makes delay (hence tx position) gradients nonzero; with
    hard binning and a fixed direction set, d(sum ir)/d(tx) is legitimately
    zero in a box room (bend angles depend only on directions and wall
    normals). Use a delay-weighted loss under soft binning."""
    dirs = jnp.asarray(sample_sphere_directions(1024, seed=55))
    scene = Scene.from_mesh(box_room)
    mesh = make_mesh({"rays": 8}, eight_devices)
    bins = jnp.arange(NBINS, dtype=jnp.float32)

    def loss(tx):
        ir = sharded_cir(scene, tx, dirs, RX, 1.5, mesh,
                         max_bounces=2, nbins=NBINS, light_speed_mps=C,
                         sample_rate_hz=RATE, soft=True)
        return jnp.sum(ir * bins)

    g = jax.grad(loss)(jnp.asarray(TX))
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.any(np.asarray(g) != 0.0)


def test_inverse_step_collective_volume(box_room, eight_devices):
    """HLO-inspection invariant: one full sharded
    inverse-solve step must communicate ONLY via all-reduce, and only:
      - the partial-IR psum over 'rays' (f32 (M/rx_shards, nbins)) twice —
        once forward, once in the backward's recompute — and
      - two scalar psums (the 'rx' loss reduction and its cotangent).
    ~8 KB per step at this shape: the checked form of the "compute/comm
    > 1000:1" claim. Any new collective (all-gather of rays, vertex
    broadcast, ...) fails this test."""
    import re

    from jax.sharding import NamedSharding, PartitionSpec as P

    from rfx.solver import make_inverse_solver

    mesh = make_mesh({"rays": 4, "rx": 2}, eight_devices)
    scene = Scene.from_mesh(box_room)
    dirs = jnp.asarray(sample_sphere_directions(512, seed=0))
    rx_centers = jnp.asarray(
        np.stack([np.linspace(-10, 10, 8), np.zeros(8), np.full(8, 5.0)], axis=1),
        jnp.float32,
    )
    dirs = jax.device_put(dirs, NamedSharding(mesh, P("rays")))
    rx_centers = jax.device_put(rx_centers, NamedSharding(mesh, P("rx")))
    nbins = 256
    init_fn, step_fn = make_inverse_solver(
        scene, dirs, rx_centers, 1.0, jnp.zeros((8,), jnp.float32),
        max_bounces=2, nbins=nbins, sample_rate_hz=10e9, mesh=mesh,
    )
    params, opt_state = init_fn(tx0=[5.0, 0.0, 5.0])
    txt = jax.jit(step_fn).lower(params, opt_state).compile().as_text()

    for op in ("all-gather", "reduce-scatter", "collective-permute",
               "all-to-all", "collective-broadcast"):
        assert f" {op}(" not in txt, f"unexpected collective {op} in step HLO"
    shapes = re.findall(r"(\S+) all-reduce\(", txt)
    ir_shape = f"f32[4,{nbins}]{{1,0}}"
    n_ir = sum(1 for s in shapes if s == ir_shape)
    n_scalar = sum(1 for s in shapes if s.startswith("f32[]"))
    assert n_ir == 2, (n_ir, shapes)
    assert n_ir + n_scalar == len(shapes), f"unexpected all-reduce shapes: {shapes}"
    assert n_scalar <= 2, shapes
