"""Oracle-parity tests: inject identical directions into the NumPy oracle and
the JAX tracer; CIRs must match (SURVEY.md 4, "Golden / parity")."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from oracle import OracleTracer, sample_sphere_directions
from rfx import physics
from rfx.cir import cir_from_trace, rx_power_dbm
from rfx.tracer import Scene, extract_paths, trace_to_rx

C = 2.998e8
RATE = 100e9
WINDOW = 200e-9
NBINS = int(WINDOW * RATE)

TX = np.array([10.0, 0.0, 5.0])
RX = np.array([-10.0, 0.0, 5.0])


def _jax_ir(mesh, dirs, max_bounces, rx_radius=1.0, rx_mode="icosphere", tx=TX, rx=RX):
    scene = Scene.from_mesh(mesh)
    result = trace_to_rx(
        scene, jnp.asarray(tx, jnp.float32), jnp.asarray(dirs), jnp.asarray(rx, jnp.float32),
        rx_radius, max_bounces=max_bounces, rx_mode=rx_mode,
    )
    ir = cir_from_trace(
        result, tx_power=1.0, num_rays=dirs.shape[0], nbins=NBINS,
        light_speed_mps=C, sample_rate_hz=RATE,
    )
    return result, np.asarray(ir)


def _oracle_ir(mesh, dirs, max_bounces, rx_radius=1.0, rx_mode="icosphere", tx=TX, rx=RX):
    tr = OracleTracer(mesh, C, RATE, WINDOW, max_bounces, rx_mode=rx_mode)
    return tr.compute_cir(tx, 1.0, rx, rx_radius, dirs)


@pytest.mark.parametrize("max_bounces", [1, 2, 4])
def test_cir_matches_oracle_box_room(box_room, max_bounces):
    dirs = sample_sphere_directions(4000, seed=42)
    paths, ir_o = _oracle_ir(box_room, dirs, max_bounces)
    result, ir_j = _jax_ir(box_room, dirs, max_bounces)
    assert int(result.captured.sum()) == len(paths)
    # Same nonzero bins, same amplitudes (f32 vs f64 tolerance).
    np.testing.assert_allclose(ir_j, ir_o, rtol=2e-4, atol=1e-9 * max(1.0, ir_o.max()))


def test_cir_matches_oracle_reference_room(room_mesh):
    """Parity on the actual reference room.stl (interior wall included)."""
    dirs = sample_sphere_directions(4000, seed=3)
    paths, ir_o = _oracle_ir(room_mesh, dirs, 3)
    result, ir_j = _jax_ir(room_mesh, dirs, 3)
    assert int(result.captured.sum()) == len(paths)
    np.testing.assert_allclose(ir_j, ir_o, rtol=2e-4, atol=1e-9 * max(1.0, ir_o.max()))


def test_analytic_rx_matches_oracle(box_room):
    dirs = sample_sphere_directions(3000, seed=9)
    paths, ir_o = _oracle_ir(box_room, dirs, 2, rx_mode="analytic")
    result, ir_j = _jax_ir(box_room, dirs, 2, rx_mode="analytic")
    assert int(result.captured.sum()) == len(paths)
    np.testing.assert_allclose(ir_j, ir_o, rtol=2e-4, atol=1e-9 * max(1.0, ir_o.max()))


def test_recorded_paths_match_oracle(box_room):
    dirs = sample_sphere_directions(1500, seed=21)
    o_paths, _ = _oracle_ir(box_room, dirs, 3)
    scene = Scene.from_mesh(box_room)
    result = trace_to_rx(
        scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs), jnp.asarray(RX, jnp.float32),
        1.0, max_bounces=3, rx_mode="icosphere", record_paths=True,
    )
    j_paths = extract_paths(TX, result)
    assert len(j_paths) == len(o_paths)
    # Paths come out in ray order in both implementations.
    for po, pj in zip(o_paths, j_paths):
        assert po.shape == pj.shape
        np.testing.assert_allclose(pj, po, rtol=1e-3, atol=2e-3)


def test_fresnel_jnp_matches_oracle():
    from oracle import fresnel_bounce_amplitude as oracle_fresnel

    angles = np.linspace(0.0, np.pi, 181)
    j = np.asarray(physics.fresnel_bounce_amplitude(jnp.asarray(angles)))
    o = oracle_fresnel(angles)
    np.testing.assert_allclose(j, o, rtol=1e-5, atol=1e-7)


def test_rx_power_dbm_matches_numpy(box_room):
    from oracle.oracle import rx_power_dbm as np_power

    dirs = sample_sphere_directions(4000, seed=5)
    _, ir = _oracle_ir(box_room, dirs, 4)
    dbm_np, sig_np = np_power(ir, WINDOW)
    dbm_j, sig_j = rx_power_dbm(jnp.asarray(ir, jnp.float32), WINDOW)
    # f32 conv vs f64 numpy conv: compare against signal scale, not pointwise
    # relative error (zero crossings amplify rtol meaninglessly).
    np.testing.assert_allclose(
        np.asarray(sig_j), sig_np, rtol=0, atol=5e-3 * np.abs(sig_np).max()
    )
    assert float(dbm_j) == pytest.approx(dbm_np, abs=0.05)


def test_padding_rays_do_not_contribute(box_room):
    dirs = sample_sphere_directions(1000, seed=8)
    scene = Scene.from_mesh(box_room)
    r1 = trace_to_rx(scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs),
                     jnp.asarray(RX, jnp.float32), 1.0, max_bounces=2)
    padded = jnp.concatenate([jnp.asarray(dirs), jnp.asarray(dirs[:24])])
    active = jnp.arange(1024) < 1000
    r2 = trace_to_rx(scene, jnp.asarray(TX, jnp.float32), padded,
                     jnp.asarray(RX, jnp.float32), 1.0, max_bounces=2, active=active)
    assert int(r2.captured[1000:].sum()) == 0
    np.testing.assert_array_equal(np.asarray(r1.captured), np.asarray(r2.captured[:1000]))
    np.testing.assert_allclose(np.asarray(r1.amplitude), np.asarray(r2.amplitude[:1000]))


@pytest.mark.parametrize("soft", [False, True])
def test_scatter_binning_matches_numpy_histogram(soft):
    """Binning drops uncaptured and out-of-window paths (they scatter to an
    out-of-range index) and otherwise equals an f64 NumPy histogram, in hard
    (truncating) and soft (linear-split) modes."""
    from rfx.cir import bin_impulse_response

    rng = np.random.default_rng(17)
    n, nbins = 100_000, 20_000
    amp = rng.random(n).astype(np.float32)
    dist = (rng.random(n) * 70.0).astype(np.float32)  # some past the 60 m window
    cap = rng.random(n) < 0.3
    got = np.asarray(bin_impulse_response(
        jnp.asarray(amp), jnp.asarray(dist), jnp.asarray(cap), soft=soft,
        nbins=nbins, light_speed_mps=C, sample_rate_hz=RATE))
    delay = dist / np.float32(C) * np.float32(RATE)  # f32, as the device computes it
    want = np.zeros(nbins)
    if soft:
        lo = np.floor(delay).astype(np.int64)
        w = delay - lo
        for b, wt in ((lo, 1.0 - w), (lo + 1, w)):
            ok = cap & (b >= 0) & (b < nbins)
            np.add.at(want, b[ok], (amp * wt)[ok])
    else:
        b = delay.astype(np.int64)
        ok = cap & (b < nbins)
        np.add.at(want, b[ok], amp[ok])
    assert got.shape == (nbins,)
    assert (dist / C * RATE >= nbins).any() and want.sum() > 0  # both branches exercised
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("rx_mode", ["analytic", "icosphere"])
def test_warp_quirk_compat_matches_oracle(box_room, rx_mode):
    """Strict Warp-kernel parity mode: the per-iteration ray_finished reset
    (ref kernel.py:58-59) means captured rays keep tracing and later captures
    overwrite; trace_to_rx(warp_quirk_compat=True) must match the oracle's
    quirk mode bin-for-bin (SURVEY.md 2.2)."""
    dirs = sample_sphere_directions(3000, seed=11)
    tr = OracleTracer(box_room, C, RATE, WINDOW, 4, rx_mode=rx_mode,
                      warp_quirk_compat=True)
    paths_o, ir_o = tr.compute_cir(TX, 1.0, RX, 1.5, dirs)
    scene = Scene.from_mesh(box_room)
    result = trace_to_rx(
        scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs),
        jnp.asarray(RX, jnp.float32), 1.5, max_bounces=4, rx_mode=rx_mode,
        warp_quirk_compat=True,
    )
    ir_j = np.asarray(cir_from_trace(
        result, tx_power=1.0, num_rays=dirs.shape[0], nbins=NBINS,
        light_speed_mps=C, sample_rate_hz=RATE,
    ))
    assert int(result.captured.sum()) == len(paths_o)
    # Pass-through re-captures are threshold events: a grazing chord whose
    # f32 entry point rounds to just OUTSIDE the sphere takes the tiny t0
    # re-entry instead of the t1 exit the f64 oracle takes (observed: one ray,
    # chord 0.1398 vs 2e-4, shifting one bin by 47 slots). Budget a couple of
    # such boundary flips; everything else must match bin-for-bin.
    mismatch = ~np.isclose(ir_j, ir_o, rtol=2e-4, atol=1e-9 * max(1.0, ir_o.max()))
    assert mismatch.sum() <= 4, f"{int(mismatch.sum())} mismatched bins"
    np.testing.assert_allclose(ir_j.sum(), ir_o.sum(), rtol=1e-3)
    # The quirk must actually bite on this workload (chord re-captures exist):
    # otherwise this test silently degenerates into the default-semantics one.
    res_default = trace_to_rx(
        scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs),
        jnp.asarray(RX, jnp.float32), 1.5, max_bounces=4, rx_mode=rx_mode,
    )
    d_q = np.asarray(result.distance)[np.asarray(result.captured)]
    d_d = np.asarray(res_default.distance)[np.asarray(res_default.captured)]
    assert not (d_q.shape == d_d.shape and np.allclose(d_q, d_d)), (
        "quirk mode produced identical captures to default mode - workload too easy"
    )
