"""Coverage engine: trace-once-for-all-receivers must equal per-receiver
tracing (the restructure of ref coverage.py:38-43; SURVEY.md 7 step 4)."""

import numpy as np
import jax.numpy as jnp

from oracle import sample_sphere_directions
from rfx.cir import cir_from_trace
from rfx.coverage import coverage_irs, make_grid
from rfx.tracer import Scene, trace_to_rx

C = 2.998e8
RATE = 100e9
WINDOW = 100e-9
NBINS = int(WINDOW * RATE)
TX = np.array([5.0, 3.0, 5.0])


def _single_rx_ir(scene, dirs, rx, radius, max_bounces):
    result = trace_to_rx(
        scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs),
        jnp.asarray(rx, jnp.float32), radius, max_bounces=max_bounces,
        rx_mode="analytic",
    )
    return np.asarray(
        cir_from_trace(result, tx_power=1.0, num_rays=dirs.shape[0], nbins=NBINS,
                       light_speed_mps=C, sample_rate_hz=RATE)
    )


def test_coverage_equals_per_rx_trace(box_room):
    dirs = sample_sphere_directions(3000, seed=17)
    scene = Scene.from_mesh(box_room)
    centers = np.array(
        [[-10.0, 0.0, 5.0], [0.0, 8.0, 2.0], [7.0, -7.0, 9.0], [12.0, 12.0, 1.0], [0.0, 0.0, 15.0]],
        np.float32,
    )
    irs = coverage_irs(
        scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs), jnp.asarray(centers),
        jnp.float32(0.8), max_bounces=3, nbins=NBINS, num_rays=dirs.shape[0],
        light_speed_mps=C, sample_rate_hz=RATE, rx_batch=2,
    )
    irs = np.asarray(irs)
    assert irs.shape == (5, NBINS)
    for m, rx in enumerate(centers):
        ir_single = _single_rx_ir(scene, dirs, rx, 0.8, 3)
        np.testing.assert_allclose(irs[m], ir_single, rtol=1e-5, atol=1e-12)


def test_make_grid_matches_reference_sweep():
    g = make_grid(range(-15, 16, 2), range(-15, 16, 2), range(0, 16, 2))
    assert g.shape == (16 * 16 * 8, 3)  # 2048 points, ref coverage.py:38-40
    assert g.min() == -15 and g.max() == 15


def test_coverage_rx_batch_invariance(box_room):
    dirs = sample_sphere_directions(1000, seed=2)
    scene = Scene.from_mesh(box_room)
    centers = jnp.asarray(make_grid(range(-12, 13, 8), range(-12, 13, 8), [2, 8]))
    kw = dict(max_bounces=2, nbins=NBINS, num_rays=1000, light_speed_mps=C, sample_rate_hz=RATE)
    a = coverage_irs(scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs), centers, 0.5, rx_batch=1, **kw)
    b = coverage_irs(scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs), centers, 0.5, rx_batch=8, **kw)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_coverage_dbm_fast_matches_exact_shape_and_values(box_room):
    """Phasor fast path tracks the exact metric (documented tolerance: the
    'same'-convolution truncation makes them differ most under destructive
    interference; on a small room sweep the median gap stays well under 1 dB)."""
    import jax
    import jax.numpy as jnp

    from oracle import sample_sphere_directions
    from rfx.cir import rx_power_dbm
    from rfx.coverage import coverage_dbm_fast, coverage_irs, make_grid
    from rfx.tracer import Scene

    scene = Scene.from_mesh(box_room)
    n = 4096
    dirs = jnp.asarray(sample_sphere_directions(n, seed=77))
    centers = jnp.asarray(make_grid(range(-12, 13, 8), [-4, 4], [2, 8]))[:12]
    tx = jnp.asarray([3.0, 2.0, 2.0], jnp.float32)
    window = 200e-9
    rate = 10e9
    nbins = int(window * rate)

    irs = coverage_irs(
        scene, tx, dirs, centers, jnp.float32(1.5),
        max_bounces=2, nbins=nbins, num_rays=n,
        light_speed_mps=2.998e8, sample_rate_hz=rate, rx_batch=4,
    )
    exact, _ = rx_power_dbm(irs, window, 2.4e9)
    fast = coverage_dbm_fast(
        scene, tx, dirs, centers, jnp.float32(1.5),
        max_bounces=2, num_rays=n, sample_window_s=window,
        sample_rate_hz=rate, carrier_hz=2.4e9, rx_batch=4,
    )
    exact = np.asarray(exact)
    fast = np.asarray(fast)
    # -inf (nothing received) must agree exactly
    assert np.array_equal(np.isfinite(exact), np.isfinite(fast))
    ok = np.isfinite(exact)
    assert ok.sum() >= 6
    diff = np.abs(fast[ok] - exact[ok])
    assert np.median(diff) < 1.0, f"median {np.median(diff)} dB"
    assert diff.max() < 6.0, f"max {diff.max()} dB"


def test_coverage_dbm_hybrid_bounds_error(box_room):
    """The hybrid metric must cap the phasor path's worst-case error: every
    receiver's hybrid dBm within ~1.2 dB of exact (the pure-fast path errs by
    up to 15+ dB on this workload under destructive interference)."""
    import jax.numpy as jnp

    from rfx.cir import rx_power_dbm
    from rfx.coverage import coverage_dbm_hybrid

    scene = Scene.from_mesh(box_room)
    n = 8192
    dirs = jnp.asarray(sample_sphere_directions(n, seed=77))
    centers = jnp.asarray(make_grid(range(-12, 13, 6), range(-12, 13, 6), [2, 8]))
    tx = jnp.asarray([3.0, 2.0, 2.0], jnp.float32)
    window = 100e-9
    rate = 10e9
    nbins = int(window * rate)

    irs = coverage_irs(
        scene, tx, dirs, centers, jnp.float32(1.0),
        max_bounces=2, nbins=nbins, num_rays=n,
        light_speed_mps=2.998e8, sample_rate_hz=rate, rx_batch=10,
    )
    exact, _ = rx_power_dbm(irs, window)
    exact = np.asarray(exact)
    hybrid, n_flagged = coverage_dbm_hybrid(
        scene, tx, dirs, centers, jnp.float32(1.0),
        max_bounces=2, num_rays=n, sample_window_s=window, sample_rate_hz=rate,
        rx_batch=10,
    )
    ok = np.isfinite(exact)
    assert np.array_equal(ok, np.isfinite(hybrid))
    assert n_flagged > 0, "workload produced no flagged receivers - test degenerate"
    err = np.abs(hybrid[ok] - exact[ok])
    assert err.max() < 1.3, f"hybrid max err {err.max():.2f} dB"

    # Auto-selection: when the flag rate exceeds
    # exact_fallback_frac, every receiver goes through the exact engine —
    # the result must then match exact-everywhere to numerical noise.
    wholesale, n_flagged2 = coverage_dbm_hybrid(
        scene, tx, dirs, centers, jnp.float32(1.0),
        max_bounces=2, num_rays=n, sample_window_s=window, sample_rate_hz=rate,
        rx_batch=10, exact_fallback_frac=0.0,
    )
    assert n_flagged2 == n_flagged
    werr = np.abs(np.asarray(wholesale)[ok] - exact[ok])
    assert werr.max() < 1e-3, f"wholesale fallback diverges from exact: {werr.max()}"


def test_coverage_icosphere_mode_matches_per_rx_trace(box_room):
    """Strict-parity receiver tessellation in the coverage engine (the
    reference inherits the 80-face icosphere receiver in its coverage sweep
    via compute_cir, ref tracer.py:26-30): engine IRs must equal a per-
    receiver icosphere trace_to_rx."""
    dirs = sample_sphere_directions(2000, seed=23)
    scene = Scene.from_mesh(box_room)
    centers = np.array([[-10.0, 0.0, 5.0], [7.0, -7.0, 9.0]], np.float32)
    irs = np.asarray(coverage_irs(
        scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs),
        jnp.asarray(centers), jnp.float32(1.2), max_bounces=2, nbins=NBINS,
        num_rays=2000, light_speed_mps=C, sample_rate_hz=RATE, rx_batch=2,
        rx_mode="icosphere",
    ))
    for m, rx in enumerate(centers):
        result = trace_to_rx(
            scene, jnp.asarray(TX, jnp.float32), jnp.asarray(dirs),
            jnp.asarray(rx, jnp.float32), 1.2, max_bounces=2,
            rx_mode="icosphere",
        )
        ir_single = np.asarray(cir_from_trace(
            result, tx_power=1.0, num_rays=2000, nbins=NBINS,
            light_speed_mps=C, sample_rate_hz=RATE))
        np.testing.assert_allclose(irs[m], ir_single, rtol=1e-5, atol=1e-12)
    assert (irs != 0).any()
