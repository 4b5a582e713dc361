"""Facade tests: rfx.api.Tracer mirrors the reference Tracer call shape
(ref tracer.py:12, tracer.py:63) with on-device execution."""

import numpy as np

from oracle import OracleTracer, sample_sphere_directions
from rfx.api import Tracer

C = 2.998e8
RATE = 100e9
WINDOW = 200e-9


def test_compute_cir_matches_oracle(box_room):
    dirs = sample_sphere_directions(3000, seed=6)
    tx = np.array([10.0, 0.0, 5.0])
    rx = np.array([-10.0, 0.0, 5.0])
    # explicit icosphere: the oracle defaults to the reference's tessellated
    # receiver, and this test pins exact geometric parity with it
    t = Tracer(box_room, C, RATE, WINDOW, max_bounces=3, tx_num_rays=3000, rx_mode="icosphere")
    # record_paths explicitly: the default is now False (paths are a
    # viz-only cost), but this test pins path parity with the oracle.
    paths, ir = t.compute_cir(tx, 1.0, rx, 1.0, directions=dirs, record_paths=True)
    o = OracleTracer(box_room, C, RATE, WINDOW, 3)
    o_paths, o_ir = o.compute_cir(tx, 1.0, rx, 1.0, dirs)
    assert len(paths) == len(o_paths)
    np.testing.assert_allclose(ir, o_ir, rtol=2e-4, atol=1e-9 * max(1.0, o_ir.max()))
    # Paths are (k, 3) numpy arrays starting at TX, like the reference output.
    assert all(p.shape[1] == 3 for p in paths)
    assert all(np.allclose(p[0], tx) for p in paths)


def test_record_paths_auto(box_room):
    """record_paths="auto" (the default) keeps the reference's always-return-
    paths contract (ref tracer.py:90-97,121) for interactive batch sizes and
    skips recording above AUTO_PATHS_MAX_RAYS."""
    dirs = sample_sphere_directions(2048, seed=9)
    tx = np.array([10.0, 0.0, 5.0])
    rx = np.array([-10.0, 0.0, 5.0])
    t = Tracer(box_room, C, RATE, WINDOW, max_bounces=3, tx_num_rays=2048)
    paths, _ = t.compute_cir(tx, 1.0, rx, 1.0, directions=dirs)
    assert len(paths) > 0  # small batch: paths recorded like the reference
    try:
        t.AUTO_PATHS_MAX_RAYS = 1024  # shrink the bound instead of tracing 262k+ rays
        paths_big, ir_big = t.compute_cir(tx, 1.0, rx, 1.0, directions=dirs)
    finally:
        del t.AUTO_PATHS_MAX_RAYS  # restore the class attribute
    assert paths_big == [] and ir_big.sum() > 0  # big batch: recording skipped


def test_compute_cir_fresh_prng(box_room):
    t = Tracer(box_room, C, RATE, WINDOW, max_bounces=2, tx_num_rays=2048, seed=1)
    _, ir1 = t.compute_cir([0, 0, 5.0], 1.0, [5, 0, 5.0], 1.0, record_paths=False)
    _, ir2 = t.compute_cir([0, 0, 5.0], 1.0, [5, 0, 5.0], 1.0, record_paths=False)
    assert ir1.shape == (int(WINDOW * RATE),)
    assert ir1.sum() > 0
    # Fresh keys per call -> different Monte-Carlo realisations.
    assert not np.array_equal(ir1, ir2)


def test_compute_coverage_shape_and_power(box_room):
    dirs = sample_sphere_directions(2000, seed=4)
    t = Tracer(box_room, C, RATE, 100e-9, max_bounces=2, tx_num_rays=2000, rx_mode="analytic")
    centers = np.array([[5.0, 5.0, 5.0], [-5.0, -5.0, 2.0], [0.0, 0.0, 10.0]], np.float32)
    irs = t.compute_coverage([0, 0, 5.0], 1.0, centers, 0.5, directions=dirs)
    assert irs.shape == (3, int(100e-9 * RATE))
    dbm = t.rx_power_dbm(irs)
    assert dbm.shape == (3,)
    assert np.all(np.isfinite(dbm))
    assert np.all(dbm < 0)  # well below 1 mW
