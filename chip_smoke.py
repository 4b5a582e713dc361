"""Smoke run of rfx's main path on the GPU, through the entry points users call.

    python chip_smoke.py                # one card: every single-card phase
    python chip_smoke.py --four-cards   # four cards: the sharded phases only

Phases (one card): device, traversal parity, trace parity and oracle, flagship
CIR (Tracer and `rfx.cli cir`), reference coverage (exact/fast/hybrid and
`rfx.cli coverage`), gradients, inverse step. With --four-cards: sharded_cir
over a ('rays',) mesh and one sharded inverse step on a 2x2 ('rays', 'rx')
mesh, each against its single-device result.

Each phase prints one line with its result and wall time; a failed check
raises, so the script exits non-zero and prints no final line. The last line
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Exits non-zero, printing no result, when JAX finds no GPU. One process drives
the card(s); the CLI phases run in-process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

C = 2.998e8
TX = (10.0, 0.0, 20.0)  # rfx/config.py TraceConfig
RX = (-10.0, 0.0, 20.0)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload sizes; the defaults are the deployments users run."""

    terrain_grid: int = 128  # 32,258 triangles: the flagship scene
    cli_scene: str = "terrain"
    parity_rays: int = 262_144
    oracle_rays: int = 65_536
    flagship_rays: int = 5_242_880
    coverage_rays: int = 1_000_000
    coverage_step: float = 2.0  # receiver grid pitch (m): 2,048 receivers
    grad_rays: int = 2048
    grad_terrain_rays: int = 16_384
    inverse_rays: int = 1_048_576
    inverse_rx: int = 64


# CPU rehearsal sizes (tests/test_chip_smoke.py).
TINY = Sizes(terrain_grid=16, cli_scene="terrain-small", parity_rays=2048, oracle_rays=512,
             flagship_rays=4096, coverage_rays=4096, coverage_step=10.0, grad_rays=512,
             grad_terrain_rays=1024, inverse_rays=2048, inverse_rx=4)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _platform() -> str:
    import jax

    return jax.devices()[0].platform


def _terrain(s: Sizes):
    from rfx.geometry import make_terrain

    return make_terrain(grid=s.terrain_grid, extent=60.0, seed=0)


def _kernel_env(mesh=None, **kw):
    """The GPU traversal kernel; its interpreter off the GPU (rehearsal)."""
    from rfx.ops.intersect import make_env_intersector

    return make_env_intersector("triton", mesh=mesh, interpret=_platform() != "gpu", **kw)


def _auto_env(mesh, **kw):
    """The intersector the facade's one decision picks for `mesh`."""
    from rfx.api import choose_backend
    from rfx.ops.intersect import make_env_intersector

    return make_env_intersector(choose_backend(_platform(), mesh.num_faces), mesh=mesh, **kw)


def _near(a, b, rel=1e-6):
    return np.abs(a - b) <= rel * np.maximum(np.abs(b), 1.0)


def compare_hits(kernel_out, brute_out) -> tuple[int, int]:
    """Kernel vs brute closest hits. Faces must agree except at exact ties
    (both t within 1e-6 relative: two triangles sharing the hit point); t and
    the unit normal agree to rtol 1e-5 — the same f32 Moller-Trumbore formula
    compiled twice (Triton may contract to FMAs, XLA fuses its own way)
    differs by a few ulps in det and qvec, and 1e-5 leaves room for the
    ill-conditioned grazing hits. Returns (hits, ties)."""
    from rfx.ops.intersect import is_hit

    tk, fk, nk = (np.asarray(x) for x in kernel_out)
    tb, fb, nb = (np.asarray(x) for x in brute_out)
    hit, hk = np.asarray(is_hit(tb)), np.asarray(is_hit(tk))
    same = fk == fb
    tie = hit & hk & ~same & _near(tk, tb)
    bad = (hk != hit) | (hit & ~same & ~tie)
    assert not bad.any(), f"{int(bad.sum())} rays disagree beyond ties (of {len(tb)})"
    ok = hit & same
    np.testing.assert_allclose(tk[ok], tb[ok], rtol=1e-5)
    np.testing.assert_allclose(nk[ok], nb[ok], rtol=1e-5, atol=1e-6)
    return int(hit.sum()), int(tie.sum())


def phase_traversal(s: Sizes) -> str:
    """One closest-hit query, kernel vs brute, both on the device: primary
    Morton rays from TX, and scattered rays (random origins above the
    terrain, random directions) like later bounces."""
    import jax
    import jax.numpy as jnp

    from rfx.ops.intersect import make_env_intersector, mesh_soa
    from rfx.sampler import morton_sphere_directions

    mesh = _terrain(s)
    tris = mesh_soa(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces))
    kern = jax.jit(_kernel_env(mesh))
    brute = jax.jit(make_env_intersector("brute"))
    n = s.parity_rays
    d0 = morton_sphere_directions(jax.random.PRNGKey(1), n)
    rng = np.random.default_rng(2)
    d1 = rng.normal(size=(n, 3))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    sets = {
        "primary": (jnp.broadcast_to(jnp.asarray(TX, jnp.float32), d0.shape), d0),
        "scattered": (jnp.asarray(rng.uniform([-30, -30, 0], [30, 30, 20], (n, 3)), jnp.float32),
                      jnp.asarray(d1, jnp.float32)),
    }
    out = []
    for name, (o, d) in sets.items():
        hits, ties = compare_hits(kern(o, d, *tris), brute(o, d, *tris))
        out.append(f"{name} {n} rays: {hits} hits, {ties} ties")
    return f"terrain {mesh.num_faces} tris; " + "; ".join(out)


def _tie_rays(env_k, env_b, tris, tx, dirs, rx, radius, bounces):
    """Replay rays along the brute path, querying both intersectors at every
    bounce: True where some bounce had a tie (kernel and brute faces differ at
    t within 1e-6, or the environment t is within 1e-6 of the receiver t)."""
    import jax.numpy as jnp

    from rfx import physics
    from rfx.ops.intersect import is_hit, ray_sphere_hit

    pos = jnp.broadcast_to(jnp.asarray(tx, jnp.float32), dirs.shape)
    d = dirs
    alive = np.ones(dirs.shape[0], bool)
    tie = np.zeros(dirs.shape[0], bool)
    for _ in range(bounces):
        tk, fk, _ = (np.asarray(x) for x in env_k(pos, d, *tris))
        tb, fb, nb = env_b(pos, d, *tris)
        tb = np.asarray(tb)
        trx = np.asarray(ray_sphere_hit(pos, d, jnp.asarray(rx, jnp.float32), radius))
        rx_hit = np.asarray(is_hit(trx))
        tie |= alive & (((fk != np.asarray(fb)) & _near(tk, tb))
                        | (rx_hit & (_near(tk, trx) | _near(tb, trx))))
        bounce = alive & ~(rx_hit & (tb > trx)) & np.asarray(is_hit(tb))
        b = jnp.asarray(bounce)[:, None]
        pos = jnp.where(b, pos + d * jnp.asarray(tb)[:, None], pos)
        d = jnp.where(b, physics.reflect(d, nb), d)
        alive = bounce
    return tie


def phase_trace(s: Sizes) -> str:
    """Full 4-bounce trace through the kernel vs brute on the terrain, then
    the facade's IR vs the NumPy oracle on the room."""
    import jax
    import jax.numpy as jnp

    from oracle import OracleTracer, sample_sphere_directions
    from rfx.api import Tracer
    from rfx.cir import cir_from_trace
    from rfx.geometry import make_room
    from rfx.ops.intersect import make_env_intersector, mesh_soa
    from rfx.sampler import morton_sphere_directions
    from rfx.tracer import Scene, trace_to_rx

    mesh = _terrain(s)
    scene = Scene.from_mesh(mesh)
    n, radius, bounces = s.parity_rays, 1.0, 4
    dirs = morton_sphere_directions(jax.random.PRNGKey(3), n)
    env_k, env_b = _kernel_env(mesh), make_env_intersector("brute")
    tx, rx = jnp.asarray(TX, jnp.float32), jnp.asarray(RX, jnp.float32)
    run = jax.jit(lambda env: trace_to_rx(scene, tx, dirs, rx, radius, max_bounces=bounces,
                                          rx_mode="analytic", env_hit=env),
                  static_argnums=0)
    rk, rb = run(env_k), run(env_b)
    ck, cb = np.asarray(rk.captured), np.asarray(rb.captured)
    diff = np.nonzero(ck != cb)[0]
    assert len(diff) <= 64, f"{len(diff)} capture mismatches"
    if len(diff):
        tris = mesh_soa(scene.vertices, scene.faces)
        ties = _tie_rays(jax.jit(env_k), jax.jit(env_b), tris, TX, dirs[diff], RX, radius,
                         bounces)
        assert ties.all(), f"capture mismatches not explained by ties: {diff[~ties]}"
    both = ck & cb
    nb_k, nb_b = np.asarray(rk.num_bounces), np.asarray(rb.num_bounces)
    assert (nb_k[both] == nb_b[both]).all(), "bounce counts differ on shared captures"
    # Per path: the same segments, so amplitude and length agree to f32
    # rounding: up to four segments, each t within the 1e-5 of
    # compare_hits, reflected into the next; rtol 1e-4 as for the IR.
    dk, db = np.asarray(rk.distance)[both], np.asarray(rb.distance)[both]
    np.testing.assert_allclose(dk, db, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(rk.amplitude)[both], np.asarray(rb.amplitude)[both],
                               rtol=1e-4)
    # A 100 GHz bin is 3 mm of path: a path within rounding of a bin edge
    # lands in the neighbouring bin. Those edge ties leave both IRs.
    kw = dict(tx_power=1.0, num_rays=n, nbins=20_000, light_speed_mps=C, sample_rate_hz=100e9)
    bin_of = lambda dist: (dist / C * kw["sample_rate_hz"]).astype(np.int64)
    same_bin = np.zeros_like(both)
    same_bin[both] = bin_of(dk) == bin_of(db)
    edge = int(both.sum() - same_bin.sum())
    keep = jnp.asarray(same_bin)
    ir_k = np.asarray(cir_from_trace(rk._replace(captured=keep), **kw))
    ir_b = np.asarray(cir_from_trace(rb._replace(captured=keep), **kw))
    assert ir_b.sum() > 0, "trace parity workload captured nothing"
    # rtol 1e-4: per-path amplitudes agree to ~1e-6 and atomic scatter-add
    # sums a bin in run-dependent order.
    np.testing.assert_allclose(ir_k, ir_b, rtol=1e-4, atol=1e-6 * np.abs(ir_b).max())
    trace_msg = (f"terrain {n} rays x {bounces} bounces: captured {int(cb.sum())} (brute) "
                 f"{int(ck.sum())} (kernel), {len(diff)} tie flips, {edge} bin-edge ties")

    room = make_room()
    m = s.oracle_rays
    odirs = sample_sphere_directions(m, seed=6)
    otx, orx = np.array([10.0, 0.0, 5.0]), np.array([-10.0, 0.0, 5.0])
    tracer = Tracer(room, C, 100e9, 200e-9, max_bounces=3, tx_num_rays=m)
    paths, ir = tracer.compute_cir(otx, 1.0, orx, 1.0, directions=odirs, record_paths=True)
    o_paths, o_ir = OracleTracer(room, C, 100e9, 200e-9, 3, rx_mode="analytic").compute_cir(
        otx, 1.0, orx, 1.0, odirs)
    assert len(paths) == len(o_paths), (len(paths), len(o_paths))
    # rtol 2e-4: f32 device amplitudes vs the f64 oracle, summed per bin.
    np.testing.assert_allclose(ir, o_ir, rtol=2e-4, atol=1e-9 * max(1.0, o_ir.max()))
    return f"{trace_msg}; oracle room {m} rays: {len(paths)} paths, IR allclose"


def phase_flagship(s: Sizes) -> str:
    """The flagship CIR through Tracer(backend="auto") and `rfx.cli cir`."""
    from rfx import cli
    from rfx.api import Tracer

    mesh = _terrain(s)
    tracer = Tracer(mesh, max_bounces=4, tx_num_rays=s.flagship_rays)
    if _platform() == "gpu":
        assert tracer.backend == "triton", tracer.backend
    out = []
    for radius in (0.1, 1.0):
        for _ in ("first call", "warm call"):
            t0 = time.perf_counter()
            _, ir = tracer.compute_cir(TX, 1.0, RX, radius, record_paths=False)
            dt = time.perf_counter() - t0
        assert ir.shape == (tracer.nbins,) and np.isfinite(ir).all()
        dbm = float(tracer.rx_power_dbm(ir))
        # The reference's 0.1 m receiver catches ~1e-5 of the rays: only the
        # 1.0 m one must capture at every size.
        assert ir.sum() > 0 or radius < 1.0, "flagship IR captured nothing"
        assert np.isfinite(dbm) or ir.sum() == 0
        out.append(f"r={radius}: {dbm:.2f} dBm, warm {dt:.3f} s")
    rc = cli.main(["cir", "--scene", s.cli_scene, "--rays", str(s.flagship_rays),
                   "--bounces", "4", "--no-viz"])
    assert rc == 0
    return (f"{s.flagship_rays} rays x 4 bounces, {tracer.nbins} bins, backend "
            f"{tracer.backend}: " + "; ".join(out) + "; rfx.cli cir rc 0")


def phase_coverage(s: Sizes) -> str:
    """The reference coverage deployment (2,048 receivers, 1 M rays, 2
    bounces, 100 ns) through Tracer: exact, fast and hybrid; then the CLI."""
    import jax

    from rfx import cli
    from rfx.api import Tracer
    from rfx.config import CoverageConfig, resolve_scene
    from rfx.sampler import morton_sphere_directions

    step = s.coverage_step
    cfg = CoverageConfig(num_rays=s.coverage_rays, grid_x=(-15.0, 15.0, step),
                         grid_y=(-15.0, 15.0, step), grid_z=(0.0, 14.0, step))
    grid = cfg.grid_points()
    tracer = Tracer(resolve_scene(cfg.scene), cfg.light_speed_mps, cfg.sample_rate_hz,
                    cfg.sample_window_s, cfg.max_bounces, cfg.num_rays, rx_mode="analytic")
    # One ray set for the three metrics, so they differ by the metric alone.
    dirs = morton_sphere_directions(jax.random.PRNGKey(5), cfg.num_rays)
    args = (cfg.tx_pos, cfg.tx_power, grid, cfg.rx_radius)
    kw = dict(directions=dirs, rx_batch=cfg.rx_batch)
    t = {}
    for _ in ("first call", "warm call"):
        t0 = time.perf_counter()
        exact = tracer.rx_power_dbm(tracer.compute_coverage(*args, **kw))
        t["exact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = tracer.compute_coverage_dbm_fast(*args, **kw)
    t["fast"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hybrid, n_flagged = tracer.compute_coverage_dbm_hybrid(*args, **kw)
    t["hybrid"] = time.perf_counter() - t0
    assert exact.shape == fast.shape == hybrid.shape == (grid.shape[0],)
    reached = np.isfinite(exact)
    assert reached.any() and not np.isnan(exact).any()
    assert (np.isfinite(fast) == reached).all() and (np.isfinite(hybrid) == reached).all()
    fast_err = float(np.median(np.abs(fast[reached] - exact[reached])))
    hyb_err = float(np.max(np.abs(hybrid[reached] - exact[reached])))
    # Bounds from the metrics' documented accuracy on the room sweep: fast
    # median 0.27 dB; hybrid max 1.13 dB on unflagged receivers, exact on
    # flagged ones. 1 dB and 1.3 dB (tests/test_coverage.py) leave room for
    # the ray count.
    assert fast_err < 1.0, f"fast vs exact median {fast_err:.2f} dB"
    assert hyb_err < 1.3, f"hybrid vs exact max {hyb_err:.2f} dB"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "coverage.json")
        with open(path, "w") as f:
            f.write(cfg.to_json())
        rc = cli.main(["coverage", "--config", path, "--no-viz"])
    assert rc == 0
    return (f"{grid.shape[0]} receivers x {s.coverage_rays} rays: {int(reached.sum())} reached; "
            f"exact {t['exact']:.2f} s warm, fast {t['fast']:.2f} s (median |d| {fast_err:.2f} dB), "
            f"hybrid {t['hybrid']:.2f} s ({n_flagged} flagged, max |d| {hyb_err:.2f} dB); "
            "rfx.cli coverage rc 0")


def phase_gradients(s: Sizes) -> str:
    """Gradients through the kernel: vertex and tx FD on the room, IR-loss
    kernel vs brute, n1 FD and vertex cross-check on the terrain."""
    import jax
    import jax.numpy as jnp

    from oracle import sample_sphere_directions
    from rfx.cir import cir_from_trace
    from rfx.geometry import make_room
    from rfx.ops.intersect import make_env_intersector
    from rfx.tracer import Scene, trace_to_rx

    done = []
    room = make_room()
    scene = Scene.from_mesh(room)
    dirs = jnp.asarray(sample_sphere_directions(s.grad_rays, seed=21))
    tx0 = jnp.asarray([4.0, 3.0, 6.0], jnp.float32)
    rxp = jnp.asarray([-6.0, -4.0, 5.0], jnp.float32)

    # 1. Vertex FD (differentiable-tris kernel). 8%: a central difference
    # over a 2e-3 step of all vertices, f32 sums of ~1e3 paths.
    env_dt = _kernel_env(room, differentiable_tris=True)

    @jax.jit
    def loss_v(vertices):
        r = trace_to_rx(Scene(vertices, scene.faces), tx0, dirs, rxp, 2.0,
                        max_bounces=2, rx_mode="analytic", env_hit=env_dt)
        return jnp.sum(jnp.where(r.captured, r.amplitude * r.distance, 0.0))

    v0 = scene.vertices
    g = jax.jit(jax.grad(loss_v))(v0)
    assert np.isfinite(np.asarray(g)).all() and float(jnp.abs(g).sum()) > 0
    u = jnp.asarray(np.random.default_rng(5).normal(size=v0.shape), jnp.float32)
    u = u / jnp.linalg.norm(u)
    fd = (float(loss_v(v0 + 2e-3 * u)) - float(loss_v(v0 - 2e-3 * u))) / 4e-3
    ad = float(jnp.vdot(g, u))
    assert abs(ad - fd) < 0.08 * max(abs(fd), abs(ad), 1e-3), ("vertex", ad, fd)
    done.append(f"room vertex ad {ad:.4g} fd {fd:.4g}")

    # 2. TX FD on a loss linear in (distance, amplitude): no binning kinks,
    # FD-stable; 8% as above.
    env_nd = _kernel_env(room)
    rng = np.random.default_rng(7)
    w = jnp.asarray(rng.normal(size=(s.grad_rays,)), jnp.float32)
    uw = jnp.asarray(rng.normal(size=(s.grad_rays,)), jnp.float32)

    @jax.jit
    def loss_tx(txp):
        r = trace_to_rx(scene, txp, dirs, rxp, 2.0, max_bounces=2, rx_mode="analytic",
                        env_hit=env_nd)
        return jnp.sum(r.captured.astype(jnp.float32) * (w * r.distance + 10.0 * uw * r.amplitude))

    gtx = np.asarray(jax.jit(jax.grad(loss_tx))(tx0))
    assert np.isfinite(gtx).all()
    for a in range(3):
        e = np.zeros(3, np.float32)
        e[a] = 1e-3
        fd = (float(loss_tx(tx0 + e)) - float(loss_tx(tx0 - e))) / 2e-3
        assert abs(gtx[a] - fd) < 0.08 * max(abs(fd), abs(gtx[a]), 1e-3), ("tx", a, gtx[a], fd)
    done.append("room tx FD x3")

    # 3. Soft-binned IR loss (kinked, so not FD-able): kernel AD vs brute
    # AD on the same graph, 3% (bin-edge f32 differences between backends).
    def make_loss_ir(env):
        @jax.jit
        def loss_ir(txp):
            r = trace_to_rx(scene, txp, dirs, rxp, 2.0, max_bounces=2, rx_mode="analytic",
                            env_hit=env)
            ir = cir_from_trace(r, tx_power=5.0, num_rays=s.grad_rays, nbins=512,
                                light_speed_mps=C, sample_rate_hz=10e9, soft=True)
            return jnp.sum(ir * ir) * 1e12

        return loss_ir

    g_k = np.asarray(jax.jit(jax.grad(make_loss_ir(env_nd)))(tx0))
    g_b = np.asarray(jax.jit(jax.grad(make_loss_ir(make_env_intersector("brute"))))(tx0))
    assert np.isfinite(g_k).all()
    rel = float(np.max(np.abs(g_k - g_b) / np.maximum(np.abs(g_b), 1e-3)))
    assert rel < 0.03, ("IR loss", g_k, g_b)
    done.append(f"room IR-loss kernel vs brute rel {rel:.1e}")

    # 4. Terrain n1: FD (5%; n1 moves no hit selection) and the
    # differentiable-tris kernel agreeing with the plain one (2%).
    terr = _terrain(s)
    tscene = Scene.from_mesh(terr)
    tdirs = jnp.asarray(sample_sphere_directions(s.grad_terrain_rays, seed=33))
    ttx = jnp.asarray([10.0, 0.0, 25.0], jnp.float32)
    trx = jnp.asarray([-10.0, 0.0, 8.0], jnp.float32)
    env_t, env_t_dt = _kernel_env(terr), _kernel_env(terr, differentiable_tris=True)

    def make_loss_n1(env):
        @jax.jit
        def loss_n1(n1):
            r = trace_to_rx(tscene, ttx, tdirs, trx, 1.5, max_bounces=3, rx_mode="analytic",
                            env_hit=env, n1=n1)
            return jnp.sum(jnp.where(r.captured, r.amplitude, 0.0)) * 1e3

        return loss_n1

    loss_n1 = make_loss_n1(env_t)
    g_n1 = float(jax.jit(jax.grad(loss_n1))(jnp.float32(5.0)))
    fd_n1 = (float(loss_n1(jnp.float32(5.01))) - float(loss_n1(jnp.float32(4.99)))) / 0.02
    assert np.isfinite(g_n1) and g_n1 != 0.0
    assert abs(g_n1 - fd_n1) < 0.05 * max(abs(fd_n1), 1e-6), ("n1", g_n1, fd_n1)
    g_n1_dt = float(jax.jit(jax.grad(make_loss_n1(env_t_dt)))(jnp.float32(5.0)))
    assert abs(g_n1_dt - g_n1) < 0.02 * max(abs(g_n1), 1e-6), ("n1 dt", g_n1_dt, g_n1)
    done.append(f"terrain n1 ad {g_n1:.4g} fd {fd_n1:.4g}")

    # 5. Terrain vertices: FD drowns in f32 noise at this scale, so the
    # kernel's backward is checked against the jnp BVH walk's, 2%.
    wt = jnp.asarray(np.random.default_rng(11).normal(size=(s.grad_terrain_rays,)), jnp.float32)
    env_bvh_dt = make_env_intersector("bvh", mesh=terr, differentiable_tris=True)

    def make_loss_vt(env):
        @jax.jit
        def loss_vt(vertices):
            r = trace_to_rx(Scene(vertices, tscene.faces), ttx, tdirs, trx, 1.5,
                            max_bounces=3, rx_mode="analytic", env_hit=env)
            return jnp.sum(r.captured.astype(jnp.float32) * (wt * r.distance + 10.0 * r.amplitude))

        return loss_vt

    g_v = jax.jit(jax.grad(make_loss_vt(env_t_dt)))(tscene.vertices)
    g_ref = jax.jit(jax.grad(make_loss_vt(env_bvh_dt)))(tscene.vertices)
    assert np.isfinite(np.asarray(g_v)).all() and float(jnp.abs(g_v).sum()) > 0
    num, den = float(jnp.linalg.norm(g_v - g_ref)), float(jnp.linalg.norm(g_ref))
    assert num < 0.02 * max(den, 1e-6), ("terrain vertex", num, den)
    done.append(f"terrain vertex vs bvh rel {num / max(den, 1e-30):.1e}")
    return "; ".join(done)


def _inverse_problem(s: Sizes, differentiable_tris=False):
    """(scene, dirs, centers, target, env) for one inverse step on the
    terrain; the target comes from the true TX and n1."""
    import jax
    import jax.numpy as jnp

    from rfx.sampler import morton_sphere_directions
    from rfx.solver import coverage_irs_soft
    from rfx.tracer import Scene

    terr = _terrain(s)
    scene = Scene.from_mesh(terr)
    side = int(round(s.inverse_rx ** 0.5))
    xs = np.linspace(-20.0, 20.0, side)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    centers = np.stack([gx, gy, np.full_like(gx, 6.0)], axis=-1).reshape(-1, 3).astype(np.float32)
    dirs = morton_sphere_directions(jax.random.PRNGKey(9), s.inverse_rays)
    env = _auto_env(terr, differentiable_tris=differentiable_tris)
    irs = jax.jit(lambda d, c: coverage_irs_soft(
        scene.vertices, scene.faces, jnp.asarray(TX, jnp.float32), 5.0, d, c, 2.0,
        num_rays=s.inverse_rays, max_bounces=2, nbins=2000, light_speed_mps=C,
        sample_rate_hz=10e9, env_hit=env))(dirs, jnp.asarray(centers))
    target = jnp.sum(irs * irs, axis=1)
    return scene, dirs, jnp.asarray(centers), target, env


def _one_step(s: Sizes, mesh=None, vertices=False):
    """(params before, params after, loss) of one Adam step (lr 0.05)."""
    from rfx.solver import make_inverse_solver

    scene, dirs, centers, target, env = _inverse_problem(s, differentiable_tris=vertices)
    init_fn, step_fn = make_inverse_solver(
        scene, dirs, centers, 2.0, target, max_bounces=2, nbins=2000,
        sample_rate_hz=10e9, mesh=mesh, env_hit=env)
    params, opt_state = init_fn(tx0=[12.0, 2.0, 18.0], n1_0=4.0,
                                vertices0=scene.vertices if vertices else None)
    new, _, loss = step_fn(params, opt_state)
    return params, new, float(loss)


def _moves(old, new, leaves) -> dict:
    """Largest |change| of each leaf; fails unless every leaf is finite and
    moved by over 1e-3 (Adam's first step moves a component with a nonzero
    gradient by ~lr = 0.05; f32 rounding at |tx| ~ 20 is ~2e-6)."""
    moved = {}
    for leaf in leaves:
        a, b = np.asarray(getattr(old, leaf)), np.asarray(getattr(new, leaf))
        assert np.isfinite(b).all(), f"{leaf} not finite"
        moved[leaf] = float(np.abs(b - a).max())
        assert moved[leaf] > 1e-3, f"{leaf} did not move: {moved[leaf]}"
    return moved


def phase_inverse(s: Sizes) -> str:
    """One inverse-solve step for TX pose and n1, and one with the vertices
    as a parameter (differentiable-tris traversal): each leaf must move."""
    out = []
    for vertices in (False, True):
        t0 = time.perf_counter()
        old, new, loss = _one_step(s, vertices=vertices)
        dt = time.perf_counter() - t0
        assert np.isfinite(loss) and loss > 0, loss
        moved = _moves(old, new, ("tx_pos", "log_n1") + (("vertices",) if vertices else ()))
        out.append(f"{'tx+n1+vertices' if vertices else 'tx+n1'} loss {loss:.4g}, max |step| "
                   + ", ".join(f"{k} {v:.3g}" for k, v in moved.items())
                   + f" ({dt:.1f} s incl. compile)")
    return f"terrain, {s.inverse_rays} rays, {s.inverse_rx} receivers: " + "; ".join(out)


def phase_sharded_cir(s: Sizes) -> str:
    """sharded_cir over a flat 4-device ('rays',) mesh vs one device."""
    import jax
    import jax.numpy as jnp

    from rfx.cir import cir_from_trace
    from rfx.parallel import make_mesh, sharded_cir
    from rfx.sampler import morton_sphere_directions
    from rfx.tracer import Scene, trace_to_rx

    mesh = _terrain(s)
    scene = Scene.from_mesh(mesh)
    env = _auto_env(mesh)
    n = s.flagship_rays
    dirs = morton_sphere_directions(jax.random.PRNGKey(4), n)
    tx, rx = jnp.asarray(TX, jnp.float32), jnp.asarray(RX, jnp.float32)
    dmesh = make_mesh({"rays": 4}, jax.devices()[:4])
    kw = dict(nbins=20_000, light_speed_mps=C, sample_rate_hz=100e9)
    ir_sh = np.asarray(sharded_cir(scene, tx, dirs, rx, 1.0, dmesh, max_bounces=4,
                                   env_hit=env, **kw))
    single = jax.jit(lambda d: cir_from_trace(
        trace_to_rx(scene, tx, d, rx, 1.0, max_bounces=4, rx_mode="analytic", env_hit=env),
        tx_power=1.0, num_rays=n, **kw))
    ir_1 = np.asarray(single(jax.device_put(dirs, jax.devices()[0])))
    assert ir_1.sum() > 0
    # Same rays, same per-ray arithmetic; only the f32 order of the bin sums
    # (four partial histograms, atomic scatter-adds) differs.
    np.testing.assert_allclose(ir_sh, ir_1, rtol=1e-4, atol=1e-6 * np.abs(ir_1).max())
    return f"{n} rays over 4 devices: IR sum {ir_sh.sum():.6e} vs {ir_1.sum():.6e}"


def phase_sharded_inverse(s: Sizes) -> str:
    """One inverse step on a 2x2 ('rays', 'rx') mesh vs the unsharded step."""
    import jax

    from rfx.parallel import make_mesh

    dmesh = make_mesh({"rays": 2, "rx": 2}, jax.devices()[:4])
    leaves = ("tx_pos", "log_n1")
    old, new_sh, loss_sh = _one_step(s, mesh=dmesh)
    _, new_1, loss_1 = _one_step(s)
    moved = _moves(old, new_sh, leaves)
    _moves(old, new_1, leaves)
    # The same sums split over shards: f32 order only (1e-4 on the loss).
    # Adam's first step is lr * g / (|g| + eps), ~lr * sign(g) per component,
    # so the moved params agree to f32 rounding of |param| <= 20.
    assert abs(loss_sh - loss_1) <= 1e-4 * abs(loss_1), (loss_sh, loss_1)
    for leaf in leaves:
        np.testing.assert_allclose(np.asarray(getattr(new_sh, leaf)),
                                   np.asarray(getattr(new_1, leaf)), atol=1e-5)
    return (f"2x2 mesh: loss {loss_sh:.6g} vs {loss_1:.6g}; params moved (max |step| "
            + ", ".join(f"{k} {v:.3g}" for k, v in moved.items()) + ") and agree")


ONE_CARD = {
    "traversal": phase_traversal,
    "trace": phase_trace,
    "flagship": phase_flagship,
    "coverage": phase_coverage,
    "gradients": phase_gradients,
    "inverse": phase_inverse,
}
FOUR_CARDS = {"sharded_cir": phase_sharded_cir, "sharded_inverse": phase_sharded_inverse}


def run_phases(phases: dict, s: Sizes) -> None:
    for name, fn in phases.items():
        t0 = time.perf_counter()
        result = fn(s)
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) {result}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded phases, on four cards")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke.py needs {need} GPUs; JAX found {len(devices)}", file=sys.stderr)
        return 1
    from rfx.utils.cache import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    device = {"platform": devices[0].platform, "kind": devices[0].device_kind,
              "count": len(devices)}
    print(card_line(), flush=True)
    print(f"phase device: ok ({time.perf_counter() - t0:.1f} s) {device}", flush=True)
    run_phases(FOUR_CARDS if args.four_cards else ONE_CARD, Sizes())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
