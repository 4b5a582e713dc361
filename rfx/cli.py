"""Command-line drivers: `python -m rfx.cli cir|coverage ...`.

These are the reference's two entry scripts as proper CLIs:
- `cir` = ref main.py (trace -> CIR plot -> RX dBm -> viz scene)
- `coverage` = ref coverage.py (RX grid sweep -> viridis point cloud), minus
  its bugs (the committed version crashes with NameError, SURVEY.md C8) and
  minus its 2048x re-tracing (one trace serves all receivers here).

Every constant the reference hardcodes is a flag with the same default.
`--config x.json` loads a TraceConfig/CoverageConfig; flags override.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from rfx.config import CoverageConfig, TraceConfig, resolve_scene


def _add_common(p: argparse.ArgumentParser, cfg):
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--scene", type=str, default=None, help="named scene or STL path")
    p.add_argument("--tx", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p.add_argument("--tx-power", type=float, default=None)
    p.add_argument("--rays", type=int, default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--rx-radius", type=float, default=None)
    p.add_argument("--sample-rate", type=float, default=None, help="Hz")
    p.add_argument("--window", type=float, default=None, help="seconds")
    p.add_argument("--backend", type=str, default=None, choices=["auto", "brute", "bvh", "triton"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", type=str, default="viz/scene.html")
    p.add_argument("--no-viz", action="store_true",
                   help="skip the scene viewer output (and, for cir, the small "
                        "secondary path-recording trace that feeds it)")
    p.add_argument("--serve", action="store_true", help="serve the scene on :8000 (blocking)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a jax.profiler device trace (TensorBoard/xprof) "
                        "and print per-phase wall-clock timings")


def _merge(cfg, args, mapping):
    for flag, fieldname in mapping.items():
        v = getattr(args, flag)
        if v is not None:
            cfg = dataclasses.replace(cfg, **{fieldname: tuple(v) if isinstance(v, list) else v})
    return cfg


_COMMON_MAP = {
    "scene": "scene",
    "tx": "tx_pos",
    "tx_power": "tx_power",
    "rays": "num_rays",
    "bounces": "max_bounces",
    "rx_radius": "rx_radius",
    "sample_rate": "sample_rate_hz",
    "window": "sample_window_s",
    "backend": "backend",
    "seed": "seed",
}


def _make_tracer(cfg):
    from rfx.api import Tracer

    mesh = resolve_scene(cfg.scene)
    return mesh, Tracer(
        mesh,
        cfg.light_speed_mps,
        cfg.sample_rate_hz,
        cfg.sample_window_s,
        cfg.max_bounces,
        cfg.num_rays,
        n1=cfg.n1,
        n2=cfg.n2,
        rx_mode=cfg.rx_mode,
        backend=cfg.backend,
        seed=cfg.seed,
    )


def cmd_cir(args) -> int:
    cfg = TraceConfig()
    if args.config:
        cfg = TraceConfig.from_json(open(args.config).read())
    cfg = _merge(cfg, args, _COMMON_MAP)
    if args.rx is not None:
        cfg = dataclasses.replace(cfg, rx_pos=tuple(args.rx))

    mesh, tracer = _make_tracer(cfg)

    import contextlib

    from rfx.utils.profiling import PhaseTimer, device_trace

    timer = PhaseTimer()
    prof = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof:
        if args.chunks and args.chunks > 1:
            # Chunked accumulation with resume (rfx.utils.checkpoint): each
            # chunk traces num_rays/chunks fresh-PRNG rays; per-path amplitude
            # normalizes by the GLOBAL ray count, so partial IRs sum exactly.
            import jax as _jax

            from rfx import sampler as _sampler
            from rfx.utils.checkpoint import run_chunked

            n_chunk = cfg.num_rays // args.chunks

            def compute_chunk(cid):
                dirs = _sampler.morton_sphere_directions(
                    _jax.random.fold_in(_jax.random.PRNGKey(cfg.seed), cid), n_chunk
                )
                with timer.phase("chunk"):
                    _, partial_ir = tracer.compute_cir(
                        cfg.tx_pos, cfg.tx_power, cfg.rx_pos, cfg.rx_radius,
                        directions=dirs,
                    )
                return {"ir": partial_ir}

            resume_dir = args.resume_dir or (args.out + ".chunks")
            acc = run_chunked(compute_chunk, args.chunks, resume_dir)
            ir = acc["ir"]
        else:
            with timer.phase("trace"):
                paths, ir = tracer.compute_cir(
                    cfg.tx_pos, cfg.tx_power, cfg.rx_pos, cfg.rx_radius,
                )
    dt = time.perf_counter() - t0
    with timer.phase("metric"):
        dbm = tracer.rx_power_dbm(ir, cfg.carrier_hz)
    print(f"traced {cfg.num_rays} rays x {cfg.max_bounces} bounces in {dt:.3f}s "
          f"({cfg.num_rays / dt / 1e6:.1f} Mrays/s)")

    # Path polylines for the viewer come from a SMALL secondary trace (capped
    # ray count, record_paths=True) so the main trace above never
    # materializes the (B, N, 3) path buffer. This also restores polylines
    # for chunked/resumed runs, where no chunk may even execute on resume.
    paths = []
    if not args.no_viz:
        from rfx import sampler as _sampler2
        import jax as _jax2

        # Cap well below num_rays: a quarter of the batch (floored at 4096
        # rays so tiny runs still catch paths) keeps the secondary trace a
        # small fraction of total time.
        n_viz = min(max(cfg.num_rays // 4, 4096), 262_144, cfg.num_rays)
        viz_dirs = _sampler2.sphere_directions(
            _jax2.random.fold_in(_jax2.random.PRNGKey(cfg.seed), 7919), n_viz
        )
        with timer.phase("viz-trace"):
            paths, _ = tracer.compute_cir(
                cfg.tx_pos, cfg.tx_power, cfg.rx_pos, cfg.rx_radius,
                directions=viz_dirs, record_paths=True, max_paths=2000,
            )
    print(f"received paths (viz subsample): {len(paths)}  |  RX power: {float(dbm):.2f} dBm")
    if args.profile:
        print(f"profiler trace written to {args.profile}")
        print(timer.report())

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(ir)
        plt.xlabel("sample")
        plt.ylabel("amplitude")
        plt.title("Impulse response")  # ref main.py:39-44
        plt.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")

    if not args.no_viz:
        from rfx.viz import visualize

        visualize(
            mesh=mesh, tx_pos=cfg.tx_pos, rx_pos=cfg.rx_pos, rx_radius=cfg.rx_radius,
            paths=paths, out_path=args.out, port=args.port, serve=args.serve,
        )
        if not args.serve:
            print(f"wrote {args.out}")
    return 0


# Five viridis anchors (matplotlib's viridis at 0, .25, .5, .75, 1), RGB 0-255.
_RAMP = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98], [253, 231, 37]],
                 np.float64)


def dbm_colors(dbm, lo: float, hi: float) -> np.ndarray:
    """(M, 3) int RGB for dBm values on a viridis-like ramp over [lo, hi];
    -inf (nothing received) maps to the low end."""
    frac = np.clip((np.nan_to_num(np.asarray(dbm, np.float64), neginf=lo) - lo) / (hi - lo),
                   0.0, 1.0)
    pos = np.linspace(0.0, 1.0, len(_RAMP))
    return np.stack([np.interp(frac, pos, _RAMP[:, c]) for c in range(3)], axis=1).astype(int)


def cmd_coverage(args) -> int:
    cfg = CoverageConfig()
    if args.config:
        cfg = CoverageConfig.from_json(open(args.config).read())
    cfg = _merge(cfg, args, _COMMON_MAP)

    mesh, tracer = _make_tracer(cfg)
    grid = cfg.grid_points()

    import contextlib

    from rfx.utils.profiling import device_trace

    prof = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof:
        if args.metric == "fast":
            dbm = np.asarray(tracer.compute_coverage_dbm_fast(
                cfg.tx_pos, cfg.tx_power, grid, cfg.rx_radius,
                carrier_hz=cfg.carrier_hz, rx_batch=cfg.rx_batch))
        elif args.metric == "hybrid":
            dbm, n_flagged = tracer.compute_coverage_dbm_hybrid(
                cfg.tx_pos, cfg.tx_power, grid, cfg.rx_radius,
                carrier_hz=cfg.carrier_hz, rx_batch=cfg.rx_batch)
            print(f"hybrid: {n_flagged} cancellation-flagged receivers re-evaluated exactly")
        else:
            irs = tracer.compute_coverage(cfg.tx_pos, cfg.tx_power, grid, cfg.rx_radius,
                                          rx_batch=cfg.rx_batch)
            dbm = np.asarray(tracer.rx_power_dbm(irs, cfg.carrier_hz))
    dt = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    print(f"coverage: {grid.shape[0]} receivers from one {cfg.num_rays}-ray trace "
          f"in {dt:.2f}s")
    finite = np.isfinite(dbm)
    if finite.any():
        print(f"dBm range: [{dbm[finite].min():.1f}, {dbm[finite].max():.1f}], "
              f"{int(finite.sum())}/{len(dbm)} receivers reached")

    if not args.no_viz:
        from rfx.viz import visualize

        # viridis-like dBm coloring, range per ref coverage.py:32-36
        lo, hi = cfg.dbm_range
        colors = dbm_colors(dbm, lo, hi)
        pairs = [(grid[i], colors[i]) for i in range(grid.shape[0])]
        visualize(
            mesh=mesh, tx_pos=cfg.tx_pos, point_color_pairs=pairs,
            out_path=args.out, port=args.port, serve=args.serve,
        )
        if not args.serve:
            print(f"wrote {args.out}")
    if args.save_dbm:
        np.save(args.save_dbm, np.concatenate([grid, dbm[:, None]], axis=1).astype(np.float32))
        print(f"wrote {args.save_dbm}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rfx", description="differentiable RF ray tracer")
    sub = parser.add_subparsers(dest="command", required=True)

    p_cir = sub.add_parser("cir", help="single-receiver channel impulse response (ref main.py)")
    _add_common(p_cir, TraceConfig())
    p_cir.add_argument("--rx", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"))
    p_cir.add_argument("--plot", type=str, default=None, help="write IR plot PNG")
    p_cir.add_argument("--chunks", type=int, default=1,
                       help="split the trace into N idempotent chunks with "
                            "checkpointed accumulation (resume after a kill)")
    p_cir.add_argument("--resume-dir", type=str, default=None,
                       help="chunk-state directory (default: <out>.chunks)")
    p_cir.set_defaults(fn=cmd_cir)

    p_cov = sub.add_parser("coverage", help="receiver-grid coverage sweep (ref coverage.py)")
    _add_common(p_cov, CoverageConfig())
    p_cov.add_argument("--save-dbm", type=str, default=None, help="write (x,y,z,dbm) .npy")
    p_cov.add_argument("--metric", type=str, default="exact",
                       choices=["exact", "fast", "hybrid"],
                       help="'fast' = phasor dBm (no per-RX IR, ~100x; measured "
                            "0.27 dB median but up to 20 dB under strong "
                            "cancellation); 'hybrid' = fast + exact re-eval of "
                            "cancellation-flagged receivers (bounded error)")
    p_cov.set_defaults(fn=cmd_coverage)

    args = parser.parse_args(argv)
    from rfx.utils.cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
