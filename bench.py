"""Timing of the flagship CIR through the facade, on the GPU.

Workload: the reference's main.py settings (ref main.py:15-21) on the 32k-
triangle terrain stand-in: 5,242,880 rays x 4 bounces, 20,000-bin IR
(200 ns at 100 GHz), analytic receiver of radius 0.1 (rfx/config.py).

    python bench.py                       # backend picked by the facade
    python bench.py --backend bvh         # one named backend
    python bench.py --query               # one closest-hit query instead

Prints the device (platform, kind, count), the card's name and power limit,
and the median and quartiles of `--reps` warm runs, each ended by
`block_until_ready`; the last line is one JSON object with those numbers.
Exits non-zero when JAX finds no GPU. The `benchmark` work defines the cells.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_RAYS = 5_242_880
BOUNCES = 4
TX = (10.0, 0.0, 20.0)
RX = (-10.0, 0.0, 20.0)


def card_name_and_power() -> str:
    """`nvidia-smi`'s name and power limit of the card(s), or a note that it
    could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def timed(fn, reps: int) -> list[float]:
    """Wall seconds of `reps` calls of fn(), each ended by block_until_ready."""
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", default="auto", choices=["auto", "brute", "bvh", "triton"])
    p.add_argument("--rays", type=int, default=N_RAYS)
    p.add_argument("--rx-radius", type=float, default=0.1)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--query", action="store_true",
                   help="time one closest-hit query of the spawned rays, not the CIR")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="after timing, trace one more call into DIR and print its "
                        "device-time breakdown")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from rfx.api import Tracer
    from rfx.geometry import make_terrain
    from rfx.ops.intersect import mesh_soa
    from rfx.sampler import morton_sphere_directions
    from rfx.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    card = card_name_and_power()
    print(f"device: {device}")
    print(f"card: {card}")

    mesh = make_terrain(grid=128, extent=60.0, seed=0)
    t0 = time.perf_counter()
    tracer = Tracer(mesh, max_bounces=BOUNCES, tx_num_rays=args.rays, backend=args.backend)
    setup_s = time.perf_counter() - t0
    dirs = morton_sphere_directions(jax.random.PRNGKey(0), args.rays)

    if args.query:
        v0, e1, e2, nrm = mesh_soa(tracer.scene.vertices, tracer.scene.faces)
        o = jnp.broadcast_to(jnp.asarray(TX, jnp.float32), dirs.shape)
        hit = jax.jit(tracer.env_hit)
        fn = lambda: hit(o, dirs, v0, e1, e2, nrm)
        what = f"closest-hit query, {args.rays} Morton rays from TX, terrain"
    else:
        fn = lambda: tracer.compute_cir(TX, 1.0, RX, args.rx_radius, directions=dirs,
                                        record_paths=False)[1]
        what = (f"compute_cir, {args.rays} rays x {BOUNCES} bounces, terrain "
                f"({mesh.num_faces} tris), {tracer.nbins} bins, rx_radius {args.rx_radius}")
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first_s = time.perf_counter() - t0
    if not args.query:
        assert np.isfinite(out).all() and out.sum() > 0, "flagship IR captured nothing"
    times = timed(fn, args.reps)
    q1, med, q3 = (float(x) for x in np.percentile(times, [25, 50, 75]))
    print(f"{what}: backend {tracer.backend}, median {med * 1e3:.3f} ms "
          f"(q1 {q1 * 1e3:.3f}, q3 {q3 * 1e3:.3f}; {args.reps} warm runs), "
          f"{args.rays / med / 1e6:.2f} Mrays/s")
    breakdown = None
    if args.profile:
        from rfx.utils.profiling import device_time_breakdown, device_trace

        with device_trace(args.profile):
            jax.block_until_ready(fn())
        breakdown = device_time_breakdown(args.profile)
        if breakdown:
            print(f"profiled call: device busy {breakdown['busy_s'] * 1e3:.3f} ms of a "
                  f"{breakdown['window_s'] * 1e3:.3f} ms window; traversal kernel "
                  f"{breakdown['kernel_s'] * 1e3:.3f} ms "
                  f"({100 * breakdown['kernel_s'] / breakdown['busy_s']:.1f}% of busy)")
    print(json.dumps({
        "what": what, "backend": tracer.backend, "device": device, "card": card,
        "median_s": med, "q1_s": q1, "q3_s": q3, "times_s": times, "reps": args.reps,
        "mrays_per_s": args.rays / med / 1e6, "setup_s": setup_s,
        "first_call_s": first_s, "device_time": breakdown,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
