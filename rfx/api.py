"""User-facing facade mirroring the reference `Tracer` API.

Reference: `Tracer(mesh, c, rate, window, max_bounces, n_rays)` then
`compute_cir(tx_pos, tx_power, rx_pos, rx_radius) -> (paths, ir)`
(ref tracer.py:12, tracer.py:63). Differences by design (SURVEY.md 7):

- everything hot runs on-device under jit; no per-call receiver BVH rebuild
  (ref tracer.py:65), no kernel-cache clearing (ref tracer.py:14), no host
  CIR loop;
- `compute_coverage` traces once for all receivers (the reference re-traces
  per grid point, ref coverage.py:38-43);
- ray directions come from a JAX PRNG key or an injected array (for oracle
  parity), not a per-thread CUDA PRNG.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rfx import cir as cir_mod
from rfx import sampler
from rfx.coverage import coverage_dbm_fast, coverage_irs
from rfx.geometry import TriangleMesh
from rfx.ops.intersect import make_env_intersector
from rfx.tracer import Scene, extract_paths, trace_to_rx
from rfx.utils.logging import get_logger, log_trace_stats

__all__ = ["Tracer", "choose_backend", "BRUTE_MAX_FACES"]

#: Meshes up to this many triangles take the brute-force intersector on
#: every platform: testing all of them is cheaper than walking a tree.
BRUTE_MAX_FACES = 2048


def choose_backend(platform: str, num_faces: int) -> str:
    """The intersector `backend="auto"` picks: 'brute' for small meshes,
    the per-ray GPU kernel ('triton') on a GPU, the jnp BVH walk ('bvh')
    elsewhere (the kernel's interpreter is far slower than XLA's CPU code)."""
    if num_faces <= BRUTE_MAX_FACES:
        return "brute"
    return "triton" if platform == "gpu" else "bvh"


class Tracer:
    """Differentiable RF ray tracer with the reference's call shape."""

    def __init__(
        self,
        environment: TriangleMesh,
        light_speed_mps: float = 2.998e8,
        sample_rate_hz: float = 100e9,
        sample_window_s: float = 200.0e-9,
        max_bounces: int = 4,
        tx_num_rays: int = 5_000_000,
        *,
        n1: float = 5.0,
        n2: float = 1.0,
        rx_mode: str = "analytic",
        backend: str = "auto",
        seed: int = 0,
    ):
        # rx_mode default matches TraceConfig ("analytic" = exact sphere —
        # faster and exact; the coverage engine only supports it). Pass
        # "icosphere" for the reference's 80-face tessellation when strict
        # geometric parity with ref tracer.py:26-30 is required.
        self.mesh = environment
        self.scene = Scene.from_mesh(environment)
        self.light_speed_mps = float(light_speed_mps)
        self.sample_rate_hz = float(sample_rate_hz)
        self.sample_window_s = float(sample_window_s)
        self.max_bounces = int(max_bounces)
        self.tx_num_rays = int(tx_num_rays)
        self.n1 = float(n1)
        self.n2 = float(n2)
        self.rx_mode = rx_mode
        self.nbins = int(sample_window_s * sample_rate_hz)
        self.key = jax.random.PRNGKey(seed)
        self.log = get_logger("rfx.api")

        if backend == "auto":
            # The fast path IS the default path, as in the reference
            # (ref tracer.py:75-79).
            backend = choose_backend(jax.devices()[0].platform, environment.num_faces)
        self.backend = backend
        self.env_hit = make_env_intersector(backend, mesh=environment)

        self._cir_fn = jax.jit(
            partial(
                self._cir_impl,
                record_paths=False,
            )
        )
        self._cir_paths_fn = jax.jit(partial(self._cir_impl, record_paths=True))

    # -- internals ------------------------------------------------------------
    def _cir_impl(self, vertices, faces, tx_pos, tx_power, rx_pos, rx_radius,
                  directions, *, record_paths: bool):
        scene = Scene(vertices, faces)
        result = trace_to_rx(
            scene,
            tx_pos,
            directions,
            rx_pos,
            rx_radius,
            max_bounces=self.max_bounces,
            n1=self.n1,
            n2=self.n2,
            rx_mode=self.rx_mode,
            env_hit=self.env_hit,
            record_paths=record_paths,
        )
        ir = cir_mod.cir_from_trace(
            result,
            tx_power=tx_power,
            num_rays=self.tx_num_rays,
            nbins=self.nbins,
            light_speed_mps=self.light_speed_mps,
            sample_rate_hz=self.sample_rate_hz,
        )
        return result, ir

    def _directions(self, directions):
        if directions is None:
            self.key, sub = jax.random.split(self.key)
            # Morton order: same law as sphere_directions, but consecutive
            # rays share a direction cone, which the GPU kernel's blocks need.
            return sampler.morton_sphere_directions(sub, self.tx_num_rays)
        return jnp.asarray(directions, jnp.float32)

    # -- reference-parity API -------------------------------------------------
    #: record_paths="auto" records paths only for batches at or below this
    #: ray count (a 256k-ray x 4-bounce path buffer is ~12 MB — interactive
    #: scale; the flagship 5M-ray buffer is 240 MB and stays opt-in).
    AUTO_PATHS_MAX_RAYS = 262_144

    def compute_cir(self, tx_pos, tx_power, rx_pos, rx_radius, *,
                    directions=None, record_paths="auto",
                    max_paths: int = 10_000):
        """(paths, impulse_response) — reference semantics (ref tracer.py:63).

        `directions`: optional (N, 3) array for reproducible runs; defaults to
        tx_num_rays fresh PRNG directions. Returns numpy outputs.

        `record_paths` defaults to "auto": the reference always returns the
        cleaned path list (ref tracer.py:90-97,121), but recording paths
        materializes a (B, N, 3) buffer (240 MB at 5M rays x 4 bounces — the
        reference round-trips that much every call, ref tracer.py:67-84).
        "auto" keeps the drop-in contract for interactive batch sizes
        (<= AUTO_PATHS_MAX_RAYS rays record paths like the reference) while
        large batches skip recording and return `paths == []`. Pass
        True/False to force either behavior. For viz, prefer a second
        small-ray-count record_paths call over recording paths on the full
        batch.
        """
        import time

        t0 = time.perf_counter()
        if record_paths == "auto":
            n_req = (self.tx_num_rays if directions is None
                     else int(np.shape(directions)[0]))
            record_paths = n_req <= self.AUTO_PATHS_MAX_RAYS
        dirs = self._directions(directions)
        fn = self._cir_paths_fn if record_paths else self._cir_fn
        result, ir = fn(
            self.scene.vertices,
            self.scene.faces,
            jnp.asarray(tx_pos, jnp.float32),
            jnp.asarray(tx_power, jnp.float32),
            jnp.asarray(rx_pos, jnp.float32),
            jnp.asarray(rx_radius, jnp.float32),
            dirs,
        )
        ir = jax.block_until_ready(ir)
        elapsed = time.perf_counter() - t0
        n_rays = int(dirs.shape[0])
        log_trace_stats(self.log, n_rays=n_rays, bounces=self.max_bounces,
                        captured=int(result.captured.sum()), seconds=elapsed)
        paths = (
            extract_paths(np.asarray(tx_pos, np.float32), result, max_paths)
            if record_paths
            else []
        )
        return paths, np.asarray(ir)

    def compute_coverage(self, tx_pos, tx_power, rx_centers, rx_radius, *,
                         directions=None, rx_batch: int = 64):
        """(M, nbins) impulse responses for M receivers from a single trace.

        Inherits this Tracer's rx_mode. rx_mode="icosphere" (the reference's
        80-face tessellation, ref tracer.py:26-30) tests 80 triangles per
        segment per receiver instead of one sphere; use the default
        "analytic" unless strict geometric parity with the reference's
        tessellated receiver is required (the two agree to ~1-2% capture
        cross-section, tests/test_oracle.py)."""
        dirs = self._directions(directions)
        irs = coverage_irs(
            self.scene,
            jnp.asarray(tx_pos, jnp.float32),
            dirs,
            jnp.asarray(rx_centers, jnp.float32),
            jnp.asarray(rx_radius, jnp.float32),
            max_bounces=self.max_bounces,
            nbins=self.nbins,
            num_rays=self.tx_num_rays,
            light_speed_mps=self.light_speed_mps,
            sample_rate_hz=self.sample_rate_hz,
            tx_power=tx_power,
            n1=self.n1,
            n2=self.n2,
            rx_batch=rx_batch,
            env_hit=self.env_hit,
            rx_mode=self.rx_mode,
        )
        return np.asarray(jax.block_until_ready(irs))

    def compute_coverage_dbm_fast(self, tx_pos, tx_power, rx_centers, rx_radius, *,
                                  carrier_hz: float = 2.4e9, directions=None,
                                  rx_batch: int = 64):
        """(M,) dBm per receiver via the phasor fast path (no per-RX impulse
        response; see rfx.coverage.coverage_dbm_fast for speed/accuracy)."""
        dirs = self._directions(directions)
        dbm = coverage_dbm_fast(
            self.scene,
            jnp.asarray(tx_pos, jnp.float32),
            dirs,
            jnp.asarray(rx_centers, jnp.float32),
            jnp.asarray(rx_radius, jnp.float32),
            max_bounces=self.max_bounces,
            num_rays=self.tx_num_rays,
            sample_window_s=self.sample_window_s,
            sample_rate_hz=self.sample_rate_hz,
            carrier_hz=carrier_hz,
            light_speed_mps=self.light_speed_mps,
            tx_power=tx_power,
            n1=self.n1,
            n2=self.n2,
            rx_batch=rx_batch,
            env_hit=self.env_hit,
        )
        return np.asarray(jax.block_until_ready(dbm))

    def compute_coverage_dbm_hybrid(self, tx_pos, tx_power, rx_centers, rx_radius, *,
                                    carrier_hz: float = 2.4e9, directions=None,
                                    rx_batch: int = 64,
                                    cancel_threshold: float = 0.5,
                                    spread_threshold_s: float = 10e-9,
                                    exact_fallback_frac: float = 0.15):
        """((M,) dBm, n_flagged): phasor fast path with exact re-evaluation of
        receivers flagged as cancellation-dominated (bounded worst-case error;
        see rfx.coverage.coverage_dbm_hybrid). When more than
        `exact_fallback_frac` of receivers are flagged, every receiver is
        re-evaluated through the exact engine instead (same single trace) —
        cheaper than the padded subset and strictly more accurate."""
        from rfx.coverage import coverage_dbm_hybrid

        dirs = self._directions(directions)
        dbm, n_flagged = coverage_dbm_hybrid(
            self.scene,
            jnp.asarray(tx_pos, jnp.float32),
            dirs,
            jnp.asarray(rx_centers, jnp.float32),
            jnp.asarray(rx_radius, jnp.float32),
            max_bounces=self.max_bounces,
            num_rays=self.tx_num_rays,
            sample_window_s=self.sample_window_s,
            sample_rate_hz=self.sample_rate_hz,
            carrier_hz=carrier_hz,
            light_speed_mps=self.light_speed_mps,
            tx_power=tx_power,
            n1=self.n1,
            n2=self.n2,
            rx_batch=rx_batch,
            env_hit=self.env_hit,
            cancel_threshold=cancel_threshold,
            spread_threshold_s=spread_threshold_s,
            exact_fallback_frac=exact_fallback_frac,
        )
        return dbm, n_flagged

    def rx_power_dbm(self, impulse_response, carrier_hz: float = 2.4e9):
        """Reference RX-power metric (ref main.py:46-55)."""
        dbm, _ = cir_mod.rx_power_dbm(
            jnp.asarray(impulse_response), self.sample_window_s, carrier_hz
        )
        return np.asarray(dbm)
