"""Pure-NumPy oracle for the reference RF ray-tracing semantics.

This module pins down, in plain NumPy with no acceleration structures, the
exact physics of the reference implementation (SURVEY.md section 2.1):

- Ray spawn: isotropic point source at tx_pos (ref kernel.py:51-52). The
  oracle takes an explicit (N, 3) direction array so the same rays can be
  injected into the JAX tracer for allclose validation (the reference's Warp
  counter-based PRNG is intentionally not replicated bit-exactly).
- Bounce loop: per bounce, closest-hit query against the receiver mesh and the
  environment mesh; the receiver wins iff it is hit AND (env missed OR
  t_env > t_rx) (ref kernel.py:85). On RX hit the path terminates and is
  recorded; on env hit the ray advances and reflects specularly
  (ref kernel.py:93-96); on double miss it terminates (ref kernel.py:97-98).
  We implement the *intended* persistent termination semantics (the reference
  resets its `ray_finished` flag each iteration, ref kernel.py:58-59 — a
  latent quirk documented in SURVEY.md 2.2; see `warp_quirk_compat` below).
- Per-path amplitude: tx_power / N_rays, multiplied per interior vertex by the
  reference's as-written s-polarised Fresnel power coefficient with n1=5.0,
  n2=1.0 (ref tracer.py:32-61).
- Delay binning: distance / c * sample_rate, truncated to the lower bin;
  out-of-window paths dropped; amplitudes sum into bins (ref tracer.py:104-117).

The oracle is deliberately slow and simple (brute-force Moller-Trumbore over
all triangles) — it is the allclose target for every accelerated path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rfx.geometry import TriangleMesh, icosphere

# Minimum hit distance: rays re-traced from a surface need an epsilon to avoid
# re-hitting the originating face. The reference delegates this to warp
# internals (SURVEY.md 2.2); we make it explicit and use the same value in the
# JAX tracer so oracle and tracer agree exactly.
T_MIN_EPS = 1e-4
T_MAX = 1.0e6


def sample_sphere_directions(n: int, seed: int = 0) -> np.ndarray:
    """Uniform directions on the unit sphere via (z, phi) sampling, float32.

    Not bit-compatible with Warp's sampler (ref kernel.py:51-52) — both the
    oracle and the JAX tracer consume explicit direction arrays instead.
    """
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.0, 1.0, size=n)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n)
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    d = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)
    return d.astype(np.float32)


def fresnel_bounce_amplitude(angle_between: np.ndarray, n1: float = 5.0, n2: float = 1.0) -> np.ndarray:
    """Reference Fresnel power reflection factor, vectorised, as written in
    ref tracer.py:34-61 (do NOT "fix" to the textbook convention).

    angle_between: bend angle between consecutive path segments (radians).
    Returns a factor in [0, 1]; NaN input or NaN result maps to 0.
    """
    angle_between = np.asarray(angle_between, dtype=np.float64)
    theta = (np.pi / 2.0) - (angle_between / 2.0)
    with np.errstate(invalid="ignore"):
        theta_i = np.arcsin((n2 * np.sin(theta)) / n1)
        num = n2 * np.cos(theta_i) - n1 * np.cos(theta)
        denom = n2 * np.cos(theta_i) + n1 * np.cos(theta)
        amp = -((num / denom) ** 2)
    amp = np.maximum(amp, -1.0)
    out = -amp
    out = np.where(np.isnan(angle_between) | np.isnan(out), 0.0, out)
    return out


def ray_triangles_closest_hit(
    origin: np.ndarray,
    direction: np.ndarray,
    tri_v0: np.ndarray,
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    t_min: float = T_MIN_EPS,
    t_max: float = T_MAX,
) -> tuple[float, int]:
    """Brute-force Moller-Trumbore closest hit of one ray against all
    triangles. Returns (t, face_index); (inf, -1) on miss.

    Equivalent of warp's `wp.mesh_query_ray` (ref kernel.py:71,82),
    without the BVH — the oracle is the gold standard, not the fast path.
    """
    pvec = np.cross(direction[None, :], tri_e2)
    det = np.einsum("ij,ij->i", tri_e1, pvec)
    # Parallel rays produce inf/nan below and fail the window test.
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = 1.0 / det
        tvec = origin[None, :] - tri_v0
        u = np.einsum("ij,ij->i", tvec, pvec) * inv_det
        qvec = np.cross(tvec, tri_e1)
        v = np.einsum("j,ij->i", direction, qvec) * inv_det
        t = np.einsum("ij,ij->i", tri_e2, qvec) * inv_det
    with np.errstate(invalid="ignore"):
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
        ok &= np.isfinite(t)
    if not ok.any():
        return np.inf, -1
    t = np.where(ok, t, np.inf)
    f = int(np.argmin(t))
    return float(t[f]), f


@dataclass
class _MeshSoA:
    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    normals: np.ndarray

    @classmethod
    def from_mesh(cls, mesh: TriangleMesh) -> "_MeshSoA":
        tri = mesh.triangles().astype(np.float64)
        v0 = tri[:, 0]
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
        return cls(v0, e1, e2, n)


class OracleTracer:
    """Reference-semantics CPU tracer (slow; for validation only).

    Mirrors the reference `Tracer` API (ref tracer.py:12, tracer.py:63) but
    takes explicit ray directions for reproducibility.
    """

    def __init__(
        self,
        environment: TriangleMesh,
        light_speed_mps: float = 2.998e8,
        sample_rate_hz: float = 100e9,
        sample_window_s: float = 200.0e-9,
        max_bounces: int = 4,
        n1: float = 5.0,
        n2: float = 1.0,
        rx_mode: str = "icosphere",
        warp_quirk_compat: bool = False,
    ):
        self.env = _MeshSoA.from_mesh(environment)
        self.light_speed_mps = light_speed_mps
        self.sample_rate_hz = sample_rate_hz
        self.sample_window_s = sample_window_s
        self.max_bounces = max_bounces
        self.n1 = n1
        self.n2 = n2
        if rx_mode not in ("icosphere", "analytic"):
            raise ValueError(rx_mode)
        self.rx_mode = rx_mode
        # warp_quirk_compat=True reproduces the reference KERNEL exactly,
        # including its latent per-iteration `ray_finished` reset (ref
        # kernel.py:58-59): termination never persists across bounce
        # iterations, so a captured ray keeps being traced from the RX-sphere
        # surface (typically re-capturing at the sphere's exit point, which
        # appends the chord through the sphere to the recorded path), and an
        # escaped ray keeps re-issuing the same missing queries. False (the
        # default) implements the INTENDED persistent termination semantics —
        # what the JAX tracer and every parity test use (SURVEY.md 2.2).
        self.warp_quirk_compat = bool(warp_quirk_compat)

    # -- receiver intersection ------------------------------------------------
    def _rx_hit_t(self, pos: np.ndarray, d: np.ndarray, rx: "_MeshSoA | tuple") -> float:
        if self.rx_mode == "icosphere":
            t, _ = ray_triangles_closest_hit(pos, d, rx.v0, rx.e1, rx.e2)
            return t
        center, radius = rx
        oc = pos - center
        b = np.dot(oc, d)
        c = np.dot(oc, oc) - radius * radius
        disc = b * b - c
        if disc < 0.0:
            return np.inf
        s = np.sqrt(disc)
        t0 = -b - s
        t1 = -b + s
        if t0 > T_MIN_EPS:
            return t0
        if t1 > T_MIN_EPS:
            return t1
        return np.inf

    def _make_rx(self, rx_pos: np.ndarray, rx_radius: float):
        if self.rx_mode == "icosphere":
            return _MeshSoA.from_mesh(icosphere(center=rx_pos, radius=rx_radius, subdivisions=1))
        return (np.asarray(rx_pos, np.float64), float(rx_radius))

    # -- main API -------------------------------------------------------------
    def trace_paths(
        self,
        tx_pos: np.ndarray,
        rx_pos: np.ndarray,
        rx_radius: float,
        directions: np.ndarray,
    ) -> list[np.ndarray]:
        """Trace every ray; return the list of received paths (each a (k, 3)
        vertex array from TX to the RX-sphere hit point), reference semantics.
        """
        tx_pos = np.asarray(tx_pos, np.float64)
        rx = self._make_rx(np.asarray(rx_pos, np.float64), rx_radius)
        paths = []
        for d0 in np.asarray(directions, np.float64):
            pos = tx_pos.copy()
            d = d0 / np.linalg.norm(d0)
            verts = [pos.copy()]
            received = None
            for bounce in range(self.max_bounces):
                t_rx = self._rx_hit_t(pos, d, rx)
                t_env, f_env = ray_triangles_closest_hit(pos, d, self.env.v0, self.env.e1, self.env.e2)
                hit_rx = np.isfinite(t_rx) and (not np.isfinite(t_env) or t_env > t_rx)
                if hit_rx:
                    pos = pos + d * t_rx
                    verts.append(pos.copy())
                    # ref kernel.py:86-92: copy the first bounce+2 traced
                    # vertices into received_paths (in quirk mode a later,
                    # longer capture overwrites this prefix).
                    received = np.asarray(verts[: bounce + 2])
                    if not self.warp_quirk_compat:
                        break
                    # quirk: ray_finished resets next iteration — keep tracing
                    # from the RX-sphere surface with the same direction.
                elif np.isfinite(t_env):
                    pos = pos + d * t_env
                    verts.append(pos.copy())
                    n = self.env.normals[f_env]
                    d = d - 2.0 * np.dot(d, n) * n
                else:
                    if not self.warp_quirk_compat:
                        break
                    # quirk: an escaped ray re-issues the identical (missing)
                    # queries every remaining iteration — no state changes, so
                    # looping on is exactly the reference's wasted work.
            if received is not None:
                paths.append(received)
        return paths

    def path_amplitude_and_distance(self, path: np.ndarray, tx_power: float, n_rays: int) -> tuple[float, float]:
        """Per-path amplitude/distance, reference host loop (ref tracer.py:102-117)."""
        amplitude = tx_power / n_rays
        distance = 0.0
        for p1, p2, p3 in zip(path[:-2], path[1:-1], path[2:]):
            seg1 = p2 - p1
            seg2 = p3 - p2
            seg1_len = np.linalg.norm(seg1)
            cosang = np.dot(seg1, seg2) / (seg1_len * np.linalg.norm(seg2))
            angle_between = np.arccos(np.clip(cosang, -1.0, 1.0))
            amplitude *= float(fresnel_bounce_amplitude(angle_between, self.n1, self.n2))
            distance += seg1_len
        distance += np.linalg.norm(path[-2] - path[-1])
        return amplitude, distance

    def compute_cir(
        self,
        tx_pos: np.ndarray,
        tx_power: float,
        rx_pos: np.ndarray,
        rx_radius: float,
        directions: np.ndarray,
    ) -> tuple[list[np.ndarray], np.ndarray]:
        """Reference `Tracer.compute_cir` semantics (ref tracer.py:63-121)."""
        n_rays = int(np.asarray(directions).shape[0])
        paths = self.trace_paths(tx_pos, rx_pos, rx_radius, directions)
        nbins = int(self.sample_window_s * self.sample_rate_hz)
        impulse_response = np.zeros(nbins, dtype=np.float64)
        for path in paths:
            amplitude, distance = self.path_amplitude_and_distance(path, tx_power, n_rays)
            delay_samples = int((distance / self.light_speed_mps) * self.sample_rate_hz)
            if delay_samples < nbins:
                impulse_response[delay_samples] += amplitude
        return paths, impulse_response


def rx_power_dbm(impulse_response: np.ndarray, sample_window_s: float, carrier_hz: float = 2.4e9):
    """Reference RX-power metric (ref main.py:46-55): convolve the IR with a
    carrier sine, mean-square over the nonzero samples, convert to dBm.
    Returns (power_dbm, signal_rx)."""
    t = np.linspace(0.0, sample_window_s, impulse_response.shape[0])
    signal_tx = np.sin(2.0 * np.pi * carrier_hz * t)
    signal_rx = np.convolve(impulse_response, signal_tx, mode="same")
    nz = np.nonzero(signal_rx)
    vals = signal_rx[nz]
    if vals.size == 0:
        return -np.inf, signal_rx
    power = np.sum(vals**2) / vals.shape[0]
    return 10.0 * np.log10(power / 1e-3), signal_rx
