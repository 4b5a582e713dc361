"""Dataclass configuration + scene registry.

The reference has no config system: workloads are module-level constants and
commented-out scene blocks edited by hand (ref main.py:15-31,
ref coverage.py:12-23 — committed broken, SURVEY.md C8). Here every knob is an
explicit dataclass field with the reference's defaults, JSON round-trippable
for reproducible runs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

from rfx.geometry import TriangleMesh, load_stl, make_empty_scene, make_room, make_terrain

__all__ = ["TraceConfig", "CoverageConfig", "resolve_scene", "SCENES"]

# Named procedural scenes; reference STL scenes resolve by path. "terrain" is
# the stand-in for the apollo_17 mesh (a missing large blob in the reference
# checkout, SURVEY.md C10).
SCENES = {
    "room": lambda: make_room(),
    "empty": lambda: make_empty_scene(),
    "terrain": lambda: make_terrain(grid=128, extent=60.0, seed=0),
    "terrain-small": lambda: make_terrain(grid=24, extent=40.0, seed=0),
}


def resolve_scene(scene: str) -> TriangleMesh:
    """Named scene or a path to an STL file."""
    if scene in SCENES:
        return SCENES[scene]()
    return load_stl(scene)


@dataclass
class TraceConfig:
    """Single-receiver CIR workload (reference defaults: ref main.py:15-21)."""

    scene: str = "terrain"
    tx_pos: tuple[float, float, float] = (10.0, 0.0, 20.0)
    rx_pos: tuple[float, float, float] = (-10.0, 0.0, 20.0)
    rx_radius: float = 0.1
    tx_power: float = 1.0
    num_rays: int = 5_000_000
    max_bounces: int = 4
    light_speed_mps: float = 2.998e8
    sample_rate_hz: float = 100e9  # ref main.py:16 (comment there is stale)
    sample_window_s: float = 200e-9
    carrier_hz: float = 2.4e9
    n1: float = 5.0
    n2: float = 1.0
    rx_mode: str = "analytic"  # 'icosphere' for exact reference tessellation
    backend: str = "auto"  # 'brute' | 'bvh' | 'triton' | 'auto'
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TraceConfig":
        d = json.loads(text)
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**d)


@dataclass
class CoverageConfig(TraceConfig):
    """Receiver-grid sweep (reference: ref coverage.py:12-16,38-40 —
    x,y in [-15,15] step 2, z in [0,14] step 2; 1 M rays; 2 bounces;
    100 ns window; dBm color range [-130, -70])."""

    scene: str = "room"
    tx_pos: tuple[float, float, float] = (3.0, 2.0, 2.0)  # inside the room (README example)
    num_rays: int = 1_000_000
    max_bounces: int = 2
    sample_window_s: float = 100e-9
    rx_radius: float = 1.0
    grid_x: tuple[float, float, float] = (-15.0, 15.0, 2.0)  # lo, hi, step
    grid_y: tuple[float, float, float] = (-15.0, 15.0, 2.0)
    grid_z: tuple[float, float, float] = (0.0, 14.0, 2.0)
    dbm_range: tuple[float, float] = (-130.0, -70.0)
    rx_batch: int = 64

    def grid_points(self):
        import numpy as np

        def axis(lo_hi_step):
            lo, hi, step = lo_hi_step
            return np.arange(lo, hi + 0.5 * step, step)

        xs, ys, zs = axis(self.grid_x), axis(self.grid_y), axis(self.grid_z)
        pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
        return pts.astype("float32")
