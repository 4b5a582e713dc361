"""Profiling hooks: jax.profiler traces + phase timers + Mrays/s metric.

The reference's only instrumentation is `time.perf_counter` around
`compute_cir` plus hot-loop prints (ref tracer.py:64,119 — SURVEY.md 5).
Here: a context manager for on-device profiler traces (viewable in
TensorBoard / xprof), named phase timers that block on device results so
wall-clock attributions are honest, and a rays/s tracker as the first-class
throughput metric (BASELINE.md north star).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax

__all__ = ["device_trace", "device_time_breakdown", "PhaseTimer", "Throughput"]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Wrap a region in a jax.profiler trace (XLA device + host timelines)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_time_breakdown(logdir: str, kernel_name: str = "rfx_bvh_closest_hit") -> dict:
    """Reduce the newest profiler trace under `logdir` to device times.

    Reads the GPU planes' CUDA stream lines (one event per kernel or copy):
    `busy_s` is the union of event intervals, `kernel_s` the summed
    durations of events whose name contains `kernel_name` (the traversal
    kernel by default), `window_s` first start to last end, and `top` the
    ten event names with the most time. Empty when no GPU plane exists."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        return {}
    spans, per_name = [], {}
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                per_name[ev.name] = per_name.get(ev.name, 0.0) + ev.duration_ns
    if not spans:
        return {}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    kernel = sum(v for k, v in per_name.items() if kernel_name in k)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (max(e for _, e in spans) - spans[0][0]) * 1e-9,
        "busy_s": busy * 1e-9,
        "kernel_s": kernel * 1e-9,
        "top": [(k, v * 1e-9) for k, v in top],
    }


@dataclass
class PhaseTimer:
    """Accumulating named phase timers.

    with timer.phase("trace", block_on=ir): ...
    `block_on` (optional pytree) is block_until_ready'd before the phase
    closes, so async dispatch doesn't attribute device time to the wrong
    phase.
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.4f}s total, {total / n:.4f}s/call x{n}")
        return "\n".join(lines)


@dataclass
class Throughput:
    """Mrays/s tracker over timed trace calls."""

    rays: int = 0
    seconds: float = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int, block_on_fn=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                jax.block_until_ready(holder["result"])
            self.seconds += time.perf_counter() - t0
            self.rays += n_rays

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-12) / 1e6
