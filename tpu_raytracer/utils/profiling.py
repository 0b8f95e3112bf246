"""Tracing / profiling utilities.

The reference's observability is an FPS window title (main.rs:81-95) and a
screenshot-save wall-clock print (screenshot.rs:151-155); its compute passes
explicitly skip GPU timestamps (gbuffer.rs:295). This module provides the
real thing (SURVEY.md §5 plan):

  * `FrameStats`: rolling fps + exact Mrays/s from the pipeline's ray
    counters,
  * `timed`: block-until-ready wall-clock stage timer,
  * `trace`: context manager around `jax.profiler.trace` for full XLA
    device traces viewable in TensorBoard/Perfetto,
  * `device_memory`: live device-memory allocation snapshot.
"""

from __future__ import annotations

import collections
import contextlib
import time

import jax


class FrameStats:
    """Rolling window over frame time + ray counts (the window-title
    telemetry, main.rs:81-95, plus a Mrays/s counter)."""

    def __init__(self, window: int = 60):
        self.times = collections.deque(maxlen=window)
        self.rays = collections.deque(maxlen=window)
        self._last = None

    def frame(self, ray_count: float) -> None:
        now = time.time()
        if self._last is not None:
            self.times.append(now - self._last)
            self.rays.append(float(ray_count))
        self._last = now

    @property
    def fps(self) -> float:
        return len(self.times) / sum(self.times) if self.times else 0.0

    @property
    def mrays_per_s(self) -> float:
        t = sum(self.times)
        return (sum(self.rays) / t / 1e6) if t else 0.0

    def summary(self) -> str:
        return f"{self.fps:.2f} fps, {self.mrays_per_s:.1f} Mrays/s"


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    """Wall-clock a stage, blocking on all device work at exit."""
    t0 = time.time()
    yield
    (jax.effects_barrier if hasattr(jax, "effects_barrier")
     else lambda: None)()
    dt = time.time() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[timed] {label}: {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/tpu_raytracer_trace"):
    """Capture a full XLA profiler trace of the device (TensorBoard
    `profile` plugin or Perfetto). Wrap a few steady-state frames, not
    the compile."""
    with jax.profiler.trace(log_dir):
        yield
    print(f"profiler trace written to {log_dir}")


def device_memory() -> dict:
    """Per-device live memory bytes (allocation telemetry)."""
    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
            out[str(d)] = {
                "bytes_in_use": stats.get("bytes_in_use", 0),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
            }
        except Exception:  # backend without memory_stats
            out[str(d)] = {}
    return out
