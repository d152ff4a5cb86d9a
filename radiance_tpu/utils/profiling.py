"""Profiling / timing utilities.

The reference's observability is wall-clock printf timing around kernel
dispatch and BVH builds (reference: radiance.cpp:252-265, 25-49;
sample1.cpp:457-476).  Equivalents here: scoped wall-clock timers with
device synchronization, frame statistics, and jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax


@contextlib.contextmanager
def timed(label: str, sync=None, quiet: bool = False):
    """Wall-clock scope; pass `sync=result` arrays to block on device work."""
    t0 = time.time()
    box = {}
    try:
        yield box
    finally:
        if box.get("sync") is not None:
            jax.block_until_ready(box["sync"])
        dt = time.time() - t0
        box["seconds"] = dt
        if not quiet:
            print(f"[{label}] {dt:.4f}s")


@dataclass
class FrameStats:
    """Rolling frame statistics for the progressive render loop."""
    frames: int = 0
    total_s: float = 0.0
    last_s: float = 0.0
    history: List[float] = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.frames += 1
        self.total_s += seconds
        self.last_s = seconds
        self.history.append(seconds)
        if len(self.history) > 100:
            self.history.pop(0)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.frames, 1)

    def rays_per_sec(self, rays_per_frame: int) -> float:
        return rays_per_frame / self.last_s if self.last_s else 0.0

    def report(self, rays_per_frame: Optional[int] = None) -> str:
        msg = (f"frames={self.frames} last={self.last_s * 1e3:.1f}ms "
               f"mean={self.mean_s * 1e3:.1f}ms")
        if rays_per_frame:
            msg += f" ({self.rays_per_sec(rays_per_frame) / 1e6:.2f} Mrays/s)"
        return msg


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/radiance_tpu_trace"):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        print(f"profiler trace written to {log_dir}")
