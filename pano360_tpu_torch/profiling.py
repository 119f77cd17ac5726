"""Stage timing and the cProfile wrapper (counterpart of
``pano360_tpu.profiling``).

A context-manager stage timer keeping the reference's stage boundaries
(keypoints / matching / registration / mosaic), and a cProfile wrapper
with the reference's top-10%-cumulative report for host code. The
device timeline is ``torch.profiler`` (``cli.py --trace-dir``).
"""
from __future__ import annotations

import contextlib
import cProfile
import io
import logging
import pstats
import time
from typing import Dict

LOG = logging.getLogger(__name__)


class StageTimer:
    """Accumulates wall-clock per pipeline stage; ``extra`` takes what a
    stage counts besides (MSOP: candidates and keypoints per level, SSC
    host seconds)."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.extra: Dict[str, object] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.time()
        try:
            yield
        finally:
            dt = time.time() - start
            self.stages[name] = self.stages.get(name, 0.0) + dt
            LOG.info("%s, time: %s", name, dt)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.3f}s ({100 * v / total:.0f}%)"
                 for k, v in self.stages.items()]
        lines.append(f"total: {total:.3f}s")
        return "\n".join(lines)


def profile(fun, *args, **kwargs):
    """cProfile wrapper printing the top 10% by cumulative time
    (profiler.py:8-19 equivalent)."""
    prof = cProfile.Profile()
    prof.enable()
    res = fun(*args, **kwargs)
    prof.disable()

    sio = io.StringIO()
    stats = pstats.Stats(prof, stream=sio).sort_stats("cumulative")
    stats.print_stats(0.1)
    print(sio.getvalue())
    return res


__all__ = ["StageTimer", "profile"]
