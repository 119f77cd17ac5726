"""The program's spans and counters, stage timing and the cProfile
wrapper (counterpart of ``pano360_tpu.profiling``).

The recorder is the one place where the port times and counts itself:

- ``span(name)`` times a region of the program (``with span("register"):
  ...``). It records its start and end stamps, taken with
  ``time.time_ns()``, and the span open around it, its parent (the
  cause). Process-wide totals keep each name's count, total time and
  self time (total less the time its child spans cover).
- ``count(name, k)`` adds to a process-wide counter: ``graphs.captures``,
  ``graphs.replays``, ``graphs.programs_made`` and
  ``graphs.programs_hit`` (``graphs.Programs.get``'s misses and hits),
  and ``host_syncs``, each point of the window's
  path where the host waits for the device, counted at its call site
  with the syncs it makes on a card (a run on the CPU counts the same
  points, though nothing waits there); ``match.pairs`` and
  ``match.edges``, the pairs the match graph tried and those it kept
  (``pipeline.matching``, from its host rows), and ``render.patch_px``,
  the padded patches' pixels of each render's layout, N ph pw
  (``render.plan_layout``).
- ``snapshot()`` returns the totals, the counters and the kernels'
  launch counts (``_kernels.LAUNCHES``, by entry point).
- ``recording(stats)``: around a stage that takes a ``stats`` dict. The
  spans closed inside go into ``stats["spans"]`` as (name, parent,
  start_ns, end_ns), and ``stats["totals"]`` receives ``snapshot()`` as
  the stage returns.

``time.time_ns()`` is the clock ``torch.profiler`` puts its host events
on (Unix time, on Linux), so a span's stamps can be placed on a device
trace. Under ``annotated()`` (``cli.device_trace``, ``--trace-dir``)
each span also opens the profiler's fast record function of its name
(a host event that skips the dispatcher: its stamps lie within a few us
of the span's), so that the Chrome trace shows the program's spans on
the kernels' timeline. Annotation is off by default, as in the
benchmark's traced runs, whose profile then holds no event of the
program's. The recorder serves one thread, the one that runs the
stages.

``StageTimer`` reports the CLI's stages from the recorder (``--profile``)
and ``profile`` is the cProfile wrapper with the reference's
top-10%-cumulative report for host code.
"""
from __future__ import annotations

import contextlib
import cProfile
import functools
import io
import logging
import pstats
import time
from typing import Dict, List, Optional

from pano360_tpu_torch._kernels import LAUNCHES

LOG = logging.getLogger(__name__)

_TOTALS: Dict[str, List[int]] = {}      # name -> [count, total ns, self ns]
_COUNTERS: Dict[str, int] = {}
_OPEN: List["span"] = []                # the open spans, innermost last
_SINKS: List[list] = []                 # the open recordings' span lists
_ANNOTATE = False


class span:
    """A timed region of the program: ``with span("register"): ...``, or
    ``@span("features")`` on a function (a span per call). ``start`` and
    ``end`` are its ``time.time_ns()`` stamps, ``parent`` the name of
    the span open around it (or None)."""

    __slots__ = ("name", "parent", "start", "end", "child", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned

    def __enter__(self):
        self.parent = _OPEN[-1].name if _OPEN else None
        self.child = 0
        self._rf = None
        if _ANNOTATE:
            from torch._C._profiler import _RecordFunctionFast
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        _OPEN.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.end = time.time_ns()
        _OPEN.pop()
        dur = self.end - self.start
        if _OPEN:
            _OPEN[-1].child += dur
        tot = _TOTALS.get(self.name)
        if tot is None:
            tot = _TOTALS[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child
        if _SINKS:
            rec = (self.name, self.parent, self.start, self.end)
            for sink in _SINKS:
                sink.append(rec)
        return False


def count(name: str, k: int = 1):
    """Add ``k`` to the process-wide counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + k


def snapshot() -> dict:
    """The process's totals: {"spans": {name: {"count", "total_ns",
    "self_ns"}}, "counters": {name: n}, "launches": {kernel: n}}."""
    return {"spans": {k: {"count": c, "total_ns": t, "self_ns": s}
                      for k, (c, t, s) in _TOTALS.items()},
            "counters": dict(_COUNTERS), "launches": dict(LAUNCHES)}


@contextlib.contextmanager
def recording(stats: Optional[dict]):
    """Around a stage given ``stats`` (None: nothing is kept): the spans
    closed inside go into ``stats["spans"]``, and ``stats["totals"]`` is
    ``snapshot()`` as the stage returns."""
    if stats is None:
        yield
        return
    sink: list = []
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)
        stats.setdefault("spans", []).extend(sink)
        stats["totals"] = snapshot()


@contextlib.contextmanager
def annotated():
    """Spans open the profiler's fast record function of their name
    inside (the profiler's trace then shows them)."""
    global _ANNOTATE
    before, _ANNOTATE = _ANNOTATE, True
    try:
        yield
    finally:
        _ANNOTATE = before


def delta(after: dict, before: dict) -> dict:
    """``after`` less ``before``, two snapshots, keyed as a snapshot."""
    def sub(a, b):
        return {k: v - b.get(k, 0) for k, v in a.items()}
    zero = {"count": 0, "total_ns": 0, "self_ns": 0}
    return {"spans": {k: sub(v, before["spans"].get(k, zero))
                      for k, v in after["spans"].items()},
            "counters": sub(after["counters"], before["counters"]),
            "launches": sub(after["launches"], before["launches"])}


class StageTimer:
    """The CLI's stages as spans. ``stages``: seconds per stage, from
    the spans' stamps (a rank's, under ``--mesh``, merged by name);
    ``extra`` takes what a stage counts besides (MSOP: candidates and
    keypoints per level, SSC host seconds); ``report()`` adds the
    program's spans, graph captures and replays, programs made and
    reused, host syncs and kernel launches recorded since the timer was
    made."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.extra: Dict[str, object] = {}
        self._since = snapshot()

    @contextlib.contextmanager
    def stage(self, name: str):
        s = span(name)
        try:
            with s:
                yield
        finally:
            dt = (s.end - s.start) / 1e9
            self.stages[name] = self.stages.get(name, 0.0) + dt
            LOG.info("%s, time: %s", name, dt)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.3f}s ({100 * v / total:.0f}%)"
                 for k, v in self.stages.items()]
        lines.append(f"total: {total:.3f}s")
        got = delta(snapshot(), self._since)
        for k, v in got["spans"].items():
            if v["count"] and k not in self.stages:
                lines.append(f"  {k}: {v['total_ns'] / 1e9:.3f}s (self "
                             f"{v['self_ns'] / 1e9:.3f}s, {v['count']}x)")
        counters = got["counters"]
        lines.append(", ".join(f"{k}: {counters.get(k, 0)}" for k in
                               ("graphs.captures", "graphs.replays",
                                "graphs.programs_made",
                                "graphs.programs_hit", "host_syncs")))
        launched = {k: v for k, v in got["launches"].items() if v}
        if launched:
            lines.append("launches: " + ", ".join(
                f"{k} {v}" for k, v in launched.items()))
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


__all__ = ["span", "count", "snapshot", "recording", "annotated", "delta",
           "StageTimer", "profile"]
