"""Device steps replayed from CUDA graphs: the port's counterpart of the
programs that ``jax.jit`` compiles once and dispatches whole.

A step is a function of one dict of tensors, its static buffers: it
reads its inputs there and leaves its outputs there, with no host sync
and no upload of host data. ``capture`` records a step as a CUDA graph;
``Replayed`` captures at its first call and replays after that;
``PROGRAMS`` keeps the process's captured steps by key (as ``jax.jit``'s
cache lives per process), all in one memory pool.

Sharing the pool is safe because the steps run one at a time on one
stream, and each step's outputs are read or copied before another step
of the pool replays: a later capture may place its buffers where an
earlier one kept its temporaries.

Kernel launches: a kernel's wrapper counts each launch in its module's
``launches``, but a replay does not call the wrapper. ``Launches`` takes
back what the wrappers counted while a step was captured (nothing ran
then) and adds it again at each replay.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from pano360_tpu_torch import profiling


def _kernel_counters():
    """What counts the port's kernels' launches, each in ``launches``:
    the modules of one kernel each, and SIFT's front end's and tail's
    counts."""
    from pano360_tpu_torch.ops import (gauss_octave, sift_front, sift_tail,
                                       warp_kernel, warp_mip)
    return ((gauss_octave, warp_kernel, warp_mip) + sift_front.COUNTS
            + sift_tail.COUNTS)


class Launches:
    """Kernel launches of a captured step, per replay."""

    def __init__(self, counters: Sequence):
        self.counters = tuple(counters)
        self.per_replay = [0] * len(self.counters)

    @contextlib.contextmanager
    def capturing(self):
        """Around a capture: records what the wrappers count inside, and
        takes it back."""
        before = [c.launches for c in self.counters]
        try:
            yield
        finally:
            self.per_replay = [c.launches - b
                               for c, b in zip(self.counters, before)]
            for c, b in zip(self.counters, before):
                c.launches = b

    def replayed(self):
        for c, k in zip(self.counters, self.per_replay):
            c.launches += k


_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream() -> torch.cuda.Stream:
    """The current device's side stream for captures, one per process:
    the caching allocator keeps freed blocks per stream, so a stream per
    capture would keep each first run's memory reserved."""
    index = torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream()
    return _STREAMS[index]


def capture(fn: Callable[[dict], None], state: dict, pool=None,
            launches: Launches = None) -> torch.cuda.CUDAGraph:
    """``fn(state)``, a step on the static buffers of ``state``, captured
    as a CUDA graph (in ``pool``, a ``torch.cuda.graph_pool_handle()``,
    or a pool of its own). A first run on copies of the buffers, outside
    the capture, sets up the libraries' lazy handles and workspaces.
    Both are the span ``graphs.capture``, counted in ``graphs.captures``."""
    profiling.count("graphs.captures")
    graph = torch.cuda.CUDAGraph()
    stream = _capture_stream()
    with profiling.span("graphs.capture"):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn({k: v.clone() for k, v in state.items()})
            with (launches.capturing() if launches
                  else contextlib.nullcontext()):
                graph.capture_begin(pool=pool)
                try:
                    fn(state)
                finally:
                    graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
    return graph


class Replayed:
    """``fn(state)`` replayed from a CUDA graph captured at its first
    call; the kernels it launches are counted at each replay."""

    def __init__(self, fn: Callable[[dict], None], state: dict, pool=None):
        self.fn, self.state, self.pool, self.graph = fn, state, pool, None
        self.device = next(iter(state.values())).device
        self.launches = Launches(_kernel_counters())

    def __call__(self):
        with torch.cuda.device(self.device):
            if self.graph is None:
                self.graph = capture(self.fn, self.state, self.pool,
                                     self.launches)
            self.graph.replay()
        self.launches.replayed()
        profiling.count("graphs.replays")


class Programs:
    """What ``make()`` returns, made once per key for the life of the
    process (steps ``Replayed`` in ``pool``)."""

    def __init__(self):
        self._made: Dict[tuple, object] = {}
        self._pool = None

    @property
    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key: tuple, make: Callable[[], object]):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]


# the process's extraction and match-graph programs
PROGRAMS = Programs()


@functools.lru_cache(maxsize=None)
def constant(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(value)`` (a float or a tuple of them) on ``device``,
    made once per process: a captured step uploads no host data, so the
    constants it uses are made by its first, eager run."""
    return torch.tensor(value, dtype=dtype, device=device)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, from pinned memory without a host
    sync on a card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, a: np.ndarray):
    """Copy a host array into ``dst``, as ``upload``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dst.device.type == "cuda":
        t = t.pin_memory()
    dst.copy_(t, non_blocking=True)


def to_host(*tensors: torch.Tensor):
    """numpy copies of device tensors with one host sync (pinned copies
    behind one wait)."""
    profiling.count("host_syncs")
    if all(t.device.type == "cpu" for t in tensors):
        return [t.numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in outs]


__all__ = ["Launches", "capture", "Replayed", "Programs", "PROGRAMS",
           "constant", "upload", "upload_into", "to_host"]
