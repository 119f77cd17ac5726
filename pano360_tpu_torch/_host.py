"""Framework-free host modules of the JAX package, loaded by file path.

``pano360_tpu/synth.py`` (numpy only), ``pano360_tpu/profiling.py``
(standard library at import) and ``pano360_tpu/native/__init__.py``
(numpy, ctypes and subprocess: the g++-built largest-rectangle crop with
its pure-Python fallback) carry no JAX code, but importing them as
``pano360_tpu.*`` would run ``pano360_tpu/__init__.py``, which imports
jax. Loading the files by path keeps the port free of jax.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PKG = Path(__file__).resolve().parent.parent / "pano360_tpu"


def _load(name: str, relpath: str):
    modname = f"pano360_tpu_torch._host_{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, _JAX_PKG / relpath)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


synth = _load("synth", "synth.py")
profiling = _load("profiling", "profiling.py")
native = _load("native", "native/__init__.py")
StageTimer = profiling.StageTimer

__all__ = ["synth", "profiling", "native", "StageTimer"]
