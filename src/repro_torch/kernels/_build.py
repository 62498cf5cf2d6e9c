"""Build the package's CUDA sources with ``nvcc`` at first use and load them
with ctypes.

Each source under ``*/csrc/`` is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) for
``sm_90a``.  A source may give more than one library: ``LIBRARIES`` names
each library with its source and the macros it is built with (the trace
instantiations of ``mr_epoch`` are their source built with ``-DMR_TRACE``,
so the untraced kernels keep their code; both WKV6 sources take the
forward's kept-state interval, ``WKV6_CHUNK``, from ``rwkv6/kernel.py``'s
``CHUNK``).  Libraries land in ``_build/``
beside this file, named by a hash of the source, macros and flags, so an
edited source rebuilds and an unchanged one loads at once.  ``build()``
starts one ``nvcc`` per missing library, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

from .rwkv6.kernel import CHUNK as _WKV6_CHUNK

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = {
    "mr_epoch": _HERE / "mr_sched" / "csrc" / "mr_epoch.cu",
    "mr_epoch_control": _HERE / "mr_sched" / "csrc" / "mr_epoch_control.cu",
    "mr_schedule": _HERE / "mr_sched" / "csrc" / "mr_schedule.cu",
    "flash_attention": _HERE / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "wkv6": _HERE / "rwkv6" / "csrc" / "wkv6.cu",
    "wkv6_bwd": _HERE / "rwkv6" / "csrc" / "wkv6_bwd.cu",
}
_WKV6 = (f"-DWKV6_CHUNK={_WKV6_CHUNK}",)
# library -> (source, macros)
LIBRARIES = {
    "mr_epoch": ("mr_epoch", ()),
    "mr_epoch_control": ("mr_epoch_control", ()),
    "mr_epoch_trace": ("mr_epoch", ("-DMR_TRACE",)),
    "mr_epoch_control_trace": ("mr_epoch_control", ("-DMR_TRACE",)),
    "mr_schedule": ("mr_schedule", ()),
    "flash_attention": ("flash_attention", ()),
    "wkv6": ("wkv6", _WKV6),
    "wkv6_bwd": ("wkv6_bwd", _WKV6),
}
BUILD_DIR = _HERE / "_build"
# Bitwise parity with the reference needs every float op to round on its
# own: no FMA contraction, IEEE division and square root, no fast math.
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-prec-div=true",
         "-prec-sqrt=true", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The ``nvcc`` to use: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> pathlib.Path:
    src, macros = LIBRARIES[name]
    h = hashlib.sha256(SOURCES[src].read_bytes()
                       + " ".join(FLAGS + macros).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What ``nvcc``/``ptxas`` printed when the library was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=None) -> dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per library, started together.  Returns the seconds
    each build took (0.0 for a library already built).  Raises with the
    compiler's output if a build fails."""
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src, macros = LIBRARIES[name]
        procs[name] = (subprocess.Popen(
            [nvcc(), *FLAGS, *macros, "-o", str(tmp), str(SOURCES[src])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {name} "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (a key of ``LIBRARIES``), built first if
    missing."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
