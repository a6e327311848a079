"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
shared library, compiled by ``nvcc`` for ``sm_90a`` into ``build/`` next
to this file (listed in ``.gitignore``) under a name keyed by a hash of
the sources and flags, so a changed source is rebuilt and an unchanged one
is not.  All missing libraries are compiled at once, one ``nvcc`` each.
The result is loaded with ``ctypes``.  A failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).with_name("csrc")
_BUILD = Path(__file__).with_name("build")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in [src, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return _BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build_all() -> dict:
    """Compile every ``csrc/*.cu`` not built yet, in parallel; returns
    {stem: library path}.  The compiler's output lands beside each
    library as ``.log``."""
    sources = sorted(_CSRC.glob("*.cu"))
    _BUILD.mkdir(parents=True, exist_ok=True)
    running = []
    for src in sources:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(src)]
        running.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, out, tmp, proc in running:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent ranks may build too
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {src.stem: _target(src) for src in sources}


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned data pointer (a copy where
    a view starts elsewhere), as the kernels' 16-byte loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _library(stem: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, with ``argtypes`` set
    from ``signatures`` ({function: [ctypes types]}; every function
    returns an int error code)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(_build_all()[stem]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[stem] = lib
        return lib
