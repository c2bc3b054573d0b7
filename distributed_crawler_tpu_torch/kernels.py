"""Build and bind the port's hand-written CUDA kernels.

Each kernel is a `csrc/*.cu` file with a plain ``extern "C"`` launcher.  At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``_build/`` (git-ignored), keyed by a hash of its source and flags, and
loaded with ``ctypes``.  Nothing here runs at import time, so the CPU tests
import the port on a machine with no ``nvcc``.  A failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # when nvcc is not on PATH

# One source file per library; every kernel of the port is listed here.
SOURCES: Dict[str, str] = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_sm90": "flash_attention_sm90.cu",
}

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills, into the log
)


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float     # nvcc wall time; 0.0 when the library was cached
    cached: bool
    log: str           # nvcc's output (ptxas register/smem report), kept
    #                    beside the library for cached builds


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_builds: Dict[str, BuildResult] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "the machine with the card, at first use")


def _target(name: str, nvcc: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> List[BuildResult]:
    """Compile every named kernel whose library is not built yet, one
    ``nvcc`` per source, all started together.  Raises on any failure."""
    names = list(names)
    for name in names:
        if name not in SOURCES:
            raise KeyError(f"unknown kernel {name!r}; one of {sorted(SOURCES)}")
    with _lock:
        todo = [n for n in names if n not in _builds]
        if todo:
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = []
            for name in todo:
                target = _target(name, nvcc)
                if target.exists():
                    log_path = target.with_suffix(".log")
                    log = log_path.read_text() if log_path.exists() else ""
                    _builds[name] = BuildResult(name, target, 0.0, True, log)
                    continue
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / SOURCES[name])]
                procs.append((name, target, tmp, time.perf_counter(),
                              subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT,
                                               text=True)))
            failures = []
            for name, target, tmp, t0, proc in procs:
                log, _ = proc.communicate()
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    failures.append(f"{name} (rc {proc.returncode}):\n{log}")
                    continue
                target.with_suffix(".log").write_text(log)
                os.replace(tmp, target)
                _builds[name] = BuildResult(name, target, seconds, False, log)
            if failures:
                raise RuntimeError("nvcc failed for " + "\n".join(failures))
        return [_builds[n] for n in names]


def load(name: str,
         signatures: Dict[str, Tuple[Sequence, object]]) -> ctypes.CDLL:
    """The kernel's library, built if needed, with ``argtypes``/``restype``
    set for every function in ``signatures``."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    (result,) = build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(result.path))
            for fn_name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _libs[name] = lib
    return lib
