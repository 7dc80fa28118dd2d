"""Build and load the hand-written CUDA kernels (nvcc -> .so -> ctypes).

Every ``csrc/*.cu`` file is compiled on first use by its own ``nvcc``
process, all started together, into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of the headers under
``csrc/`` (``hopper.cuh``), so an edited kernel or header is never served
from a stale build.  The build directory (``kernels/_build``, listed
in ``.gitignore``) also keeps each build's ``ptxas`` report.  Nothing is
compiled or loaded at import time: the CPU tests import every module.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last :func:`reset_launches`.
LAUNCHES: collections.Counter = collections.Counter()
#: E -> launches of subcge_apply_epochs with E epochs (same reset).
EPOCH_LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry points per source file: name -> argtypes.
_SIGNATURES = {
    "rank1_matmul": {"rank1_matmul_f32": [_P] * 7 + [_I] * 8 + [_L] * 10
                     + [_P],
                     "rank1_matmul_bf16": [_P] * 9 + [_I] * 12 + [_L] * 10
                     + [_P]},
    "subcge_apply": {"subcge_apply_f32": [_P] * 5 + [_I] * 11 + [_L] * 2
                     + [_P],
                     "subcge_apply_bf16": [_P] * 5 + [_I] * 11 + [_L] * 2
                     + [_P]},
    "selective_scan": {"selective_scan_f32": [_P] * 6 + [_I] * 4 + [_P]},
    "selective_scan_bwd": {"selective_scan_bwd_f32": [_P] * 12 + [_I] * 10
                           + [_P]},
}


def reset_launches() -> None:
    LAUNCHES.clear()
    EPOCH_LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card")
    return path


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, of
    every header under ``csrc/`` (any source may include one) and of the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    """The compiler's report (``ptxas -v``) of ``csrc/<name>.cu``'s build."""
    return _lib_path(name).with_suffix(".log")


def build_all() -> float:
    """Compile every source whose library is missing, one nvcc per source,
    all in parallel.  Returns the wall seconds spent; raises on failure."""
    t0 = time.perf_counter()
    todo = [n for n in sorted(_SIGNATURES) if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        final = _lib_path(name)
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, final, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, final, tmp, proc in procs:
        log, _ = proc.communicate()
        log_path(name).write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, final)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
