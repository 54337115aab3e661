"""Build and bind the CUDA kernels of csrc/ (nvcc → shared library → ctypes).

The sources are compiled at first use into ``build/cloudy_tpu_torch/`` at
the root of the checkout, with a plain C interface (no PyTorch headers, so a
build takes seconds). The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
The compiler's per-kernel report (``-Xptxas -v``: registers, shared memory,
spills) is written beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cloudy_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    return BUILD_DIR / f"libcloudy_fused_{_digest()}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, declare every entry point's signature
    (pointers and the stream as ``c_void_p``: 64 bits), and check that the
    library's configuration layout is the one the host packs."""
    from cloudy_tpu_torch.ops.fused_coalescence import LAYOUT

    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for tag in ("f32", "f64"):
        f = getattr(lib, f"cloudy_coal_{tag}")
        f.argtypes = [p, p, p, i, ll, p]
        f.restype = i
        f = getattr(lib, f"cloudy_step_{tag}")
        f.argtypes = [p, p, p, i, ll, i, p]
        f.restype = i
    lib.cloudy_error_string.argtypes = [i]
    lib.cloudy_error_string.restype = ctypes.c_char_p
    got = (ctypes.c_int * 8)()
    n = lib.cloudy_layout(got)
    if tuple(got[:n]) != LAYOUT:
        raise RuntimeError(
            f"{lib._name}: configuration layout {tuple(got[:n])} (MAX_MODES, "
            f"MAX_NTOT, MAX_M, CFG_MAX_BYTES, header ints) differs from the "
            f"host's {LAYOUT}"
        )
    return lib
