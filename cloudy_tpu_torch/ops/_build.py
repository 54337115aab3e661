"""Build and bind the CUDA kernels of csrc/ (nvcc → shared library → ctypes).

The sources are compiled at first use into ``build/cloudy_tpu_torch/`` at
the root of the checkout, with a plain C interface (no PyTorch headers). A
source declares build units (``CLOUDY_IN_UNIT(u)``, one kernel in one type
each, some declared to build without FMA contraction); every unit is
compiled by its own ``nvcc``, all started together, and the objects are
linked into one shared library, so the build takes as
long as its slowest kernel. The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. The compiler's per-kernel report (``-Xptxas -v``: registers,
shared memory, spills) is written beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cloudy_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _units(src: Path):
    """The build units a source declares (``CLOUDY_IN_UNIT(u)``), or [None]
    for a source built whole."""
    units = sorted({int(u) for u in re.findall(r"CLOUDY_IN_UNIT\((\d+)\)",
                                               src.read_text())})
    return units or [None]


def _no_fma_units(src: Path) -> set:
    """The units a source builds without FMA contraction (``-fmad=false``),
    declared once as ``CLOUDY_NO_FMA_UNITS: u ...``."""
    m = re.search(r"CLOUDY_NO_FMA_UNITS:([ \t\d]*)", src.read_text())
    return {int(u) for u in m.group(1).split()} if m else set()


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists: one
    ``nvcc -c`` per build unit, all running at once, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        no_fma = _no_fma_units(src)
        for u in _units(src):
            obj = BUILD_DIR / f"{tag}.{src.stem}.{u}.o"
            unit = [] if u is None else [f"-DCLOUDY_UNIT={u}"]
            unit += ["-fmad=false"] if u in no_fma else []
            cmd = [nvcc, *NVCC_FLAGS, *unit, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], None
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    tmp = so.with_name(f"{tag}.tmp")
    if failed is None:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed = (cmd, res.returncode, res.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, declare every entry point's signature
    (pointers and the stream as ``c_void_p``: 64 bits), and check that the
    library's configuration layout is the one the host packs."""
    from cloudy_tpu_torch.ops import fused_coalescence, numerical_coalescence

    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for tag in ("f32", "f64"):
        for name in ("cloudy_coal", "cloudy_rhs"):
            f = getattr(lib, f"{name}_{tag}")
            f.argtypes = [p, p, p, i, ll, i, p]  # ..., B, arms, stream
            f.restype = i
        f = getattr(lib, f"cloudy_step_{tag}")
        f.argtypes = [p, p, p, i, ll, i, i, p]  # ..., B, nz, arms, stream
        f.restype = i
        f = getattr(lib, f"cloudy_step_scaled_{tag}")
        f.argtypes = [p, p, p, i, ll, i, i, p, p]  # ..., B, nz, arms, scale, stream
        f.restype = i
        for n_modes in range(1, numerical_coalescence.MAX_MODES + 1):
            f = getattr(lib, f"cloudy_numerical_{tag}_n{n_modes}")
            f.argtypes = [p, p, p, i, ll, i, i, p]  # ..., B, G, ktag, stream
            f.restype = i
    lib.cloudy_error_string.argtypes = [i]
    lib.cloudy_error_string.restype = ctypes.c_char_p
    got = (ctypes.c_int * 8)()
    for export, module, names in (
        (lib.cloudy_layout, fused_coalescence,
         "MAX_MODES, MAX_NTOT, MAX_M, CFG_MAX_BYTES, header ints"),
        (lib.cloudy_numerical_layout, numerical_coalescence,
         "MAX_MODES, MAX_G, MAX_NMOM, CFG_MAX_BYTES, header ints"),
    ):
        n = export(got)
        if tuple(got[:n]) != module.LAYOUT:
            raise RuntimeError(
                f"{lib._name}: configuration layout {tuple(got[:n])} ({names}) "
                f"differs from the host's {module.LAYOUT}"
            )
    return lib
