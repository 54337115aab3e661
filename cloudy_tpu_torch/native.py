"""The native golden model: an independent C++ oracle of the analytical
coalescence step, bound by ctypes.

Port of `cloudy_tpu.native`. `native/cloudy_golden.cc` (closure inversion,
diagnostic moments, the log-grid Simpson / incomplete-gamma autoconversion
integrals, the Q/R/S assembly, for gamma and exponential modes with fixed
thresholds) is the repository's own source; this module compiles it with
g++ into ``build/cloudy_tpu_torch/`` under a name that carries the source's
digest, at first use, and never writes the library beside the source
(``native/libcloudy_golden.so`` belongs to the JAX package). The oracle runs
on the host in f64: `coal_ints_golden` takes the port's `CoalescenceData`
and moments as a tensor on any device or an array, and returns a host
array.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from cloudy_tpu_torch.coalescence import CoalescenceData
from cloudy_tpu_torch.spec import Family

_REPO = Path(__file__).resolve().parent.parent
SOURCE = _REPO / "native" / "cloudy_golden.cc"
BUILD_DIR = _REPO / "build" / "cloudy_tpu_torch"
#: the JAX package's build command (cloudy_tpu/native.py:35-44)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libcloudy_golden_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the oracle if its library is missing (or `force`); the
    library is written under a temporary name and renamed into place."""
    lib = library_path()
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
        lib.coal_ints_golden.restype = ctypes.c_int
        lib.coal_ints_golden.argtypes = [dp, ctypes.c_int64, ctypes.c_int, ip, ip, dp,
                                         ctypes.c_int, dp, dp]
        _lib = lib
    return _lib


def coal_ints_golden(data: CoalescenceData, mom) -> np.ndarray:
    """Golden-model coalescence tendencies for normalized moments ``mom
    [B, n_tot]`` (a tensor on any device, or an array; read to the host as
    f64). Gamma and exponential modes, FixedThreshold only."""
    spec = data.spec
    if data.moving:
        raise ValueError("golden model supports FixedThreshold only")
    codes = {Family.EXPONENTIAL: 0, Family.GAMMA: 1}
    for f in spec.families:
        if f not in codes:
            raise ValueError(f"golden model does not support {Family(f).name}")
    if isinstance(mom, torch.Tensor):
        mom = mom.detach().to("cpu", torch.float64).numpy()
    mom = np.ascontiguousarray(np.atleast_2d(np.asarray(mom, np.float64)))
    out = np.empty_like(mom)
    families = np.asarray([codes[f] for f in spec.families], np.int32)
    nprog = np.asarray(spec.nprogmoms, np.int32)
    kernels = np.ascontiguousarray(data.kernels, np.float64)
    thresholds = np.ascontiguousarray(data.thresholds, np.float64)
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    rc = _load().coal_ints_golden(
        mom.ctypes.data_as(dp), ctypes.c_int64(mom.shape[0]), ctypes.c_int(spec.n_modes),
        families.ctypes.data_as(ip), nprog.ctypes.data_as(ip), kernels.ctypes.data_as(dp),
        ctypes.c_int(data.P), thresholds.ctypes.data_as(dp), out.ctypes.data_as(dp))
    if rc != 0:
        raise RuntimeError(f"coal_ints_golden failed: {rc}")
    return out
