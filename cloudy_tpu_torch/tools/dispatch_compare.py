"""Time what compiling the kernel function into the quadrature kernel buys.

`csrc/numerical_coalescence.cu` instantiates its kernel per kernel function
(constant, linear, hydrodynamic, Long): 24 instances in six build units. Built
with ``-DCLOUDY_RUNTIME_KTAG`` the same source reads the tag from the
configuration instead, a test that is uniform over the launch: 6 instances.
This tool builds both libraries and times both in one process order
``compiled, runtime, runtime, compiled`` (one subprocess each, so each loads
its own library): the numerical bench (262,144 boxes, Long, f32, 10 launches)
and the hydrodynamic kernel on two gamma modes at (64, 32) nodes on 32,768
boxes in f32 and f64. One JSON line per run, with the build's seconds (0 for
a library that is already built). Needs a CUDA device and nvcc:

    python -m cloudy_tpu_torch.tools.dispatch_compare
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _time_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def run(dispatch: str) -> dict:
    import torch

    from cloudy_tpu_torch import bench
    from cloudy_tpu_torch import kernels as K
    from cloudy_tpu_torch.ops import _build
    from cloudy_tpu_torch.ops import numerical_coalescence as nc
    from cloudy_tpu_torch.spec import Family, SpectrumSpec

    if dispatch == "runtime":
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DCLOUDY_RUNTIME_KTAG")
    t0 = time.perf_counter()
    _build.load_library()
    out = {"dispatch": dispatch, "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    fn = bench.numerical_fn("cuda")
    x = torch.as_tensor(bench.numerical_moments().T.copy(), dtype=torch.float32,
                        device="cuda")
    out["bench_long_f32_ms"] = _time_ms(lambda: fn.soa(x), 10)
    out["bench_checksum"] = float(fn.soa(x).double().sum())
    spec = SpectrumSpec((Family.GAMMA, Family.GAMMA))
    x = x[:, :32768].contiguous()
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        hydro = nc.make_numerical_fn(spec, K.HydrodynamicKernelFunction(1e-2), 64, 32,
                                     device="cuda", dtype=dtype)
        xs = x.to(dtype)
        out[f"hydro_{name}_ms"] = _time_ms(lambda: hydro.soa(xs), 5)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print(json.dumps(run(argv[0])))
        return
    for dispatch in ("compiled", "runtime", "runtime", "compiled"):
        subprocess.run([sys.executable, "-m", "cloudy_tpu_torch.tools.dispatch_compare",
                        dispatch], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
