"""Per-op-class chain kernels (B6), with their plain PyTorch twin.

Counterpart of tools/op_microbench.py (`_kernel` :141, `measure` :157,
`pallas_call` :170): each *chain* applies K serial *links* of one small
bundle of operations to ILP independent streams of elements. Each link
depends on the one before, so no link can be dropped or merged, and the
ILP streams give the scheduler independent work. Timing two chain lengths
and differencing cancels the launch and the loads and stores
(`cloudy_tpu_torch.tools.op_microbench`).

The chain table is the JAX tool's: the same 18 names, the same per-link
counts over the same 13 `CLASSES` (12 primitive and mixed chains, 6
bundles of the special functions the coalescence kernels evaluate). The
link functions are written like the JAX lambdas, constants as Python
scalars, so that they round once to the tensor's type as jnp's weakly
typed constants do; the bundles call this port's `ops.special`.

Layout: ``x [ilp, n]``, contiguous; stream i is row i. `chain_plain` is
the twin on any device. The kernel (csrc/op_chains.cu, one instance per
chain and type, at ILP 8) runs one thread per column with its ILP values in
registers; `chain_kernel(name, dtype)` returns its wrapper, which runs the
twin for a tensor on the CPU and launches the kernel for a tensor on the
card, or raises; it never falls back. Its `launches` counts launches.
"""

from __future__ import annotations

import functools

import torch

from cloudy_tpu_torch.ops import special

#: the JAX tool's short chain lengths (tools/op_microbench.py:47, :50,
#: :176-183); the long one, K2, is sized on the card by a pilot
K1 = 32
K1_BUNDLE = 4
K1_GAMMAINCINV = 2
#: independent streams per thread, the one ILP the kernels are compiled for
#: (the JAX tool's default)
ILP = 8
#: threads per block of the chain kernels (csrc/op_chains.cu kThreads)
THREADS = 256

#: lgamma(4.5), the `gln` of the gammainc_gl12 chain (tools/op_microbench.py:98)
_GLN_45 = 2.4537365708424423

# chain name -> (per-link op-class counts, link function); classes: mul, add
# (incl. sub/neg/min/max/compare), div, exp, log, sqrt, sel (where)
CHAINS = {
    "mul": ({"mul": 1}, lambda x: x * 1.0000001),
    "add": ({"add": 1}, lambda x: x + 1e-6),
    "muladd": ({"mul": 1, "add": 1}, lambda x: x * 0.999999 + 1e-4),
    "div": ({"div": 1, "add": 2}, lambda x: (x + 2.0) / (x + 3.0)),
    "exp": ({"exp": 1, "add": 1}, lambda x: torch.exp(0.3 - x)),
    "log": ({"log": 1, "add": 1}, lambda x: torch.log(x + 1.5)),
    "sqrt": ({"sqrt": 1, "add": 1}, lambda x: torch.sqrt(x + 0.5)),
    "sel": (
        {"sel": 1, "mul": 1, "add": 2},
        lambda x: torch.where(x > 0.6, x * 0.699999, x + 0.25),
    ),
    # mixed validation chains (overdetermine the least-squares system)
    "expdiv": (
        {"exp": 1, "div": 1, "add": 2},
        lambda x: torch.exp(-x) / (x + 1.5) + 0.4,
    ),
    "explog": (
        {"exp": 1, "log": 1, "add": 2},
        lambda x: torch.log(torch.exp(0.3 - x) + 0.9),
    ),
    "poly": (
        {"mul": 3, "add": 3},
        lambda x: ((0.01 * x + 0.2) * x + 0.1) * x + 0.3,
    ),
    "expmul4": (
        {"exp": 1, "mul": 4, "add": 1},
        lambda x: torch.exp(0.3 - x) * (0.9999 * 1.0001)
        * ((1.0 + 1e-7) * x + 1e-6) * 0.5,
    ),
}

# whole special-function evaluations; the class columns of each row are the
# chain's own glue operations besides its bundle
BUNDLES = {
    "lgamma": ({"lgamma": 1, "add": 1}, lambda x: special.lgamma(x + 2.2)),
    "lgamma_stirling": (
        {"lgamma_stirling": 1, "add": 1},
        lambda x: special.lgamma_stirling(x + 2.2),
    ),
    "gammainc_gl12": (
        {"gammainc_gl12": 1, "mul": 1, "add": 1},
        lambda x: special.gammainc_gl(4.5, 0.5 + 3.0 * x, n_nodes=12, gln=_GLN_45),
    ),
    "erf_approx": (
        {"erf_approx": 1, "mul": 1, "add": 2},
        lambda x: 0.1 + 0.7 * torch.abs(special.erf_approx(x)),
    ),
    "gamma_ratio": (
        {"gamma_ratio": 1, "mul": 1, "add": 2},
        lambda x: 0.2 + 0.5 * special.gamma_ratio(x + 0.5, 1.0 / 6.0),
    ),
    "gammaincinv_gl12": (
        {"gammaincinv_gl12": 1, "mul": 1},
        # a = 2.5 as a tensor on x's device (a bare float would stay on the host)
        lambda x: 0.1 * special.gammaincinv_gl_impl(x.new_tensor(2.5), x, n_iter=3,
                                                    n_nodes=12),
    ),
}
CHAINS.update(BUNDLES)

CLASSES = (
    "mul", "add", "div", "exp", "log", "sqrt", "sel",
    "lgamma", "lgamma_stirling", "gammainc_gl12", "erf_approx",
    "gamma_ratio", "gammaincinv_gl12",
)
#: the primitive classes, onto which `tools.opcount.count_ops_by_class`
#: maps a twin's operations
PRIMITIVE_CLASSES = CLASSES[:7]
#: chain index = the kernel's chain id (csrc/op_chains.cu CLOUDY_CHAINS)
NAMES = tuple(CHAINS)


def k1_of(name: str) -> int:
    """The short chain length of `name` (the JAX tool's K1)."""
    if name == "gammaincinv_gl12":
        return K1_GAMMAINCINV
    return K1_BUNDLE if name in BUNDLES else K1


def chain_plain(name: str, xs: torch.Tensor, k: int) -> torch.Tensor:
    """`k` links of chain `name` applied to every element of `xs` (any
    shape; the ILP streams are independent, so a stacked tensor is the
    streams side by side)."""
    link = CHAINS[name][1]
    for _ in range(k):
        xs = link(xs)
    return xs


@functools.lru_cache(maxsize=None)
def _config() -> dict:
    """The configuration the bundles read their Gauss-Legendre tables from:
    one gamma mode of a 12-node fast-tier plan, packed by the host packer
    of the coalescence kernels (the tables sit in shared memory where B1
    reads them). Both types' packings, cached on the host."""
    from cloudy_tpu_torch.ops import fused_coalescence as fc
    from cloudy_tpu_torch.spec import Family

    plan = fc.FusedPlan(families=(int(Family.GAMMA),), offsets=(0,), nprog=(3,),
                        thr_flag=(0,), thr_const=(), moving=False, M=3, wb_nz=(),
                        wf_nz=(), gl_nodes=12)
    return {dt: torch.from_numpy(fc.pack_config(plan, dt))
            for dt in (torch.float32, torch.float64)}


class ChainFn:
    """Chain `name` in `dtype`: ``fn(x [ilp, n], k)`` → ``[ilp, n]``. The
    twin for a CPU tensor, kernel ``cloudy_chain_<tag>`` for a CUDA tensor;
    `launches` counts kernel launches."""

    def __init__(self, name: str, dtype: torch.dtype):
        if name not in CHAINS:
            raise ValueError(f"unknown chain {name!r}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, not {dtype}")
        self.name = name
        self.dtype = dtype
        self.chain_id = NAMES.index(name)
        self.launches = 0
        self._cfg = {}

    @property
    def _tag(self) -> str:
        return "f32" if self.dtype == torch.float32 else "f64"

    def _check(self, x: torch.Tensor, k: int) -> None:
        if x.dtype != self.dtype:
            raise ValueError(f"tensor of {x.dtype}, chain built for {self.dtype}")
        if x.ndim != 2 or x.shape[0] != ILP or x.shape[1] == 0:
            raise ValueError(f"expected [ilp = {ILP}, n > 0], got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("expected a contiguous [ilp, n] tensor")
        if k < 0:
            raise ValueError(f"k={k} < 0")

    def __call__(self, x: torch.Tensor, k: int) -> torch.Tensor:
        self._check(x, k)
        if x.device.type == "cpu":
            return chain_plain(self.name, x, k)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        from cloudy_tpu_torch.ops import _build

        lib = _build.load_library()
        cfg = self._cfg.get(x.device)
        if cfg is None:
            cfg = self._cfg[x.device] = _config()[self.dtype].to(x.device)
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = getattr(lib, f"cloudy_chain_{self._tag}")(
                self.chain_id, x.shape[0], x.data_ptr(), out.data_ptr(), x.shape[1],
                int(k), cfg.data_ptr(), cfg.numel(), stream)
        if err != 0:
            raise RuntimeError(
                f"cloudy_chain_{self._tag}[{self.name}] launch failed: cudaError "
                f"{err} ({lib.cloudy_error_string(err).decode()})")
        self.launches += 1
        return out

    def plain(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """The plain twin on any device (comparisons and timing)."""
        self._check(x, k)
        return chain_plain(self.name, x, k)

    def blocks_per_sm(self) -> int:
        """Resident blocks of `THREADS` threads per SM of the kernel instance
        (the CUDA occupancy calculator, on the current device)."""
        import ctypes

        from cloudy_tpu_torch.ops import _build

        lib = _build.load_library()
        n = ctypes.c_int(0)
        cfg_bytes = _config()[self.dtype].numel()
        err = getattr(lib, f"cloudy_chain_blocks_per_sm_{self._tag}")(
            self.chain_id, cfg_bytes, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"occupancy of chain {self.name}: cudaError {err}")
        return n.value


@functools.lru_cache(maxsize=None)
def chain_kernel(name: str, dtype: torch.dtype = torch.float32) -> ChainFn:
    """The wrapper of chain `name` in `dtype` (one per pair, so that its
    launch count is the pair's)."""
    return ChainFn(name, dtype)
