"""Collision–coalescence kernels: continuous functions and polynomial tensors.

Port of `cloudy_tpu.kernels` (reference src/Kernels/KernelFunctions.jl,
src/Kernels/KernelTensors.jl). Kernel *functions* K(x, y) are frozen
dataclasses callable on numpy arrays, Python floats and torch tensors (the
numerical-quadrature path, `coalescence_numerical`, evaluates them on the
device; the CUDA quadrature kernel reads the four classes here as a tag and
parameters, `ops.numerical_coalescence.kernel_descriptor`, and any other
callable from its trace, `ops.kernel_expr`).
Kernel *tensors* approximate K by a symmetric polynomial
``K(x,y) ≈ Σ c[a,b] x^a y^b`` fitted at init time by linear least squares,
exactly as the JAX package fits them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import numpy as np
import torch

DEFAULT_NORMS = (1e6, 1e-9)  # number scale 1/m^3, mass scale kg


# --------------------------------------------------------------------------
# kernel functions (reference src/Kernels/KernelFunctions.jl:39-116)
# --------------------------------------------------------------------------


def _is_tensor(x, y) -> bool:
    """Whether x or y takes torch functions: a tensor, or the symbolic
    operand of `ops.kernel_expr.trace`."""
    return hasattr(type(x), "__torch_function__") or hasattr(type(y), "__torch_function__")


@dataclasses.dataclass(frozen=True)
class KernelFunction:
    """Base class: callable K(x, y) on scalars or arrays."""

    def __call__(self, x, y):
        raise NotImplementedError

    def normalized(self, norms: Tuple[float, float]) -> "KernelFunction":
        """Rescaled kernel in nondimensional units (reference
        `get_normalized_kernel_func`, src/Kernels/KernelFunctions.jl:124-154)."""
        raise NotImplementedError

    @property
    def x_kinks(self) -> Tuple[float, ...]:
        """Mass coordinates where K is non-smooth."""
        return ()


@dataclasses.dataclass(frozen=True)
class ConstantKernelFunction(KernelFunction):
    """K = B (src/Kernels/KernelFunctions.jl:94-96)."""

    coll_coal_rate: float

    def __call__(self, x, y):
        if _is_tensor(x, y):
            return torch.full_like(x + y, self.coll_coal_rate)
        return np.broadcast_to(
            np.asarray(self.coll_coal_rate),
            np.broadcast_shapes(np.shape(x), np.shape(y)),
        )

    def normalized(self, norms):
        return ConstantKernelFunction(self.coll_coal_rate * norms[0])


@dataclasses.dataclass(frozen=True)
class LinearKernelFunction(KernelFunction):
    """Golovin kernel K = B (x + y) (src/Kernels/KernelFunctions.jl:98-100)."""

    coll_coal_rate: float

    def __call__(self, x, y):
        return self.coll_coal_rate * (x + y)

    def normalized(self, norms):
        return LinearKernelFunction(self.coll_coal_rate * norms[0] * norms[1])


@dataclasses.dataclass(frozen=True)
class HydrodynamicKernelFunction(KernelFunction):
    """K = E (r1 + r2)² |A1 − A2| with r = (3x/4π)^(1/3)
    (src/Kernels/KernelFunctions.jl:102-108)."""

    coal_eff: float

    def __call__(self, x, y):
        r1 = (3.0 / 4.0 / np.pi * x) ** (1.0 / 3.0)
        r2 = (3.0 / 4.0 / np.pi * y) ** (1.0 / 3.0)
        a1 = np.pi * r1**2
        a2 = np.pi * r2**2
        absdiff = torch.abs(a1 - a2) if _is_tensor(x, y) else np.abs(a1 - a2)
        return self.coal_eff * (r1 + r2) ** 2 * absdiff

    def normalized(self, norms):
        return HydrodynamicKernelFunction(
            self.coal_eff * norms[0] * norms[1] ** (4.0 / 3.0)
        )


@dataclasses.dataclass(frozen=True)
class LongKernelFunction(KernelFunction):
    """Long (1974) piecewise kernel: B_lo (x² + y²) below the mass threshold,
    B_hi (x + y) above (src/Kernels/KernelFunctions.jl:110-116)."""

    x_threshold: float
    coal_rate_below_threshold: float
    coal_rate_above_threshold: float

    def __call__(self, x, y):
        below = (x < self.x_threshold) & (y < self.x_threshold)
        where = torch.where if _is_tensor(x, y) else np.where
        return where(
            below,
            self.coal_rate_below_threshold * (x**2 + y**2),
            self.coal_rate_above_threshold * (x + y),
        )

    def normalized(self, norms):
        return LongKernelFunction(
            self.x_threshold / norms[1],
            self.coal_rate_below_threshold * norms[0] * norms[1] ** 2,
            self.coal_rate_above_threshold * norms[0] * norms[1],
        )

    @property
    def x_kinks(self):
        return (self.x_threshold,)


def get_normalized_kernel_func(kern: KernelFunction, norms) -> KernelFunction:
    """`kern` in nondimensional units (`KernelFunction.normalized`)."""
    return kern.normalized(tuple(norms))


# --------------------------------------------------------------------------
# kernel tensors (reference src/Kernels/KernelTensors.jl)
# --------------------------------------------------------------------------


def check_symmetry_array(c: np.ndarray) -> None:
    """Raise if the coefficient matrix is not symmetric
    (reference check_symmetry, src/Kernels/KernelTensors.jl:157-171)."""
    c = np.asarray(c)
    if c.size > 1:
        if c.ndim != 2 or c.shape[0] != c.shape[1]:
            raise ValueError("array must be square to be symmetric")
        if not np.array_equal(c, c.T):
            raise ValueError("array not symmetric")


def check_symmetry_func(func: Callable, n_test: int = 1000, seed: int = 0) -> None:
    """Random-sample symmetry test of K(x,y) = K(y,x)
    (reference src/Kernels/KernelTensors.jl:173-181)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n_test, 2))
    a = np.asarray(func(pts[:, 0], pts[:, 1]))
    b = np.asarray(func(pts[:, 1], pts[:, 0]))
    if np.any(np.abs(a - b) > 1e-6):
        raise ValueError("function likely not symmetric")


def polyfit(
    kernel_func: Union[KernelFunction, Callable],
    order: int,
    limit: float,
    lower_limit: float = 0.0,
    norms: Tuple[float, float] = DEFAULT_NORMS,
    npoints: int = 10,
) -> np.ndarray:
    """Fit ``K(x,y) ≈ Σ_{a,b} c[a,b] x^a y^b`` (c symmetric) on the
    reference's sample grid and loss, solved exactly by least squares
    (same grid, constraint and solver as `cloudy_tpu.kernels.polyfit`, so the
    coefficients are bit-identical). Returned coefficients are in physical
    units."""
    if isinstance(kernel_func, KernelFunction):
        kfn = kernel_func.normalized(norms)
    else:
        kfn = kernel_func
        norms = (1.0, 1.0)
    limit_n = limit / norms[1]
    lower_limit_n = lower_limit / norms[1]
    check_symmetry_func(kfn)
    if limit_n <= lower_limit_n or lower_limit_n < 0:
        raise ValueError("polyfit limits improperly specified")

    # triangular sample grid (reference :103-112)
    delta = limit_n / (npoints - 1)
    idx = np.arange(npoints * npoints)
    x_ = (idx % npoints) * delta
    y_ = np.floor(idx / npoints) * delta
    keep = (y_ >= lower_limit_n) & (y_ - x_ >= 0)
    xk, yk = x_[keep], y_[keep]

    c00 = max(np.finfo(np.float64).eps, float(np.asarray(kfn(0.0, 0.0))))
    P = order + 1
    if order == 0:
        return np.array([[c00 / norms[0]]])

    # loss over the cartesian product of the kept x-list and kept y-list
    X = xk[:, None]
    Y = yk[None, :]
    target = (np.asarray(kfn(X, Y)) - c00).ravel()

    # free symmetric coefficient pairs (a <= b), excluding (0, 0)
    pairs = [(a, b) for b in range(P) for a in range(b + 1) if (a, b) != (0, 0)]
    design = np.stack(
        [
            (X**a * Y**b + (X**b * Y**a if a != b else 0.0)).ravel()
            for (a, b) in pairs
        ],
        axis=1,
    )
    coef, *_ = np.linalg.lstsq(design, target, rcond=None)

    c = np.zeros((P, P))
    c[0, 0] = c00
    for (a, b), v in zip(pairs, coef):
        c[a, b] = v
        c[b, a] = v
    # denormalize (reference :141-145)
    denorm = norms[0] * norms[1] ** (
        np.add.outer(np.arange(P), np.arange(P)).astype(np.float64)
    )
    return c / denorm


@dataclasses.dataclass(frozen=True)
class CoalescenceTensor:
    """Symmetric polynomial kernel tensor (reference `CoalescenceTensor`,
    src/Kernels/KernelTensors.jl:44-64). ``c`` has shape (P, P)."""

    c: Tuple[Tuple[float, ...], ...]  # stored as nested tuples => hashable

    def __post_init__(self):
        arr = np.asarray(self.c, dtype=np.float64)
        check_symmetry_array(arr)
        object.__setattr__(
            self, "c", tuple(tuple(float(v) for v in row) for row in arr)
        )

    @property
    def array(self) -> np.ndarray:
        return np.asarray(self.c, dtype=np.float64)

    @property
    def order(self) -> int:
        return len(self.c) - 1

    @classmethod
    def from_function(
        cls,
        kernel_func,
        order: int,
        limit: float,
        lower_limit: float = 0.0,
        norms: Tuple[float, float] = DEFAULT_NORMS,
    ) -> "CoalescenceTensor":
        return cls(polyfit(kernel_func, order, limit, lower_limit, norms))

    def normalized(self, norms: Tuple[float, float]) -> "CoalescenceTensor":
        """``c[a,b] *= norms[0] * norms[1]^(a+b)`` (reference
        `get_normalized_kernel_tensor`, src/Kernels/KernelTensors.jl:189-199)."""
        P = len(self.c)
        scale = norms[0] * norms[1] ** (
            np.add.outer(np.arange(P), np.arange(P)).astype(np.float64)
        )
        return CoalescenceTensor(self.array * scale)

    def __call__(self, x, y):
        """Evaluate the polynomial approximation at (x, y)."""
        arr = self.array
        P = arr.shape[0]
        out = 0.0
        for a in range(P):
            for b in range(P):
                if arr[a, b] != 0.0:
                    out = out + arr[a, b] * x**a * y**b
        return out


def get_normalized_kernel_tensor(kernel: CoalescenceTensor, norms) -> CoalescenceTensor:
    """`kernel` in nondimensional units (`CoalescenceTensor.normalized`)."""
    return kernel.normalized(tuple(norms))
