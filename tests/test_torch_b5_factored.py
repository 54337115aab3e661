"""B5's traced arm in its factored form (`kernel_expr.factor`), on the CPU.

The ``KT_GEN`` arm of csrc/numerical_coalescence.cu takes R from the
factored form of the traced K(x, y) = Σ_i f_i(x) g_i(y) + r(x, y): the
separable terms as block sums of g_i(y) WX F_j(y) times f_i(X), the
remainder alone over every pair, from x values computed once per outer node
and y values tabled once per node. Here:

- the factoring of named traces: the kernel tensor (separable, no
  remainder), the lambda 1e-3 (x² + y²) + 1e-4 sqrt(xy) (two separable
  terms, the sqrt in the remainder), `efficiency` (all remainder, log1p(x)
  an x value), (x − y)² (not expanded: all remainder), a separable term
  that changes sign ((x − 1)(y − 1), its factors kept whole), and
  `coverage`, `special` and `activations` (mostly separable, some
  remainder); for every one Σ f_i g_i + r evaluated on a grid is K (f64
  relative ≤ 1e-14);
- the emitted unit (``cfg.cuh``: ``cloudy_gen_y``, ``cloudy_gen_x``,
  ``cloudy_gen_pair``) compiled as host C++ and run as the arm runs it,
  against ``cloudy_kernel_gen`` summed pair by pair, in f64 at 1e-14
  relative on A_j;
- the twin's R from the factored form (`kernel_expr.factored_r_sums`,
  through which `tools.opcount` counts the arm's work) against the twin's
  loop over every pair (f64, row-scaled ≤ 1e-14), and the count: no G × G
  work where K is separable;
- the budget of tabled y values: past it the remainder recomputes the rest
  from y per pair, and the unit is still K.

The kernel against the twin on the card:
tests/test_torch_cuda_kernels.py::test_traced_kernel_function_matches_twin.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import _codegen_host as ch
from test_torch_b5_callable import CASES, TWO_GAMMA, _moments
from test_torch_kernel_expr import ERFINV

from cloudy_tpu_torch.ops import _build, codegen, kernel_expr
from cloudy_tpu_torch.ops import numerical_coalescence as nc
from cloudy_tpu_torch.spec import SpectrumSpec
from cloudy_tpu_torch.tools import opcount
from cloudy_tpu_torch.tools import traced_kernels as tk

torch.set_num_threads(1)


def _sign(x, y):
    """A separable term that changes sign: (x − 1)(y − 1), each factor a
    sum of one variable, kept whole."""
    return 1e-3 * (x + y) + 1e-4 * (x - 1.0) * (y - 1.0)


#: the traced kernel functions of this file
KERNELS = {
    "tensor": lambda: CASES["tensor"]()[0],
    "lambda": lambda: CASES["lambda"]()[0],
    "square": lambda: (lambda x, y: 1e-3 * (x - y) ** 2),
    "sign": lambda: _sign,
    **{k: (lambda f: lambda: f)(f) for k, f in tk.KERNELS.items()},
}


def _ops(e):
    """The operations of an expression, as a set."""
    out, stack, seen = set(), [e], set()
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        out.add(n.op)
        if n.op not in ("var", "const", "int"):
            stack.extend(n.args)
    return out


def _factor(name, dtype=torch.float64):
    return kernel_expr.factor(kernel_expr.trace(KERNELS[name](), dtype))


def test_factoring_of_the_named_traces():
    tensor = _factor("tensor")
    assert tensor.remainder is None and tensor.terms and not tensor.tabled
    lam = _factor("lambda")
    assert len(lam.terms) == 2 and lam.remainder is not None
    assert "sqrt" in _ops(lam.remainder) and "add" not in _ops(lam.remainder)
    assert lam.remainder_nodes == 3  # 1e-4 * sqrt(x * y)
    eff = _factor("efficiency")
    assert not eff.terms and eff.remainder is not None
    assert any(v.op == "log1p" and v.args[0].op == "var" for v in eff.x_values)
    square = _factor("square")
    assert not square.terms and square.remainder is not None  # (x - y)**2 stays whole
    sign = _factor("sign")
    assert sign.remainder is None
    gs = [kernel_expr.statements(g, repr)[1] for _, g in sign.terms]
    fs = [kernel_expr.device_source(f, repr) for f, _ in sign.terms]
    assert any("x - 1.0" in f for f in fs) and len(gs) == 3  # (x - 1) kept whole
    for name in ("coverage", "special", "activations"):
        fac = _factor(name)
        assert fac.terms and fac.remainder is not None, name
        assert len(fac.tabled) <= kernel_expr.TABLE_BUDGET


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_factored_form_is_the_kernel(name):
    """Σ f_i(x) g_i(y) + r(x, y) evaluated on a grid is K, in f64."""
    expr = kernel_expr.trace(KERNELS[name]())
    fac = kernel_expr.factor(expr)
    rng = np.random.default_rng(41)
    x = torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), np.log(50.0), (40, 1))))
    y = torch.as_tensor(np.exp(rng.uniform(np.log(1e-3), np.log(50.0), (1, 30))))
    total = torch.zeros(40, 30, dtype=torch.float64)
    for f, g in fac.terms:
        total = total + kernel_expr.evaluate(f, x, y) * kernel_expr.evaluate(g, x, y)
    if fac.remainder is not None:
        total = total + kernel_expr.evaluate(fac.remainder, x, y)
    want = kernel_expr.evaluate(expr, x, y)
    assert float(((total - want).abs() / want.abs().clamp_min(1e-300)).max()) <= 1e-14


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_factored_twin_r_matches_pair_loop(name):
    """The twin with R from the factored form against the twin's loop
    over every pair (f64, (32, 16) nodes, 8 boxes)."""
    mom = torch.as_tensor(_moments(TWO_GAMMA, 8, seed=3).T.copy())
    fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), KERNELS[name](), 32, 16, device="cpu",
                              dtype=torch.float64)
    want = nc.numerical_soa_plain(mom, fn.plan)
    got = nc.numerical_soa_plain(mom, fn.plan, kernel_expr.factored_r_sums(
        kernel_expr.factor(kernel_expr.trace(fn.plan.kernel_func))))
    d = (got - want).abs().max(dim=1).values / want.abs().max(dim=1).values
    assert float(d.max()) <= 1e-14


def test_bound_counts_no_pair_loop_where_k_is_separable():
    """`opcount.count_ops_traced` counts the arm's work: the tensor's count
    grows linearly in the outer nodes (no G × G term), the lambda's and
    `efficiency`'s quadratically (8 boxes, three node budgets)."""
    mom = torch.as_tensor(_moments(TWO_GAMMA, 8, seed=3).T.copy())

    def count(name, n_outer):
        fn = nc.make_numerical_fn(SpectrumSpec(TWO_GAMMA), KERNELS[name](), n_outer, 8,
                                  device="cpu", dtype=torch.float64)
        return fn.plan.g_total, opcount.count_ops_traced(fn, mom)

    def quadratic(name):
        # the count is c0 + c1 G + c2 G^2 (a kinked K's panels round G)
        g, n = zip(*(count(name, k) for k in (18, 36, 72)))
        return np.linalg.solve(np.vander(np.asarray(g, float), 3), np.asarray(n, float))[0]

    assert abs(quadratic("tensor")) < 1e-6
    assert quadratic("lambda") > 1.0 and quadratic("efficiency") > 1.0
    assert quadratic("lambda") < quadratic("efficiency")


# --------------------------------------------------------------------------
# the emitted unit as host C++
# --------------------------------------------------------------------------

#: A_j of two modes on G nodes, by the pair sum and as the arm takes them
HARNESS = """#include "cfg.cuh"
using cloudy::kGenTerms; using cloudy::kGenXValues; using cloudy::kGenYValues;
constexpr int NT = kGenTerms > 0 ? kGenTerms : 1;
extern "C" void host_r(const double* X, const double* WF, int G, double* pair, double* fac) {
  for (int x = 0; x < G; ++x)
    for (int j = 0; j < 2; ++j) {
      double a = 0.0;
      for (int y = 0; y < G; ++y)
        a += WF[j * G + y] * cloudy::cloudy_kernel_gen<double>(X[x], X[y]);
      pair[j * G + x] = a;
    }
  double S[2][NT] = {};
  double* tab = new double[(kGenYValues > 0 ? kGenYValues : 1) * G];
  for (int y = 0; y < G; ++y) {
    double g[NT], yv[kGenYValues > 0 ? kGenYValues : 1];
    cloudy::cloudy_gen_y<double>(X[y], g, yv);
    for (int j = 0; j < 2; ++j)
      for (int i = 0; i < kGenTerms; ++i) S[j][i] += g[i] * WF[j * G + y];
    for (int k = 0; k < kGenYValues; ++k) tab[k * G + y] = yv[k];
  }
  for (int x = 0; x < G; ++x) {
    double f[NT], xv[kGenXValues > 0 ? kGenXValues : 1];
    cloudy::cloudy_gen_x<double>(X[x], f, xv);
    for (int j = 0; j < 2; ++j) {
      double a = 0.0;
      for (int i = 0; i < kGenTerms; ++i) a += f[i] * S[j][i];
      if (cloudy::kGenRemainder)
        for (int y = 0; y < G; ++y)
          a += WF[j * G + y] * cloudy::cloudy_gen_pair<double>(xv, tab + y, G);
      fac[j * G + x] = a;
    }
  }
  delete[] tab;
}
"""


def _host_unit(tmp_path, unit):
    (tmp_path / "shim").mkdir(exist_ok=True)
    (tmp_path / "shim" / "cuda_runtime.h").write_text(ch.SHIM + ERFINV)
    (tmp_path / "cfg.cuh").write_text(unit.cfg)
    (tmp_path / "host.cpp").write_text(HARNESS)
    so = tmp_path / f"lib_{unit.digest}.so"
    subprocess.run([*ch._GXX, "-I", str(tmp_path / "shim"), "-I", str(_build.CSRC), "-I",
                    str(tmp_path), "-o", str(so), str(tmp_path / "host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.host_r.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p]
    return lib


def _r_inputs(G=96, seed=42):
    rng = np.random.default_rng(seed)
    X = np.ascontiguousarray(np.sort(np.exp(rng.uniform(np.log(1e-3), np.log(50.0), G))))
    WF = np.ascontiguousarray(np.exp(rng.uniform(np.log(1e-6), 0.0, (2, G))))
    return X, WF


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_factored_unit_on_the_host(name, tmp_path):
    """The unit's factored functions, run as the arm runs them, against
    ``cloudy_kernel_gen`` summed pair by pair: A_j at G = 96 nodes, two
    modes, f64, relative ≤ 1e-14."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the emitted functions on the host")
    unit = codegen.numerical_unit(2, torch.float64, kernel_expr.trace(KERNELS[name]()))
    lib = _host_unit(tmp_path, unit)
    X, WF = _r_inputs()
    pair, fac = np.empty((2, X.size)), np.empty((2, X.size))
    lib.host_r(X.ctypes.data, WF.ctypes.data, X.size, pair.ctypes.data, fac.ctypes.data)
    assert np.isfinite(pair).all()
    rel = np.abs(fac - pair) / np.abs(pair)
    assert rel.max() <= 1e-14, (name, rel.max())


def test_table_budget_recomputes_the_rest(tmp_path, monkeypatch):
    """Past `TABLE_BUDGET` y values the unit tables y and the first ones,
    and its pair body recomputes the rest from y: still K on the host."""
    monkeypatch.setattr(kernel_expr, "TABLE_BUDGET", 3)
    fac = _factor("special")
    assert len(fac.y_values) > 3 and len(fac.tabled) == 3
    assert fac.tabled[0].op == "var"
    unit = codegen.numerical_unit(2, torch.float64, kernel_expr.trace(tk.special))
    assert dict(unit.gen)["tabled"] == 3
    lib = _host_unit(tmp_path, unit)
    X, WF = _r_inputs(G=48)
    pair, fac_a = np.empty((2, X.size)), np.empty((2, X.size))
    lib.host_r(X.ctypes.data, WF.ctypes.data, X.size, pair.ctypes.data, fac_a.ctypes.data)
    assert (np.abs(fac_a - pair) / np.abs(pair)).max() <= 1e-14


def test_unit_records_its_factored_form():
    """The unit carries its factored form's counts (chip_smoke.py prints
    them), its text the three functions, and its node table in shared
    memory is the tabled y values and WX·F_j per node (none for the
    tensor)."""
    spec = SpectrumSpec(TWO_GAMMA)
    for name in sorted(KERNELS):
        fn = nc.make_numerical_fn(spec, KERNELS[name](), device="cpu", dtype=torch.float64)
        gen = dict(fn.unit.gen)
        fac = _factor(name)
        assert gen == {"terms": len(fac.terms), "x_values": len(fac.x_values),
                       "tabled": len(fac.tabled), "remainder_nodes": fac.remainder_nodes,
                       "remainder": int(fac.remainder is not None)}
        for fname in ("cloudy_gen_y", "cloudy_gen_x", "cloudy_gen_pair"):
            assert f"{fname}(" in fn.unit.cfg
        per_node = (2 + gen["tabled"]) if gen["remainder"] else 0
        assert fn._smem_bytes(1024) == 1024 + per_node * fn.plan.g_total * 8
    assert dict(nc.make_numerical_fn(spec, KERNELS["tensor"](), device="cpu").unit.gen)[
        "remainder"] == 0
