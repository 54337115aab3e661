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

The kernels generated per configuration (`ops.codegen`) are built apart:
each unit is one ``nvcc`` into a shared library of its own under
``build/cloudy_tpu_torch/gen/<hash>/`` (the generated header and unit, the
library and its ``build.log``), the hash taken over the generated text, the
csrc/ sources, the flags and the rule that rebuilds a unit whose registers
spilled (`gen_flags_digest`). Units are built at first use, several at once
when asked for together (`build_generated`), and loaded by ctypes
(`load_generated`). So are the units of configurations past the prebuilt
library's capacities: a reference-tier kernel at capacities of its own
(`load_ref`) and the quadrature kernel at more than three modes
(`load_numerical`); each exports its layout, checked on load.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cloudy_tpu_torch"
GEN_DIR = BUILD_DIR / "gen"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def sources_digest() -> str:
    """Hash of the csrc/ sources and the compiler flags (the library's name
    and a generated unit's carry it)."""
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
    return BUILD_DIR / f"libcloudy_fused_{sources_digest()}.so"


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
    library's configuration layout and chain table are the ones the host
    uses."""
    from cloudy_tpu_torch.ops import fused_coalescence, numerical_coalescence, op_chains

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
        f = getattr(lib, f"cloudy_step_blocks_per_sm_{tag}")
        f.argtypes = [i, i, i, p]  # cfg bytes, nz, arms, out
        f.restype = i
        for name in ("cloudy_rhs_blocks_per_sm", "cloudy_coal_blocks_per_sm"):
            f = getattr(lib, f"{name}_{tag}")
            f.argtypes = [i, i, p]  # cfg bytes, arms, out
            f.restype = i
        f = getattr(lib, f"cloudy_step_scaled_{tag}")
        f.argtypes = [p, p, p, i, ll, i, i, p, p]  # ..., B, nz, arms, scale, stream
        f.restype = i
        for n_modes in range(1, numerical_coalescence.MAX_MODES + 1):
            for body in ("", "direct_"):
                f = getattr(lib, f"cloudy_numerical_{body}{tag}_n{n_modes}")
                f.argtypes = [p, p, p, i, ll, i, i, p]  # ..., B, G, ktag, stream
                f.restype = i
        f = getattr(lib, f"cloudy_chain_{tag}")
        f.argtypes = [i, i, p, p, ll, i, p, i, p]  # chain, ilp, in, out, n, k, cfg, bytes, stream
        f.restype = i
        f = getattr(lib, f"cloudy_chain_blocks_per_sm_{tag}")
        f.argtypes = [i, i, p]  # chain, cfg bytes, out
        f.restype = i
        f = getattr(lib, f"cloudy_coal_warp_{tag}")
        f.argtypes = [p, p, p, i, ll, p]  # mom, out, cfg, cfg bytes, B, stream
        f.restype = i
        f = getattr(lib, f"cloudy_coal_ref_threads_per_sm_{tag}")
        f.argtypes = [i, p]  # cfg bytes, out
        f.restype = i
    for name in ("cloudy_device_sms", "cloudy_device_smem_optin"):
        f = getattr(lib, name)
        f.argtypes = [i, p]  # device, out
        f.restype = i
    lib.cloudy_error_string.argtypes = [i]
    lib.cloudy_error_string.restype = ctypes.c_char_p
    lib.cloudy_chain_name.argtypes = [i]
    lib.cloudy_chain_name.restype = ctypes.c_char_p
    names = tuple(lib.cloudy_chain_name(c).decode() for c in range(len(op_chains.NAMES)))
    if names != op_chains.NAMES or lib.cloudy_chain_name(len(names)) is not None:
        raise RuntimeError(f"{lib._name}: chain table {names} differs from the host's "
                           f"{op_chains.NAMES}")
    for export, want, names in (
        (lib.cloudy_layout, fused_coalescence.LAYOUT, "modes, moments, M, header ints"),
        (lib.cloudy_numerical_layout, numerical_coalescence.LAYOUT,
         "per-mode stride, moment orders, header ints"),
    ):
        _check_layout(lib._name, export, want, names)
    return lib


def _check_layout(name: str, export, want: tuple, names: str) -> None:
    """Refuse a library or unit whose packed-configuration layout, as it
    exports it, differs from the host's `want`."""
    got = (ctypes.c_int * 8)()
    n = export(got)
    if tuple(got[:n]) != tuple(want):
        raise RuntimeError(f"{name}: configuration layout {tuple(got[:n])} ({names}) "
                           f"differs from the host's {tuple(want)}")


@functools.lru_cache(maxsize=None)
def device_smem_optin(device: int) -> int:
    """The shared memory a block of CUDA device `device` may opt into, in
    bytes (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    out = ctypes.c_int(0)
    err = load_library().cloudy_device_smem_optin(int(device), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"device attribute query failed: cudaError {err}")
    return out.value


#: one record per generated unit this process built (`build_generated`)
GEN_BUILDS: list = []

#: the define a generated unit is rebuilt with when ptxas spilled under its
#: own register target (csrc/gen_kernels.cuh, CLOUDY_GEN_BOUNDS)
GEN_RETRY_FLAG = "-DCLOUDY_GEN_MIN_BLOCKS=1"
#: a generated unit's library by the extra flags it was built with
GEN_LIBRARY = {(): "lib.so", (GEN_RETRY_FLAG,): "lib.minblocks1.so"}
#: one kernel's stack frame and spills in a ``-Xptxas -v`` report
_PTXAS_STACK = r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"


def gen_flags_digest() -> str:
    """What a generated unit's name carries besides its text: the csrc/
    sources and compiler flags (`sources_digest`), the retry flag and the
    spill rule that decides it."""
    h = hashlib.sha256(sources_digest().encode())
    h.update(GEN_RETRY_FLAG.encode())
    h.update(_PTXAS_STACK.encode())
    return h.hexdigest()[:16]


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spills of the first kernel in a
    ``-Xptxas -v`` report."""
    out = {}
    for ln in log.splitlines():
        if m := re.search(_PTXAS_STACK, ln):
            out.setdefault("stack", int(m.group(1)))
            out.setdefault("spill_stores", int(m.group(2)))
            out.setdefault("spill_loads", int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", ln):
            out.setdefault("registers", int(m.group(1)))
    return out


def _spills(ptxas_log: str) -> bool:
    """The spill rule: any stack frame or spill bytes in the report."""
    return any(int(v) > 0 for m in re.finditer(_PTXAS_STACK, ptxas_log) for v in m.groups())


def _gen_dir(u) -> Path:
    return GEN_DIR / u.digest


def _write(path: Path, text: str) -> None:
    """Write through a temporary file and a rename: a concurrent reader
    sees the old file or the new one, whole."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def build_generated(units, max_jobs: int = None) -> list:
    """Build every unit built at first use (`codegen.Unit`) whose library
    does not exist yet: one ``nvcc -shared`` each, with the unit's own
    flags, up to `max_jobs` (default twice the CPU count) running at once. A
    generated kernel whose ``ptxas`` report shows stack or spills
    (`_spills`) is built once more with `GEN_RETRY_FLAG` into
    ``lib.minblocks1.so`` (the first report kept as ``build.first.log``);
    otherwise, and for the first-use units of the table-driven sources
    (whose local arrays the rule does not touch), its library is
    ``lib.so``.
    Returns one record per unit: its label, library path, whether it was
    built here and retried, the seconds from the start to the exit of its
    ``nvcc`` runs and the compiler's report. A failed build raises."""
    max_jobs = max_jobs or 2 * (os.cpu_count() or 4)
    records, todo = [], []
    for u in {u.digest: u for u in units}.values():
        d = _gen_dir(u)
        rec = {"label": u.label, "built": False, "retried": False, "seconds": 0.0}
        records.append(rec)
        done = [(d / name, bool(extra)) for extra, name in GEN_LIBRARY.items()
                if (d / name).exists()]
        if done:
            rec["path"], rec["retried"] = done[0]
            rec["log"] = (d / "build.log").read_text() if (d / "build.log").exists() else ""
        else:
            todo.append((u, rec, ()))
    running, failed = [], None
    nvcc = _nvcc() if todo else None
    while todo or running:
        while todo and len(running) < max_jobs:
            u, rec, extra = todo.pop(0)
            d = _gen_dir(u)
            d.mkdir(parents=True, exist_ok=True)
            _write(d / "cfg.cuh", u.cfg)
            _write(d / "unit.cu", u.source)
            tmp = d / f"lib.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, *u.flags, *extra, "-I", str(CSRC), "-shared", "-o",
                   str(tmp), str(d / "unit.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            running.append((u, rec, extra, cmd, tmp, proc, time.perf_counter()))
        done = next((r for r in running if r[5].poll() is not None), None)
        if done is None:
            time.sleep(0.05)  # its report is a few lines: the pipe does not fill
            continue
        running.remove(done)
        u, rec, extra, cmd, tmp, proc, t0 = done
        rec["seconds"] += time.perf_counter() - t0
        out, _ = proc.communicate()
        d = _gen_dir(u)
        if proc.returncode != 0:
            failed = failed or (cmd, proc.returncode, out)
            tmp.unlink(missing_ok=True)
            continue
        if not extra and _spills(out) and u.kind in _gen_kinds():
            _write(d / "build.first.log", out)
            tmp.unlink(missing_ok=True)
            rec["retried"] = True
            todo.append((u, rec, (GEN_RETRY_FLAG,)))
            continue
        rec["log"] = out
        rec["path"] = d / GEN_LIBRARY[extra]
        _write(d / "build.log", out)
        os.replace(tmp, rec["path"])  # atomic: a concurrent build sees all or nothing
        rec["built"] = True
        GEN_BUILDS.append(rec)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    return records


def _gen_kinds():
    from cloudy_tpu_torch.ops import codegen

    return codegen.KINDS


_GEN_LIBS: dict = {}


def _load_unit(u, prefix: str, entries: dict, info: tuple):
    """Build `u` if needed, load it, declare its entry points (`entries`:
    name after `prefix` → argtypes, each returning an int; pointers and the
    stream as ``c_void_p``) and its error string, and check that its info
    export is `info`: the kernel the host asked for."""
    lib = _GEN_LIBS.get(u.digest)
    if lib is not None:
        return lib
    rec, = build_generated([u])
    lib = ctypes.CDLL(str(rec["path"]))
    for name, argtypes in {**entries, "info": [ctypes.c_void_p]}.items():
        f = getattr(lib, f"{prefix}_{name}")
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    f = getattr(lib, f"{prefix}_error_string")
    f.argtypes = [ctypes.c_int]
    f.restype = ctypes.c_char_p
    got = (ctypes.c_int * 8)()
    n = getattr(lib, f"{prefix}_info")(got)
    if tuple(got[:n]) != tuple(info):
        raise RuntimeError(f"{rec['path']}: kernel {tuple(got[:n])} is not the unit's {info}")
    _GEN_LIBS[u.digest] = lib
    return lib


def load_generated(u) -> ctypes.CDLL:
    """Build the generated unit `u` if needed and load it, checking that it
    is the kernel the host asked for (kind, n_tot, nz, type size, block
    size, stencil, scaled, SFU forms)."""
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    info = (_gen_kinds()[u.kind], u.n_tot, u.nz, u.dtype.itemsize, u.threads,
            int(u.shfl), int(u.scaled), int(u.sfu))
    return _load_unit(u, "cloudy_gen", {"launch": [p, p, ll, p, p],  # mom, out, B, scale, stream
                                        "blocks_per_sm": [p]}, info)


def load_ref(u) -> ctypes.CDLL:
    """Build the reference-tier unit `u` (`codegen.ref_unit`) if needed and
    load it, checking its kind, type size and layout: the capacities it was
    built at (`fused_coalescence.layout`)."""
    from cloudy_tpu_torch.ops import fused_coalescence as fc

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    kind = fc.REF_KINDS.index(u.kind[len("ref_"):])
    lib = _load_unit(u, "cloudy_ref", {
        # mom, out, cfg, cfg bytes, B, nz, scale, stream
        "launch": [p, p, p, i, ll, i, p, p],
        "layout": [p], "threads_per_sm": [i, p]}, (kind, u.dtype.itemsize))
    _check_layout(u.label, lib.cloudy_ref_layout, fc.layout(u.caps),
                  "modes, moments, M, header ints")
    return lib


def load_numerical(u) -> ctypes.CDLL:
    """Build the quadrature-kernel unit `u` (`codegen.numerical_unit`) if
    needed and load it, checking its modes, type size and layout
    (`numerical_coalescence.layout`)."""
    from cloudy_tpu_torch.ops import numerical_coalescence as nc

    n_modes, = u.caps
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = _load_unit(u, "cloudy_numerical_unit", {
        "launch": [p, p, p, i, ll, i, i, p],  # mom, out, cfg, cfg bytes, B, G, ktag, stream
        "layout": [p]}, (n_modes, u.dtype.itemsize))
    _check_layout(u.label, lib.cloudy_numerical_unit_layout, nc.layout(n_modes),
                  "per-mode stride, moment orders, header ints")
    return lib


@functools.lru_cache(maxsize=None)
def sass_counts(so: Path, ops=("LDL", "STL", "LDS", "STS", "BAR", "SHFL", "CALL", "MUFU")
                ) -> dict:
    """Per kernel function of a library, the count of each SASS opcode in
    `ops` and of all instructions (``cuobjdump -sass``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    return _count_sass(text, ops)


#: a kernel's header and one SASS instruction (its opcode, after any
#: predicate) in ``cuobjdump -sass`` output
_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_OPCODE = re.compile(r"^[ \t]*/\*[0-9a-f]{4,}\*/[ \t]+(?:@!?U?P\w+[ \t]+)?([A-Z][A-Z0-9_]*)",
                          re.M)


def _count_sass(text: str, ops) -> dict:
    """`sass_counts` of one ``cuobjdump -sass`` listing: each function's
    opcodes found by one pass of a compiled pattern over its part."""
    out = {}
    parts = _SASS_FUNCTION.split(text)
    for name, body in zip(parts[1::2], parts[2::2]):
        found = _SASS_OPCODE.findall(body)
        cur = out.setdefault(name, {**{o: 0 for o in ops}, "total": 0})
        cur["total"] += len(found)
        for o in ops:
            cur[o] += found.count(o)
    return out
