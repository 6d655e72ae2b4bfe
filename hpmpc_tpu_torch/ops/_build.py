"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles each ``csrc/<kernel>.cu`` into its own shared library with
a plain C interface (no PyTorch headers: a build takes seconds, not
minutes), for ``sm_90a``, once per problem shape.  The stage dimensions
are compile-time ``-D`` defines (``HP_NU``, ``HP_NX``, ``HP_NB``,
``HP_NG``) — the CUDA form of the JAX kernels' ``static_argnames`` — so
the per-thread arrays are fixed-size and the stage loops unroll.  The
library name carries the dimensions and a hash of the sources and flags,
so an edited source is never served from a stale build.

The library lands in ``hpmpc_tpu_torch/_build/`` (git-ignored) at first
use and is loaded with ``ctypes``; nothing is built at import.
:func:`build_all` starts one ``nvcc`` per library at once and waits for
all of them.  ``ptxas -v`` reports each kernel's registers, stack and
spills; the report of every build in this process is kept in
:data:`PTXAS_LOG`.  ``--use_fast_math`` is deliberately absent: the
kernels reproduce the JAX kernels' exact ``rsqrt``/reciprocal with clamped
pivots.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}
_NG_TABLES: dict = {}
#: library file name -> the ptxas report of its build in this process
PTXAS_LOG: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _key(kernel: str, dims: dict) -> str:
    h = hashlib.sha1()
    for p in [CSRC / f"{kernel}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = "_".join(f"{k}{v}" for k, v in sorted(dims.items()))
    return f"{kernel}_{tag}_{h.hexdigest()[:12]}"


def _start(kernel: str, dims: dict):
    """Start ``nvcc`` on ``csrc/<kernel>.cu`` for ``dims`` unless a build of
    the same sources exists; returns (library path, running job or None)."""
    out = BUILD_DIR / f"lib{_key(kernel, dims)}.so"
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    defs = [f"-DHP_{k}={int(v)}" for k, v in sorted(dims.items())]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *defs, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{kernel}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, (proc, cmd, tmp)


def _finish(out: pathlib.Path, job) -> pathlib.Path:
    """Wait for a job of :func:`_start`; raise if nvcc failed."""
    if job is None:
        return out
    proc, cmd, tmp = job
    try:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{stdout}\n{stderr}")
        PTXAS_LOG[out.name] = stderr
        os.replace(tmp, out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(kernel: str, dims: dict) -> pathlib.Path:
    """Compile ``csrc/<kernel>.cu`` for ``dims`` (e.g. ``{"NU": 3, "NX": 8,
    "NB": 7}``) unless a build of the same sources exists; returns the
    library path."""
    return _finish(*_start(kernel, dims))


def build_all(specs) -> list:
    """Build every ``(kernel, dims)`` of ``specs`` with one ``nvcc`` each,
    all running at once; returns the library paths in order."""
    jobs = [_start(kernel, dims) for kernel, dims in specs]
    try:
        return [_finish(out, job) for out, job in jobs]
    finally:
        for _, job in jobs:   # left running when an earlier build failed
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
            if job is not None and os.path.exists(job[2]):
                os.unlink(job[2])


#: the entry points of each library whose entry is not ``hp_<kernel>``
ENTRIES = {"step_flat": ("prep_flat", "alpha_sums_flat", "corr_geff_flat"),
           "soft_step_flat": ("soft_prep_flat", "soft_alpha_sums_flat",
                              "soft_corr_flat"),
           "factor_solve_flat": ("factor_solve_folded_flat",),
           "refine_flat": ("refine_flat_fused",)}


def load(kernel: str, **dims) -> ctypes.CDLL:
    """The library of ``csrc/<kernel>.cu`` for these stage dimensions
    (built on first use, then cached for the process).  Every library
    exports ``hp_<entry>(const Args*, int dtype_code, cudaStream_t)`` for
    each entry of :data:`ENTRIES` (default: the kernel's own name),
    returning ``cudaGetLastError()`` after the launch, and
    ``hp_error_string``."""
    key = (kernel,) + tuple(sorted(dims.items()))
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(kernel, dims)))
        for entry in ENTRIES.get(kernel, (kernel,)):
            f = getattr(lib, f"hp_{entry}")
            f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.hp_error_string.argtypes = [ctypes.c_int]
        lib.hp_error_string.restype = ctypes.c_char_p
        _LIBS[key] = lib
    return lib


def launch(kernel: str, entry: str, args: ctypes.Structure, dev, dt,
           **dims) -> None:
    """Launch ``hp_<entry>`` of the library of ``csrc/<kernel>.cu`` for
    these stage dimensions (built on first use) with the Args struct
    ``args`` in dtype ``dt`` on the current stream of ``dev``; no sync.
    Raises on a dtype the kernels do not take and on a CUDA error code."""
    code = dtype_code(dt)
    lib = load(kernel, **dims)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, f"hp_{entry}")(ctypes.addressof(args), code, stream)
    check(lib, rc, entry)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.hp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def dtype_code(dt) -> int:
    """The C entry points' dtype switch: 0 float32, 1 float64."""
    if dt == torch.float32:
        return 0
    if dt == torch.float64:
        return 1
    raise TypeError(f"kernels take float32 or float64, got {dt}")


def check_tensors(dev, dt, named: dict, shapes: dict) -> None:
    """Raise unless every tensor in ``named`` lies on ``dev``, has dtype
    ``dt`` (the index tables ``idx_tab``/``idxs_tab``: int32), is contiguous
    and has ``shapes[name]``."""
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        want_dt = torch.int32 if name in ("idx_tab", "idxs_tab") else dt
        if x.dtype != want_dt:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {want_dt}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shapes[name]}")


def ng_table(ng_stage_ids, dev):
    """The (n_ng,) int32 table of the stages that carry general
    constraints, on ``dev``, made once per process so that a launch makes
    no host-to-device copy."""
    key = (tuple(ng_stage_ids), str(dev))
    tab = _NG_TABLES.get(key)
    if tab is None:
        tab = torch.tensor(list(ng_stage_ids) or [0], dtype=torch.int32,
                           device=dev)
        _NG_TABLES[key] = tab
    return tab


def ptr(t) -> int:
    """Device pointer of a tensor as an int (None -> NULL)."""
    return 0 if t is None else t.data_ptr()
