"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface under ``<repo>/build/kernels/`` on first use, and is
loaded with :mod:`ctypes`. Nothing here runs at import time: the CPU tests
import every module of the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("rdb_ct", "tail_ct", "dgrad_ct", "wgrad_ct", "stage_ct", "rdb_t", "philox",
           "workbench_conv", "workbench_rdb")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32


class DzSrc(ctypes.Structure):
    """Where a backward kernel reads a conv output's cotangent
    (``csrc/dz_src.cuh``: the same plain C layout, checked against the
    library's ``esr_dzsrc_size()`` when it loads)."""

    _fields_ = [("g", P), ("noise", P), ("fac", P), ("d32", P), ("mask", P),
                ("mode", I), ("g_stride", I), ("d_stride", I), ("coff", I),
                ("coff2", I), ("m_stride", I), ("co", I), ("H", I), ("W", I),
                ("sigma", F), ("scale", F), ("slope", F)]


DZ_G, DZ_GATE, DZ_PLAIN, DZ_PHASE = 0, 1, 2, 3  # csrc/dz_src.cuh DzMode
PDZ = ctypes.POINTER(DzSrc)
# C signatures (every pointer and the stream as c_void_p, or ctypes truncates
# them to 32-bit ints); each function returns cudaGetLastError() as an int.
SIGNATURES = {
    "rdb_ct": {
        "esr_dense_conv3x3": [I, I, I, I, P, I, P, I, I, P, P, P, P, I, P, I, P, I,
                              P, I, P, F, P, I, F, F, F, I, I, I, P],
        "esr_dense_plan": [I, I, I, I, I, I, I, I, P],
    },
    "dgrad_ct": {
        "esr_dgrad": [I, I, I, I, PDZ, I, P, I, P, I, I, P, I, PDZ, I, P],
        "esr_dzsrc_size": [],
    },
    "wgrad_ct": {
        "esr_wgrad": [I, I, I, P, I, P, I, I, PDZ, I, P, I, P, I, P],
        "esr_dzsrc_size": [],
    },
    "rdb_t": {
        "esr_rdb_t_stage": [I, I, I, I, I, I, P, P, I, I, P, P, P, P, I, P, I, P, I, P, I,
                            F, F, F, I, I, I, P],
        "esr_rdb_t_dgrad": [I, I, I, I, I, I, PDZ, I, P, I, P, I, I, P, I, PDZ, I, P],
        "esr_rdb_t_wgrad": [I, I, I, I, I, P, P, I, I, PDZ, I, P, I, P, I, P],
        "esr_dzsrc_size": [],
    },
    "philox": {
        "esr_philox_normal": [P, P, I, I, I, I, I, P],
        "esr_philox_factor": [P, P, F, I, I, I, I, I, P],
        "esr_philox_bits": [P, P, I, U, P],
    },
    "tail_ct": {
        "esr_upfold": [I, I, I, I, P, P, P, P, I, I, I, F, P],
        "esr_conv_hr": [I, I, I, I, P, P, P, P, P, P, I, I, I, F, P],
        "esr_conv_hr_out": [I, I, I, P, P, P, P, I, I, I, P],
        "esr_upfold_dz": [I, I, P, P, P, P, I, P, I, I, I, F, P],
        "esr_upfold_dgrad": [I, I, I, P, P, P, I, I, I, P],
        "esr_upfold_wgrad": [I, I, I, P, P, P, I, P, I, I, I, P],
        "esr_conv_hr_hid_fix": [I, P, P, P, P, I, I, I, F, P],
        "esr_conv_hr_adj": [I, I, P, P, P, P, P, I, P, I, I, I, F, P],
    },
    "stage_ct": {
        "esr_stage_fwd": [I, I, I, I, P, P, P, P, I, I, I, I, I, I, F, P],
        "esr_stage_dgrad": [I, I, I, I, P, P, P, P, I, I, I, I, I, I, F, P],
        "esr_stage_wgrad": [I, I, I, I, P, P, P, P, I, P, I, I, I, I, I, I, F, P],
    },
    "workbench_conv": {
        "esr_wb_conv3x3": [I, I, P, P, P, P, I, I, I, I, I, I, F, P],
    },
    "workbench_rdb": {
        "esr_wb_rdb_fused": [I, I, I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, I, I,
                             P],
    },
}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit (set CUDA_HOME)")


def kernel_names() -> frozenset:
    """The names of the ``__global__`` functions ``csrc/`` defines: the
    kernels of this package, as a profiler trace names them (less their
    template arguments and parameters, ``utils/trace.op_family``)."""
    import re

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)"
                         r"\s*)?(\w+)")
    return frozenset(m.group(1) for p in sorted(CSRC.glob("*.cu*"))
                     for m in pattern.finditer(p.read_text()))


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def build(names=SOURCES, force: bool = False) -> dict:
    """Compile ``names`` (one ``nvcc`` per source, all started together).

    Returns ``{name: compiler output}`` (``-Xptxas -v`` register, shared
    memory and spill lines) for the sources that were compiled. Raises with
    the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))  # atomic: no process loads a half-written file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if missing or
    older than its sources."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            if "esr_dzsrc_size" in SIGNATURES[name]:
                check_dzsrc_layout(lib.esr_dzsrc_size(), name)
            _libs[name] = lib
        return lib


def check_dzsrc_layout(c_size: int, name: str) -> None:
    """Raise if the C ``DzSrc`` a library was built with differs in size
    from :class:`DzSrc`: a field added on one side only would hand both
    gradient kernels garbage without an error."""
    if c_size != ctypes.sizeof(DzSrc):
        raise RuntimeError(f"lib{name}.so: sizeof(DzSrc) is {c_size} in C, "
                           f"{ctypes.sizeof(DzSrc)} in kernels/build.py; the two layouts differ")


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


KERNEL_WIDTHS = (8, 16, 32, 64)  # output-channel counts csrc/*.cu instantiate


def require_width(n: int, name: str, widths=KERNEL_WIDTHS) -> None:
    if n not in widths:
        raise ValueError(f"{name}={n}: the CUDA kernels take {widths}")


def require(t, name: str, shape: tuple, dtype, device) -> None:
    """Validate a tensor handed to a CUDA kernel: device, dtype, shape and
    contiguity (the kernels index NHWC / HWIO buffers densely)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
