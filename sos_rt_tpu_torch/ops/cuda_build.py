"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each source under ``sos_rt_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library in ``build/sos_rt_tpu_torch/`` at the
root of the checkout, named by a hash of the source, so a changed source
is rebuilt and an unchanged one is reused.  Nothing is built or loaded
when a module is imported: :func:`library` builds at first use.  A build
that fails raises :class:`KernelBuildError` with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "sos_rt_tpu_torch")
# the resident kernel's ablated builds are three sources (one a type and
# mode), so that their 42 kernels compile in parallel
ABLATE_SOURCES = ("mega_ablate", "mega_ablate_f32", "mega_ablate_f64")
# the streamed passes' ablated builds (passA's and passB's flags)
SOURCES = ("megastream", "megakernel", "fused_sweeps", "fused_source", "micro",
           "megastream_ablate") + ABLATE_SOURCES
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P, _I, _D, _Q = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
# argument types of every C entry point, by library
SIGNATURES = {
    "megastream": {
        "sos_passA": [_I, _I] + [_P] * 7 + [_I] + [_P] * 2 + [_I] * 3 + [_P],
        "sos_passI": [_I, _I, _I] + [_P] * 7 + [_I] + [_P] * 2 + [_I] * 4 + [_P],
        "sos_passB_band": [_I, _I] + [_P] * 8 + [_I] * 5 + [_P],
        "sos_passB_walk": [_I, _I] + [_P] * 8 + [_I] * 4 + [_P],
        "sos_passB_smooth": [_I] + [_P] * 2 + [_I] * 4 + [_P],
        "sos_tc_smem": [],
    },
    "megastream_ablate": {
        "sos_passA_ablate": [_I] * 3 + [_P] * 7 + [_I] + [_P] * 2 + [_I] * 3 + [_P],
        "sos_passB_ablate": [_I] * 3 + [_P] * 13 + [_I] * 5 + [_P],
    },
    "megakernel": {
        "sos_mega_blocks": [_I] * 4,
        "sos_mega": [_I] * 4 + [_P] * 23 + [_I] * 8 + [_D, _P],
        "sos_mega_i1in_blocks": [_I] * 4,
        "sos_mega_i1in": [_P] * 2 + [_I] * 4 + [_P] * 23 + [_I] * 8 + [_D, _P],
    },
    "fused_sweeps": {
        "sos_down_sweep": [_I] + [_P] * 4 + [_I] * 3 + [_Q, _Q, _P],
        "sos_up_walk": [_I] + [_P] * 6 + [_I] * 3 + [_Q, _Q, _P],
        "sos_up_joins": [_I] + [_P] * 3 + [_I] * 2 + [_P],
        "sos_up_rows": [_I] + [_P] * 5 + [_I] * 3 + [_P],
    },
    "fused_source": {
        "sos_fused_source": [_I, _P, _P, _Q, _Q, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "micro": {
        "sos_micro_ops": [_I, _I] + [_P] * 8,
        "sos_micro_pass": [_I, _I] + [_P] * 3,
    },
}
SIGNATURES.update({name: {
    "sos_mega_ablate_blocks": [_I] * 5,
    "sos_mega_ablate": [_I] * 5 + [_P] * 23 + [_I] * 8 + [_D, _P],
} for name in ABLATE_SOURCES})


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a CUDA error."""


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found (needs the CUDA toolkit)")
    return path


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of the flags, the source and
    every shared header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == name + ".cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source, all started
    together.  Returns {name: seconds} for the sources it compiled; the
    compiler's output (register and shared-memory use) is kept beside
    each library as ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        with open(out + ".log", "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        took[name] = time.perf_counter() - t0
    return took


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with argtypes
    and restype declared for every entry point."""
    build_all((name,))
    lib = ctypes.CDLL(_lib_path(name))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise KernelLaunchError(f"{what} failed with CUDA error {code}")
