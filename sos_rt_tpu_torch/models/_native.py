"""ctypes loader for the native Mie core (``sos_rt_tpu_torch/csrc/miecore.cpp``).

Counterpart of ``sos_rt_tpu/models/_native.py``.  The core is host C++:
at first use it is compiled with ``g++ -O3 -shared -fPIC`` into
``build/sos_rt_tpu_torch/`` at the root of the checkout (where
``ops/cuda_build.py`` puts the CUDA libraries), named by a hash of the
source, and loaded with ctypes.  Without a toolchain, or with
``SOS_RT_NO_NATIVE`` set, :func:`get_lib` returns None and
``models/miecore.py`` runs its NumPy series instead (the same values to
~1e-12).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

from sos_rt_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC

_LIB = None
_TRIED = False

SOURCE = os.path.join(CSRC, "miecore.cpp")


def lib_path() -> str:
    """The library's path, named by a hash of the source."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsosmie_{tag}.so")


def _build() -> str | None:
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError) as e:   # no toolchain → NumPy
        print(f"[sos_rt_tpu_torch] native mie build skipped: {e}", file=sys.stderr)
        return None


def get_lib():
    """The loaded native library, or None (NumPy fallback)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SOS_RT_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    lib.mie_nstop.restype = ctypes.c_int64
    lib.mie_nstop.argtypes = [ctypes.c_double]
    lib.mie_ab.restype = None
    lib.mie_ab.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_double,
                           ctypes.c_int64, dp, dp, dp, dp]
    lib.mie_s1s2.restype = None
    lib.mie_s1s2.argtypes = [dp, dp, dp, dp, ctypes.c_int64, dp,
                             ctypes.c_int64, dp, dp, dp, dp]
    lib.mie_efficiencies.restype = None
    lib.mie_efficiencies.argtypes = [dp, dp, dp, dp, ctypes.c_int64,
                                     ctypes.c_double, dp]
    _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _parts(z: np.ndarray):
    """Contiguous float64 real and imaginary parts of a complex array."""
    return np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)


def native_ab(m: complex, x: float, nmax: int):
    """a_n, b_n for n = 1..nmax; ``m`` is passed as its real and imaginary
    parts, with its sign convention as given."""
    lib = get_lib()
    a_re, a_im, b_re, b_im = (np.empty(nmax) for _ in range(4))
    lib.mie_ab(float(m.real), float(m.imag), float(x), nmax,
               _ptr(a_re), _ptr(a_im), _ptr(b_re), _ptr(b_im))
    return a_re + 1j * a_im, b_re + 1j * b_im


def native_s1s2(a: np.ndarray, b: np.ndarray, mu: np.ndarray):
    lib = get_lib()
    shape = np.shape(mu)
    mu = np.ascontiguousarray(np.ravel(mu), dtype=np.float64)
    n_mu = mu.size
    a_re, a_im = _parts(a)
    b_re, b_im = _parts(b)
    s1_re, s1_im, s2_re, s2_im = (np.empty(n_mu) for _ in range(4))
    lib.mie_s1s2(_ptr(a_re), _ptr(a_im), _ptr(b_re), _ptr(b_im), len(a),
                 _ptr(mu), n_mu, _ptr(s1_re), _ptr(s1_im), _ptr(s2_re),
                 _ptr(s2_im))
    return ((s1_re + 1j * s1_im).reshape(shape),
            (s2_re + 1j * s2_im).reshape(shape))


def native_efficiencies(a: np.ndarray, b: np.ndarray, x: float):
    lib = get_lib()
    out = np.empty(4)
    a_re, a_im = _parts(a)
    b_re, b_im = _parts(b)
    lib.mie_efficiencies(_ptr(a_re), _ptr(a_im), _ptr(b_re), _ptr(b_im),
                         len(a), float(x), _ptr(out))
    return tuple(out)
