"""Phase-function model registry, strict dispatch, content-hashed cache.

Counterpart of ``sos_rt_tpu/models/__init__.py``: unknown names raise,
and tables are cached under a content hash of (model, grid, µ0, every
parameter).  ``eva`` and ``wildfire`` are aliases of the log-normal Mie
model with their presets' parameters.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, Tuple

import numpy as np

from sos_rt_tpu_torch.models.analytic import henyey_greenstein, isotropic, rayleigh
from sos_rt_tpu_torch.models.fwc import fwc
from sos_rt_tpu_torch.models.mie_tables import log_normal_mie, mie
from sos_rt_tpu_torch.spans import TABLES_BUILD, span

Tables = Tuple[np.ndarray, np.ndarray]

# name → (builder, tuple of required param names)
_REGISTRY: Dict[str, Tuple[Callable[..., Tables], Tuple[str, ...]]] = {
    "iso": (lambda mu, mu0, **kw: isotropic(mu, mu0), ()),
    "rayleigh": (lambda mu, mu0, **kw: rayleigh(mu, mu0), ()),
    "hg": (lambda mu, mu0, *, g, **kw: henyey_greenstein(mu, mu0, g), ("g",)),
    "fwc": (lambda mu, mu0, **kw: fwc(mu, mu0), ()),
    "mie": (
        lambda mu, mu0, *, indx, r, lambda0, **kw: mie(mu, mu0, indx, r, lambda0),
        ("indx", "r", "lambda0"),
    ),
    "lognormal": (
        lambda mu, mu0, *, lambda0, indx, n0, r_m, sig, **kw: log_normal_mie(
            mu, mu0, lambda0, indx, n0, r_m, sig
        ),
        ("lambda0", "indx", "n0", "r_m", "sig"),
    ),
}
_ALIASES = {"eva": "lognormal", "wildfire": "lognormal", "henyey_greenstein": "hg",
            "isotropic": "iso"}


def available_models():
    return sorted(set(_REGISTRY) | set(_ALIASES))


def _cache_dir() -> str:
    return os.environ.get(
        "SOS_RT_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "sos_rt_tpu_torch"),
    )


def _cache_key(kind: str, mu: np.ndarray, mu0: float, params: dict) -> str:
    h = hashlib.sha256()
    h.update(kind.encode())
    h.update(np.ascontiguousarray(mu, dtype=np.float64).tobytes())
    h.update(repr(float(mu0)).encode())
    h.update(json.dumps({k: repr(v) for k, v in sorted(params.items())}).encode())
    return h.hexdigest()[:32]


def build_phase_tables(kind: str, mu: np.ndarray, mu0: float, *,
                       cache: bool = True, **params) -> Tables:
    """Build (or load from the content-addressed cache) the (P0, P) tables.
    A build runs in the span ``sos.tables.build``; ``builds`` and
    ``cache_hits`` (attributes of this function) count builds and the
    loads that the cache answered."""
    kind = _ALIASES.get(kind, kind)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown phase model {kind!r}; available: {available_models()}")
    builder, required = _REGISTRY[kind]
    missing = [p for p in required if params.get(p) is None]
    if missing:
        raise ValueError(f"phase model {kind!r} requires parameters {missing}")

    if cache:
        key = _cache_key(kind, mu, mu0, params)
        path = os.path.join(_cache_dir(), f"{kind}_{key}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                build_phase_tables.cache_hits += 1
                return z["p0"].copy(), z["p"].copy()

    with span(TABLES_BUILD):
        p0, p = builder(np.asarray(mu, dtype=np.float64), float(mu0), **params)
    build_phase_tables.builds += 1

    if cache:
        os.makedirs(_cache_dir(), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}.npz"  # savez appends .npz otherwise
        np.savez_compressed(tmp, p0=p0, p=p)
        os.replace(tmp, path)
    return p0, p


build_phase_tables.builds = 0
build_phase_tables.cache_hits = 0
