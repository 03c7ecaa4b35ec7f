"""Grid, scene and solver options of the PyTorch port.

Counterpart of ``sos_rt_tpu/config.py``:

- :class:`GridSpec`      static grid geometry (hashable).
- :class:`Scene`         per-column physical parameters; every field is a
                         Python float or a tensor with a leading batch axis.
- :class:`SolverOptions` static solver knobs (surface, order cap,
                         tolerance, dtype, matmul precision mode).

Every product in the port runs in full float32 or float64: the TPU
package's ``Precision.HIGHEST`` becomes "no TF32" on the GPU, which
:func:`full_precision_matmul` enforces where host preparation calls
``torch.matmul``.  The ``mm`` modes ``bf16x3``/``bf16x5`` keep their
meaning (``ops/precision.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

# µ-threshold constants (reference: SOS_Aer_global_va.py:5-7)
MU_THRESHOLD = 0.01          # switch to asymptotic small-µ handling
MU_EXTREME_THRESHOLD = 1e-8  # extremely small µ → pure Taylor limit
MU_VERY_SMALL_THRESHOLD = 0.001  # very small µ → Taylor limit

# Resonance tolerance |µ ± µ0| (reference: SOS_Aer_main_lambertian.py:111)
MU0_RESONANCE_TOL = 1e-4


def full_precision_matmul() -> None:
    """Keep float32 products in full float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a card and without ``device='cpu'`` this raises —
    the port never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    return device


def torch_dtype(name: str) -> torch.dtype:
    if name == "float32":
        return torch.float32
    if name == "float64":
        return torch.float64
    raise ValueError(f"unknown dtype {name!r}")


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static angular/vertical grid geometry.

    ``spacing='uniform'`` is the reference layout
    (SOS_Aer_main_lambertian.py:57-61): µ = concat(linspace(-1,0,M),
    linspace(0,1,M)), 2M points with µ=0 duplicated at indices M-1 and M.
    ``spacing='gauss'`` places the M-1 interior points of each half at
    Gauss–Legendre nodes mapped to (−1,0)/(0,1), keeping the two µ=0
    points.  Quadratures stay trapezoid-on-the-grid.
    """

    nb_angles: int = 501
    nb_layers: int = 800
    spacing: str = "uniform"

    def __post_init__(self):
        if self.nb_angles < 8:
            raise ValueError("nb_angles must be >= 8")
        if self.nb_layers < 4:
            raise ValueError("nb_layers must be >= 4")
        if self.spacing not in ("uniform", "gauss"):
            raise ValueError(f"unknown spacing: {self.spacing!r}")

    @property
    def n_mu(self) -> int:
        return 2 * self.nb_angles

    def mu(self) -> np.ndarray:
        """The 2M-point µ grid, float64, with duplicated 0."""
        m = self.nb_angles
        if self.spacing == "gauss":
            x, _ = np.polynomial.legendre.leggauss(m - 1)
            up = np.sort(0.5 * (x + 1.0))
            return np.concatenate([-up[::-1], [0.0], [0.0], up])
        return np.concatenate([np.linspace(-1.0, 0.0, m),
                               np.linspace(0.0, 1.0, m)])

    def trapz_weights(self) -> np.ndarray:
        """w such that  Σ_k w_k f_k == np.trapz(f, mu)  for any f."""
        return trapz_weights(self.mu())


def trapz_weights(x: np.ndarray) -> np.ndarray:
    """Per-point trapezoid weights for a 1-D (possibly non-uniform) grid."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2.0
    w[1:] += dx / 2.0
    return w


SCENE_FIELDS = ("mu0", "grd_alb", "alb_atm", "alb_aer", "tau_star_atm",
                "tau_star_aer", "z0", "z_up", "z_down")


@dataclasses.dataclass(frozen=True)
class Scene:
    """Per-column physical parameters (SOS_Aer_main_lambertian.py:22-96).

    - ``mu0``           cosine of solar zenith angle.
    - ``grd_alb``       ground albedo / reflectivity ρ.
    - ``alb_atm/aer``   single-scattering albedos ω.
    - ``tau_star_atm``  molecular optical depth (whole column).
    - ``tau_star_aer``  aerosol-layer optical depth.
    - ``z0/z_up/z_down`` atmosphere top and aerosol-layer bounds (km).
    """

    mu0: Any = 0.5
    grd_alb: Any = 0.15
    alb_atm: Any = 1.0
    alb_aer: Any = 1.0
    tau_star_atm: Any = 0.104
    tau_star_aer: Any = 0.120
    z0: Any = 120.0
    z_up: Any = 25.0
    z_down: Any = 17.0

    def map(self, fn) -> "Scene":
        """A new Scene with ``fn`` applied to every field."""
        return Scene(**{f: fn(getattr(self, f)) for f in SCENE_FIELDS})


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver options.

    - ``surface``     'lambertian' | 'specular'.
    - ``max_orders``  hard cap on scattering orders.
    - ``tol``         series truncation criterion (1e-4 = 100 ppm).
    - ``dtype``       compute dtype ('float32' | 'float64').
    - ``mm``          matmul precision mode of the float32 Jₙ products:
                      'bf16x3' | 'bf16x5' | 'highest' (the split
                      decompositions of ops/precision.py, or full
                      precision).  None is the engine's default: 'bf16x3'
                      for the mega engine, full-precision products
                      ('highest') for the fused engine and the reference
                      engine, as in the JAX package.  float64 always runs
                      at full precision.
    - ``scan_impl``   the reference engine's affine scans over layers:
                      'sequential' runs a loop over layers; any other value
                      (default 'associative') the associative scan.
    """

    surface: str = "lambertian"
    max_orders: int = 100
    tol: float = 1e-4
    dtype: str = "float64"
    scan_impl: str = "associative"
    mm: Optional[str] = None

    def __post_init__(self):
        if self.surface not in ("lambertian", "specular"):
            raise ValueError(f"unknown surface type: {self.surface!r}")
        if self.mm not in (None, "bf16x3", "bf16x5", "highest"):
            raise ValueError(f"unknown mm mode: {self.mm!r}")
        torch_dtype(self.dtype)
