"""Scenario presets (counterpart of ``sos_rt_tpu/presets.py``).

1. ``rayleigh``  pure Rayleigh atmosphere, Lambertian, µ0=0.5, τ*=0.124.
2. ``hg``        Henyey-Greenstein aerosol layer (g=0.7) over Rayleigh,
                 Lambertian albedo 0.15.
3. ``eva``       EVA volcanic scenario (log-normal Mie aerosol).
4. ``wildfire``  wildfire scenario (log-normal Mie aerosol), specular.
5. ``fwc_sweep`` batched sweep with the FWC tabulated cloud phase function
                 on the 64×128 grid, float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    grid: GridSpec
    scene: Scene
    opts: SolverOptions
    atm: Tuple[str, Dict[str, Any]]
    aer: Tuple[str, Dict[str, Any]]
    batch: int = 0          # >0 → batched sweep preset


_CANON = GridSpec(nb_angles=501, nb_layers=800)

PRESETS: Dict[str, Preset] = {
    "rayleigh": Preset(
        name="rayleigh", grid=_CANON,
        scene=Scene(mu0=0.5, grd_alb=0.15, tau_star_atm=0.124,
                    tau_star_aer=0.0),
        opts=SolverOptions(surface="lambertian"),
        atm=("rayleigh", {}), aer=("rayleigh", {})),
    "hg": Preset(
        name="hg", grid=_CANON,
        scene=Scene(mu0=0.5, grd_alb=0.15),
        opts=SolverOptions(surface="lambertian"),
        atm=("rayleigh", {}), aer=("hg", {"g": 0.7})),
    "eva": Preset(
        name="eva", grid=_CANON,
        scene=Scene(mu0=0.5, grd_alb=0.15, alb_atm=1.0, alb_aer=0.97,
                    tau_star_atm=0.104, tau_star_aer=0.120,
                    z0=120.0, z_up=25.0, z_down=17.0),
        opts=SolverOptions(surface="lambertian"),
        atm=("rayleigh", {}),
        aer=("lognormal", {"lambda0": 0.550, "indx": 1.44 + 0.0j,
                           "n0": 501187.0, "r_m": 0.506, "sig": 1.2})),
    "wildfire": Preset(
        name="wildfire", grid=_CANON,
        scene=Scene(mu0=0.5, grd_alb=0.15, alb_atm=1.0, alb_aer=0.97,
                    tau_star_atm=0.104, tau_star_aer=0.0075,
                    z0=120.0, z_up=15.0, z_down=14.0),
        opts=SolverOptions(surface="specular"),
        atm=("rayleigh", {}),
        aer=("lognormal", {"lambda0": 0.550, "indx": 1.7 + 0.03j,
                           "n0": 501187.0, "r_m": 0.065, "sig": 1.5})),
    "fwc_sweep": Preset(
        name="fwc_sweep", grid=GridSpec(nb_angles=64, nb_layers=128),
        scene=Scene(mu0=0.5, grd_alb=0.15),
        opts=SolverOptions(surface="lambertian", dtype="float32",
                           max_orders=40),
        atm=("rayleigh", {}), aer=("fwc", {}), batch=100_000),
}


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
