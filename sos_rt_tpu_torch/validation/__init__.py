"""External validation anchors (van de Hulst / Chandrasekhar theory).

Counterpart of ``sos_rt_tpu/validation``: the NumPy anchors that the
single-layer SOS solve (``sos_rt_tpu_torch/single_layer.py``) is held
against — the Chandrasekhar H-function (semi-infinite isotropic slab) and
a doubling-adding slab solver (finite slabs, any azimuth-averaged phase
function), both algorithmically unrelated to successive orders of
scattering.
"""
from sos_rt_tpu_torch.validation.vdh import (  # noqa: F401
    chandrasekhar_h,
    doubling_slab,
    gauss_mu,
    hg_azimuth_avg,
    semi_infinite_reflection,
)
