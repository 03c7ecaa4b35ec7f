"""sos_rt_tpu_torch — the successive-orders-of-scattering solver in PyTorch
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``sos_rt_tpu`` (JAX on TPU), which stays the reference it is
held against.  This package imports torch and numpy only; its CUDA
kernels (``csrc/``) are compiled at first use.  Entry points run on the
GPU unless the caller passes ``device='cpu'``, which runs the plain
PyTorch versions of the kernels.
"""
from sos_rt_tpu_torch.config import GridSpec, Scene, SolverOptions  # noqa: F401
from sos_rt_tpu_torch.solver import PhaseTables, Solution  # noqa: F401

__version__ = "0.3.0"
