"""Kernel-attribution tools of the port, run as modules on the card:

    python -m sos_rt_tpu_torch.tools.micro_ops [pattern ...]
    python -m sos_rt_tpu_torch.tools.micro_pass
    python -m sos_rt_tpu_torch.tools.ablate_kernel [orders] [block] [batch]

Counterparts of the JAX package's ``tools/micro_ops.py``,
``tools/micro_pass.py`` and ``tools/ablate_kernel.py``.  Each takes
``--device cpu``, which runs the plain versions (for the tests; its times
are the CPU's, not the card's).  :mod:`.card` holds the card's peak rates
and the timing helper they share.
"""
