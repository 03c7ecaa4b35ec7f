from sos_rt_tpu_torch.parallel.mesh import (  # noqa: F401
    broadcast_scene,
    make_mesh,
    solve_batch,
)
