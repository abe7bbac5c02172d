from acr_tpu_torch.parallel.mesh import (
    Mesh,
    gather_outputs,
    init_distributed,
    make_mesh,
    pad_batch,
    split_batch,
)
