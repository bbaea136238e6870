"""Data parallelism across processes (the JAX package's ``parallel/``:
``mesh.py`` and ``multihost.py``; tensor, sequence and pipeline
parallelism are not ported yet)."""

from sdumc_tpu_torch.parallel.mesh import DataAxis, make_data_axis, shard_batch  # noqa: F401
from sdumc_tpu_torch.parallel.multihost import (  # noqa: F401
    gather_eval,
    gather_rows,
    global_t_max,
    initialize_from_env,
    pad_frames,
    process_metrics,
    reduce_gradients,
    shutdown,
    warmup_collectives,
)
