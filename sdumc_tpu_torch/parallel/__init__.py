"""Data, tensor, sequence and pipeline parallelism across processes (the
JAX package's ``parallel/``: ``mesh.py``, ``multihost.py``, ``sharding.py``,
``ring_attention.py``, ``wavlm_sp.py``, ``pipeline.py`` and
``combined.py``)."""

from sdumc_tpu_torch.parallel.mesh import (  # noqa: F401
    DataAxis,
    ModelAxis,
    make_data_axis,
    make_hierarchical_mesh,
    make_mesh,
    make_model_axis,
    shard_batch,
)
from sdumc_tpu_torch.parallel.multihost import (  # noqa: F401
    LocalProcesses,
    free_port,
    gather_eval,
    gather_rows,
    global_t_max,
    initialize_from_env,
    pad_frames,
    process_metrics,
    reduce_gradients,
    run_local_ranks,
    shutdown,
    warmup_collectives,
)
from sdumc_tpu_torch.parallel.pipeline import (  # noqa: F401
    llama_pp_forward,
    pipeline_apply,
    stage_layers,
    stage_model_from_state_dict,
)
from sdumc_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention_sharded,
    ring_bias_diags,
    ring_gated_attention,
)
from sdumc_tpu_torch.parallel.sharding import (  # noqa: F401
    LLAMA_RULES,
    WAVLM_RULES,
    llama_specs,
    partition_specs,
    shard_llama_model,
    shard_state_dict,
    shard_wavlm_model,
    tp_sharding_summary,
    wavlm_specs,
)
from sdumc_tpu_torch.parallel.wavlm_sp import wavlm_forward_sp  # noqa: F401
from sdumc_tpu_torch.parallel.combined import make_tp_dp_dual_step  # noqa: F401,E402
