"""Parallelism over ranks: DP, Megatron TP, ring-attention SP, GPipe PP and
top-1 MoE EP (counterpart of ``vision_transformers_tpu/parallel``).

    from vision_transformers_tpu_torch import parallel
    parallel.init_distributed_mode()        # torchrun's env, or its kwargs
    mesh = parallel.make_mesh((2, 4), ("data", "model"))
    fit(model, train, test, epochs, mesh=mesh)
"""

from vision_transformers_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_params,
    batch_sharding,
    replicated,
    param_partition_spec,
)
from vision_transformers_tpu_torch.parallel.distributed import (
    init_distributed_mode,
    destroy_distributed_mode,
    is_main_process,
    get_rank,
    get_world_size,
    all_gather_objects,
    save_on_master,
)
from vision_transformers_tpu_torch.parallel.mesh import audit_tp_coverage
from vision_transformers_tpu_torch.parallel.sequence import (
    ring_attention_local,
    sequence_parallel_attention,
    sequence_sharding,
)
from vision_transformers_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_local,
    vit_pipeline_forward,
)
from vision_transformers_tpu_torch.parallel.expert import (
    expert_parallel_mlp,
    moe_mlp_reference,
)
