"""Data, tensor/expert, pipeline and sequence parallelism over
``torch.distributed`` (mirrors velocity_asr_tpu/parallel): NCCL between
CUDA devices, gloo between CPU processes."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, create_mesh, init_distributed,
                   order_devices_hierarchical, shard_batch, shutdown_distributed)
from .pp import current_pipeline_parallel, pipeline_blocks, pipeline_parallel
from .sp_scan import (current_sequence_parallel, selective_scan_sequence_parallel,
                      selective_scan_sp_padded, sequence_parallel)
from .tp import TP_RULES, shard_params_tp, tp_param_specs

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "TP_RULES", "create_mesh", "current_pipeline_parallel",
    "current_sequence_parallel", "init_distributed", "order_devices_hierarchical",
    "pipeline_blocks", "pipeline_parallel", "selective_scan_sequence_parallel",
    "selective_scan_sp_padded", "sequence_parallel", "shard_batch", "shard_params_tp",
    "shutdown_distributed", "tp_param_specs",
]
