"""Parallel serving and the parallel library: the shard mesh and the
state's sharded layout (``mesh.py``, with the fleet's merge and adoption),
the sharded step with the owner exchange (``step.py``), the sequence kind
over shards (``sequence_step.py``), process groups, the 2-axis mesh and
the library's mesh across processes (``distributed.py``), and the
long-context and model-parallel forms: blockwise, ring and Ulysses
attention (``ring_attention.py``), Megatron tensor parallelism
(``tensor_parallel.py``), expert parallelism (``expert_parallel.py``) and
the GPipe pipeline (``pipeline_parallel.py``). The exports are the JAX
package's ``parallel/__init__.py``'s."""

from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    reshard_feature_state,
    shard_feature_state,
)
from real_time_fraud_detection_system_tpu_torch.parallel.step import (  # noqa: F401
    make_sharded_step,
    partition_batch_by_customer,
)
from real_time_fraud_detection_system_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    make_hybrid_mesh,
    mesh_axes,
    process_local_batch_slice,
)
from real_time_fraud_detection_system_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    make_dp_tp_step,
    make_tp_mlp,
    make_tp_step,
    make_tp_transformer,
    make_tp_transformer_step,
)
from real_time_fraud_detection_system_tpu_torch.parallel.pipeline_parallel import (  # noqa: F401
    make_pipeline,
)
from real_time_fraud_detection_system_tpu_torch.parallel.sequence_step import (  # noqa: F401
    init_sharded_history_state,
    make_sharded_sequence_step,
    reshard_history_state,
)
from real_time_fraud_detection_system_tpu_torch.parallel.expert_parallel import (  # noqa: F401
    init_moe,
    make_ep_apply,
    moe_apply_dense,
)
