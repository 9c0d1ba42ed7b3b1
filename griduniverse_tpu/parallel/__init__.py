"""Multi-device / multi-host parallelism (SURVEY.md §2.3, §7.1 step 6).

Mesh + PartitionSpec + shard_map + XLA collectives in place of a
distributed backend: the program names psum/all_gather and the runtime
carries them (NCCL over NVLink between cards, Gloo between CPU
processes).
"""

from .bitplane import (
    compile_q_learning_fast_sharded,
    compile_rollout_random_sharded,
)
from . import distributed
from .dp import (
    policy_iteration_batched_grid_sharded,
    policy_iteration_batched_sharded,
    policy_iteration_sharded,
    value_iteration_batched_grid_sharded,
    value_iteration_batched_sharded,
    value_iteration_sharded,
)
from .learner import (
    DistTDResult,
    mc_control_sharded,
    mc_prediction_sharded,
    q_learning_batched_sharded,
    q_learning_sharded,
    td_lambda_prediction_sharded,
    td_lambda_sharded,
)
from .mesh import (
    ENV_AXIS,
    HOST_AXIS,
    env_sharding,
    env_spec,
    make_env_mesh,
    make_host_env_mesh,
    replicated_sharding,
    shard_env_state,
)
from .rollout import episode_stats_sharded, reset_batch_sharded
