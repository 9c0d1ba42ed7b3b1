"""griduniverse_tpu — a gridworld RL framework in JAX.

A from-scratch JAX (jit/vmap/lax.scan/shard_map) re-design of the
capabilities of `TheMTank/GridUniverse` (see SURVEY.md for the structural
analysis of the reference and its evidence status): Gym-style discrete
gridworld step/reset re-expressed as pure-functional branchless transitions
over packed integer device arrays, vmapped over tens of thousands of env
instances, with on-device tabular solvers and multi-device env sharding via
XLA collectives. Runs on NVIDIA GPUs and on CPU (the package keeps the
name it was first built under, on a TPU).

Subpackages:
  core      — semantics table, pytree types, the step/reset transition, model
  levels    — text-level I/O, programmatic builders, maze generation
  ops       — vectorized rollouts (vmap + scan), the bit-packed step engine
  algos     — on-device tabular solvers (VI, PI, MC, Q-learning, SARSA)
  models    — neural learners (actor-critic, PPO, DQN), plain-JAX networks
  parallel  — device mesh, sharded rollouts, all-reduce learners
  compat    — Gym-style + gymnasium env classes, vector env, rendering
  utils     — NumPy oracle, struct pytrees, metrics, checkpointing,
              compile cache, profiling
"""

from .core.semantics import (
    DEFAULT_CONFIG,
    EMPTY,
    GOAL,
    LAVA,
    NUM_ACTIONS,
    NUM_TILE_TYPES,
    WALL,
    Semantics,
    SemanticsConfig,
    make_semantics,
)
from .core.step import observe, reset, step, step_autoreset
from .core.types import EnvState, Level, StepResult, make_level
from .core.model import ModelTable, build_model_table

__version__ = "0.5.0"
