"""Core pytree types: Level, EnvState, StepResult.

The reference env (SURVEY.md §2.1 #1) is a mutable `gym.Env` object holding
the grid, the agent position and a step counter. Here that state becomes
two immutable pytrees of packed integer arrays:

  * `Level`    — the static world: an (H, W) int32 tile-code grid plus the
                 start index. Loaded ONCE to device (SURVEY.md §7.1 step 3);
                 shared/replicated across all vectorized envs unless each env
                 has its own maze (then it is vmapped/sharded like EnvState).
  * `EnvState` — the per-env dynamic state: agent index, step counter, done
                 flag and a PRNG key (for procedurally regenerated levels and
                 stochastic variants). A few bytes per env, so 64k envs is
                 still ~1 MB.

Everything is a `utils.struct` dataclass, i.e. a registered JAX pytree, so the
whole env state vmaps, shards (`NamedSharding` over an `env` mesh axis), scans
and checkpoints (orbax) with zero glue code.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils import struct


@struct.dataclass
class Level:
    """A gridworld level: static tile codes + start position.

    grid      — (H, W) int32 tile codes (see core.semantics for the alphabet).
    start_idx — () int32 row-major state index of the agent start.
    """

    grid: jnp.ndarray
    start_idx: jnp.ndarray

    @property
    def height(self) -> int:
        return int(self.grid.shape[-2])

    @property
    def width(self) -> int:
        return int(self.grid.shape[-1])

    @property
    def num_states(self) -> int:
        return self.height * self.width


def make_level(grid: np.ndarray, start_idx: int) -> Level:
    """Host-side constructor: validates and uploads a level."""
    grid = np.asarray(grid, dtype=np.int32)
    if grid.ndim != 2:
        raise ValueError(f"level grid must be 2-D (H, W); got shape {grid.shape}")
    n = grid.shape[0] * grid.shape[1]
    if not 0 <= int(start_idx) < n:
        raise ValueError(f"start_idx {start_idx} out of range for {grid.shape} grid")
    return Level(grid=jnp.asarray(grid), start_idx=jnp.asarray(start_idx, jnp.int32))


@struct.dataclass
class EnvState:
    """Per-env dynamic state. All fields are scalars (per env); batching is
    done purely by vmap / sharding — the step kernel never sees a batch dim.

    agent_idx — () int32 row-major state index of the agent.
    t         — () int32 steps taken this episode.
    done      — () bool  episode finished (frozen until reset / auto-reset).
    key       — (2,) uint32 PRNG key (threaded for procedural levels etc.).
    """

    agent_idx: jnp.ndarray
    t: jnp.ndarray
    done: jnp.ndarray
    key: jnp.ndarray


@struct.dataclass
class StepResult:
    """What `step` returns alongside the new state — mirrors the reference's
    Gym 4-tuple `(obs, reward, done, info)` (SURVEY.md §3.2) minus `info`,
    which is empty in the reference's hot path.

    obs    — () int32 observation = agent state index (Discrete(H*W)).
    reward — () float32.
    done   — () bool.
    """

    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
