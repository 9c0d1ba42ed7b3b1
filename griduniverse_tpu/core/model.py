"""Dense transition-model table — the functional `look_step_ahead`.

The reference's DP solvers call `env.look_step_ahead(state, action)` — a pure
model lookahead with no env mutation — inside S×A Python loops (SURVEY.md
§3.3). Here we precompute the WHOLE model once as three dense (S, A)
device arrays by vmapping the core transition over every (state, action)
pair; every DP sweep is then pure gathers/reductions with no Python in the
loop (SURVEY.md §7.1 step 5).

For a 16×16 grid: S=256, A=4 → three 1k-element arrays. Even a 1024×1024
mega-grid is only a 4M-entry table — trivially HBM-resident.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import struct
from .semantics import Semantics
from .step import _move
from .types import Level


@struct.dataclass
class ModelTable:
    """Dense deterministic MDP model.

    next_state[s, a] — int32 successor index.
    reward[s, a]     — float32 reward for taking a in s.
    done[s, a]       — bool, successor is terminal.
    terminal[s]      — bool, s itself is terminal (absorbing for DP: sweeps
                       must not propagate value out of terminal states).
    """

    next_state: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    terminal: jnp.ndarray

    @property
    def num_states(self) -> int:
        return int(self.next_state.shape[0])

    @property
    def num_actions(self) -> int:
        return int(self.next_state.shape[1])


def build_model_table(sem: Semantics, level: Level) -> ModelTable:
    """vmap the core transition over all (s, a): one fused kernel, no loops."""
    n = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = sem.deltas.shape[0]
    states = jnp.arange(n, dtype=jnp.int32)
    actions = jnp.arange(num_actions, dtype=jnp.int32)

    # (S, A) grids of the transition, via nested vmap over broadcast args.
    move_sa = jax.vmap(
        jax.vmap(lambda s, a: _move(sem, level, s, a), in_axes=(None, 0)),
        in_axes=(0, None),
    )
    next_state, reward, done = move_sa(states, actions)

    terminal = sem.terminal[level.grid.reshape(-1)]
    return ModelTable(
        next_state=next_state, reward=reward, done=done, terminal=terminal
    )
