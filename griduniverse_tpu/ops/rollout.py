"""Vectorized stepping and scan rollouts — the throughput engine.

Reference hot loop (SURVEY.md §3.2/§3.4): an interpreted Python `while` around
`env.step`. Vectorized replacement (SURVEY.md §7.1 step 4): `jax.vmap` of the
scalar step over the env batch, wrapped in `jax.lax.scan` over time, all under
ONE `jit` — so a whole T×B rollout is a single XLA program with zero host
round-trips (SURVEY.md §7.3–7.6 "keep the whole rollout inside one jit'd
scan").

Conventions:
  * batched `EnvState` = the scalar pytree with a leading env axis on every
    leaf (vmap'd, or sharded over an `env` mesh axis by parallel/).
  * trajectories are returned time-major: (T, B) leaves.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.semantics import Semantics
from ..core.step import reset, step, step_autoreset, step_autoreset_truncated
from ..core.types import EnvState, Level

# vmapped single-step variants: (sem, level, state_B, action_B) -> ...
step_batch = jax.vmap(step, in_axes=(None, None, 0, 0))
step_autoreset_batch = jax.vmap(step_autoreset, in_axes=(None, None, 0, 0))

# per-env-level variants: every env has its OWN level (BASELINE config 4,
# procedural mazes) — Level leaves carry a leading (B,) axis.
step_per_level = jax.vmap(step, in_axes=(None, 0, 0, 0))
step_autoreset_per_level = jax.vmap(step_autoreset, in_axes=(None, 0, 0, 0))


def _is_batched_level(level: Level) -> bool:
    return level.grid.ndim == 3


def _pick_step(
    level: Level,
    batched_state: bool,
    auto_reset: bool,
    max_episode_steps: int | None = None,
):
    """Resolve the right step variant for (level batching, state batching,
    optional time-limit truncation). `max_episode_steps` requires
    auto_reset (the freeze-on-done path keeps the classic untruncated
    semantics for parity with the reference)."""
    if max_episode_steps is not None:
        if not auto_reset:
            raise ValueError("max_episode_steps requires auto_reset=True")
        base = lambda sem, lvl, st, a: step_autoreset_truncated(  # noqa: E731
            sem, lvl, st, a, max_episode_steps
        )
        if not batched_state:
            return base
        if _is_batched_level(level):
            return jax.vmap(base, in_axes=(None, 0, 0, 0))
        return jax.vmap(base, in_axes=(None, None, 0, 0))
    if not batched_state:
        return step_autoreset if auto_reset else step
    if _is_batched_level(level):
        return step_autoreset_per_level if auto_reset else step_per_level
    return step_autoreset_batch if auto_reset else step_batch


def reset_batch(level: Level, key: jnp.ndarray, batch_size: int) -> EnvState:
    """B independent envs at the level start, each with its own PRNG key.
    Accepts a shared level or a per-env batched level (leading (B,) axis)."""
    keys = jax.random.split(key, batch_size)
    if _is_batched_level(level):
        return jax.vmap(reset, in_axes=(0, 0))(level, keys)
    return jax.vmap(reset, in_axes=(None, 0))(level, keys)


def rollout_actions(
    sem: Semantics,
    level: Level,
    state: EnvState,
    actions: jnp.ndarray,
    auto_reset: bool = False,
    max_episode_steps: int | None = None,
):
    """Step through a pre-drawn (T,) or (T, B) action array.

    The parity harness drives the JAX env and the NumPy oracle with the SAME
    pre-drawn actions (SURVEY.md §7.3 "the parity harness must drive both
    sides with the same pre-drawn action arrays"), sidestepping the
    Python-random vs jax.random stream mismatch.
    """
    batched = actions.ndim == 2
    step_fn = _pick_step(level, batched, auto_reset, max_episode_steps)

    def body(carry: EnvState, action):
        new_state, out = step_fn(sem, level, carry, action)
        return new_state, out

    final_state, traj = jax.lax.scan(body, state, actions)
    return final_state, traj


def rollout_random(
    sem: Semantics,
    level: Level,
    state: EnvState,
    key: jnp.ndarray,
    num_steps: int,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
):
    """Uniform-random-action rollout (BASELINE configs 1–3). Batched iff
    `state` is batched. Actions drawn on-device inside the scan."""
    num_actions = sem.deltas.shape[0]
    batched = state.agent_idx.ndim == 1
    shape = state.agent_idx.shape
    step_fn = _pick_step(level, batched, auto_reset, max_episode_steps)

    def body(carry, key_t):
        state = carry
        actions = jax.random.randint(key_t, shape, 0, num_actions, dtype=jnp.int32)
        new_state, out = step_fn(sem, level, state, actions)
        return new_state, out

    keys = jax.random.split(key, num_steps)
    final_state, traj = jax.lax.scan(body, state, keys)
    return final_state, traj


def rollout_policy(
    sem: Semantics,
    level: Level,
    state: EnvState,
    key: jnp.ndarray,
    policy_fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    num_steps: int,
    auto_reset: bool = True,
):
    """Rollout under `policy_fn(obs_batch, key) -> action_batch`."""
    batched = state.agent_idx.ndim == 1
    step_fn = _pick_step(level, batched, auto_reset)

    def body(carry, key_t):
        state = carry
        actions = policy_fn(state.agent_idx, key_t)
        new_state, out = step_fn(sem, level, state, actions)
        return new_state, out

    keys = jax.random.split(key, num_steps)
    final_state, traj = jax.lax.scan(body, state, keys)
    return final_state, traj


@partial(jax.jit, static_argnames=("num_steps", "auto_reset", "max_episode_steps"))
def episode_stats(
    sem: Semantics,
    level: Level,
    state: EnvState,
    key: jnp.ndarray,
    num_steps: int,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
):
    """Random rollout + on-device episode-return statistics (BASELINE config 4
    gate: "episode-return stats stable").

    Accumulates per-env running return/length; on each done, folds them into
    (count, return_sum, length_sum). Returns aggregate stats — scalars only
    leave the device.
    """
    num_actions = sem.deltas.shape[0]
    shape = state.agent_idx.shape
    step_fn = _pick_step(level, True, auto_reset, max_episode_steps)

    def body(carry, key_t):
        state, run_ret, run_len, n_eps, ret_sum, len_sum = carry
        actions = jax.random.randint(key_t, shape, 0, num_actions, dtype=jnp.int32)
        new_state, out = step_fn(sem, level, state, actions)
        run_ret = run_ret + out.reward
        run_len = run_len + 1
        d = out.done
        n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
        ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
        len_sum = len_sum + jnp.sum(jnp.where(d, run_len, 0), dtype=jnp.int32)
        run_ret = jnp.where(d, 0.0, run_ret)
        run_len = jnp.where(d, 0, run_len)
        return (new_state, run_ret, run_len, n_eps, ret_sum, len_sum), None

    b = shape[0] if shape else ()
    init = (
        state,
        jnp.zeros(shape, jnp.float32),
        jnp.zeros(shape, jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.float32),
        jnp.zeros((), jnp.int32),
    )
    keys = jax.random.split(key, num_steps)
    (state, _, _, n_eps, ret_sum, len_sum), _ = jax.lax.scan(body, init, keys)
    return state, {
        "episodes": n_eps,
        "mean_return": ret_sum / jnp.maximum(n_eps, 1),
        "mean_length": len_sum / jnp.maximum(n_eps, 1),
    }
