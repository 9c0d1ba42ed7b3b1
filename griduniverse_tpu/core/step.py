"""Pure-functional reset/step — the entire hot path of the framework.

Reference behavior (SURVEY.md §3.2, reconstructed): `env.step(a)` computes a
candidate cell from a row-major index + action delta, stays in place if the
candidate is off-grid or a wall, commits, then returns
`(obs=new index, reward, done, info)` with reward = per-step cost | lava
penalty | goal reward and done = new state ∈ {goal, lava}.

Design:
  * Zero Python branching on traced values — the whole step is index
    arithmetic + two gathers (tile code, reward) + `jnp.where` chains, which
    XLA fuses into a single elementwise kernel over the env batch.
  * The step takes and returns SCALAR per-env state; batching is purely
    `jax.vmap` (ops.rollout) and sharding is purely `NamedSharding`/`shard_map`
    (parallel/). One definition serves 1 env on CPU (parity config) and 64k
    envs sharded over a multi-host mesh.
  * Auto-reset (BASELINE north star: "auto-reset is branchless via
    lax.select") is a `where` on the done flag — no `lax.cond`, so it
    vectorizes with no divergence cost.

Post-terminal convention (must match utils/oracle.py bit-for-bit):
  * `step` (no auto-reset): once `done`, further steps are frozen — the state
    does not move, reward is 0.0, done stays True, t stops counting. This
    mirrors "classic Gym: stepping a done env is undefined; we freeze" and
    gives a well-defined parity contract for fixed-length scans.
  * `step_autoreset`: when a step finishes an episode, the returned
    (obs, reward, done) are the TERMINAL transition's, while the returned
    state is already reset to the level start for the next step. This is the
    standard batched-RL convention (NAVIX/Jumanji-style, PAPERS.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .semantics import Semantics
from .types import EnvState, Level, StepResult


def reset(level: Level, key: jnp.ndarray) -> EnvState:
    """Place the agent at the level start. Mirrors reference `reset()`
    (SURVEY.md §3.1): start state, zeroed step counter."""
    return EnvState(
        agent_idx=jnp.asarray(level.start_idx, jnp.int32),
        t=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool),
        key=key,
    )


def observe(state: EnvState) -> jnp.ndarray:
    """Observation = agent state index (reference obs space: Discrete(H*W))."""
    return state.agent_idx


def _move(sem: Semantics, level: Level, agent_idx: jnp.ndarray, action: jnp.ndarray):
    """Core transition: (agent_idx, action) -> (new_idx, reward, done).

    Stateless and done-agnostic; reused by the model-table builder
    (core.model) as the functional replacement for the reference's
    `look_step_ahead(state, action)` (SURVEY.md §3.3).
    """
    h = level.grid.shape[-2]
    w = level.grid.shape[-1]
    grid_flat = level.grid.reshape(-1)

    row = agent_idx // w
    col = agent_idx % w
    delta = sem.deltas[action]
    nrow = row + delta[0]
    ncol = col + delta[1]

    in_bounds = (nrow >= 0) & (nrow < h) & (ncol >= 0) & (ncol < w)
    # Clip so the candidate gather index is always valid; the in_bounds mask
    # decides whether the move commits.
    crow = jnp.clip(nrow, 0, h - 1)
    ccol = jnp.clip(ncol, 0, w - 1)
    cand_idx = crow * w + ccol

    cand_code = grid_flat[cand_idx]
    blocked = jnp.logical_not(in_bounds) | jnp.logical_not(sem.passable[cand_code])
    new_idx = jnp.where(blocked, agent_idx, cand_idx)

    new_code = grid_flat[new_idx]
    reward = sem.reward[new_code]
    done = sem.terminal[new_code]
    return new_idx, reward, done


def step(
    sem: Semantics, level: Level, state: EnvState, action: jnp.ndarray
) -> tuple[EnvState, StepResult]:
    """One env step, frozen after termination (see module docstring).

    Note: out-of-range action indices are silently clamped by XLA gather
    semantics (e.g. action=99 behaves like the last delta row). Samplers in
    this framework always produce ints in [0, num_actions); host-facing
    wrappers (compat/) validate actions before calling in.
    """
    new_idx, reward, done_now = _move(sem, level, state.agent_idx, action)

    was_done = state.done
    agent_idx = jnp.where(was_done, state.agent_idx, new_idx)
    reward = jnp.where(was_done, jnp.float32(0.0), reward)
    done = was_done | done_now
    t = jnp.where(was_done, state.t, state.t + 1)

    new_state = EnvState(agent_idx=agent_idx, t=t, done=done, key=state.key)
    return new_state, StepResult(obs=agent_idx, reward=reward, done=done)


def step_autoreset(
    sem: Semantics, level: Level, state: EnvState, action: jnp.ndarray
) -> tuple[EnvState, StepResult]:
    """One env step with branchless auto-reset (BASELINE north star).

    Returns the terminal transition's (obs, reward, done) but a state already
    reset to the start when the episode ended. `state.done` is always False
    on entry and exit of this function under normal use.
    """
    new_idx, reward, done = _move(sem, level, state.agent_idx, action)

    key_next, key_reset = jax.random.split(state.key)
    fresh = reset(level, key_reset)
    # Branchless select between the stepped state and a fresh reset.
    next_state = EnvState(
        agent_idx=jnp.where(done, fresh.agent_idx, new_idx),
        t=jnp.where(done, fresh.t, state.t + 1),
        done=jnp.zeros((), bool),
        key=key_next,
    )
    return next_state, StepResult(obs=new_idx, reward=reward, done=done)


def step_autoreset_truncated(
    sem: Semantics,
    level: Level,
    state: EnvState,
    action: jnp.ndarray,
    max_episode_steps: int,
) -> tuple[EnvState, StepResult]:
    """`step_autoreset` with a time limit: an episode also ends (and the env
    resets) when it reaches `max_episode_steps` steps. The reported `done`
    covers both terminal-tile and time-limit endings (the classic Gym
    TimeLimit-wrapper semantics the reference era used); the truncated
    step's reward is the ordinary step reward.

    Guarantees bounded episode lengths for random policies on goal-only
    levels — without it, rollout statistics on sparse-goal levels are
    dominated by never-ending episodes.
    """
    new_idx, reward, done_env = _move(sem, level, state.agent_idx, action)
    truncated = (state.t + 1) >= max_episode_steps
    done = done_env | truncated

    key_next, key_reset = jax.random.split(state.key)
    fresh = reset(level, key_reset)
    next_state = EnvState(
        agent_idx=jnp.where(done, fresh.agent_idx, new_idx),
        t=jnp.where(done, fresh.t, state.t + 1),
        done=jnp.zeros((), bool),
        key=key_next,
    )
    return next_state, StepResult(obs=new_idx, reward=reward, done=done)
