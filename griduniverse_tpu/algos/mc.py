"""Monte-Carlo prediction and control — on-device, episode-batched.

Reference (SURVEY.md §2.1 #6): first-visit MC prediction and ε-greedy MC
control from sampled episodes, as Python episode loops.

Vectorized redesign: B episodes of fixed max length T are rolled in parallel
(vmap) inside one `lax.scan` (freeze-on-done gives fixed shapes — XLA needs
static shapes, SURVEY.md §7); returns are a reverse scan; FIRST-VISIT
detection is a (T, T) triangular self-comparison per episode (tiny: T≤ a few
hundred); per-state aggregation is `segment_sum`. The entire
generate→return→aggregate pipeline is one XLA program per round.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.semantics import Semantics
from ..core.step import step
from ..core.types import Level
from ..ops.rollout import reset_batch
from .td import epsilon_greedy


def _roll_episodes(sem, level, q_or_policy, key, batch_size, max_steps, epsilon):
    """Roll B freeze-on-done episodes. Returns time-major (T, B) arrays:
    s (pre-step state), a, r, valid (step happened before termination) —
    plus the (B,) `finished` flag: True iff episode b actually terminated
    within the T-step budget (its observed return is the COMPLETE return).

    q_or_policy: (S, A) Q-table for ε-greedy, or None for uniform random.
    """
    key, k_reset = jax.random.split(key)
    state0 = reset_batch(level, k_reset, batch_size)
    num_actions = sem.deltas.shape[0]
    step_b = jax.vmap(step, in_axes=(None, None, 0, 0))

    def body(state, key_t):
        s = state.agent_idx
        valid = jnp.logical_not(state.done)
        if q_or_policy is None:
            a = jax.random.randint(
                key_t, s.shape, 0, num_actions, dtype=jnp.int32
            )
        else:
            a = epsilon_greedy(q_or_policy[s], key_t, epsilon)
        new_state, out = step_b(sem, level, state, a)
        return new_state, (s, a, out.reward, valid)

    keys = jax.random.split(key, max_steps)
    final_state, (s, a, r, valid) = jax.lax.scan(body, state0, keys)
    return s, a, r, valid, final_state.done


def discounted_returns(rewards: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """G_t = r_t + γ·G_{t+1}, computed by a reverse scan over the time axis.
    rewards: (T, ...) → returns (T, ...). Frozen post-done rewards are 0, so
    no masking is needed."""
    def body(g_next, r_t):
        g = r_t + gamma * g_next
        return g, g

    _, g = jax.lax.scan(body, jnp.zeros_like(rewards[0]), rewards, reverse=True)
    return g


def first_visit_mask(ids: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """(T, B) ids → (T, B) bool: True where ids[t, b] is the FIRST valid
    occurrence in episode b. O(T²) broadcast compare — T is small and static.
    """
    t = ids.shape[0]
    same = ids[:, None, :] == ids[None, :, :]          # (T, T', B)
    earlier = (
        jax.lax.broadcasted_iota(jnp.int32, (t, t), 1)
        < jax.lax.broadcasted_iota(jnp.int32, (t, t), 0)
    )[:, :, None]                                       # t' < t
    seen_before = jnp.any(same & earlier & valid[None, :, :], axis=1)
    return valid & jnp.logical_not(seen_before)


class MCResult(NamedTuple):
    value: jnp.ndarray   # (S,) or (S, A)
    counts: jnp.ndarray  # visit counts, same shape


@partial(
    jax.jit,
    static_argnames=("batch_size", "max_steps", "first_visit",
                     "include_unfinished"),
)
def mc_prediction(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    policy_q: jnp.ndarray | None = None,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    batch_size: int = 256,
    max_steps: int = 100,
    first_visit: bool = True,
    include_unfinished: bool = False,
) -> MCResult:
    """MC state-value prediction (reference `monte_carlo_evaluation`).

    V(s) = mean of (first-visit) returns observed from s, over B parallel
    episodes under the ε-greedy(policy_q) — or uniform-random — policy.

    Episodes still running at `max_steps` carry PARTIAL returns; including
    them biases V toward zero wherever the step budget binds. They are therefore EXCLUDED by default — only episodes
    whose terminal was reached contribute. `include_unfinished=True`
    restores the biased everything-counts estimator (useful only when
    max_steps provably never binds and the extra samples are wanted).
    """
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    s, _, r, valid, finished = _roll_episodes(
        sem, level, policy_q, key, batch_size, max_steps, epsilon
    )
    if not include_unfinished:
        valid = valid & finished[None, :]
    g = discounted_returns(r, gamma)
    mask = first_visit_mask(s, valid) if first_visit else valid

    flat = jnp.where(mask, s, num_states).reshape(-1)  # invalid → overflow bin
    g_sum = jax.ops.segment_sum(
        jnp.where(mask, g, 0.0).reshape(-1), flat, num_segments=num_states + 1
    )[:num_states]
    n = jax.ops.segment_sum(
        mask.astype(jnp.float32).reshape(-1), flat, num_segments=num_states + 1
    )[:num_states]
    v = jnp.where(n > 0, g_sum / jnp.maximum(n, 1.0), 0.0)
    return MCResult(value=v, counts=n)


class MCControlResult(NamedTuple):
    q: jnp.ndarray        # (S, A)
    episodes: jnp.ndarray # () int32 total episodes sampled


@partial(
    jax.jit,
    static_argnames=("num_rounds", "batch_size", "max_steps", "first_visit",
                     "include_unfinished"),
)
def mc_control(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    num_rounds: int = 50,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    alpha: float = 0.05,
    batch_size: int = 256,
    max_steps: int = 100,
    first_visit: bool = True,
    include_unfinished: bool = False,
) -> MCControlResult:
    """ε-greedy MC control (GLIE-style, constant-α incremental updates).

    Each round: roll B episodes under ε-greedy(Q), compute (first-visit)
    returns per (s, a), apply Q ← Q + α·(G − Q) aggregated by segment_sum
    (synchronous batched semantics, as in algos.td). `lax.scan` over rounds —
    the whole training run is one XLA program.

    As in `mc_prediction`, unfinished episodes (partial returns) are
    excluded from the update by default.
    """
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = sem.deltas.shape[0]

    def round_body(q, key_r):
        s, a, r, valid, finished = _roll_episodes(
            sem, level, q, key_r, batch_size, max_steps, epsilon
        )
        if not include_unfinished:
            valid = valid & finished[None, :]
        g = discounted_returns(r, gamma)
        sa = s * num_actions + a
        mask = first_visit_mask(sa, valid) if first_visit else valid

        delta = g - q.reshape(-1)[sa]                 # (T, B)
        flat = jnp.where(mask, sa, num_states * num_actions).reshape(-1)
        upd = jax.ops.segment_sum(
            jnp.where(mask, alpha * delta, 0.0).reshape(-1),
            flat,
            num_segments=num_states * num_actions + 1,
        )[: num_states * num_actions]
        cnt = jax.ops.segment_sum(
            mask.astype(jnp.float32).reshape(-1),
            flat,
            num_segments=num_states * num_actions + 1,
        )[: num_states * num_actions]
        # mean over colliding (s, a) increments — see algos.td.apply_td_updates
        q = q + upd.reshape(num_states, num_actions) / jnp.maximum(
            cnt.reshape(num_states, num_actions), 1.0
        )
        return q, None

    keys = jax.random.split(key, num_rounds)
    q, _ = jax.lax.scan(
        round_body, jnp.zeros((num_states, num_actions), jnp.float32), keys
    )
    return MCControlResult(
        q=q, episodes=jnp.asarray(num_rounds * batch_size, jnp.int32)
    )
