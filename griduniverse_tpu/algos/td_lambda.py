"""TD(λ) — eligibility-trace control (SARSA(λ), Watkins Q(λ)) and
TD(λ) prediction.

Beyond-reference capability: the reference stops at one-step TD control
(SURVEY.md §2.1 #7); eligibility traces are the classic bridge between its
one-step TD and its Monte-Carlo methods (#6), so they round out the
textbook tabular family for users switching from the reference.

Design:
  * Each env carries its OWN eligibility tensor e_i — shape (B, S, A) for
    control, (B, S) for prediction — exactly the per-episode trace of the
    sequential algorithm, vectorized over envs.
  * The trace bump is a broadcasted one-hot outer product
    `e ← γλ·e + onehot(s) ⊗ onehot(a)` — elementwise + broadcast only, no
    scatters (chosen for the TPU, where scatters serialize).
  * Tiny traces are flushed to exact zero below `trace_cutoff` (standard
    practice): keeps the batched aggregation's visit counts honest and the
    whole tensor sparse-in-value.
  * Batched aggregation follows `apply_td_updates`' collision-MEAN
    convention (algos/td.py): per (s, a), the Q increment is the mean over
    envs holding a live (nonzero) trace of their sequential update
    α·δ_i·e_i[s,a]. With B = 1 this is bit-exactly the sequential rule
    `Q += α·δ·e` (tests/test_td_lambda.py pins it against a NumPy oracle).
  * Episode boundaries zero the finished env's whole trace (auto-reset);
    Watkins Q(λ) additionally zeroes it when the env's next action is
    exploratory (the off-policy cut).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.rollout import reset_batch, step_autoreset_batch
from .td import TDResult, epsilon_greedy


def decay_traces(e, gamma, lam, cutoff):
    """γλ decay with flush-to-zero below `cutoff`."""
    e = gamma * lam * e
    return jnp.where(e < cutoff, 0.0, e)


def bump_traces(e, s, a, num_states, num_actions, kind):
    """Add this step's visit to each env's trace — one-hot outer product,
    no scatter. kind: "accumulating" (e += 1) or "replacing" (e = 1)."""
    hot = (
        jax.nn.one_hot(s, num_states, dtype=e.dtype)[:, :, None]
        * jax.nn.one_hot(a, num_actions, dtype=e.dtype)[:, None, :]
    )
    if kind == "accumulating":
        return e + hot
    return jnp.maximum(e, hot)  # replacing: e[s,a] = 1


def apply_trace_updates(q, delta, e, alpha):
    """Q += α · mean-over-live-traces(δ_i·e_i), per (s, a).

    `delta` (B,), `e` (B, S, A). Envs with e_i[s,a] = 0 don't count toward
    the (s, a) denominator — so a state visited by one env updates at full
    α·δ·e (sequential parity), and a start state shared by thousands of
    envs moves by their mean update instead of the sum (the α-scaling
    hazard, SURVEY.md §7.3)."""
    num = jnp.einsum("b,bsa->sa", delta, e)
    cnt = jnp.sum(e != 0.0, axis=0)
    return q + alpha * num / jnp.maximum(cnt, 1.0)


@partial(
    jax.jit,
    static_argnames=("algo", "trace", "num_steps", "batch_size"),
)
def _td_lambda_control(
    sem,
    level,
    key,
    algo: str,
    num_steps: int,
    batch_size: int,
    alpha: float,
    gamma: float,
    epsilon: float,
    lam: float,
    trace: str,
    trace_cutoff: float,
    q0,
) -> TDResult:
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = int(sem.deltas.shape[0])
    q = (
        jnp.zeros((num_states, num_actions), jnp.float32) if q0 is None else q0
    )
    key, k_reset, k_a0 = jax.random.split(key, 3)
    state0 = reset_batch(level, k_reset, batch_size)
    a0 = epsilon_greedy(q[state0.agent_idx], k_a0, epsilon)
    e0 = jnp.zeros((batch_size, num_states, num_actions), jnp.float32)

    def body(carry, t):
        q, e, state, a, run_ret, n_eps, ret_sum = carry
        key_t = jax.random.fold_in(key, t)
        s = state.agent_idx
        new_state, out = step_autoreset_batch(sem, level, state, a)
        s2, r, d = out.obs, out.reward, out.done

        # Trace first: decay, then bump this step's (s, a).
        e = decay_traces(e, gamma, lam, trace_cutoff)
        e = bump_traces(e, s, a, num_states, num_actions, trace)

        a_next = epsilon_greedy(q[new_state.agent_idx], key_t, epsilon)
        greedy2 = jnp.argmax(q[s2], axis=-1).astype(jnp.int32)

        if algo == "sarsa":
            p_a2 = jax.nn.one_hot(a_next, num_actions, dtype=q.dtype)
            boot = jnp.sum(q[s2] * p_a2, axis=-1)
        else:  # watkins: off-policy max target
            boot = jnp.max(q[s2], axis=-1)
        p_sa = jax.nn.one_hot(a, num_actions, dtype=q.dtype)
        q_sa = jnp.sum(q[s] * p_sa, axis=-1)
        delta = r + gamma * jnp.where(d, 0.0, boot) - q_sa

        q = apply_trace_updates(q, delta, e, alpha)

        # Cut traces: always at episode end; Watkins also on exploration.
        cut = d
        if algo == "watkins":
            cut = jnp.logical_or(cut, a_next != greedy2)
        e = jnp.where(cut[:, None, None], 0.0, e)

        run_ret = run_ret + r
        n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
        ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
        run_ret = jnp.where(d, 0.0, run_ret)
        return (q, e, new_state, a_next, run_ret, n_eps, ret_sum), None

    init = (
        q, e0, state0, a0,
        jnp.zeros(batch_size, jnp.float32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.float32),
    )
    steps = jnp.arange(num_steps, dtype=jnp.int32)
    (q, _, _, _, _, n_eps, ret_sum), _ = jax.lax.scan(body, init, steps)
    return TDResult(
        q=q,
        episodes=n_eps,
        mean_return=ret_sum / jnp.maximum(n_eps, 1),
    )


def sarsa_lambda(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1,
    lam: float = 0.9, trace: str = "accumulating",
    trace_cutoff: float = 1e-4, q0=None,
) -> TDResult:
    """On-policy SARSA(λ) with per-env eligibility traces."""
    if trace not in ("accumulating", "replacing"):
        raise ValueError(f"unknown trace kind: {trace!r}")
    return _td_lambda_control(
        sem, level, key, "sarsa", num_steps, batch_size, alpha, gamma,
        epsilon, lam, trace, trace_cutoff, q0,
    )


def watkins_q_lambda(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1,
    lam: float = 0.9, trace: str = "accumulating",
    trace_cutoff: float = 1e-4, q0=None,
) -> TDResult:
    """Watkins Q(λ): off-policy max targets; traces cut at exploratory
    actions (and episode ends)."""
    if trace not in ("accumulating", "replacing"):
        raise ValueError(f"unknown trace kind: {trace!r}")
    return _td_lambda_control(
        sem, level, key, "watkins", num_steps, batch_size, alpha, gamma,
        epsilon, lam, trace, trace_cutoff, q0,
    )


class TDLambdaPredictionResult(NamedTuple):
    v: jnp.ndarray          # (S,) state values under the policy
    episodes: jnp.ndarray   # () int32 completed episodes


@partial(jax.jit, static_argnames=("num_steps", "batch_size", "trace"))
def td_lambda_prediction(
    sem,
    level,
    policy: jnp.ndarray,
    key,
    num_steps: int = 10_000,
    batch_size: int = 32,
    alpha: float = 0.1,
    gamma: float = 0.99,
    lam: float = 0.9,
    trace: str = "accumulating",
    trace_cutoff: float = 1e-4,
) -> TDLambdaPredictionResult:
    """TD(λ) policy evaluation: learn V^π for a fixed stochastic policy
    (S, A) from on-policy experience, per-env (B, S) traces."""
    if trace not in ("accumulating", "replacing"):
        raise ValueError(f"unknown trace kind: {trace!r}")
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    v0 = jnp.zeros((num_states,), jnp.float32)
    key, k_reset = jax.random.split(key)
    state0 = reset_batch(level, k_reset, batch_size)
    e0 = jnp.zeros((batch_size, num_states), jnp.float32)
    logp = jnp.log(jnp.maximum(policy, 1e-30))

    def body(carry, t):
        v, e, state, run_eps = carry
        key_t = jax.random.fold_in(key, t)
        s = state.agent_idx
        a = jax.random.categorical(key_t, logp[s]).astype(jnp.int32)
        new_state, out = step_autoreset_batch(sem, level, state, a)
        s2, r, d = out.obs, out.reward, out.done

        e = decay_traces(e, gamma, lam, trace_cutoff)
        hot = jax.nn.one_hot(s, num_states, dtype=e.dtype)
        e = e + hot if trace == "accumulating" else jnp.maximum(e, hot)

        delta = r + gamma * jnp.where(d, 0.0, v[s2]) - v[s]
        num = jnp.einsum("b,bs->s", delta, e)
        cnt = jnp.sum(e != 0.0, axis=0)
        v = v + alpha * num / jnp.maximum(cnt, 1.0)

        e = jnp.where(d[:, None], 0.0, e)
        run_eps = run_eps + jnp.sum(d, dtype=jnp.int32)
        return (v, e, new_state, run_eps), None

    init = (v0, e0, state0, jnp.zeros((), jnp.int32))
    (v, _, _, n_eps), _ = jax.lax.scan(
        body, init, jnp.arange(num_steps, dtype=jnp.int32)
    )
    return TDLambdaPredictionResult(v=v, episodes=n_eps)
