"""Dynamic-programming solvers — on-device value/policy iteration.

Reference (SURVEY.md §2.1 #5, §3.3): tabular `policy_evaluation`,
`policy_iteration`, `value_iteration` as S×A Python loops calling
`env.look_step_ahead`. Vectorized (SURVEY.md §7.1 step 5): the model is a
precomputed dense (S, A) table (core.model) and every sweep is a single fused
gather + reduction over the whole state space inside a `lax.while_loop` — no
Python in the loop, the entire solve is ONE XLA program.

Conventions:
  * V has shape (S,) float32; terminal states are absorbing with V = 0.
  * Deterministic policies are (S,) int32 action indices; stochastic policies
    are (S, A) float32 probabilities.
  * Greedy ties break toward the LOWEST action index (jnp.argmax), matching
    NumPy `argmax` so host-side checks agree bit-for-bit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.model import ModelTable


def action_values(model: ModelTable, v: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """Q(s, a) = r(s, a) + γ·V(s') with no bootstrap through terminals.

    One (S, A) gather of V at the successor table — the vectorized form of
    the reference's per-(s, a) `look_step_ahead` loop body (SURVEY.md §3.3).
    """
    cont = jnp.where(model.done, 0.0, v[model.next_state])
    q = model.reward + gamma * cont
    # A terminal state has no outgoing transitions: pin its Q-row to 0 so
    # sweeps never propagate value out of it.
    return jnp.where(model.terminal[:, None], 0.0, q)


@partial(jax.jit, static_argnames=("max_iters",))
def value_iteration(
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """Classic VI: sweep V ← max_a Q until the sup-norm delta < theta.

    Returns (V, greedy_policy, num_iters). The whole loop runs on device in
    a single `lax.while_loop`; only the converged tables come back.
    """
    v0 = jnp.zeros(model.num_states, jnp.float32)

    def cond(carry):
        _, delta, i = carry
        return (delta >= theta) & (i < max_iters)

    def body(carry):
        v, _, i = carry
        q = action_values(model, v, gamma)
        v_new = jnp.max(q, axis=1)
        delta = jnp.max(jnp.abs(v_new - v))
        return v_new, delta, i + 1

    v, _, iters = jax.lax.while_loop(cond, body, (v0, jnp.float32(jnp.inf), 0))
    policy = jnp.argmax(action_values(model, v, gamma), axis=1).astype(jnp.int32)
    return v, policy, iters


@partial(jax.jit, static_argnames=("max_iters",))
def policy_evaluation(
    model: ModelTable,
    policy: jnp.ndarray,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """Iterative policy evaluation. `policy` may be (S,) int32 deterministic
    or (S, A) float32 stochastic. Returns (V, num_iters)."""
    v0 = jnp.zeros(model.num_states, jnp.float32)
    deterministic = policy.ndim == 1

    def backup(v):
        q = action_values(model, v, gamma)
        if deterministic:
            return jnp.take_along_axis(q, policy[:, None], axis=1)[:, 0]
        return jnp.sum(policy * q, axis=1)

    def cond(carry):
        _, delta, i = carry
        return (delta >= theta) & (i < max_iters)

    def body(carry):
        v, _, i = carry
        v_new = backup(v)
        delta = jnp.max(jnp.abs(v_new - v))
        return v_new, delta, i + 1

    v, _, iters = jax.lax.while_loop(cond, body, (v0, jnp.float32(jnp.inf), 0))
    return v, iters


def greedy_policy_improvement(
    model: ModelTable, v: jnp.ndarray, gamma: float
) -> jnp.ndarray:
    """π(s) = argmax_a Q(s, a) — the reference's `policy_improvement`."""
    return jnp.argmax(action_values(model, v, gamma), axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_eval_iters", "max_policy_iters"))
def policy_iteration(
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
):
    """Howard policy iteration: evaluate-then-improve until the policy is
    stable. Nested `lax.while_loop`s — still one XLA program.

    Returns (V, policy, num_policy_iters).
    """
    s = model.num_states
    policy0 = jnp.zeros(s, jnp.int32)

    def eval_policy(policy):
        def cond(carry):
            _, delta, i = carry
            return (delta >= theta) & (i < max_eval_iters)

        def body(carry):
            v, _, i = carry
            q = action_values(model, v, gamma)
            v_new = jnp.take_along_axis(q, policy[:, None], axis=1)[:, 0]
            delta = jnp.max(jnp.abs(v_new - v))
            return v_new, delta, i + 1

        v, _, _ = jax.lax.while_loop(
            cond, body, (jnp.zeros(s, jnp.float32), jnp.float32(jnp.inf), 0)
        )
        return v

    def cond(carry):
        _, _, stable, i = carry
        return jnp.logical_not(stable) & (i < max_policy_iters)

    def body(carry):
        policy, _, _, i = carry
        v = eval_policy(policy)
        new_policy = greedy_policy_improvement(model, v, gamma)
        stable = jnp.all(new_policy == policy)
        return new_policy, v, stable, i + 1

    policy, v, _, iters = jax.lax.while_loop(
        cond, body, (policy0, jnp.zeros(s, jnp.float32), jnp.asarray(False), 0)
    )
    return v, policy, iters
