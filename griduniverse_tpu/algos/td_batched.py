"""Per-maze sampled TD control — one Q-table PER MAZE, (N, S, A).

The model-free twin of algos.dp_batched: batched VI solves N distinct
mazes from their known model tables; `q_learning_batched` solves them by
SAMPLING — each env lives in its own maze and learns its own Q-table, so
one XLA program trains N independent tabular agents at once (the
"sampling solvers × per-env models" cell of the solver matrix; the
shared-Q learners in algos/td.py are the wrong tool across DISTINCT
mazes, where experience must not mix).

Design:
  * Env transitions ride the bit-packed step engine (ops/bitplane.py) on
    the batched BitLevel — gather-free.
  * Per-env Q-row lookups `Q[n, s_n]` are the same branchless select
    tree the batched DP sweeps use (S−1 selects over (N, A) lanes).
  * The update `Q[n, s_n, a_n] += α·δ_n` is a one-hot outer product —
    (N, S, A) elementwise lanes, NO scatter — and needs NO collision
    aggregation at all: every env owns its table, so this is exactly the
    sequential update rule per maze (no α-scaling hazard by
    construction).
  * Counter-based per-step keys (`fold_in(key, t)`) — chunk-invariant,
    same contract as every other learner here: pass the returned
    `BatchedTDState` back as `state0` (with the SAME base key) and
    run(2N) ≡ run(N)∘run(N) bit-exactly (tests/test_td_batched.py).
    A bare `q0` warm-start is NOT a resume — it restarts envs and the
    random stream at t=0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.semantics import Semantics
from ..core.types import Level
from ..ops.bitplane import _select_tree, pack_level, reset_bits, step_bits
from .dp_batched import _SELECT_TREE_MAX_STATES
from .td import epsilon_greedy


class BatchedTDState(NamedTuple):
    """Full resumable carry of `q_learning_batched` — tables, env batch,
    the carried on-policy action, running episode stats and the global
    step counter. Feed back as `state0` to continue the EXACT stream."""

    q: jnp.ndarray            # (N, S, A) per-maze action values
    env_state: object         # BitEnvState batch
    a: jnp.ndarray            # (N,) int32 next action (SARSA carry)
    run_ret: jnp.ndarray      # (N,) float32 running episode returns
    episodes: jnp.ndarray     # () int32
    ret_sum: jnp.ndarray      # () float32
    t: jnp.ndarray            # () int32 steps taken so far


class BatchedTDResult(NamedTuple):
    q: jnp.ndarray            # (N, S, A) per-maze action values
    episodes: jnp.ndarray     # () int32 completed episodes (all mazes)
    mean_return: jnp.ndarray  # () float32 mean episode return
    state: BatchedTDState | None = None  # resume carry (batched path)


def _q_rows(q: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Q[n, s_n, :] → (N, A): select tree up to dp_batched's
    lookup="auto" threshold, gather above it (the tree's program size is
    linear in S; past ~2k states compile time explodes)."""
    if q.shape[1] <= _SELECT_TREE_MAX_STATES:
        return _select_tree(
            [q[:, k, :] for k in range(q.shape[1])], s[:, None]
        )
    return jnp.take_along_axis(q, s[:, None, None], axis=1)[:, 0, :]


def _td_step(sem, bl, algo, alpha, gamma, epsilon, max_episode_steps,
             draw, q, state, a, key_t):
    """ONE per-maze TD transition + table update — the single home of the
    update rule, shared by q_learning_batched and the sharded twin
    (parallel.learner.q_learning_batched_sharded), which differ only in
    `draw(q, s, key_t) -> actions` (full-batch vs shard-local/parity
    randoms). Returns (q, new_state, a_next, r, d)."""
    a_dim = int(sem.deltas.shape[0])
    s_dim = bl.height * bl.width
    s = state.agent_idx
    new_state, (s2, r, d) = step_bits(
        sem, bl, state, a, True, max_episode_steps
    )

    rows_s = _q_rows(q, s)
    rows_s2 = _q_rows(q, s2)
    hot_a = jax.nn.one_hot(a, a_dim, dtype=q.dtype)
    q_sa = jnp.sum(rows_s * hot_a, axis=-1)

    a_next = draw(q, new_state.agent_idx, key_t)
    if algo == "q_learning":
        boot = jnp.max(rows_s2, axis=-1)
    elif algo == "sarsa":
        # on-policy: the value of the action that WILL be executed
        # (post-auto-reset states coincide with s2 mid-episode)
        boot = jnp.sum(
            rows_s2 * jax.nn.one_hot(a_next, a_dim, dtype=q.dtype),
            axis=-1,
        )
    else:  # expected_sarsa
        greedy = jnp.max(rows_s2, axis=-1)
        mean = jnp.mean(rows_s2, axis=-1)
        boot = (1.0 - epsilon) * greedy + epsilon * mean
    delta = r + gamma * jnp.where(d, 0.0, boot) - q_sa

    # per-maze tables ⇒ the sequential rule verbatim, no aggregation.
    # The α·δ product stays f32 and is cast once, so the carry dtype is
    # stable (bit-identical to the pre-cast form for f32 tables, and the
    # bf16 diet of the r5 row budget for dtype="bfloat16")
    hot_s = jax.nn.one_hot(s, s_dim, dtype=q.dtype)
    q = q + (alpha * delta)[:, None, None].astype(q.dtype) * (
        hot_s[:, :, None] * hot_a[:, None, :]
    )
    return q, new_state, a_next, r, d


@partial(
    jax.jit,
    static_argnames=("num_steps", "algo", "max_episode_steps", "dtype"),
)
def q_learning_batched(
    sem: Semantics,
    levels: Level,
    key: jnp.ndarray,
    num_steps: int = 5_000,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
    q0: jnp.ndarray | None = None,
    state0: BatchedTDState | None = None,
    dtype: str = "float32",
) -> BatchedTDResult:
    """Train one ε-greedy TD agent PER MAZE for `num_steps` steps.

    levels — batched (N, H, W); env n steps maze n with auto-reset.
    algo — "q_learning" (off-policy max target), "sarsa" (on-policy,
    carried next action) or "expected_sarsa" (ε-greedy expectation).
    state0 — a `result.state` from a previous call with the SAME `key`:
    resumes the exact per-step random stream (keys are fold_in(key, t)
    with t continuing), so chunked runs are bit-equal to unbroken ones.
    `q0` alone warm-starts tables but RESTARTS envs and the stream.
    dtype — Q-table storage dtype. "bfloat16" HALVES the (N, S, A)
    table stream each step reads and writes. TD errors are still computed in f32; the
    semantics delta is bf16 rounding of the stored tables (α·δ
    increments below ~1/256 of a Q entry's magnitude are lost), which
    the convergence test bounds. Ignored when q0/state0 supply tables.
    Returns per-maze Q (N, S, A), pooled episode stats and the resume
    carry in `.state`."""
    if levels.grid.ndim != 3:
        raise ValueError(
            f"q_learning_batched expects a batched (N, H, W) level grid; "
            f"got {levels.grid.shape} — use algos.td.q_learning"
        )
    if algo not in ("q_learning", "sarsa", "expected_sarsa"):
        raise ValueError(algo)
    bl = pack_level(levels)
    n = levels.grid.shape[0]
    s_dim = bl.height * bl.width
    a_dim = int(sem.deltas.shape[0])
    key, k_a0 = jax.random.split(key)
    if state0 is not None:
        q_init = state0.q
        env0, a0, t0 = state0.env_state, state0.a, state0.t
        run_ret0, eps0, rets0 = (
            state0.run_ret, state0.episodes, state0.ret_sum
        )
    else:
        q_init = (
            jnp.zeros((n, s_dim, a_dim), jnp.dtype(dtype))
            if q0 is None
            else q0
        )
        env0 = reset_bits(bl, None)
        a0 = epsilon_greedy(_q_rows(q_init, env0.agent_idx), k_a0, epsilon)
        t0 = jnp.zeros((), jnp.int32)
        run_ret0 = jnp.zeros(n, jnp.float32)
        eps0 = jnp.zeros((), jnp.int32)
        rets0 = jnp.zeros((), jnp.float32)

    def draw(q, s_local, key_t):
        return epsilon_greedy(_q_rows(q, s_local), key_t, epsilon)

    def body(carry, t):
        q, state, a, run_ret, n_eps, ret_sum = carry
        key_t = jax.random.fold_in(key, t)
        q, new_state, a_next, r, d = _td_step(
            sem, bl, algo, alpha, gamma, epsilon, max_episode_steps,
            draw, q, state, a, key_t,
        )
        run_ret = run_ret + r
        n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
        ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
        run_ret = jnp.where(d, 0.0, run_ret)
        return (q, new_state, a_next, run_ret, n_eps, ret_sum), None

    init = (q_init, env0, a0, run_ret0, eps0, rets0)
    (q, env_f, a_f, run_ret_f, n_eps, ret_sum), _ = jax.lax.scan(
        body, init, t0 + jnp.arange(num_steps, dtype=jnp.int32)
    )
    return BatchedTDResult(
        q=q,
        episodes=n_eps,
        mean_return=ret_sum / jnp.maximum(n_eps, 1),
        state=BatchedTDState(
            q=q, env_state=env_f, a=a_f, run_ret=run_ret_f,
            episodes=n_eps, ret_sum=ret_sum, t=t0 + num_steps,
        ),
    )
