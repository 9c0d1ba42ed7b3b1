"""Temporal-difference control — Q-learning / SARSA / expected SARSA.

Reference (SURVEY.md §2.1 #7, §3.4): a Python episode loop with ε-greedy
draws and scalar `Q[s,a] += α·(r + γ·max Q[s'] − Q[s,a])` updates.

Vectorized redesign (SURVEY.md §7.1 step 5):
  * The whole training run is ONE `lax.scan` over steps of B vmapped
    auto-reset envs — no host round-trips.
  * Batched scatter updates: many envs may hit the same (s, a) in one step.
    We aggregate per-(s, a) increments with `jax.ops.segment_sum` of the
    per-env TD errors BEFORE one dense add (SURVEY.md §7.3 "scatter
    contention"). Semantics: synchronous batched TD — every env's TD error is
    computed against the SAME pre-update Q, and colliding increments SUM
    (i.e. an (s, a) visited by k envs moves k·α·δ̄). With B=1 this reduces
    exactly to the reference's sequential update rule, which is what the
    oracle parity tests pin down (tests/test_td.py).
  * ε-greedy uses explicit `jax.random` key threading; greedy ties break to
    the lowest action index (argmax), matching the oracle.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


from ..utils import struct
from ..core.semantics import Semantics
from ..core.step import step_autoreset
from ..core.types import EnvState, Level
from ..ops.rollout import reset_batch, step_autoreset_batch


def epsilon_greedy(
    q_rows: jnp.ndarray, key: jnp.ndarray, epsilon: float
) -> jnp.ndarray:
    """ε-greedy over per-state Q rows. q_rows: (..., A) → actions (...,).

    Draw order (fixed, part of the parity contract with the oracle): one
    uniform per env for the explore/exploit coin, one randint per env for
    the explore action.
    """
    ku, ka = jax.random.split(key)
    batch_shape = q_rows.shape[:-1]
    num_actions = q_rows.shape[-1]
    explore = jax.random.uniform(ku, batch_shape) < epsilon
    random_a = jax.random.randint(ka, batch_shape, 0, num_actions, dtype=jnp.int32)
    greedy_a = jnp.argmax(q_rows, axis=-1).astype(jnp.int32)
    return jnp.where(explore, random_a, greedy_a)


def td_error_qlearning(q, s, a, r, s2, done, gamma):
    """δ = r + γ·(1−done)·max_a' Q(s', a') − Q(s, a). Off-policy target."""
    target = r + gamma * jnp.where(done, 0.0, jnp.max(q[s2], axis=-1))
    return target - q[s, a]


def td_error_sarsa(q, s, a, r, s2, a2, done, gamma):
    """δ = r + γ·(1−done)·Q(s', a') − Q(s, a). On-policy target."""
    target = r + gamma * jnp.where(done, 0.0, q[s2, a2])
    return target - q[s, a]


def td_error_expected_sarsa(q, s, a, r, s2, done, gamma, epsilon):
    """δ with the ε-greedy expectation over Q(s', ·)."""
    num_actions = q.shape[-1]
    q2 = q[s2]
    greedy = jnp.max(q2, axis=-1)
    mean = jnp.mean(q2, axis=-1)
    expected = (1.0 - epsilon) * greedy + epsilon * mean
    target = r + gamma * jnp.where(done, 0.0, expected)
    return target - q[s, a]


def apply_td_updates(q, s, a, delta, alpha):
    """Aggregate per-env α·δ increments into the dense Q via segment_sum —
    deterministic (fixed reduction order), contention-free.

    Collisions take the MEAN of the α·δ increments for an (s, a), not the
    sum: with thousands of envs sharing a start state, summing would scale
    the effective step size by the collision count and diverge (the
    α-scaling hazard in SURVEY.md §7.3). With B=1 the count is 1 and this is
    bit-exactly the reference's sequential update (tests/test_td_mc.py).
    """
    num_states, num_actions = q.shape
    flat = s * num_actions + a
    upd = jax.ops.segment_sum(
        alpha * delta, flat, num_segments=num_states * num_actions
    )
    cnt = jax.ops.segment_sum(
        jnp.ones_like(delta), flat, num_segments=num_states * num_actions
    )
    return q + upd.reshape(num_states, num_actions) / jnp.maximum(
        cnt.reshape(num_states, num_actions), 1.0
    )


class TDResult(NamedTuple):
    q: jnp.ndarray          # (S, A) learned action values
    episodes: jnp.ndarray   # () int32 completed episodes
    mean_return: jnp.ndarray  # () float32 mean episode return over the run


@struct.dataclass
class TDTrainState:
    """Full resumable learner state (SURVEY.md §5 checkpoint/resume: "the
    full learner pytree … + env-state + RNG keys; resume must be bit-exact
    because everything incl. RNG keys is explicit state").

    Per-step randomness is `fold_in(key, global_step)` — a counter-based
    stream — so training chunked across any checkpoint boundaries consumes
    EXACTLY the same randoms as one unbroken run (tested bit-exact in
    tests/test_checkpoint.py).
    """

    q: jnp.ndarray           # (S, A)
    env_state: EnvState      # batched
    action: jnp.ndarray      # (B,) next action to execute (SARSA carry)
    key: jnp.ndarray         # base PRNG key (never consumed, only folded)
    step: jnp.ndarray        # () int32 global step counter
    run_ret: jnp.ndarray     # (B,) running per-env episode returns
    episodes: jnp.ndarray    # () int32
    ret_sum: jnp.ndarray     # () float32


def td_init(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    batch_size: int,
    epsilon: float = 0.1,
    q0: jnp.ndarray | None = None,
) -> TDTrainState:
    """Build the initial train state (key layout: key → _, k_reset, k_a0)."""
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = sem.deltas.shape[0]
    q_init = (
        jnp.zeros((num_states, num_actions), jnp.float32) if q0 is None else q0
    )
    key, k_reset, k_a0 = jax.random.split(key, 3)
    state0 = reset_batch(level, k_reset, batch_size)
    a0 = epsilon_greedy(q_init[state0.agent_idx], k_a0, epsilon)
    return TDTrainState(
        q=q_init,
        env_state=state0,
        action=a0,
        key=key,
        step=jnp.zeros((), jnp.int32),
        run_ret=jnp.zeros(batch_size, jnp.float32),
        episodes=jnp.zeros((), jnp.int32),
        ret_sum=jnp.zeros((), jnp.float32),
    )


@partial(jax.jit, static_argnames=("algo", "num_steps"))
def td_run(
    sem: Semantics,
    level: Level,
    ts: TDTrainState,
    num_steps: int,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
) -> TDTrainState:
    """Advance training by `num_steps`. Chunk-invariant: two runs of N/2
    bit-equal one run of N (counter-based RNG; all state explicit)."""

    def body(carry, t):
        q, state, a, run_ret, n_eps, ret_sum = carry
        key_t = jax.random.fold_in(ts.key, t)
        s = state.agent_idx
        new_state, out = step_autoreset_batch(sem, level, state, a)
        s2, r, d = out.obs, out.reward, out.done

        # Next action: drawn from the CURRENT q at the post-reset state
        # (classic SARSA ordering — a' chosen before the update commits).
        a_next = epsilon_greedy(q[new_state.agent_idx], key_t, epsilon)

        if algo == "q_learning":
            delta = td_error_qlearning(q, s, a, r, s2, d, gamma)
        elif algo == "sarsa":
            # On non-terminal steps the post-reset state IS s2, so a_next is
            # exactly the on-policy a'; on terminal steps the target drops
            # the bootstrap, so a' is irrelevant.
            delta = td_error_sarsa(q, s, a, r, s2, a_next, d, gamma)
        elif algo == "expected_sarsa":
            delta = td_error_expected_sarsa(q, s, a, r, s2, d, gamma, epsilon)
        else:  # pragma: no cover - guarded by public wrappers
            raise ValueError(algo)

        q = apply_td_updates(q, s, a, delta, alpha)

        run_ret = run_ret + r
        n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
        ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
        run_ret = jnp.where(d, 0.0, run_ret)
        return (q, new_state, a_next, run_ret, n_eps, ret_sum), None

    steps = ts.step + jnp.arange(num_steps, dtype=jnp.int32)
    init = (ts.q, ts.env_state, ts.action, ts.run_ret, ts.episodes, ts.ret_sum)
    (q, state, a, run_ret, n_eps, ret_sum), _ = jax.lax.scan(body, init, steps)
    return ts.replace(
        q=q,
        env_state=state,
        action=a,
        step=ts.step + num_steps,
        run_ret=run_ret,
        episodes=n_eps,
        ret_sum=ret_sum,
    )


def _td_train(
    sem, level, key, algo, num_steps, batch_size, alpha, gamma, epsilon, q0
) -> TDResult:
    ts = td_init(sem, level, key, batch_size, epsilon, q0)
    ts = td_run(sem, level, ts, num_steps, alpha, gamma, epsilon, algo)
    return TDResult(
        q=ts.q,
        episodes=ts.episodes,
        mean_return=ts.ret_sum / jnp.maximum(ts.episodes, 1),
    )


@partial(jax.jit, static_argnames=("num_steps", "batch_size"))
def q_learning(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1, q0=None,
) -> TDResult:
    """Batched synchronous Q-learning (reference `q_learning`, SURVEY.md §3.4)."""
    return _td_train(
        sem, level, key, "q_learning", num_steps, batch_size, alpha, gamma,
        epsilon, q0,
    )


@partial(jax.jit, static_argnames=("num_steps", "batch_size"))
def sarsa(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1, q0=None,
) -> TDResult:
    """Batched on-policy SARSA."""
    return _td_train(
        sem, level, key, "sarsa", num_steps, batch_size, alpha, gamma,
        epsilon, q0,
    )


@partial(jax.jit, static_argnames=("num_steps", "batch_size"))
def expected_sarsa(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1, q0=None,
) -> TDResult:
    """Batched expected SARSA."""
    return _td_train(
        sem, level, key, "expected_sarsa", num_steps, batch_size, alpha,
        gamma, epsilon, q0,
    )


class DoubleTDResult(NamedTuple):
    q: jnp.ndarray            # (S, A) combined table (q_a + q_b) / 2
    q_a: jnp.ndarray          # (S, A) first table
    q_b: jnp.ndarray          # (S, A) second table
    episodes: jnp.ndarray     # () int32 completed episodes
    mean_return: jnp.ndarray  # () float32 mean episode return over the run


def apply_td_updates_masked(q, s, a, delta, alpha, mask):
    """apply_td_updates restricted to envs where `mask` is True — the
    masked-subset form used by per-env-coin double Q-learning. Collisions
    still take the MEAN of the selected envs' α·δ increments."""
    num_states, num_actions = q.shape
    flat = s * num_actions + a
    w = mask.astype(delta.dtype)
    upd = jax.ops.segment_sum(
        alpha * delta * w, flat, num_segments=num_states * num_actions
    )
    cnt = jax.ops.segment_sum(w, flat, num_segments=num_states * num_actions)
    return q + upd.reshape(num_states, num_actions) / jnp.maximum(
        cnt.reshape(num_states, num_actions), 1.0
    )


@partial(jax.jit, static_argnames=("num_steps", "batch_size", "coin"))
def double_q_learning(
    sem, level, key, num_steps: int = 10_000, batch_size: int = 32,
    alpha: float = 0.1, gamma: float = 0.99, epsilon: float = 0.1,
    coin: str = "per_env",
) -> DoubleTDResult:
    """Batched double Q-learning (van Hasselt 2010) — two tables, each
    evaluated by the other, removing Q-learning's maximization bias.

    Behavior policy: ε-greedy on (q_a + q_b). Updated table X with
    evaluator Y:

        X[s,a] += α·(r + γ·(1−done)·Y[s', argmax_a X[s',·]] − X[s,a])

    with the same MEAN collision aggregation as `apply_td_updates`.

    coin — which table each transition updates:
      * "per_env" (default): an independent coin PER ENV splits the batch
        between the tables every step — the faithful batched analogue of
        the sequential algorithm's per-update coin, and every transition
        contributes an update (full throughput).
      * "global": ONE coin per step updates a single table with the whole
        batch; the other table's update is computed and discarded
        (branchless, r1 behavior — kept for reproducibility of r1 runs).

    Beyond-reference capability (the reference has plain Q-learning only,
    SURVEY.md §2.1 #7); same convergence contract as the other learners.
    """
    if coin not in ("per_env", "global"):
        raise ValueError(f"unknown coin mode: {coin!r}")
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = sem.deltas.shape[0]
    qz = jnp.zeros((num_states, num_actions), jnp.float32)
    key, k_reset = jax.random.split(key)
    state0 = reset_batch(level, k_reset, batch_size)

    def cross_delta(q_upd, q_eval, s, a, r, s2, d):
        a_star = jnp.argmax(q_upd[s2], axis=-1)
        target = r + gamma * jnp.where(d, 0.0, q_eval[s2, a_star])
        return target - q_upd[s, a]

    def body(carry, t):
        q_a, q_b, state, run_ret, n_eps, ret_sum = carry
        key_t = jax.random.fold_in(key, t)
        k_act, k_coin = jax.random.split(key_t)
        s = state.agent_idx
        act = epsilon_greedy((q_a + q_b)[s], k_act, epsilon)
        new_state, out = step_autoreset_batch(sem, level, state, act)
        s2, r, d = out.obs, out.reward, out.done

        delta_a = cross_delta(q_a, q_b, s, act, r, s2, d)
        delta_b = cross_delta(q_b, q_a, s, act, r, s2, d)
        if coin == "per_env":
            pick_a = jax.random.bernoulli(k_coin, shape=s.shape)  # (B,)
            q_a = apply_td_updates_masked(q_a, s, act, delta_a, alpha, pick_a)
            q_b = apply_td_updates_masked(
                q_b, s, act, delta_b, alpha, jnp.logical_not(pick_a)
            )
        else:  # "global": one coin per step, r1 semantics
            c = jax.random.bernoulli(k_coin)  # ()
            q_a = jnp.where(c, apply_td_updates(q_a, s, act, delta_a, alpha), q_a)
            q_b = jnp.where(c, q_b, apply_td_updates(q_b, s, act, delta_b, alpha))

        run_ret = run_ret + r
        n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
        ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
        run_ret = jnp.where(d, 0.0, run_ret)
        return (q_a, q_b, new_state, run_ret, n_eps, ret_sum), None

    init = (
        qz, qz, state0,
        jnp.zeros(batch_size, jnp.float32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.float32),
    )
    steps = jnp.arange(num_steps, dtype=jnp.int32)
    (q_a, q_b, _, _, n_eps, ret_sum), _ = jax.lax.scan(body, init, steps)
    return DoubleTDResult(
        q=(q_a + q_b) * 0.5,
        q_a=q_a,
        q_b=q_b,
        episodes=n_eps,
        mean_return=ret_sum / jnp.maximum(n_eps, 1),
    )
