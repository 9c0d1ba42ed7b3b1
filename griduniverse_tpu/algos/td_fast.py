"""Matmul-form tabular TD control — the fast Q-learning/SARSA engine.

The generic TD learner (algos/td.py) is built from dynamic gathers
(`q[s]`, `q[s2]`, env-step tile lookups) and segment_sum scatters. This
module re-expresses every table access as dense linear algebra plus the
bit-packed select-tree step — a design made for the TPU, whose gathers and
scatters serialize; ROADMAP Speed item 5 times it against the scatter form
on the GPU:

  * env transition      → ops.bitplane step (gather-free select trees);
  * Q(s, ·) row lookup  → FACTORIZED one-hot matmul (below);
  * V(s') = max Q(s',·) → same factorized lookup against max_A Q;
  * the (s,a)-aggregated update (segment_sum in td.py) → scatter-add as a
    transposed matmul.

FACTORIZATION: a (B, S) one-hot costs S bytes/env/step of memory traffic.
Writing s = hi·L + lo with S = H·L, `one_hot(s) = one_hot_H(hi) ⊗
one_hot_L(lo)`, every one-hot contraction splits into a (B, H) matmul plus
a tiny lo-contraction that XLA fuses elementwise:

  row lookup   : y = p_hi @ Q.reshape(H, L·A); rows = Σ_lo p_lo ⊙ y
  V(s') lookup : t = p2_hi @ V.reshape(H, L);  v_s2 = Σ_lo p2_lo ⊙ t
  update       : w = p_lo ⊙ u → (B, L·2A);     ZZ = p_hiᵀ @ w → (H, L·2A)

The largest (B, ·) operand drops from S=256 to H=64 columns. The per-env
results are arithmetically IDENTICAL to the unfactored form (one-hot
products select exact bf16 values either way); only the f32 accumulation
order over colliding envs can differ in the last bit.

Operands are bf16 with f32 accumulation — one-hot entries are exact in
bf16, counts accumulate in f32 (exact), and only the Q reads / αδ
increments see bf16 rounding (covered by the precision contract below).

Update semantics match algos/td.apply_td_updates: colliding (s, a)
increments take the MEAN of α·δ (the α-scaling guard of SURVEY.md §7.3);
every env's δ is computed against the same pre-update Q (synchronous
batched TD). Numerics: matmuls take bf16 inputs with f32 accumulation,
so Q values may differ from the
exact gather path in the last ~8 bits — the contract here is "converges to
the optimal policy" (tested), not bit-parity; use algos/td.py when you
need the bit-exact/checkpoint-parity path.

RNG: one xorshift32 round per env per step supplies both the ε coin
(low 16 bits) and the explore action (top bits) — the same stream family
as ops.bitplane.rollout_random_bits.

Reference behavior recon: SURVEY.md §3.4 (the q_learning episode loop).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import struct
from ..core.semantics import Semantics
from ..ops.bitplane import (
    BitLevel,
    FastState,
    reset_bits,
    step_bits,
    xorshift_init,
    xorshift_next,
)


class FastTDResult(NamedTuple):
    q: jnp.ndarray            # (S, A) learned action values (float32)
    episodes: jnp.ndarray     # () int32 completed episodes
    mean_return: jnp.ndarray  # () float32 mean episode return over the run


@struct.dataclass
class FastTDTrainState:
    """Full resumable state of the fast engine (SURVEY.md §5 checkpoint row:
    "the full learner pytree … + env-state + RNG keys"). Every bit of run-to-run state is explicit here — the Q-table, the
    per-env FastState (agent index/tile code/step counter/done), the
    xorshift RNG lanes, and the episode accumulators — so chunked training
    across checkpoint boundaries is BIT-EXACT equal to one unbroken scan
    (tests/test_checkpoint.py, tests/test_fault_tolerance.py)."""

    q: jnp.ndarray            # (S, A) float32
    env_state: FastState      # batched (B,) leaves
    rs: jnp.ndarray           # (B,) uint32 xorshift lanes
    step: jnp.ndarray         # () int32 global step counter
    run_ret: jnp.ndarray      # (B,) float32 running episode returns
    n_eps_env: jnp.ndarray    # (B,) int32 completed episodes per env
    ret_sum_env: jnp.ndarray  # (B,) float32 folded return sums per env


def fast_td_init(
    sem: Semantics,
    bl: BitLevel,
    seed,
    batch_size: int | None = None,
    q0: jnp.ndarray | None = None,
) -> FastTDTrainState:
    """Initial fast-engine train state: all envs at the level start, xorshift
    lanes seeded per env id (the same streams compile_q_learning_fast uses,
    so a chunked run reproduces the one-shot run exactly)."""
    num_states = bl.height * bl.width
    num_actions = int(np.asarray(sem.deltas).shape[0])
    state = reset_bits(bl, None if bl.batched else batch_size)
    shape = state.agent_idx.shape
    return FastTDTrainState(
        q=(
            jnp.zeros((num_states, num_actions), jnp.float32)
            if q0 is None
            else jnp.asarray(q0, jnp.float32)
        ),
        env_state=state,
        rs=xorshift_init(seed, shape),
        step=jnp.zeros((), jnp.int32),
        run_ret=jnp.zeros(shape, jnp.float32),
        n_eps_env=jnp.zeros(shape, jnp.int32),
        ret_sum_env=jnp.zeros(shape, jnp.float32),
    )


def fast_td_result(ts: FastTDTrainState) -> FastTDResult:
    """Reduce a train state's per-env accumulators to the summary result."""
    n = jnp.sum(ts.n_eps_env)
    return FastTDResult(
        q=ts.q,
        episodes=n,
        mean_return=jnp.sum(ts.ret_sum_env) / jnp.maximum(n, 1),
    )


def _factor_split(num_states: int) -> tuple[int, int]:
    """Pick the hi/lo factorization S = H·L for the one-hot split.

    Small L balances the two operands (the update's (B, L·2A) operand
    grows with L; the lookup's (B, H) operand with H — L=4 balances them
    at S=256; chosen on the TPU, re-tested by ROADMAP Speed item 5). Prefer L=4, degrade through
    smaller divisors; L=1 (prime S) degenerates to the unfactored form
    with p_lo ≡ 1, which is still correct.
    """
    for lo in (4, 3, 2, 1):
        if num_states % lo == 0:
            return num_states // lo, lo
    raise AssertionError  # pragma: no cover - lo=1 always divides


def _epsilon_greedy_bits(q_rows: jnp.ndarray, bits: jnp.ndarray, epsilon: float):
    """ε-greedy from one uint32 of randomness per env: low 16 bits are the
    explore coin, top bits pick the explore action (Lemire multiply-shift,
    uniform over num_actions)."""
    num_actions = q_rows.shape[-1]
    coin = (bits & jnp.uint32(0xFFFF)) < jnp.uint32(int(epsilon * 65536.0))
    rand_a = (((bits >> 16) * jnp.uint32(num_actions)) >> 16).astype(jnp.int32)
    greedy_a = jnp.argmax(q_rows, axis=-1).astype(jnp.int32)
    return jnp.where(coin, rand_a, greedy_a)


def compile_q_learning_fast(
    sem: Semantics,
    bl: BitLevel,
    batch_size: int,
    num_steps: int,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
):
    """Factory: returns a jitted `fn(seed, q0) -> FastTDResult` running the
    whole training loop as ONE XLA program, with the semantics/level tables
    baked in as compile-time constants. algo — "q_learning" (off-policy max target) or "expected_sarsa"
    (ε-greedy expectation target); both act ε-greedily.
    """
    if algo not in ("q_learning", "expected_sarsa"):
        raise ValueError(f"unknown algo: {algo!r}")
    sem_c: Semantics = jax.tree.map(np.asarray, sem)
    bl_c: BitLevel = jax.tree.map(np.asarray, bl)
    num_states = bl_c.height * bl_c.width
    num_actions = int(np.asarray(sem_c.deltas).shape[0])

    @jax.jit
    def fn(seed, q0=None):
        ts = fast_td_init(sem_c, bl_c, seed, batch_size, q0)
        ts = td_scan_fast(
            sem_c, bl_c, ts, num_steps,
            alpha, gamma, epsilon, algo, max_episode_steps,
        )
        return fast_td_result(ts)

    return fn


def compile_fast_td_run(
    sem: Semantics,
    bl: BitLevel,
    chunk_steps: int,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
):
    """Chunked-training factory for the fast engine (the checkpointable
    API, mirroring algos.td.td_run): returns a jitted
    `run(ts: FastTDTrainState) -> FastTDTrainState` advancing training by
    `chunk_steps` with the semantics/level tables baked in as compile-time
    constants (same 10× constant-folding lever as compile_q_learning_fast).

    Chunk-invariant: run∘run on N-step chunks is bit-equal to one 2N-step
    scan — the xorshift lanes and every accumulator live IN the state, so
    there is nothing implicit to lose at a checkpoint boundary. Typical
    long-run loop:

        ts = fast_td_init(sem, bl, seed, batch)
        run = compile_fast_td_run(sem, bl, 10_000)
        mgr = CheckpointManager(dir)
        start, ts = mgr.restore_latest(ts)
        for chunk in range(start, n_chunks):
            ts = run(ts)
            mgr.save(chunk + 1, ts)
    """
    if algo not in ("q_learning", "expected_sarsa"):
        raise ValueError(f"unknown algo: {algo!r}")
    sem_c: Semantics = jax.tree.map(np.asarray, sem)
    bl_c: BitLevel = jax.tree.map(np.asarray, bl)

    @jax.jit
    def run(ts: FastTDTrainState) -> FastTDTrainState:
        return td_scan_fast(
            sem_c, bl_c, ts, chunk_steps,
            alpha, gamma, epsilon, algo, max_episode_steps,
        )

    return run


def td_scan_fast(
    sem_c: Semantics,
    bl_c: BitLevel,
    ts: FastTDTrainState,
    num_steps: int,
    alpha: float,
    gamma: float,
    epsilon: float,
    algo: str,
    max_episode_steps: int | None,
    psum_axes=None,
) -> FastTDTrainState:
    """The fused TD training scan: advances a FastTDTrainState by
    `num_steps` (chunk-invariant — see compile_fast_td_run). With
    `psum_axes` set (inside a shard_map), the ΔQ/count aggregates are
    all-reduced over those mesh axes before each update — the distributed
    data-parallel learner: every device steps its env shard, the replicated
    Q advances identically everywhere.
    """
    num_states = bl_c.height * bl_c.width
    num_actions = ts.q.shape[-1]
    hi_n, lo_n = _factor_split(num_states)

    bf16, f32 = jnp.bfloat16, jnp.float32

    def body(carry, _):
        q, state, rs, run_ret, n_eps_env, ret_sum_env = carry
        rs, bits = xorshift_next(rs)

        # --- act: Q rows via FACTORIZED one-hot lookup (module docstring),
        # ε-greedy on the result
        s = state.agent_idx
        p_hi = jax.nn.one_hot(s // lo_n, hi_n, dtype=bf16)   # (B, H)
        p_lo = jax.nn.one_hot(s % lo_n, lo_n, dtype=bf16)    # (B, L)
        y = jnp.matmul(
            p_hi,
            q.astype(bf16).reshape(hi_n, lo_n * num_actions),
            preferred_element_type=f32,
        ).reshape(-1, lo_n, num_actions)                     # (B, L, A)
        q_rows = jnp.sum(p_lo.astype(f32)[:, :, None] * y, axis=1)  # (B, A)
        a = _epsilon_greedy_bits(q_rows, bits, epsilon)

        # --- env transition (gather-free bitplane step, auto-reset)
        state, (s2, r, d) = step_bits(
            sem_c, bl_c, state, a, True, max_episode_steps
        )

        # --- TD target: V(s2) via the same factorized lookup
        if algo == "q_learning":
            v = jnp.max(q, axis=-1)                          # (S,)
        else:  # expected_sarsa: ε-greedy expectation over Q(s', ·)
            v = (1.0 - epsilon) * jnp.max(q, axis=-1) + epsilon * jnp.mean(
                q, axis=-1
            )
        p2_hi = jax.nn.one_hot(s2 // lo_n, hi_n, dtype=bf16)
        p2_lo = jax.nn.one_hot(s2 % lo_n, lo_n, dtype=bf16)
        t = jnp.matmul(
            p2_hi, v.astype(bf16).reshape(hi_n, lo_n),
            preferred_element_type=f32,
        )                                                    # (B, L)
        v_s2 = jnp.sum(p2_lo.astype(f32) * t, axis=-1)       # (B,)
        p_a = jax.nn.one_hot(a, num_actions, dtype=f32)
        q_sa = jnp.sum(q_rows * p_a, axis=-1)                # exact: reuse rows
        delta = r + gamma * jnp.where(d, 0.0, v_s2) - q_sa

        # --- update: scatter-add as a transposed matmul over the fused
        # [ΔQ ‖ cnt] block, factorized (ZZ[hi, lo·2A+z] = Σ_b p_hi·p_lo·u);
        # MEAN over colliding (s, a) increments (matches
        # algos/td.apply_td_updates semantics)
        u = jnp.concatenate(
            [p_a * (alpha * delta)[:, None], p_a], axis=-1
        ).astype(bf16)                                       # (B, 2A)
        w = (p_lo[:, :, None] * u[:, None, :]).reshape(
            -1, lo_n * 2 * num_actions
        )                                                    # (B, L·2A)
        zz = jnp.einsum(
            "bh,bw->hw", p_hi, w, preferred_element_type=f32
        ).reshape(num_states, 2 * num_actions)               # (S, 2A)
        dq = zz[:, :num_actions]
        cnt = zz[:, num_actions:]
        if psum_axes is not None:
            # distributed data-parallel learner: combine every shard's
            # aggregates so the replicated Q takes one identical global step
            dq = jax.lax.psum(dq, psum_axes)
            cnt = jax.lax.psum(cnt, psum_axes)
        q = q + dq / jnp.maximum(cnt, 1.0)

        # --- episode stats (per-env accumulators; reduced once at the end)
        run_ret = run_ret + r
        n_eps_env = n_eps_env + d
        ret_sum_env = ret_sum_env + jnp.where(d, run_ret, 0.0)
        run_ret = jnp.where(d, 0.0, run_ret)
        return (q, state, rs, run_ret, n_eps_env, ret_sum_env), None

    init = (
        ts.q,
        ts.env_state,
        ts.rs,
        ts.run_ret,
        ts.n_eps_env,
        ts.ret_sum_env,
    )
    (q, state, rs, run_ret, n_eps_env, ret_sum_env), _ = jax.lax.scan(
        body, init, None, length=num_steps
    )
    return ts.replace(
        q=q,
        env_state=state,
        rs=rs,
        step=ts.step + num_steps,
        run_ret=run_ret,
        n_eps_env=n_eps_env,
        ret_sum_env=ret_sum_env,
    )
