"""Distributed tabular learner — sharded envs + all-reduce Q updates.

BASELINE config 5: "On-device tabular Q-learning / value iteration over the
vectorized model, multi-host sharded envs" with a "sharded tabular learner
via all-reduce". Mechanism (SURVEY.md §2.3): envs sharded over the mesh,
the Q-table REPLICATED on every device, and each step's segment-summed TD
increments combined with `jax.lax.psum` — an all-reduce the runtime
carries (NCCL between cards), with zero backend code.

Determinism contract (tested on the 8-device CPU mesh,
tests/test_parallel.py):
  * In PARITY mode, per-step ε-greedy randomness is drawn as the FULL (B,)
    arrays from the shared per-step key inside every shard, then sliced to
    the local batch — the distributed run consumes bit-identical random
    streams to the single-device `algos.td.q_learning` run with the same
    key. In scalable mode each shard draws only its local randoms from a
    shard-folded key (O(B/n) work; independent streams, deterministic for
    a fixed mesh).
  * psum of the per-(s,a) sums/counts is order-fixed for a fixed mesh
    (SURVEY.md §7.3 multi-host determinism), and the mean update is computed
    AFTER the global reduction — distributed == single-device up to float
    associativity of the psum itself.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..algos.td import (
    td_error_expected_sarsa,
    td_error_qlearning,
    td_error_sarsa,
)
from ..core.semantics import Semantics
from ..core.types import Level
from ..ops.rollout import _pick_step
from .mesh import env_axes, env_spec
from .rollout import reset_batch_sharded


class DistTDResult(NamedTuple):
    q: jnp.ndarray
    episodes: jnp.ndarray
    mean_return: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "algo", "num_steps", "batch_size", "parity", "psum_every"
    ),
)
def q_learning_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    num_steps: int = 10_000,
    batch_size: int = 1024,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    parity: bool = False,
    psum_every: int = 1,
) -> DistTDResult:
    """Distributed synchronous batched TD control (see module docstring).

    The entire training scan runs inside one shard_map: per step, each shard
    steps its local envs, computes local per-(s, a) α·δ sums + visit counts,
    psums both across the mesh, and applies the global mean update to its
    replica of Q. One psum of 2·S·A floats per step — for a 16×16 grid
    that's ~8 KB, pure collective latency.

    psum_every=k (k > 1) amortizes that latency: each shard accumulates
    its raw α·δ sums and visit counts over a k-step WINDOW against the Q
    frozen at the window start, then one psum + one pooled mean update
    per window — 1/k the collectives at fixed work. Documented
    semantics delta vs k=1: within a window, action draws and bootstrap
    targets read the window-start Q (the staleness a sync-period-k
    parameter server would have), and the window's visits pool into ONE
    mean update instead of k per-step means — so α-dynamics match k=1
    only in the limit of disjoint visits. Q stays bit-replicated across
    shards either way (every replica applies the same global update).
    k=1 is the exact per-step path. Requires parity=False and
    num_steps % k == 0.

    Key threading mirrors `algos.td._td_train` exactly: (key → k_reset,
    k_a0, per-step keys), so CPU-mesh tests can assert distributed ==
    single-device.
    """
    if algo not in ("q_learning", "sarsa", "expected_sarsa"):
        raise ValueError(algo)
    if psum_every < 1:
        raise ValueError(f"psum_every must be >= 1, got {psum_every}")
    if psum_every > 1 and parity:
        raise ValueError(
            "parity mode is defined as the bit-exact per-step rule; "
            "psum_every > 1 changes update semantics (see docstring) — "
            "use parity=False"
        )
    if num_steps % psum_every:
        raise ValueError(
            f"num_steps ({num_steps}) must be divisible by psum_every "
            f"({psum_every})"
        )
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = int(sem.deltas.shape[0])
    axes = env_axes(mesh)
    spec = env_spec(mesh)
    n_dev = mesh.size
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {n_dev}"
        )
    local_b = batch_size // n_dev
    step_fn = _pick_step(level, True, True)

    def draw_local(q, s_local, key_t, idx):
        """Shard-local ε-greedy draws.

        parity mode: draw the FULL batch's randoms (same structure as
        algos.td.epsilon_greedy) on every shard and slice the local span —
        bit-identical streams to the single-device run, O(B) work per
        shard (fine for the parity contract, wasteful at scale).

        scalable mode: fold the shard index into
        the step key and draw only the LOCAL (B/n,) randoms — O(B/n) work
        and different-but-independent streams per shard (the same
        global-id-keyed-lanes scheme parallel/bitplane.py uses)."""
        greedy_l = jnp.argmax(q[s_local], axis=-1).astype(jnp.int32)
        if parity:
            ku, ka = jax.random.split(key_t)
            explore = jax.random.uniform(ku, (batch_size,)) < epsilon
            random_a = jax.random.randint(
                ka, (batch_size,), 0, num_actions, dtype=jnp.int32
            )
            lo = idx * local_b
            explore_l = jax.lax.dynamic_slice_in_dim(explore, lo, local_b)
            random_l = jax.lax.dynamic_slice_in_dim(random_a, lo, local_b)
        else:
            ku, ka = jax.random.split(jax.random.fold_in(key_t, idx))
            explore_l = jax.random.uniform(ku, (local_b,)) < epsilon
            random_l = jax.random.randint(
                ka, (local_b,), 0, num_actions, dtype=jnp.int32
            )
        return jnp.where(explore_l, random_l, greedy_l)

    def shard_body(q0, sem, level, state0, k_a0, key_base):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)

        def transition(q, state, a, t):
            """One env step + TD error against `q` → local per-(s,a)
            segment sums (pre-psum). Shared by the per-step (k=1) and
            windowed (psum_every=k) paths."""
            key_t = jax.random.fold_in(key_base, t)
            s = state.agent_idx
            new_state, out = step_fn(sem, level, state, a)
            s2, r, d = out.obs, out.reward, out.done
            a_next = draw_local(q, new_state.agent_idx, key_t, idx)
            if algo == "q_learning":
                delta = td_error_qlearning(q, s, a, r, s2, d, gamma)
            elif algo == "sarsa":
                delta = td_error_sarsa(q, s, a, r, s2, a_next, d, gamma)
            else:
                delta = td_error_expected_sarsa(
                    q, s, a, r, s2, d, gamma, epsilon
                )
            flat = s * num_actions + a
            upd_l = jax.ops.segment_sum(
                alpha * delta, flat, num_segments=num_states * num_actions
            )
            cnt_l = jax.ops.segment_sum(
                jnp.ones_like(delta),
                flat,
                num_segments=num_states * num_actions,
            )
            return new_state, a_next, r, d, flat, delta, upd_l, cnt_l

        def body(carry, t):
            q, state, a, run_ret, n_eps, ret_sum = carry
            (new_state, a_next, r, d, flat, delta, upd_l, cnt_l) = (
                transition(q, state, a, t)
            )

            if parity:
                # Bit-exact mode (SURVEY.md §7.3 multi-host determinism):
                # all_gather the raw per-env (s·A+a, α·δ) pairs and run the
                # IDENTICAL global segment_sum on every replica — literally
                # the same op on the same values as the single-device path,
                # so Q (and hence trajectories) match bit-for-bit. Costs an
                # all_gather of 2·B floats/step instead of a psum of
                # 2·S·A — prefer the psum path at scale.
                flat_g = jax.lax.all_gather(flat, axes, tiled=True)
                inc_g = jax.lax.all_gather(alpha * delta, axes, tiled=True)
                upd = jax.ops.segment_sum(
                    inc_g, flat_g, num_segments=num_states * num_actions
                )
                cnt = jax.ops.segment_sum(
                    jnp.ones_like(inc_g),
                    flat_g,
                    num_segments=num_states * num_actions,
                )
            else:
                # Scalable mode: local per-(s,a) partial sums, then one
                # all-reduce over every mesh axis; the SAME mean update on
                # every replica keeps Q replicated. Last-bit float
                # association differs from single-device — documented.
                upd = jax.lax.psum(upd_l, axes)
                cnt = jax.lax.psum(cnt_l, axes)
            q = q + (upd / jnp.maximum(cnt, 1.0)).reshape(
                num_states, num_actions
            )

            run_ret = run_ret + r
            n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
            ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
            run_ret = jnp.where(d, 0.0, run_ret)
            return (q, new_state, a_next, run_ret, n_eps, ret_sum), None

        def window_body(carry, w):
            # psum_every=k: k steps against the window-start Q, raw sums
            # and counts accumulated LOCALLY, then ONE all-reduce and one
            # pooled mean update (docstring semantics note)
            q, state, a, run_ret, n_eps, ret_sum = carry

            def inner(c, j):
                state, a, run_ret, n_eps, ret_sum, acc_u, acc_c = c
                (new_state, a_next, r, d, _, _, upd_l, cnt_l) = (
                    transition(q, state, a, w * psum_every + j)
                )
                run_ret = run_ret + r
                n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
                ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
                run_ret = jnp.where(d, 0.0, run_ret)
                return (
                    new_state, a_next, run_ret, n_eps, ret_sum,
                    acc_u + upd_l, acc_c + cnt_l,
                ), None

            zeros = jnp.zeros((num_states * num_actions,), jnp.float32)
            (state, a, run_ret, n_eps, ret_sum, acc_u, acc_c), _ = (
                jax.lax.scan(
                    inner,
                    (state, a, run_ret, n_eps, ret_sum, zeros, zeros),
                    jnp.arange(psum_every, dtype=jnp.int32),
                )
            )
            upd = jax.lax.psum(acc_u, axes)
            cnt = jax.lax.psum(acc_c, axes)
            q = q + (upd / jnp.maximum(cnt, 1.0)).reshape(
                num_states, num_actions
            )
            return (q, state, a, run_ret, n_eps, ret_sum), None

        a0 = draw_local(q0, state0.agent_idx, k_a0, idx)
        init = (
            q0,
            state0,
            a0,
            jnp.zeros(local_b, jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.float32),
        )
        if psum_every == 1:
            steps = jnp.arange(num_steps, dtype=jnp.int32)
            (q, _, _, _, n_eps, ret_sum), _ = jax.lax.scan(body, init, steps)
        else:
            windows = jnp.arange(num_steps // psum_every, dtype=jnp.int32)
            (q, _, _, _, n_eps, ret_sum), _ = jax.lax.scan(
                window_body, init, windows
            )
        n_eps = jax.lax.psum(n_eps, axes)
        ret_sum = jax.lax.psum(ret_sum, axes)
        return q, n_eps, ret_sum

    # Key layout mirrors algos.td.td_init + td_run (counter-based fold_in
    # streams) so parity mode can be asserted bit-exact vs single device.
    key, k_reset, k_a0 = jax.random.split(key, 3)
    state0 = reset_batch_sharded(mesh, level, k_reset, batch_size)
    q0 = jnp.zeros((num_states, num_actions), jnp.float32)

    q, n_eps, ret_sum = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), spec, P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(q0, sem, level, state0, k_a0, key)

    return DistTDResult(
        q=q, episodes=n_eps, mean_return=ret_sum / jnp.maximum(n_eps, 1)
    )


def td_lambda_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    num_steps: int = 10_000,
    batch_size: int = 1024,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    lam: float = 0.9,
    algo: str = "sarsa",
    trace: str = "accumulating",
    trace_cutoff: float = 1e-4,
) -> DistTDResult:
    """Distributed TD(λ) control (SARSA(λ) / Watkins Q(λ)) — the
    eligibility-trace member of the all-reduce learner family.

    Sharding layout: each env's (S, A) eligibility tensor lives WITH its
    env shard (traces are per-env state, never communicated); Q stays
    replicated. Per step each shard computes its local trace-weighted
    update numerator `Σ_b δ_b·e_b` and live-trace counts, both are
    `psum`'d (2·S·A floats — same wire cost as q_learning_sharded), and
    every replica applies the identical global collision-mean update
    (algos.td_lambda.apply_trace_updates semantics, reduction grouping
    aside). Behavior draws are shard-local (fold_in(step_key, shard)).
    """
    if algo not in ("sarsa", "watkins"):
        raise ValueError(algo)
    if trace not in ("accumulating", "replacing"):
        raise ValueError(f"unknown trace kind: {trace!r}")
    from ..algos.td_lambda import bump_traces, decay_traces

    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = int(sem.deltas.shape[0])
    axes = env_axes(mesh)
    spec = env_spec(mesh)
    n_dev = mesh.size
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {n_dev}"
        )
    local_b = batch_size // n_dev
    step_fn = _pick_step(level, True, True)

    def draw_local(q, s_local, key_t, idx):
        greedy_l = jnp.argmax(q[s_local], axis=-1).astype(jnp.int32)
        ku, ka = jax.random.split(jax.random.fold_in(key_t, idx))
        explore_l = jax.random.uniform(ku, (local_b,)) < epsilon
        random_l = jax.random.randint(
            ka, (local_b,), 0, num_actions, dtype=jnp.int32
        )
        return jnp.where(explore_l, random_l, greedy_l)

    def shard_body(q0, sem, level, state0, k_a0, key_base):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)

        def body(carry, t):
            q, e, state, a, run_ret, n_eps, ret_sum = carry
            key_t = jax.random.fold_in(key_base, t)
            s = state.agent_idx
            new_state, out = step_fn(sem, level, state, a)
            s2, r, d = out.obs, out.reward, out.done

            e = decay_traces(e, gamma, lam, trace_cutoff)
            e = bump_traces(e, s, a, num_states, num_actions, trace)

            a_next = draw_local(q, new_state.agent_idx, key_t, idx)
            greedy2 = jnp.argmax(q[s2], axis=-1).astype(jnp.int32)

            if algo == "sarsa":
                p_a2 = jax.nn.one_hot(a_next, num_actions, dtype=q.dtype)
                boot = jnp.sum(q[s2] * p_a2, axis=-1)
            else:
                boot = jnp.max(q[s2], axis=-1)
            p_sa = jax.nn.one_hot(a, num_actions, dtype=q.dtype)
            q_sa = jnp.sum(q[s] * p_sa, axis=-1)
            delta = r + gamma * jnp.where(d, 0.0, boot) - q_sa

            # local trace-weighted partials → one all-reduce each
            num = jax.lax.psum(jnp.einsum("b,bsa->sa", delta, e), axes)
            cnt = jax.lax.psum(jnp.sum(e != 0.0, axis=0), axes)
            q = q + alpha * num / jnp.maximum(cnt, 1.0)

            cut = d
            if algo == "watkins":
                cut = jnp.logical_or(cut, a_next != greedy2)
            e = jnp.where(cut[:, None, None], 0.0, e)

            run_ret = run_ret + r
            n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
            ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
            run_ret = jnp.where(d, 0.0, run_ret)
            return (q, e, new_state, a_next, run_ret, n_eps, ret_sum), None

        a0 = draw_local(q0, state0.agent_idx, k_a0, idx)
        e0 = jnp.zeros((local_b, num_states, num_actions), jnp.float32)
        init = (
            q0, e0, state0, a0,
            jnp.zeros(local_b, jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.float32),
        )
        steps = jnp.arange(num_steps, dtype=jnp.int32)
        (q, _, _, _, _, n_eps, ret_sum), _ = jax.lax.scan(body, init, steps)
        n_eps = jax.lax.psum(n_eps, axes)
        ret_sum = jax.lax.psum(ret_sum, axes)
        return q, n_eps, ret_sum

    key, k_reset, k_a0 = jax.random.split(key, 3)
    state0 = reset_batch_sharded(mesh, level, k_reset, batch_size)
    q0 = jnp.zeros((num_states, num_actions), jnp.float32)

    q, n_eps, ret_sum = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), spec, P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(q0, sem, level, state0, k_a0, key)

    return DistTDResult(
        q=q, episodes=n_eps, mean_return=ret_sum / jnp.maximum(n_eps, 1)
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "num_rounds", "batch_size", "max_steps",
                     "first_visit", "include_unfinished", "parity"),
)
def mc_control_sharded(
    mesh: Mesh,
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
    parity: bool = False,
):
    """Distributed ε-greedy MC control — episodes sharded over the mesh,
    Q replicated, per-round (first-visit) return aggregates all-reduced
    (completes the distributed tabular family together with
    parallel.dp.policy_iteration_sharded).

    Each round every shard rolls its local B/n episodes under the shared
    replicated Q, computes its local first-visit return increments, and
    the per-(s, a) segment sums are combined across the mesh before the
    identical collision-mean update lands on every replica.

    Modes (the q_learning_sharded contract):
      * parity=True — per-step randoms are drawn as FULL (B,) arrays from
        the single-device key schedule and sliced locally, and the raw
        (T, B) increment arrays are all_gather'd so the IDENTICAL global
        segment_sum runs on every replica: bit-exact equal to
        algos.mc.mc_control with the same key (tested).
      * parity=False (default) — shard-local draws from shard-folded keys
        and psum'd partial segment sums: O(B/n) RNG work and 2·S·A floats
        on the wire per round.

    Returns algos.mc.MCControlResult (q replicated, episodes total).
    """
    from ..algos.mc import (
        MCControlResult,
        discounted_returns,
        first_visit_mask,
    )
    from ..core.step import reset

    if level.grid.ndim != 2:
        raise ValueError(
            "mc_control_sharded requires a single shared (H, W) level; got "
            f"grid shape {level.grid.shape}. Batched (N, H, W) per-env "
            "levels are not supported on this path (the episode roll and "
            "Q-table are defined over one shared geometry)."
        )
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = int(sem.deltas.shape[0])
    axes = env_axes(mesh)
    n_dev = mesh.size
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {n_dev}"
        )
    local_b = batch_size // n_dev
    from ..core.step import step as core_step

    step_b = jax.vmap(core_step, in_axes=(None, None, 0, 0))

    def shard_body(q0, sem, level, key):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)

        def round_body(q, key_r):
            # key threading mirrors algos.mc._roll_episodes exactly
            key_s, k_reset = jax.random.split(key_r)
            if parity:
                keys_b = jax.random.split(k_reset, batch_size)
                keys_local = jax.lax.dynamic_slice_in_dim(
                    keys_b, idx * local_b, local_b, 0
                )
            else:
                keys_local = jax.random.split(
                    jax.random.fold_in(k_reset, idx), local_b
                )
            state0 = jax.vmap(reset, in_axes=(None, 0))(level, keys_local)

            def body(state, key_t):
                s = state.agent_idx
                valid = jnp.logical_not(state.done)
                greedy = jnp.argmax(q[s], axis=-1).astype(jnp.int32)
                if parity:
                    ku, ka = jax.random.split(key_t)
                    explore = jax.random.uniform(ku, (batch_size,)) < epsilon
                    random_a = jax.random.randint(
                        ka, (batch_size,), 0, num_actions, dtype=jnp.int32
                    )
                    lo = idx * local_b
                    explore_l = jax.lax.dynamic_slice_in_dim(
                        explore, lo, local_b
                    )
                    random_l = jax.lax.dynamic_slice_in_dim(
                        random_a, lo, local_b
                    )
                else:
                    ku, ka = jax.random.split(jax.random.fold_in(key_t, idx))
                    explore_l = jax.random.uniform(ku, (local_b,)) < epsilon
                    random_l = jax.random.randint(
                        ka, (local_b,), 0, num_actions, dtype=jnp.int32
                    )
                a = jnp.where(explore_l, random_l, greedy)
                new_state, out = step_b(sem, level, state, a)
                return new_state, (s, a, out.reward, valid)

            step_keys = jax.random.split(key_s, max_steps)
            final_state, (s, a, r, valid) = jax.lax.scan(
                body, state0, step_keys
            )
            if not include_unfinished:
                valid = valid & final_state.done[None, :]
            g = discounted_returns(r, gamma)
            sa = s * num_actions + a
            mask = first_visit_mask(sa, valid) if first_visit else valid

            delta = g - q.reshape(-1)[sa]
            inc = jnp.where(mask, alpha * delta, 0.0)
            flat = jnp.where(mask, sa, num_states * num_actions)
            n_seg = num_states * num_actions + 1
            if parity:
                # identical global segment_sum on every replica — the MC
                # analogue of q_learning_sharded's parity aggregation
                flat_g = jax.lax.all_gather(flat, axes, tiled=True, axis=1)
                inc_g = jax.lax.all_gather(inc, axes, tiled=True, axis=1)
                m_g = jax.lax.all_gather(
                    mask.astype(jnp.float32), axes, tiled=True, axis=1
                )
                upd = jax.ops.segment_sum(
                    inc_g.reshape(-1), flat_g.reshape(-1), num_segments=n_seg
                )[: num_states * num_actions]
                cnt = jax.ops.segment_sum(
                    m_g.reshape(-1), flat_g.reshape(-1), num_segments=n_seg
                )[: num_states * num_actions]
            else:
                upd = jax.lax.psum(
                    jax.ops.segment_sum(
                        inc.reshape(-1), flat.reshape(-1), num_segments=n_seg
                    )[: num_states * num_actions],
                    axes,
                )
                cnt = jax.lax.psum(
                    jax.ops.segment_sum(
                        mask.astype(jnp.float32).reshape(-1),
                        flat.reshape(-1),
                        num_segments=n_seg,
                    )[: num_states * num_actions],
                    axes,
                )
            q = q + upd.reshape(num_states, num_actions) / jnp.maximum(
                cnt.reshape(num_states, num_actions), 1.0
            )
            return q, None

        keys = jax.random.split(key, num_rounds)
        q, _ = jax.lax.scan(round_body, q0, keys)
        return q

    q0 = jnp.zeros((num_states, num_actions), jnp.float32)
    q = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(q0, sem, level, key)

    return MCControlResult(
        q=q, episodes=jnp.asarray(num_rounds * batch_size, jnp.int32)
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "batch_size", "max_steps", "first_visit",
                     "include_unfinished", "parity"),
)
def mc_prediction_sharded(
    mesh: Mesh,
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
    parity: bool = False,
):
    """Distributed first-visit MC state-value prediction — the prediction
    twin of mc_control_sharded. Episodes sharded over
    the mesh; V is computed identically on every replica from the global
    per-state return sums/counts.

    Modes (the mc_control_sharded contract):
      * parity=True — full-batch (B,) randoms sliced locally and raw
        (T, B) increments all_gather'd so the IDENTICAL global segment_sum
        runs everywhere: bit-exact equal to algos.mc.mc_prediction with
        the same key (tested).
      * parity=False (default) — shard-local draws, psum'd partial
        segment sums: O(B/n) RNG work, 2·S floats on the wire.

    Returns algos.mc.MCResult (value and counts, replicated)."""
    from ..algos.mc import MCResult, discounted_returns, first_visit_mask
    from ..core.step import reset
    from ..core.step import step as core_step

    if level.grid.ndim != 2:
        raise ValueError(
            "mc_prediction_sharded requires a single shared (H, W) level; "
            f"got grid shape {level.grid.shape}"
        )
    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = int(sem.deltas.shape[0])
    axes = env_axes(mesh)
    n_dev = mesh.size
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {n_dev}"
        )
    local_b = batch_size // n_dev
    step_b = jax.vmap(core_step, in_axes=(None, None, 0, 0))

    def shard_body(policy_q, sem, level, key):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)

        # key threading mirrors algos.mc._roll_episodes exactly
        key_s, k_reset = jax.random.split(key)
        if parity:
            keys_b = jax.random.split(k_reset, batch_size)
            keys_local = jax.lax.dynamic_slice_in_dim(
                keys_b, idx * local_b, local_b, 0
            )
        else:
            keys_local = jax.random.split(
                jax.random.fold_in(k_reset, idx), local_b
            )
        state0 = jax.vmap(reset, in_axes=(None, 0))(level, keys_local)

        def body(state, key_t):
            s = state.agent_idx
            valid = jnp.logical_not(state.done)
            if policy_q is None:
                if parity:
                    full = jax.random.randint(
                        key_t, (batch_size,), 0, num_actions, dtype=jnp.int32
                    )
                    a = jax.lax.dynamic_slice_in_dim(
                        full, idx * local_b, local_b
                    )
                else:
                    a = jax.random.randint(
                        jax.random.fold_in(key_t, idx), (local_b,), 0,
                        num_actions, dtype=jnp.int32,
                    )
            else:
                greedy = jnp.argmax(policy_q[s], axis=-1).astype(jnp.int32)
                if parity:
                    ku, ka = jax.random.split(key_t)
                    explore = jax.random.uniform(ku, (batch_size,)) < epsilon
                    random_a = jax.random.randint(
                        ka, (batch_size,), 0, num_actions, dtype=jnp.int32
                    )
                    lo = idx * local_b
                    explore_l = jax.lax.dynamic_slice_in_dim(
                        explore, lo, local_b
                    )
                    random_l = jax.lax.dynamic_slice_in_dim(
                        random_a, lo, local_b
                    )
                else:
                    ku, ka = jax.random.split(jax.random.fold_in(key_t, idx))
                    explore_l = jax.random.uniform(ku, (local_b,)) < epsilon
                    random_l = jax.random.randint(
                        ka, (local_b,), 0, num_actions, dtype=jnp.int32
                    )
                a = jnp.where(explore_l, random_l, greedy)
            new_state, out = step_b(sem, level, state, a)
            return new_state, (s, out.reward, valid)

        step_keys = jax.random.split(key_s, max_steps)
        final_state, (s, r, valid) = jax.lax.scan(body, state0, step_keys)
        if not include_unfinished:
            valid = valid & final_state.done[None, :]
        g = discounted_returns(r, gamma)
        mask = first_visit_mask(s, valid) if first_visit else valid

        flat = jnp.where(mask, s, num_states)
        n_seg = num_states + 1
        if parity:
            flat_g = jax.lax.all_gather(flat, axes, tiled=True, axis=1)
            g_g = jax.lax.all_gather(
                jnp.where(mask, g, 0.0), axes, tiled=True, axis=1
            )
            m_g = jax.lax.all_gather(
                mask.astype(jnp.float32), axes, tiled=True, axis=1
            )
            g_sum = jax.ops.segment_sum(
                g_g.reshape(-1), flat_g.reshape(-1), num_segments=n_seg
            )[:num_states]
            n = jax.ops.segment_sum(
                m_g.reshape(-1), flat_g.reshape(-1), num_segments=n_seg
            )[:num_states]
        else:
            g_sum = jax.lax.psum(
                jax.ops.segment_sum(
                    jnp.where(mask, g, 0.0).reshape(-1),
                    flat.reshape(-1),
                    num_segments=n_seg,
                )[:num_states],
                axes,
            )
            n = jax.lax.psum(
                jax.ops.segment_sum(
                    mask.astype(jnp.float32).reshape(-1),
                    flat.reshape(-1),
                    num_segments=n_seg,
                )[:num_states],
                axes,
            )
        v = jnp.where(n > 0, g_sum / jnp.maximum(n, 1.0), 0.0)
        return v, n

    if policy_q is None:
        policy_q_arg, pq_spec = None, None
    else:
        policy_q_arg, pq_spec = policy_q, P()
    v, n = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(pq_spec, P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(policy_q_arg, sem, level, key)
    return MCResult(value=v, counts=n)


@partial(
    jax.jit,
    static_argnames=("mesh", "num_steps", "batch_size", "trace", "parity"),
)
def td_lambda_prediction_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    policy: jnp.ndarray,
    key: jnp.ndarray,
    num_steps: int = 10_000,
    batch_size: int = 1024,
    alpha: float = 0.1,
    gamma: float = 0.99,
    lam: float = 0.9,
    trace: str = "accumulating",
    trace_cutoff: float = 1e-4,
    parity: bool = False,
):
    """Distributed TD(λ) policy EVALUATION — learn V^π for a fixed
    stochastic (S, A) policy with per-env (B/n, S) eligibility traces
    sharded with their envs and V replicated (the prediction member of
    the all-reduce family).

    Per step each shard computes its local trace-weighted partial
    `Σ_b δ_b·e_b` and live-trace counts; both are psum'd (2·S floats on
    the wire) and every replica applies the identical collision-mean
    update (algos.td_lambda.td_lambda_prediction semantics).

    parity=True (test mode): the full (B, A) Gumbel noise behind the
    single-device `jax.random.categorical` draw is materialized on every
    shard and sliced locally, and the raw (B,) deltas + (B, S) traces are
    all_gather'd so the IDENTICAL global einsum runs everywhere —
    bit-exact equal to the single-device run with the same key (tested);
    O(B·S) wire per step, so scalable runs keep the default."""
    if trace not in ("accumulating", "replacing"):
        raise ValueError(f"unknown trace kind: {trace!r}")
    from ..algos.td_lambda import TDLambdaPredictionResult, decay_traces

    num_states = level.grid.shape[-2] * level.grid.shape[-1]
    num_actions = int(sem.deltas.shape[0])
    axes = env_axes(mesh)
    spec = env_spec(mesh)
    n_dev = mesh.size
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {n_dev}"
        )
    local_b = batch_size // n_dev
    step_fn = _pick_step(level, True, True)

    def shard_body(sem, level, policy, state0, key_base):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
        logp = jnp.log(jnp.maximum(policy, 1e-30))

        def draw(v_unused, s_local, key_t):
            if parity:
                # jax.random.categorical IS gumbel+argmax; materializing
                # the full-batch noise and slicing keeps bit-parity
                gumbel = jax.random.gumbel(
                    key_t, (batch_size, num_actions), logp.dtype
                )
                g_l = jax.lax.dynamic_slice_in_dim(
                    gumbel, idx * local_b, local_b, 0
                )
                return jnp.argmax(logp[s_local] + g_l, axis=-1).astype(
                    jnp.int32
                )
            return jax.random.categorical(
                jax.random.fold_in(key_t, idx), logp[s_local]
            ).astype(jnp.int32)

        def body(carry, t):
            v, e, state, run_eps = carry
            key_t = jax.random.fold_in(key_base, t)
            s = state.agent_idx
            a = draw(v, s, key_t)
            new_state, out = step_fn(sem, level, state, a)
            s2, r, d = out.obs, out.reward, out.done

            e = decay_traces(e, gamma, lam, trace_cutoff)
            hot = jax.nn.one_hot(s, num_states, dtype=e.dtype)
            e = e + hot if trace == "accumulating" else jnp.maximum(e, hot)

            delta = r + gamma * jnp.where(d, 0.0, v[s2]) - v[s]
            if parity:
                delta_g = jax.lax.all_gather(delta, axes, tiled=True)
                e_g = jax.lax.all_gather(e, axes, tiled=True)
                num = jnp.einsum("b,bs->s", delta_g, e_g)
                cnt = jnp.sum(e_g != 0.0, axis=0)
            else:
                num = jax.lax.psum(jnp.einsum("b,bs->s", delta, e), axes)
                cnt = jax.lax.psum(jnp.sum(e != 0.0, axis=0), axes)
            v = v + alpha * num / jnp.maximum(cnt, 1.0)

            e = jnp.where(d[:, None], 0.0, e)
            run_eps = run_eps + jnp.sum(d, dtype=jnp.int32)
            return (v, e, new_state, run_eps), None

        v0 = jnp.zeros((num_states,), jnp.float32)
        e0 = jnp.zeros((local_b, num_states), jnp.float32)
        init = (v0, e0, state0, jnp.zeros((), jnp.int32))
        (v, _, _, n_eps), _ = jax.lax.scan(
            body, init, jnp.arange(num_steps, dtype=jnp.int32)
        )
        return v, jax.lax.psum(n_eps, axes)

    # key threading mirrors algos.td_lambda.td_lambda_prediction exactly
    key, k_reset = jax.random.split(key)
    state0 = reset_batch_sharded(mesh, level, k_reset, batch_size)

    v, n_eps = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), spec, P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(sem, level, policy, state0, key)
    return TDLambdaPredictionResult(v=v, episodes=n_eps)


@partial(
    jax.jit,
    static_argnames=("mesh", "num_steps", "algo", "max_episode_steps",
                     "parity"),
)
def q_learning_batched_sharded(
    mesh: Mesh,
    sem: Semantics,
    levels: Level,
    key: jnp.ndarray,
    num_steps: int = 5_000,
    alpha: float = 0.1,
    gamma: float = 0.99,
    epsilon: float = 0.1,
    algo: str = "q_learning",
    max_episode_steps: int | None = None,
    parity: bool = False,
):
    """Per-maze sampled TD control over the maze-sharded axis — each
    shard's envs live in their own mazes and train their own (n_local,
    S, A) Q-tables; experience and tables never cross shards, so the
    only collectives are the end-of-run episode-stat psums (the
    embarrassingly-parallel composition, like value_iteration_batched_
    sharded but model-free; completes the sampling-solver × per-env-model
    × mesh cell of the matrix).

    parity=True draws the full (N,) per-step randoms and slices locally:
    bit-exact equal to algos.q_learning_batched with the same key
    (tested). Default: shard-folded O(N/n) draws.

    Returns algos.td_batched.BatchedTDResult with the (N, S, A) tables
    assembled across shards."""
    from ..algos.td_batched import BatchedTDResult, _q_rows, _td_step
    from ..ops.bitplane import pack_level, reset_bits

    if levels.grid.ndim != 3:
        raise ValueError(
            f"expected a batched (N, H, W) level grid; got "
            f"{levels.grid.shape}"
        )
    if algo not in ("q_learning", "sarsa", "expected_sarsa"):
        raise ValueError(algo)
    n = levels.grid.shape[0]
    axes = env_axes(mesh)
    n_dev = mesh.size
    if n % n_dev:
        raise ValueError(f"maze count {n} not divisible by mesh size {n_dev}")
    local_n = n // n_dev
    num_actions = int(sem.deltas.shape[0])
    bl = pack_level(levels)
    from ..models.a2c import _level_specs

    spec = env_spec(mesh)
    bl_specs = _level_specs(bl, n, spec)

    def shard_body(sem, bl, key):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
        s_dim = bl.height * bl.width

        def draw(q, s_local, key_t):
            greedy = jnp.argmax(_q_rows(q, s_local), axis=-1).astype(
                jnp.int32
            )
            if parity:
                ku, ka = jax.random.split(key_t)
                explore = jax.random.uniform(ku, (n,)) < epsilon
                random_a = jax.random.randint(
                    ka, (n,), 0, num_actions, dtype=jnp.int32
                )
                lo = idx * local_n
                explore_l = jax.lax.dynamic_slice_in_dim(explore, lo, local_n)
                random_l = jax.lax.dynamic_slice_in_dim(random_a, lo, local_n)
            else:
                ku, ka = jax.random.split(jax.random.fold_in(key_t, idx))
                explore_l = jax.random.uniform(ku, (local_n,)) < epsilon
                random_l = jax.random.randint(
                    ka, (local_n,), 0, num_actions, dtype=jnp.int32
                )
            return jnp.where(explore_l, random_l, greedy)

        key_run, k_a0 = jax.random.split(key)
        state0 = reset_bits(bl, None)
        q0 = jnp.zeros((local_n, s_dim, num_actions), jnp.float32)
        a0 = draw(q0, state0.agent_idx, k_a0)

        def body(carry, t):
            q, state, a, run_ret, n_eps, ret_sum = carry
            key_t = jax.random.fold_in(key_run, t)
            # the ONE update rule (algos.td_batched._td_step); only the
            # action draw is shard-aware
            q, new_state, a_next, r, d = _td_step(
                sem, bl, algo, alpha, gamma, epsilon, max_episode_steps,
                draw, q, state, a, key_t,
            )
            run_ret = run_ret + r
            n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
            ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
            run_ret = jnp.where(d, 0.0, run_ret)
            return (q, new_state, a_next, run_ret, n_eps, ret_sum), None

        init = (
            q0, state0, a0,
            jnp.zeros(local_n, jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.float32),
        )
        (q, _, _, _, n_eps, ret_sum), _ = jax.lax.scan(
            body, init, jnp.arange(num_steps, dtype=jnp.int32)
        )
        return q, jax.lax.psum(n_eps, axes), jax.lax.psum(ret_sum, axes)

    q, n_eps, ret_sum = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), bl_specs, P()),
        out_specs=(spec, P(), P()),
        check_vma=False,
    )(sem, bl, key)
    return BatchedTDResult(
        q=q, episodes=n_eps, mean_return=ret_sum / jnp.maximum(n_eps, 1)
    )
