"""Sharded bit-packed rollouts — the multi-host throughput engine.

Combines the two performance layers of this framework:

  * the bit-packed select-tree step (ops/bitplane.py) — gather-free,
    constant-folded;
  * env data-parallelism over a device mesh via `shard_map`
    (parallel/rollout.py) — the BASELINE north-star scaling axis.

Determinism contract: every env's action stream is a xorshift32 lane seeded
by its GLOBAL env id (ops.bitplane.xorshift_init offset), so a sharded run
produces EXACTLY the per-env trajectories of the unsharded
`compile_rollout_random` — episode counts match integer-exactly for any
mesh shape (1/2/4/8 devices tested); float stat sums may differ only in
reduction order. This is the "determinism tests across device counts stand
in for race tests" strategy of SURVEY.md §5.

The level tables are baked into the per-device program as compile-time
constants so XLA folds the select trees. Per-env
batched levels (one maze per env) are embedded whole and each shard
dynamic-slices its rows by mesh position — keeping constant-folding AND
sharding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.semantics import Semantics
from ..ops.bitplane import (
    BitLevel,
    random_scan_bits,
    reset_bits,
    xorshift_init,
)
from .mesh import env_axes, env_spec


def _global_shard_index(axes) -> jnp.ndarray:
    """Row-major linear index of this device across the given mesh axes."""
    idx = jax.lax.axis_index(axes[0])
    for ax in axes[1:]:
        idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
    return idx


def compile_rollout_random_sharded(
    mesh: Mesh,
    sem: Semantics,
    bl: BitLevel,
    batch_size: int,
    num_steps: int,
    max_episode_steps: int | None = None,
    unroll: int = 16,
):
    """Peak-throughput sharded factory: returns a jitted
    `fn(seed) -> (final FastState sharded over the mesh, stats scalars)`.

    Envs are sharded over every mesh axis; the whole T-step scan runs inside
    shard_map (one XLA program per device, zero host round-trips); the only
    collectives are three scalar psums at the end. Semantics/level tables
    are closed over as host constants so XLA folds the select trees.
    """
    axes = env_axes(mesh)
    spec = env_spec(mesh)
    n = mesh.size
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {n}")
    local = batch_size // n

    # Host copies → trace as compile-time constants inside the shard body.
    sem_c: Semantics = jax.tree.map(np.asarray, sem)
    bl_c: BitLevel = jax.tree.map(np.asarray, bl)
    if bl_c.batched and bl_c.code_words.shape[0] != batch_size:
        raise ValueError(
            f"batched BitLevel has {bl_c.code_words.shape[0]} levels; "
            f"expected batch_size={batch_size}"
        )

    def shard_body(seed):
        offset = _global_shard_index(axes) * local
        if bl_c.batched:
            # Embed the full level constants; each shard slices its rows.
            words = jax.lax.dynamic_slice_in_dim(
                jnp.asarray(bl_c.code_words), offset, local, 0
            )
            start_idx = jax.lax.dynamic_slice_in_dim(
                jnp.broadcast_to(jnp.asarray(bl_c.start_idx), (batch_size,)),
                offset, local, 0,
            )
            start_code = jax.lax.dynamic_slice_in_dim(
                jnp.broadcast_to(jnp.asarray(bl_c.start_code), (batch_size,)),
                offset, local, 0,
            )
            bl_local = BitLevel(
                code_words=words,
                start_idx=start_idx,
                start_code=start_code,
                height=bl_c.height,
                width=bl_c.width,
            )
        else:
            bl_local = bl_c
        state = reset_bits(bl_local, local)
        rs = xorshift_init(seed, (local,), offset=offset)
        state, n_eps, ret_sum, len_sum = random_scan_bits(
            sem_c, bl_local, state, rs, None, num_steps,
            max_episode_steps, "xorshift", unroll,
        )
        n_tot = jax.lax.psum(jnp.sum(n_eps), axes)
        ret_tot = jax.lax.psum(jnp.sum(ret_sum), axes)
        len_tot = jax.lax.psum(jnp.sum(len_sum), axes)
        return state, n_tot, ret_tot, len_tot

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=(spec, P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def fn(seed):
        state, n, ret_sum, len_sum = sharded(seed)
        stats = {
            "episodes": n,
            "mean_return": ret_sum / jnp.maximum(n, 1),
            "mean_length": len_sum / jnp.maximum(n, 1),
        }
        return state, stats

    return fn


def compile_q_learning_fast_sharded(
    mesh: Mesh,
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
    """Distributed matmul-form Q-learning (the BASELINE north-star "sharded
    tabular learner via all-reduce", on the fast engine): envs sharded over
    the mesh, Q replicated, and each step's ΔQ/count matmul aggregates
    psum'd before the update — so the replicated Q advances identically on
    every device, and the result equals the unsharded
    algos.td_fast.compile_q_learning_fast run (same global xorshift
    streams) up to float reduction order.

    Returns a jitted `fn(seed, q0=None) -> FastTDResult`.
    """
    from ..algos.td_fast import (
        FastTDResult,
        FastTDTrainState,
        td_scan_fast,
    )

    if algo not in ("q_learning", "expected_sarsa"):
        raise ValueError(f"unknown algo: {algo!r}")
    axes = env_axes(mesh)
    n = mesh.size
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {n}")
    local = batch_size // n
    sem_c: Semantics = jax.tree.map(np.asarray, sem)
    bl_c: BitLevel = jax.tree.map(np.asarray, bl)
    if bl_c.batched and bl_c.code_words.shape[0] != batch_size:
        raise ValueError(
            f"batched BitLevel has {bl_c.code_words.shape[0]} levels; "
            f"expected batch_size={batch_size}"
        )
    num_states = bl_c.height * bl_c.width
    num_actions = int(np.asarray(sem_c.deltas).shape[0])

    def shard_body(seed, q):
        offset = _global_shard_index(axes) * local
        if bl_c.batched:
            # per-env levels: each shard slices its level rows out of the
            # embedded constants (the compile_rollout_random_sharded
            # pattern) — the shared Q then learns the family-average
            # action values across all mazes, exactly as the unsharded
            # batched run does
            bl_local = BitLevel(
                code_words=jax.lax.dynamic_slice_in_dim(
                    jnp.asarray(bl_c.code_words), offset, local, 0
                ),
                start_idx=jax.lax.dynamic_slice_in_dim(
                    jnp.broadcast_to(
                        jnp.asarray(bl_c.start_idx), (batch_size,)
                    ),
                    offset, local, 0,
                ),
                start_code=jax.lax.dynamic_slice_in_dim(
                    jnp.broadcast_to(
                        jnp.asarray(bl_c.start_code), (batch_size,)
                    ),
                    offset, local, 0,
                ),
                height=bl_c.height,
                width=bl_c.width,
            )
        else:
            bl_local = bl_c
        state = reset_bits(bl_local, local)
        rs = xorshift_init(seed, (local,), offset=offset)
        ts = FastTDTrainState(
            q=q,
            env_state=state,
            rs=rs,
            step=jnp.zeros((), jnp.int32),
            run_ret=jnp.zeros((local,), jnp.float32),
            n_eps_env=jnp.zeros((local,), jnp.int32),
            ret_sum_env=jnp.zeros((local,), jnp.float32),
        )
        ts = td_scan_fast(
            sem_c, bl_local, ts, num_steps,
            alpha, gamma, epsilon, algo, max_episode_steps,
            psum_axes=axes,
        )
        n_tot = jax.lax.psum(jnp.sum(ts.n_eps_env), axes)
        ret_tot = jax.lax.psum(jnp.sum(ts.ret_sum_env), axes)
        return ts.q, n_tot, ret_tot

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def fn(seed, q0=None):
        q = (
            jnp.zeros((num_states, num_actions), jnp.float32)
            if q0 is None
            else jnp.asarray(q0, jnp.float32)
        )
        q, n_eps, ret_sum = sharded(seed, q)
        return FastTDResult(
            q=q,
            episodes=n_eps,
            mean_return=ret_sum / jnp.maximum(n_eps, 1),
        )

    return fn
