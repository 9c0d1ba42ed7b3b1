"""Sharded rollouts — envs data-parallel over the mesh via shard_map.

BASELINE north star: "Scale across a v5p multi-host slice with envs sharded
over hosts". The env step has NO cross-env coupling, so a rollout is
embarrassingly parallel: each device scans its own shard of the env batch;
the ONLY collectives are the psums that combine episode statistics — scalars,
so communication cost is nil. We use `shard_map` (not bare jit auto-sharding)
so the partitioning is explicit and XLA can't insert accidental resharding
(pattern refs: SNIPPETS.md shard_map/PartitionSpec snippets).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.semantics import Semantics
from ..core.step import reset
from ..core.types import EnvState, Level
from ..ops.rollout import _pick_step
from .mesh import env_axes, env_spec


def reset_batch_sharded(
    mesh: Mesh, level: Level, key: jnp.ndarray, batch_size: int
) -> EnvState:
    """B envs with their state sharded over the mesh (per-device key split
    happens inside each shard — no cross-device key traffic)."""
    n = mesh.size
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh size {n}")

    keys = jax.random.split(key, batch_size)
    # level replicated, keys sharded
    return jax.shard_map(
        lambda lvl, ks: jax.vmap(reset, in_axes=(None, 0))(lvl, ks),
        mesh=mesh,
        in_specs=(P(), env_spec(mesh)),
        out_specs=env_spec(mesh),
    )(level, keys)


@partial(
    jax.jit, static_argnames=("mesh", "num_steps", "auto_reset", "batch_size")
)
def episode_stats_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    batch_size: int,
    num_steps: int,
    auto_reset: bool = True,
):
    """Random-action rollout with episode stats, envs sharded over the mesh.

    The whole T-step scan runs INSIDE shard_map (one XLA program per device,
    zero host round-trips); per-shard stats are psum'd at the end — the only
    collective in the program. Stats match the single-device
    ops.rollout.episode_stats semantics.
    """
    num_actions = sem.deltas.shape[0]
    axes = env_axes(mesh)
    spec = env_spec(mesh)
    step_fn = _pick_step(level, True, auto_reset)

    def shard_body(sem, level, state0, keys):
        local = state0.agent_idx.shape[0]

        def body(carry, key_t):
            state, run_ret, n_eps, ret_sum, len_sum, run_len = carry
            # Per-shard independent streams: fold the shard index into the
            # per-step key so shards don't replay identical actions.
            idx = jax.lax.axis_index(axes[0])
            for ax in axes[1:]:
                idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
            key_local = jax.random.fold_in(key_t, idx)
            actions = jax.random.randint(
                key_local, (local,), 0, num_actions, dtype=jnp.int32
            )
            new_state, out = step_fn(sem, level, state, actions)
            run_ret = run_ret + out.reward
            run_len = run_len + 1
            d = out.done
            n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
            ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
            len_sum = len_sum + jnp.sum(jnp.where(d, run_len, 0), dtype=jnp.int32)
            run_ret = jnp.where(d, 0.0, run_ret)
            run_len = jnp.where(d, 0, run_len)
            return (new_state, run_ret, n_eps, ret_sum, len_sum, run_len), None

        init = (
            state0,
            jnp.zeros(local, jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.int32),
            jnp.zeros(local, jnp.int32),
        )
        (state, _, n_eps, ret_sum, len_sum, _), _ = jax.lax.scan(body, init, keys)
        # all-reduce the scalar stats over every mesh axis
        n_eps = jax.lax.psum(n_eps, axes)
        ret_sum = jax.lax.psum(ret_sum, axes)
        len_sum = jax.lax.psum(len_sum, axes)
        return state, n_eps, ret_sum, len_sum

    key_reset, key_steps = jax.random.split(key)
    state0 = reset_batch_sharded(mesh, level, key_reset, batch_size)
    keys = jax.random.split(key_steps, num_steps)

    state, n_eps, ret_sum, len_sum = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), spec, P()),
        out_specs=(spec, P(), P(), P()),
        check_vma=False,
    )(sem, level, state0, keys)

    return state, {
        "episodes": n_eps,
        "mean_return": ret_sum / jnp.maximum(n_eps, 1),
        "mean_length": len_sum / jnp.maximum(n_eps, 1),
        "steps": jnp.asarray(num_steps * batch_size, jnp.int32),
    }
