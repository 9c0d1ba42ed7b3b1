"""Bring-up check of griduniverse_tpu on one NVIDIA card (or four).

    python chip_smoke.py               # every phase on one card
    python chip_smoke.py --four-cards  # only the sharded path, on four cards

Each phase drives a public entry point of the library at the size users run
(64k envs, 64k mazes, PPO/DQN over 64k envs) and checks its output against
the repo's own reference: the gather step and the NumPy oracle, the maze
validator, the table-form solver, or the same computation on the host's CPU
device. Per phase it prints one JSON line: the first call's seconds
(compile + run), the steady seconds (median of three more calls, each
fenced with `jax.block_until_ready`), compile seconds as their
difference, the process's peak device memory so far, and what the check
found.

A failed check or any exception ends the run with a nonzero exit code. The
script refuses to run without a GPU: there is no CPU fallback. Its last
line is `{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from griduniverse_tpu import make_semantics
from griduniverse_tpu.algos import (
    action_values_batched,
    build_model_tables,
    compile_fast_td_run,
    compile_q_learning_fast,
    fast_td_init,
    q_learning,
    value_iteration_batched,
    value_iteration_batched_grid,
)
from griduniverse_tpu.core.types import Level
from griduniverse_tpu.levels.builders import walls_and_goal_16x16
from griduniverse_tpu.levels.maze import check_perfect_maze, generate_mazes_device
from griduniverse_tpu.models import (
    DQNConfig,
    PPOConfig,
    dqn_init,
    dqn_result,
    dqn_run,
    make_network,
    per_scores,
    ppo_loss,
    ppo_train,
    ppo_train_sharded,
    prioritized_sample,
)
from griduniverse_tpu.ops.bitplane import (
    compile_rollout_random,
    pack_level,
    reset_bits,
    rollout_actions_bits,
)
from griduniverse_tpu.ops.rollout import reset_batch, rollout_actions, rollout_random
from griduniverse_tpu.parallel import (
    compile_rollout_random_sharded,
    make_env_mesh,
    q_learning_sharded,
    value_iteration_batched_grid_sharded,
)
from griduniverse_tpu.utils.compile_cache import enable_compile_cache
from griduniverse_tpu.utils.profiling import gpu_name_and_power_limit
from griduniverse_tpu.utils.oracle import OracleGridEnv

MAX_EPISODE_STEPS = 512  # time limit of the timed rollouts (bench.py's)
CHECK_EPISODE_STEPS = 64  # shorter limit, so the checks cross truncations
# The repo's own solver tolerance: algos.dp_batched._close_expr.
VI_ATOL, VI_RTOL = 1e-4, 1e-5


class CheckFailed(RuntimeError):
    """A phase's output disagreed with its reference."""


def check(ok, what: str):
    if not bool(ok):
        raise CheckFailed(what)


def timed(fn, *args, **kwargs):
    """(result, seconds) of one call, fenced with block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def first_and_steady(fn, *args, **kwargs):
    """The first call compiles; steady state is the median of three more."""
    out, first = timed(fn, *args, **kwargs)
    steady = []
    for _ in range(3):
        out, seconds = timed(fn, *args, **kwargs)
        steady.append(seconds)
    steady = float(np.median(steady))
    return out, {
        "first_call_s": first,
        "steady_s": steady,
        "compile_s": max(first - steady, 0.0),
    }


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def maze_levels(key, cells, n, algorithm="binary_tree") -> Level:
    grids, start = generate_mazes_device(key, cells, n, algorithm=algorithm)
    return Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))


def on_device(tree, device):
    return jax.device_put(jax.device_get(tree), device)


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------


def phase_step(sem, n_envs=65_536, n_steps=2_000, n_check_envs=1_024,
               n_check_steps=256, n_oracle_envs=8,
               max_episode_steps=MAX_EPISODE_STEPS):
    """Packed (select-tree) engine vs the gather step vs the NumPy oracle."""
    level = walls_and_goal_16x16()
    bl = pack_level(level)
    packed = compile_rollout_random(
        sem, bl, n_envs, n_steps, max_episode_steps=max_episode_steps
    )
    (_, stats), t = first_and_steady(packed, jnp.uint32(0))
    check(int(stats["episodes"]) > 0, "packed rollout finished no episode")
    check(np.isfinite(float(stats["mean_return"])), "packed return not finite")

    # the same rollout through the gather step (core/step.py), for timing
    gather = jax.jit(
        rollout_random,
        static_argnames=("num_steps", "auto_reset", "max_episode_steps"),
    )
    state0 = reset_batch(level, jax.random.PRNGKey(0), n_envs)
    _, t_gather = first_and_steady(
        gather, sem, level, state0, jax.random.PRNGKey(1), num_steps=n_steps,
        max_episode_steps=max_episode_steps,
    )

    # bit-exact: same pre-drawn actions through both engines
    actions = jnp.asarray(
        np.random.default_rng(0).integers(
            0, 4, (n_check_steps, n_check_envs), dtype=np.int32
        )
    )
    run_bits = jax.jit(
        rollout_actions_bits, static_argnames=("auto_reset", "max_episode_steps")
    )
    run_gather = jax.jit(
        rollout_actions, static_argnames=("auto_reset", "max_episode_steps")
    )
    fb, (obs_b, rew_b, done_b) = run_bits(
        sem, bl, reset_bits(bl, n_check_envs), actions,
        auto_reset=True, max_episode_steps=CHECK_EPISODE_STEPS,
    )
    fg, out_g = run_gather(
        sem, level, reset_batch(level, jax.random.PRNGKey(2), n_check_envs),
        actions, auto_reset=True, max_episode_steps=CHECK_EPISODE_STEPS,
    )
    for name, a, b in (
        ("obs", obs_b, out_g.obs), ("reward", rew_b, out_g.reward),
        ("done", done_b, out_g.done), ("agent_idx", fb.agent_idx, fg.agent_idx),
        ("t", fb.t, fg.t),
    ):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"packed vs gather step: {name} differs")
    acts = np.asarray(actions)
    for i in range(n_oracle_envs):
        o, r, d = OracleGridEnv(
            np.asarray(level.grid), int(level.start_idx), auto_reset=True,
            max_episode_steps=CHECK_EPISODE_STEPS,
        ).run_actions(acts[:, i])
        check(
            np.array_equal(o, np.asarray(obs_b[:, i]))
            and np.array_equal(r, np.asarray(rew_b[:, i]))
            and np.array_equal(d, np.asarray(done_b[:, i])),
            f"packed step vs NumPy oracle: env {i} differs",
        )
    return {
        **t,
        "gather_step_first_call_s": t_gather["first_call_s"],
        "gather_step_steady_s": t_gather["steady_s"],
        "env_steps": n_envs * n_steps,
        "episodes": int(stats["episodes"]),
        "check": (
            f"bit-exact: packed == gather on {n_check_envs} envs x "
            f"{n_check_steps} steps, == oracle on {n_oracle_envs} envs"
        ),
    }


def phase_mazes(n_mazes=65_536, cells=(4, 4), n_check=256):
    """Device maze generators vs the host perfect-maze validator."""
    out = {}
    rng = np.random.default_rng(0)
    for algorithm in ("binary_tree", "aldous_broder"):
        (grids, _), t = first_and_steady(
            generate_mazes_device, jax.random.PRNGKey(7), cells, n_mazes,
            algorithm=algorithm,
        )
        pick = rng.choice(n_mazes, size=min(n_check, n_mazes), replace=False)
        sample = np.asarray(grids[jnp.asarray(pick)])
        bad = [int(i) for i, g in zip(pick, sample)
               if not check_perfect_maze(g, cells)]
        check(not bad, f"{algorithm}: imperfect mazes at {bad[:5]}")
        out[algorithm] = t
    out["check"] = f"exact: {min(n_check, n_mazes)} sampled mazes of each are perfect"
    return out


def _vi_agree(sem, levels, v, policy, v_ref, policy_ref, what):
    """V within the solver's tolerance; policies equal except where the two
    actions' values tie within that tolerance. Returns #tied differences."""
    v, v_ref = np.asarray(v), np.asarray(v_ref)
    check(
        np.all(np.abs(v - v_ref) <= VI_ATOL + VI_RTOL * np.abs(v_ref)),
        f"{what}: V differs by {np.max(np.abs(v - v_ref)):.3g}",
    )
    policy, policy_ref = np.asarray(policy), np.asarray(policy_ref)
    diff = policy != policy_ref
    if diff.any():
        q = np.asarray(action_values_batched(
            build_model_tables(sem, levels), jnp.asarray(v_ref), 0.99, "gather"
        ))
        qa = np.take_along_axis(q, policy[..., None], -1)[..., 0]
        qb = np.take_along_axis(q, policy_ref[..., None], -1)[..., 0]
        tie = np.abs(qa - qb) <= VI_ATOL + VI_RTOL * np.abs(qb)
        check(np.all(tie[diff]), f"{what}: greedy policies differ beyond ties")
    return int(diff.sum())


def phase_vi(sem, n_mazes=65_536, cells=(4, 4), n_check=64):
    """Grid-form batched VI vs the table-form solver on a slice."""
    levels = maze_levels(jax.random.PRNGKey(7), cells, n_mazes)
    (v, policy, iters), t = first_and_steady(
        value_iteration_batched_grid, sem, levels
    )
    part = Level(grid=levels.grid[:n_check], start_idx=levels.start_idx[:n_check])
    v_ref, policy_ref, iters_ref = value_iteration_batched(
        build_model_tables(sem, part)
    )
    ties = _vi_agree(sem, part, v[:n_check], policy[:n_check], v_ref,
                     policy_ref, "grid VI vs table VI")
    return {
        **t, "mazes": n_mazes, "iters": int(iters),
        "iters_table_slice": int(iters_ref),
        "check": (
            f"V within atol {VI_ATOL} rtol {VI_RTOL} of the table form on "
            f"{n_check} mazes; policies equal but {ties} tied cells"
        ),
    }


def phase_vi_canary(sem, shapes=(((4, 4), 131_072), ((16, 16), 16_384)),
                    n_check=64):
    """Raw grid VI (no validation) at the two shapes the TPU toolchain
    miscompiled, vs the same solve on slices at both ends of the batch."""
    out = {}
    for cells, n in shapes:
        levels = maze_levels(jax.random.PRNGKey(11), cells, n)
        solve = partial(value_iteration_batched_grid, validate=False)
        (v, policy, iters), t = first_and_steady(solve, sem, levels)
        ties = 0
        for lo in (0, n - n_check):
            part = Level(grid=levels.grid[lo:lo + n_check],
                         start_idx=levels.start_idx[lo:lo + n_check])
            v_ref, policy_ref, _ = solve(sem, part)
            ties += _vi_agree(
                sem, part, v[lo:lo + n_check], policy[lo:lo + n_check],
                v_ref, policy_ref, f"{2 * cells[0] + 1}x{2 * cells[1] + 1} "
                f"N={n} rows {lo}..{lo + n_check}",
            )
        out[f"{2 * cells[0] + 1}x{2 * cells[1] + 1}_N{n}"] = {
            **t, "iters": int(iters), "tied_policy_cells": ties,
        }
    out["check"] = (
        f"V within atol {VI_ATOL} rtol {VI_RTOL} of {n_check}-maze re-solves "
        "at both ends of each batch; policies equal but ties"
    )
    return out


def phase_qlearn_fast(sem, n_envs=65_536, n_steps=500, n_spread=50,
                      max_episode_steps=MAX_EPISODE_STEPS):
    """The one-hot-matmul tabular learner; one update step on the card vs
    the same step on the CPU device of this process."""
    bl = pack_level(walls_and_goal_16x16())
    fn = compile_q_learning_fast(
        sem, bl, n_envs, n_steps, max_episode_steps=max_episode_steps
    )
    res, t = first_and_steady(fn, jnp.uint32(0))
    check(np.all(np.isfinite(np.asarray(res.q))), "Q not finite")
    check(int(res.episodes) > 0, "no episode finished")

    # a fixed batch of n_envs transitions: learned Q, envs spread out
    ts = fast_td_init(sem, bl, jnp.uint32(1), n_envs, q0=res.q)
    ts = jax.device_get(
        compile_fast_td_run(sem, bl, n_spread,
                            max_episode_steps=max_episode_steps)(ts)
    )
    one_step = compile_fast_td_run(sem, bl, 1,
                                   max_episode_steps=max_episode_steps)
    card = one_step(on_device(ts, jax.devices()[0]))
    host = one_step(on_device(ts, jax.devices("cpu")[0]))
    for name in ("agent_idx", "agent_code", "t"):
        check(np.array_equal(np.asarray(getattr(card.env_state, name)),
                             np.asarray(getattr(host.env_state, name))),
              f"env state {name} differs between card and CPU")
    dq = float(np.max(np.abs(np.asarray(card.q) - np.asarray(host.q))))
    check(dq <= 1e-3, f"Q update differs by {dq:.3g} > 1e-3 (card vs CPU)")
    return {
        **t, "transitions": n_envs * n_steps, "episodes": int(res.episodes),
        "max_abs_q_diff_card_vs_cpu": dq,
        "check": f"one update on {n_envs} transitions: env state exact, "
                 "Q within atol 1e-3 of the CPU device",
    }


def _ppo_batch(num_states, n, seed=0):
    """A fixed synthetic minibatch (obs, actions, logp_old, v_old, adv,
    targets) for the loss comparison."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        rng.integers(0, num_states, n, dtype=np.int32),
        rng.integers(0, 4, n, dtype=np.int32),
        (np.log(0.25) + 0.1 * rng.standard_normal(n)).astype(f32),
        rng.standard_normal(n).astype(f32),
        rng.standard_normal(n).astype(f32),
        rng.standard_normal(n).astype(f32),
    )


def _loss_and_grad_norm(net, cfg, params, mb, device):
    fn = jax.jit(jax.value_and_grad(partial(ppo_loss, net, cfg), has_aux=True))
    (loss, _), grads = fn(on_device(params, device), on_device(mb, device))
    return float(loss), float(optax.global_norm(grads))


def phase_ppo(sem, n_envs=65_536, n_updates=5,
              max_episode_steps=MAX_EPISODE_STEPS):
    """PPO at its defaults (plus the time limit); one loss + gradient on the
    card vs the CPU."""
    level = walls_and_goal_16x16()
    cfg = PPOConfig(max_episode_steps=max_episode_steps)
    res, t = first_and_steady(
        ppo_train, sem, level, jax.random.PRNGKey(0), cfg,
        num_updates=n_updates, batch_size=n_envs,
    )
    check(np.isfinite(float(res.final_loss)), "PPO loss not finite")

    mb = _ppo_batch(
        level.num_states, cfg.rollout_len * n_envs // cfg.num_minibatches
    )
    card, cpu = jax.devices()[0], jax.devices("cpu")[0]
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    net32 = make_network(level, 4, cfg32)
    with jax.default_matmul_precision("highest"):
        l_card, g_card = _loss_and_grad_norm(net32, cfg32, res.params, mb, card)
        l_cpu, g_cpu = _loss_and_grad_norm(net32, cfg32, res.params, mb, cpu)
    rel_l = abs(l_card - l_cpu) / max(abs(l_cpu), 1e-30)
    rel_g = abs(g_card - g_cpu) / max(abs(g_cpu), 1e-30)
    check(rel_l <= 1e-4 and rel_g <= 1e-4,
          f"f32 PPO loss/grad-norm differ card vs CPU: rel {rel_l:.3g}, "
          f"{rel_g:.3g} > 1e-4")
    # the default bf16 path, reported without a gate
    net16 = make_network(level, 4, cfg)
    b_card = _loss_and_grad_norm(net16, cfg, res.params, mb, card)
    b_cpu = _loss_and_grad_norm(net16, cfg, res.params, mb, cpu)
    return {
        **t, "env_steps": n_updates * cfg.rollout_len * n_envs,
        "episodes": int(res.episodes), "final_loss": float(res.final_loss),
        "f32_loss_rel_diff": rel_l, "f32_grad_norm_rel_diff": rel_g,
        "bf16_loss_rel_diff": abs(b_card[0] - b_cpu[0]) / max(abs(b_cpu[0]), 1e-30),
        "bf16_grad_norm_rel_diff": abs(b_card[1] - b_cpu[1]) / max(abs(b_cpu[1]), 1e-30),
        "check": f"f32 loss and grad norm on {len(mb[0])} samples within "
                 "rtol 1e-4 of the CPU device (matmul precision highest)",
    }


def phase_ppo_mazes(sem, n_mazes=65_536, n_updates=3, cells=(4, 4),
                    max_episode_steps=48):
    """Conv PPO over distinct per-env mazes (grid observations). The time
    limit is the 9x9 generalization recipe's (GENERALIZATION.json), so the
    untrained policy's episodes end within the run."""
    levels = maze_levels(jax.random.PRNGKey(7), cells, n_mazes)
    cfg = PPOConfig(obs="grid", conv_channels=(32,), hidden=(64,),
                    rollout_len=16, max_episode_steps=max_episode_steps)
    res, t = first_and_steady(
        ppo_train, sem, levels, jax.random.PRNGKey(0), cfg,
        num_updates=n_updates, batch_size=n_mazes,
    )
    check(np.isfinite(float(res.final_loss)), "maze PPO loss not finite")
    check(int(res.episodes) > 0, "maze PPO finished no episode")
    return {
        **t, "env_steps": n_updates * cfg.rollout_len * n_mazes,
        "episodes": int(res.episodes), "final_loss": float(res.final_loss),
        "check": "finite loss, episodes > 0",
    }


def phase_dqn(sem, n_envs=65_536, n_steps=300, capacity=131_072,
              max_episode_steps=MAX_EPISODE_STEPS):
    """Prioritized DQN; its top-k sampler vs a host argsort."""
    level = walls_and_goal_16x16()
    cfg = DQNConfig(prioritized=True, buffer_capacity=capacity,
                    max_episode_steps=max_episode_steps)
    ts0 = dqn_init(sem, level, jax.random.PRNGKey(0), cfg, n_envs)
    ts, t = first_and_steady(dqn_run, sem, level, ts0, cfg, n_steps)
    res = dqn_result(ts)
    check(np.isfinite(float(res.final_loss)), "DQN loss not finite")
    check(int(res.episodes) > 0, "DQN finished no episode")

    size = jnp.minimum(ts.t * n_envs, capacity)
    key = jax.random.PRNGKey(5)
    k = cfg.batch_size_train
    idx, w = prioritized_sample(ts.prio, key, size, k, cfg.per_alpha,
                                jnp.float32(cfg.per_beta0))
    score = np.asarray(per_scores(ts.prio, key, size, cfg.per_alpha))
    ref = np.argsort(-score, kind="stable")[:k]
    check(np.array_equal(np.asarray(idx), ref),
          "prioritized_sample's top-k differs from the host argsort")
    check(np.all(np.isfinite(np.asarray(w))), "PER weights not finite")
    return {
        **t, "env_steps": n_envs * n_steps, "episodes": int(res.episodes),
        "final_loss": float(res.final_loss),
        "check": f"exact: top-{k} of {int(size)} Gumbel scores == host argsort",
    }


# ---------------------------------------------------------------------------
# Four-card phases: each sharded path beside what it is compared with
# ---------------------------------------------------------------------------


def phase_sharded(sem, n_devices=4, n_envs=65_536, q_steps=200,
                  n_mazes=65_536, ppo_updates=5, n_rollout_envs=65_536,
                  rollout_steps=2_000, max_episode_steps=MAX_EPISODE_STEPS):
    mesh = make_env_mesh(n_devices)
    check(mesh.size == n_devices, f"need {n_devices} devices, have {mesh.size}")
    level = walls_and_goal_16x16()
    out = {}

    # (a) parity-mode distributed Q-learning vs the one-device learner
    key = jax.random.PRNGKey(0)
    res_s, out["q_learning_sharded"] = first_and_steady(
        q_learning_sharded, mesh, sem, level, key, num_steps=q_steps,
        batch_size=n_envs, parity=True,
    )
    res_1 = q_learning(sem, level, key, num_steps=q_steps, batch_size=n_envs)
    check(np.array_equal(np.asarray(res_s.q), np.asarray(res_1.q))
          and int(res_s.episodes) == int(res_1.episodes),
          "q_learning_sharded(parity=True) != q_learning, bit for bit")

    # (b) maze-sharded grid VI vs the one-device grid VI
    levels = maze_levels(jax.random.PRNGKey(7), (4, 4), n_mazes)
    (v_s, p_s, _), out["vi_grid_sharded"] = first_and_steady(
        value_iteration_batched_grid_sharded, mesh, sem, levels
    )
    v_1, p_1, _ = value_iteration_batched_grid(sem, levels)
    dv = float(np.max(np.abs(np.asarray(v_s) - np.asarray(v_1))))
    check(dv <= 1e-6, f"sharded VI differs by {dv:.3g} > 1e-6")
    check(np.array_equal(np.asarray(p_s), np.asarray(p_1)),
          "sharded VI policy differs")

    # (c) data-parallel PPO: finite, and params identical on every device
    res_p, out["ppo_train_sharded"] = first_and_steady(
        ppo_train_sharded, mesh, sem, level, jax.random.PRNGKey(0),
        PPOConfig(max_episode_steps=max_episode_steps),
        num_updates=ppo_updates, batch_size=n_envs,
    )
    check(np.isfinite(float(res_p.final_loss)), "sharded PPO loss not finite")
    for leaf in jax.tree.leaves(res_p.params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        check(len(shards) == n_devices
              and all(np.array_equal(shards[0], s) for s in shards[1:]),
              "sharded PPO params differ between devices")

    # (d) sharded packed rollout
    fn = compile_rollout_random_sharded(
        mesh, sem, pack_level(level), n_rollout_envs, rollout_steps,
        max_episode_steps=max_episode_steps,
    )
    (_, stats), out["rollout_sharded"] = first_and_steady(fn, jnp.uint32(0))
    check(int(stats["episodes"]) > 0, "sharded rollout finished no episode")

    out["max_abs_v_diff"] = dv
    out["check"] = ("Q bit-exact vs one device; V within atol 1e-6 and "
                    "identical policies; PPO params replicated; episodes > 0")
    return out


ONE_CARD_PHASES = (
    ("step", phase_step),
    ("mazes", lambda sem: phase_mazes()),
    ("vi", phase_vi),
    ("vi_canary", phase_vi_canary),
    ("qlearn_fast", phase_qlearn_fast),
    ("ppo", phase_ppo),
    ("ppo_mazes", phase_ppo_mazes),
    ("dqn", phase_dqn),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on four cards")
    args = p.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    count = 4 if args.four_cards else 1
    if len(devices) < count:
        print(f"chip_smoke: needs {count} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    print(f"device_kind: {devices[0].device_kind}; jax {jax.__version__}",
          flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    sem = make_semantics()
    phases = (
        (("sharded", lambda sem: phase_sharded(sem, count)),)
        if args.four_cards else ONE_CARD_PHASES
    )
    for name, run in phases:
        result = run(sem)
        print(json.dumps({"phase": name, **result,
                          "peak_bytes_in_use": peak_bytes()}), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
