"""Benchmark harness — work per second of every cell on one GPU.

Runs the BASELINE.json vectorization ladder (1 / 4k / 16k / 64k envs) of
random-action auto-reset rollouts through the bit-packed step engine
(ops/bitplane.py, level tables baked in as compile-time constants via
compile_rollout_random), the per-env procedural-maze rows, maze
generation, batched VI, the tabular learners, PPO/A2C/DQN training and the
maze-generalization gates. Progress goes to stderr; the last line of
stdout is ONE JSON object:

    {"metric": ..., "value": N, "unit": "env_steps_per_s", "vs_baseline": N,
     "details": {cell: rate}, "device": {...}, "card": "<name>, <power limit>"}

`value` is the 64k-env rollout rate. `vs_baseline` is value / 1e5 — the
reference (TheMTank/GridUniverse) publishes no numbers (BASELINE.md), so
the baseline is the documented order-of-magnitude estimate of its
pure-Python step loop (~1e5 steps/s on one CPU thread).

Timing: each cell is compiled and warmed by one call, then timed as the
median of three calls fenced with `jax.block_until_ready`. One attempt per
cell; a failure ends the run. No share of any hardware peak is reported
yet (ROADMAP Speed item 1 adds the peaks table and the trace reduction).
The script refuses to run without a GPU.

    python bench.py
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp

from griduniverse_tpu import make_semantics
from griduniverse_tpu.core import semantics as S
from griduniverse_tpu.core.types import Level
from griduniverse_tpu.levels.builders import (
    empty_level,
    lava_level,
    walls_and_goal_16x16,
)
from griduniverse_tpu.levels.maze import generate_mazes_device
from griduniverse_tpu.ops.bitplane import compile_rollout_random, pack_level
from griduniverse_tpu.utils.compile_cache import enable_compile_cache
from griduniverse_tpu.utils.profiling import gpu_name_and_power_limit, time_fn

REFERENCE_STEPS_PER_S = 1.0e5  # BASELINE.md: reference pure-Python estimate
MAX_EPISODE_STEPS = 512


def rate(fn, work: float) -> float:
    """work / median seconds of `fn()` (one warm-up call compiles)."""
    seconds, _ = time_fn(fn)
    return work / seconds


def report(details: dict, name: str, value: float, unit: str):
    details[name] = value
    print(f"{name}: {value:,.3f} {unit}", file=sys.stderr, flush=True)


def maze_levels(key, cells, n) -> Level:
    grids, start = generate_mazes_device(key, cells, n, algorithm="binary_tree")
    return Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))


def main():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX found {devices[0].platform!r}")
    card = gpu_name_and_power_limit()
    print(f"card: {card}", file=sys.stderr, flush=True)
    enable_compile_cache()
    sem = make_semantics()
    details = {}

    # BASELINE config 1 is "single env on CPU (reference parity)":
    #   cfg1a — the imperative compat.GridUniverseEnv.step() loop on the
    #           host (the path a reference user actually migrates to);
    #   cfg1b — a single env inside a device scan: the latency floor of
    #           the compiled path, NOT a reference-comparable number.
    from griduniverse_tpu.compat import GridUniverseEnv

    env = GridUniverseEnv(grid_shape=(8, 8), goal_states=[63], seed=0)
    env.reset()
    n_imp = 3_000
    t0 = time.perf_counter()
    for i in range(n_imp):
        _, _, d, _ = env.step(i & 3)
        if d:
            env.reset()
    report(details, "cfg1a_imperative_cpu_1env",
           n_imp / (time.perf_counter() - t0), "steps/s")

    def rollout_rate(bl, batch, steps):
        fn = compile_rollout_random(
            sem, bl, batch, steps, max_episode_steps=MAX_EPISODE_STEPS
        )
        return rate(lambda: fn(jnp.uint32(0)), steps * batch)

    for name, level, batch, steps in (
        ("cfg1b_scan_1env", empty_level(8, 8, goal=True), 1, 100_000),
        ("cfg2_16x16_walls_4k", walls_and_goal_16x16(), 4096, 100_000),
        ("cfg3_lava_16k", lava_level(), 16_384, 100_000),
        ("cfg4_64k", walls_and_goal_16x16(), 65_536, 100_000),
    ):
        report(details, name, rollout_rate(pack_level(level), batch, steps),
               "steps/s")

    # config 4 variant: per-env procedural 9x9 mazes generated on device
    b = 65_536
    mazes = maze_levels(jax.random.PRNGKey(7), (4, 4), b)
    report(details, "cfg4_mazes_64k",
           rollout_rate(jax.jit(pack_level)(mazes), b, 50_000), "steps/s")

    # the same engine on 33x33 mazes (S=1089, a 69-word packed level)
    b33 = 16_384
    mazes33 = maze_levels(jax.random.PRNGKey(7), (16, 16), b33)
    report(details, "cfg4_mazes33_16k",
           rollout_rate(jax.jit(pack_level)(mazes33), b33, 50_000), "steps/s")

    # grid-form batched VI at S=1089
    from griduniverse_tpu.algos import value_iteration_batched_grid

    b33v = 8_192
    vi33 = Level(
        grid=mazes33.grid[:b33v].at[:, 31, 31].set(S.GOAL),
        start_idx=mazes33.start_idx[:b33v],
    )
    report(details, "vi_mazes33_8k", rate(
        lambda: value_iteration_batched_grid(sem, vi33, max_iters=400), b33v
    ), "mazes/s")
    del mazes33, vi33

    # the matmul-form tabular Q-learner at 64k envs (transitions/s,
    # including env stepping, ε-greedy and the Q updates)
    from griduniverse_tpu.algos.td_fast import compile_q_learning_fast

    steps = 2_000
    qfn = compile_q_learning_fast(
        sem, pack_level(walls_and_goal_16x16()), b, steps,
        max_episode_steps=MAX_EPISODE_STEPS,
    )
    report(details, "qlearn_fast_64k",
           rate(lambda: qfn(jnp.uint32(0)), steps * b), "transitions/s")

    # exactly-uniform mass maze generation (Aldous-Broder)
    for name, n in (("mazegen_ab_64k", b), ("mazegen_ab_256k", 262_144)):
        report(details, name, rate(
            lambda n=n: generate_mazes_device(
                jax.random.PRNGKey(0), (4, 4), n, algorithm="aldous_broder"
            ),
            n,
        ), "mazes/s")

    # batched VI over 64k and 256k distinct on-device 9x9 mazes
    vi_levels = Level(grid=mazes.grid.at[:, 7, 7].set(S.GOAL),
                      start_idx=mazes.start_idx)
    report(details, "vi_mazes_64k", rate(
        lambda: value_iteration_batched_grid(sem, vi_levels), b
    ), "mazes/s")
    b_big = 262_144
    big = maze_levels(jax.random.PRNGKey(7), (4, 4), b_big)
    vi_big = Level(grid=big.grid.at[:, 7, 7].set(S.GOAL),
                   start_idx=big.start_idx)
    report(details, "vi_mazes_256k", rate(
        lambda: value_iteration_batched_grid(sem, vi_big), b_big
    ), "mazes/s")
    del big, vi_big

    # neural learners: full training env-steps/s — rollout + GAE/replay +
    # SGD all included
    from griduniverse_tpu.algos import q_learning_batched
    from griduniverse_tpu.models import (
        A2CConfig,
        DQNConfig,
        PPOConfig,
        a2c_train,
        dqn_train,
        greedy_success_rate,
        make_network,
        ppo_train,
    )

    level = walls_and_goal_16x16()
    ppo_cfg = PPOConfig(max_episode_steps=MAX_EPISODE_STEPS)
    updates = 40
    report(details, "ppo_64k", rate(
        lambda: ppo_train(sem, level, jax.random.PRNGKey(0), ppo_cfg,
                          num_updates=updates, batch_size=b),
        updates * ppo_cfg.rollout_len * b,
    ), "steps/s")

    # PPO with GRID observations across 64k DISTINCT on-device mazes
    maze_ppo_cfg = PPOConfig(
        rollout_len=16, max_episode_steps=MAX_EPISODE_STEPS,
        obs="grid", conv_channels=(32,), hidden=(64,),
    )
    updates = 10
    for name, cfg in (
        ("ppo_mazes_64k", maze_ppo_cfg),
        ("ppo_mazes16_64k",
         dataclasses.replace(maze_ppo_cfg, conv_channels=(16,))),
    ):
        report(details, name, rate(
            lambda cfg=cfg: ppo_train(sem, vi_levels, jax.random.PRNGKey(0),
                                      cfg, num_updates=updates, batch_size=b),
            updates * cfg.rollout_len * b,
        ), "steps/s")

    # 64k INDEPENDENT tabular agents, one Q-table per maze, f32 and bf16
    ql_steps = 2_000
    for name, dtype in (("qlearn_mazes_64k", "float32"),
                        ("qlearn_mazes_bf16_64k", "bfloat16")):
        report(details, name, rate(
            lambda dtype=dtype: q_learning_batched(
                sem, vi_levels, jax.random.PRNGKey(0), num_steps=ql_steps,
                max_episode_steps=MAX_EPISODE_STEPS, dtype=dtype,
            ),
            ql_steps * b,
        ), "transitions/s")

    # maze-generalization gates: one seed of the GENERALIZATION.json 7x7
    # and 9x9 recipes — held-out success on 256 unseen uniform mazes and
    # the wrong-tiles ablation (which must stay far below it)
    def gen_levels(key, n, cells):
        g, g_start = generate_mazes_device(
            key, (cells, cells), n, algorithm="aldous_broder"
        )
        h = g.shape[1]
        return Level(grid=g.at[:, h - 2, h - 2].set(S.GOAL),
                     start_idx=jnp.broadcast_to(g_start, (n,)))

    for row, cells, ch, gen_updates, ent, lr_schedule in (
        ("ppo_mazes_gen", 3, (32,), 1500, 0.03, "constant"),
        ("ppo_mazes9_gen", 4, (32, 32), 4000, 0.05, "linear"),
    ):
        gen_cfg = PPOConfig(
            rollout_len=16, max_episode_steps=48, obs="grid",
            conv_channels=ch, hidden=(64,), num_epochs=4,
            num_minibatches=4, lr=1e-3, lr_schedule=lr_schedule,
            lr_decay_updates=gen_updates, ent_coef=ent, gamma=0.97,
            compute_dtype="float32",
        )
        gen_train = gen_levels(jax.random.PRNGKey(0), 1024, cells)
        gen_eval = gen_levels(jax.random.PRNGKey(99), 256, cells)
        gen_net = make_network(gen_train, 4, gen_cfg)
        gen_res = ppo_train(sem, gen_train, jax.random.PRNGKey(1), gen_cfg,
                            num_updates=gen_updates, batch_size=1024)
        report(details, f"{row}_heldout", float(
            greedy_success_rate(sem, gen_net, gen_res.params, gen_eval)
        ), "success")
        report(details, f"{row}_ablation", float(greedy_success_rate(
            sem, gen_net, gen_res.params, gen_eval,
            tiles_levels=Level(grid=jnp.roll(gen_eval.grid, 1, axis=0),
                               start_idx=gen_eval.start_idx),
        )), "success")

    a2c_cfg = A2CConfig(max_episode_steps=MAX_EPISODE_STEPS)
    report(details, "a2c_64k", rate(
        lambda: a2c_train(sem, level, jax.random.PRNGKey(0), a2c_cfg,
                          num_updates=100, batch_size=b),
        100 * a2c_cfg.rollout_len * b,
    ), "steps/s")

    dqn_cfg = DQNConfig(buffer_capacity=2 * b,
                        max_episode_steps=MAX_EPISODE_STEPS)
    steps = 300
    report(details, "dqn_64k", rate(
        lambda: dqn_train(sem, level, jax.random.PRNGKey(0), dqn_cfg,
                          num_steps=steps, batch_size=b),
        steps * b,
    ), "steps/s")

    value = details["cfg4_64k"]
    print(json.dumps({
        "metric": "env_steps_per_s_64k_envs_single_chip",
        "value": value,
        "unit": "env_steps_per_s",
        "vs_baseline": value / REFERENCE_STEPS_PER_S,
        "details": details,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
        "card": card,
    }))


if __name__ == "__main__":
    main()
