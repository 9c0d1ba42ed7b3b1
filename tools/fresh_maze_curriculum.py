"""Fresh-maze curriculum probe for 11×11 generalization (r5).

At 11×11 the 9×9 recipe generalizes 0.66–0.77 with the first real
train→held-out GAP (train 0.87–0.94), i.e. the failure is DATA-bound —
1024 fixed training mazes no longer cover 11×11 maze space.

This probe keeps the batch shape and adds data with the framework's own chunked
training contract: train in chunks, REGENERATING the 1024-maze training
set from a fresh key every chunk and carrying params+opt_state across
chunks (PPOTrainState.replace — the same warm-start the sharded
trainers expose as init_params/init_opt_state). Every chunk is the
same 1024×11×11 shape, but the agent sees chunks×1024 DISTINCT mazes
over the run — unbounded maze diversity at bounded memory (regeneration
is a few ms on device) rather than a bigger-batch fix.

Run: python tools/fresh_maze_curriculum.py --cells 5 --chunks 8
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from griduniverse_tpu import make_semantics
from griduniverse_tpu.core import semantics as S
from griduniverse_tpu.core.types import Level
from griduniverse_tpu.levels.maze import generate_mazes_device
from griduniverse_tpu.models import (
    PPOConfig,
    greedy_success_rate,
    make_network,
    ppo_init,
    ppo_run,
)


def maze_levels(key, n, cells):
    grids, start = generate_mazes_device(
        key, cells, n, algorithm="aldous_broder"
    )
    h, w = grids.shape[1], grids.shape[2]
    grids = grids.at[:, h - 2, w - 2].set(S.GOAL)
    return Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=5)
    ap.add_argument("--mazes", type=int, default=1024)
    ap.add_argument("--eval_mazes", type=int, default=256)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--updates_per_chunk", type=int, default=500)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--ent", type=float, default=0.05)
    ap.add_argument("--budget", type=int, default=60)
    args = ap.parse_args()

    sem = make_semantics()
    cells = (args.cells, args.cells)
    total_updates = args.chunks * args.updates_per_chunk
    eval_lv = maze_levels(jax.random.PRNGKey(99), args.eval_mazes, cells)
    abl_lv = Level(
        grid=jnp.roll(eval_lv.grid, 1, axis=0), start_idx=eval_lv.start_idx
    )

    cfg = PPOConfig(
        rollout_len=16, max_episode_steps=48, obs="grid",
        conv_channels=(32, 32), hidden=(64,),
        num_epochs=4, num_minibatches=4,
        lr=1e-3, lr_schedule="linear", lr_decay_updates=total_updates,
        ent_coef=args.ent, gamma=0.97, compute_dtype="float32",
    )
    print(
        f"== {2*args.cells+1}x{2*args.cells+1} fresh-maze curriculum: "
        f"{args.chunks} chunks x {args.updates_per_chunk} updates, "
        f"{args.chunks * args.mazes} distinct training mazes total",
        flush=True,
    )
    for seed in args.seeds:
        t0 = time.perf_counter()
        params = opt_state = None
        for chunk in range(args.chunks):
            # fresh mazes every chunk — same shape, new data
            lv = maze_levels(
                jax.random.fold_in(jax.random.PRNGKey(seed), chunk),
                args.mazes, cells,
            )
            ts = ppo_init(
                sem, lv, jax.random.fold_in(jax.random.PRNGKey(1000 + seed),
                                            chunk),
                cfg, batch_size=args.mazes,
            )
            if params is not None:
                # warm start: carry params AND Adam state (incl. the
                # schedule's step count) across the level swap
                ts = ts.replace(params=params, opt_state=opt_state)
            ts = ppo_run(sem, lv, ts, cfg, args.updates_per_chunk)
            params, opt_state = ts.params, ts.opt_state
        float(ts.last_loss)  # fence
        wall = time.perf_counter() - t0
        net = make_network(eval_lv, 4, cfg)
        tr = float(
            greedy_success_rate(sem, net, params, lv, args.budget)
        )
        he = float(
            greedy_success_rate(sem, net, params, eval_lv, args.budget)
        )
        ab = float(
            greedy_success_rate(
                sem, net, params, eval_lv, args.budget, tiles_levels=abl_lv
            )
        )
        print(
            f"  seed {seed}: last-chunk-train {tr:.3f} heldout {he:.3f} "
            f"ablation {ab:.3f} ({wall:.0f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
