"""Recipe hunter for the flagship maze-generalization task: sweep PPO hyperparameters on N×N Aldous–Broder mazes and
print train/held-out/ablation per seed, so the committed artifact's
recipe is found by measurement rather than folklore.

The r5 baseline problem: at 9×9 the r4 recipe's failures are
OPTIMIZATION failures — seeds that plateau on the TRAINING mazes
(train 0.33 → held-out 0.25) — while every seed that trains ≥0.93
generalizes ≥0.85. So the hunt targets seed-robust optimization:
updates, γ (credit horizon), entropy, lr schedule, episode caps.

Run:  python tools/recipe_sweep.py --cells 4 --updates 4000 --seeds 1 2 3
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
    ppo_train,
)


def maze_levels(key, n, cells):
    grids, start = generate_mazes_device(key, cells, n, algorithm="aldous_broder")
    h, w = grids.shape[1], grids.shape[2]
    grids = grids.at[:, h - 2, w - 2].set(S.GOAL)
    return Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=4)
    ap.add_argument("--mazes", type=int, default=1024)
    ap.add_argument("--eval_mazes", type=int, default=256)
    ap.add_argument("--updates", type=int, default=2000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr_schedule", default="constant")
    ap.add_argument("--ent", type=float, default=0.03)
    ap.add_argument("--gamma", type=float, default=0.97)
    ap.add_argument("--mes", type=int, default=48, help="max_episode_steps")
    ap.add_argument("--budget", type=int, default=60, help="greedy budget")
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--ch", type=int, nargs="+", default=[32])
    ap.add_argument("--hidden", type=int, nargs="+", default=[64])
    args = ap.parse_args()

    sem = make_semantics()
    cells = (args.cells, args.cells)
    train_lv = maze_levels(jax.random.PRNGKey(0), args.mazes, cells)
    eval_lv = maze_levels(jax.random.PRNGKey(99), args.eval_mazes, cells)

    cfg = PPOConfig(
        rollout_len=args.rollout, max_episode_steps=args.mes, obs="grid",
        conv_channels=tuple(args.ch), hidden=tuple(args.hidden),
        num_epochs=4, num_minibatches=4,
        lr=args.lr, lr_schedule=args.lr_schedule,
        lr_decay_updates=args.updates,
        ent_coef=args.ent, gamma=args.gamma,
        compute_dtype="float32",
    )
    net = make_network(train_lv, 4, cfg)
    tag = (
        f"cells{args.cells} u{args.updates} lr{args.lr}/{args.lr_schedule} "
        f"ent{args.ent} g{args.gamma} mes{args.mes} ch{args.ch}"
    )
    print(f"== {tag}", flush=True)
    abl_lv = Level(grid=jnp.roll(eval_lv.grid, 1, axis=0),
                   start_idx=eval_lv.start_idx)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = ppo_train(sem, train_lv, jax.random.PRNGKey(seed), cfg,
                        num_updates=args.updates, batch_size=args.mazes)
        float(res.final_loss)  # fence
        wall = time.perf_counter() - t0
        tr = float(greedy_success_rate(sem, net, res.params, train_lv,
                                       args.budget))
        he = float(greedy_success_rate(sem, net, res.params, eval_lv,
                                       args.budget))
        ab = float(greedy_success_rate(sem, net, res.params, eval_lv,
                                       args.budget, tiles_levels=abl_lv))
        print(f"  seed {seed}: train {tr:.3f} heldout {he:.3f} "
              f"ablation {ab:.3f} ({wall:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
