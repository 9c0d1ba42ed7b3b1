"""Flagship generalization FRONTIER as a reproducible artifact: one conv-trunk PPO agent trained across distinct on-device
mazes, measured at four points — 7×7 at the throughput-bench channel
widths (ch32 and ch16), 9×9, and an 11×11 fresh-maze curriculum — each
with the wrong-tiles ablation control on five seeds and a 256-maze
held-out set (4× finer than the r4 artifact's 1/64 resolution), written
to GENERALIZATION.json.

Recipes (r5, found by tools/recipe_sweep.py measurement on the chip):

* 7×7 (ch32 and ch16): the r4 recipe unchanged — Aldous–Broder mazes
  (exactly uniform — no binary-tree motion prior to exploit), rollout
  16, γ0.97, max_episode_steps 48, lr 1e-3 constant, ent 0.03,
  hidden (64,), 1500 updates at B=1024, 60-step greedy budget. ch16 is
  the 2.4×-throughput config from bench row `ppo_mazes16_64k`; r5
  closes the "does the fast config still read mazes?" gap: yes —
  held-out 0.93–1.00 across five seeds, ablation 0.13.
* 9×9: the r4 prose result (held-out 0.62–0.80, wide seed spread) is
  superseded by an r5 recipe hunt against the three WORST r4 seeds:
  failures were optimization plateaus (train 0.33 → held-out 0.25, yet
  every seed that trains ≥0.93 generalizes ≥0.85), so the hunt targeted
  seed-robust optimization. Winning levers, each measured against the
  stress seeds: linear lr decay to 0
  (0.65/0.63/0.25 → 0.87/0.88/0.73), a second conv layer (receptive
  field 5×5; seeds 2/3 → 0.98), ent 0.05 (rescues the plateau seed:
  0.72 → 0.92). Final: ch(32,32), ent 0.05, lr 1e-3 linearly decayed
  over 4000 updates — held-out 0.918–0.992 across SEVEN seeds,
  ablation ≤ 0.03 (at 9×9 no motion prior solves any measurable
  fraction, so held-out success is pure maze-reading).

Run: python tools/gen_artifact.py                  (on a card; the 11×11
                                                    curriculum is the
                                                    longest config)
     python tools/gen_artifact.py --configs 9x9_ch32x2    (one config)
     python tools/gen_artifact.py --updates 50 --mazes 128 \
         --configs 7x7_ch32                               (smoke)
"""

from __future__ import annotations

import argparse
import json
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

# The frontier: name -> (cells, conv_channels, updates, ent, lr_schedule).
# 7×7 rows keep the r4 recipe; the 9×9 row is the r5 hunt's winner; the
# 11×11 row is the r5 fresh-maze CURRICULUM (fresh_maze_chunks):
# 11×11 is DATA-bound under a fixed 1024-maze set (train 0.87–0.94 vs
# held-out 0.66–0.77 — the r5 probe's gap), so the curriculum
# regenerates the 1024-maze training set from a fresh key every
# 500-update chunk (each chunk the same shape; params+opt_state carried
# across chunks) — 32×1024 distinct
# mazes over the run for held-out 0.902-0.934 across five seeds
# (tools/fresh_maze_curriculum.py is the standalone probe).
CONFIGS = {
    "7x7_ch32": dict(cells=3, ch=(32,), updates=1500, ent=0.03,
                     lr_schedule="constant", budget=60),
    "7x7_ch16": dict(cells=3, ch=(16,), updates=1500, ent=0.03,
                     lr_schedule="constant", budget=60),
    "9x9_ch32x2": dict(cells=4, ch=(32, 32), updates=4000, ent=0.05,
                       lr_schedule="linear", budget=60),
    "11x11_curriculum": dict(cells=5, ch=(32, 32), updates=500, ent=0.05,
                             lr_schedule="linear", budget=60,
                             fresh_maze_chunks=32),
}


def maze_levels(key, n, cells):
    grids, start = generate_mazes_device(
        key, cells, n, algorithm="aldous_broder"
    )
    h, w = grids.shape[1], grids.shape[2]
    grids = grids.at[:, h - 2, w - 2].set(S.GOAL)
    return Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))


def rolled_tiles_level(levels: Level) -> Level:
    """The wrong-tiles ablation: env b keeps ITS maze dynamics but the
    network sees maze b+1's planes (the `tiles_levels` argument of
    models.evaluation.greedy_success_rate)."""
    return Level(
        grid=jnp.roll(levels.grid, 1, axis=0), start_idx=levels.start_idx
    )


def _curriculum_train(sem, cfg, seed, chunks, updates_per_chunk, mazes,
                      cells):
    """Fresh-maze curriculum: regenerate the training set every chunk,
    carry params+opt_state (incl. the lr schedule's Adam count) across
    the level swap. Returns (params, last_train_level)."""
    from griduniverse_tpu.models import ppo_init, ppo_run

    params = opt_state = lv = None
    for chunk in range(chunks):
        lv = maze_levels(
            jax.random.fold_in(jax.random.PRNGKey(seed), chunk),
            mazes, cells,
        )
        ts = ppo_init(
            sem, lv,
            jax.random.fold_in(jax.random.PRNGKey(1000 + seed), chunk),
            cfg, batch_size=mazes,
        )
        if params is not None:
            ts = ts.replace(params=params, opt_state=opt_state)
        ts = ppo_run(sem, lv, ts, cfg, updates_per_chunk)
        params, opt_state = ts.params, ts.opt_state
    jax.block_until_ready(ts.last_loss)
    return params, lv


def run_config(name, spec, mazes, eval_mazes, seeds, updates_override=None):
    sem = make_semantics()
    cells = (spec["cells"], spec["cells"])
    updates = updates_override or spec["updates"]
    chunks = spec.get("fresh_maze_chunks")
    train_lv = maze_levels(jax.random.PRNGKey(0), mazes, cells)
    eval_lv = maze_levels(jax.random.PRNGKey(99), eval_mazes, cells)
    abl_lv = rolled_tiles_level(eval_lv)

    cfg = PPOConfig(
        rollout_len=16, max_episode_steps=48, obs="grid",
        conv_channels=spec["ch"], hidden=(64,),
        num_epochs=4, num_minibatches=4,
        lr=1e-3, lr_schedule=spec["lr_schedule"],
        lr_decay_updates=updates * (chunks or 1),
        ent_coef=spec["ent"], gamma=0.97,
        compute_dtype="float32",
    )
    net = make_network(train_lv, 4, cfg)
    budget = spec["budget"]

    runs = []
    for seed in seeds:
        t0 = time.perf_counter()
        if chunks:
            params, last_lv = _curriculum_train(
                sem, cfg, seed, chunks, updates, mazes, cells
            )
            train_eval_lv = last_lv  # train score = last chunk's mazes
        else:
            res = ppo_train(
                sem, train_lv, jax.random.PRNGKey(seed), cfg,
                num_updates=updates, batch_size=mazes,
            )
            jax.block_until_ready(res.final_loss)
            params = res.params
            train_eval_lv = train_lv
        wall = time.perf_counter() - t0
        train_s = float(
            greedy_success_rate(sem, net, params, train_eval_lv, budget)
        )
        held_s = float(
            greedy_success_rate(sem, net, params, eval_lv, budget)
        )
        abl_s = float(
            greedy_success_rate(
                sem, net, params, eval_lv, budget, tiles_levels=abl_lv
            )
        )
        runs.append(
            {
                "seed": seed,
                "train_success": round(train_s, 4),
                "heldout_success": round(held_s, 4),
                "wrong_tiles_ablation": round(abl_s, 4),
                "train_wall_s": round(wall, 1),
            }
        )
        print(
            f"{name} seed {seed}: train {train_s:.3f} held-out {held_s:.3f} "
            f"ablation {abl_s:.3f} ({wall:.0f}s)",
            flush=True,
        )

    grid = 2 * spec["cells"] + 1
    return {
        "name": name,
        "recipe": {
            "mazes": mazes, "eval_mazes": eval_mazes,
            "grid": f"{grid}x{grid}",
            "algorithm": "aldous_broder", "updates": updates,
            "rollout_len": cfg.rollout_len,
            "max_episode_steps": cfg.max_episode_steps,
            "gamma": cfg.gamma, "lr": cfg.lr,
            "lr_schedule": cfg.lr_schedule, "ent_coef": cfg.ent_coef,
            "conv_channels": list(cfg.conv_channels),
            "hidden": list(cfg.hidden),
            "greedy_budget_steps": budget,
            **(
                {"fresh_maze_chunks": chunks,
                 "updates_total": updates * chunks}
                if chunks else {}
            ),
        },
        "runs": runs,
        "heldout_min": min(r["heldout_success"] for r in runs),
        "ablation_max": max(r["wrong_tiles_ablation"] for r in runs),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mazes", type=int, default=1024)
    ap.add_argument("--eval_mazes", type=int, default=256)
    ap.add_argument("--updates", type=int, default=None,
                    help="override per-config updates (smoke runs)")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1, 2, 3, 4, 5])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS),
                    choices=list(CONFIGS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    artifact = {
        "metric": "ppo_mazes_generalization_frontier",
        "device": str(jax.devices()[0]),
        "configs": [
            run_config(
                name, CONFIGS[name], args.mazes, args.eval_mazes,
                args.seeds, args.updates,
            )
            for name in args.configs
        ],
    }
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "GENERALIZATION.json",
    )
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
