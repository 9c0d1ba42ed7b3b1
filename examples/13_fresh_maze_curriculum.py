"""Unbounded maze diversity at bounded memory: the fresh-maze curriculum.

When the generalization frontier becomes DATA-bound — any fixed training
set of N mazes trains well but generalizes poorly because N mazes no
longer cover the maze space (first seen at 11×11) — the fix is not a bigger batch. It is the framework's own
chunked-training contract: train in chunks, REGENERATING the training
set from a fresh key every chunk, and carry params + optimizer state
(including the lr schedule's Adam step count) across the level swap via
`PPOTrainState.replace`. Every chunk keeps the same compiled shapes, but
the agent sees `chunks × mazes` DISTINCT mazes over the run —
regeneration is a few milliseconds on device, so diversity is free.

This composes three public APIs the earlier examples introduced
separately: on-device maze generation (example 04), per-env-level
conv-trunk PPO (example 11), and warm-started chunked training
(example 12's resume contract, used here to swap DATA instead of to
survive a crash).

Run (defaults are CPU-sized; the second line is the committed 11×11
GENERALIZATION.json recipe — held-out 0.90–0.93 across five seeds):
    python examples/13_fresh_maze_curriculum.py
    python examples/13_fresh_maze_curriculum.py --platform gpu \
        --cells 5 --mazes 1024 --eval_mazes 256 --chunks 32 \
        --updates_per_chunk 500 --channels 32 --hidden 64
"""

from __future__ import annotations

import time

from _common import parse_args


def main():
    args = parse_args(
        "PPO trained on a fresh batch of on-device mazes every chunk",
        cells=(int, 3, "maze cells per side (grid is 2*cells+1 square)"),
        mazes=(int, 256, "training mazes per chunk (= env batch)"),
        eval_mazes=(int, 64, "held-out mazes for the generalization check"),
        chunks=(int, 3, "training chunks; each sees a fresh maze set"),
        updates_per_chunk=(int, 60, "PPO updates per chunk"),
        channels=(int, 16, "conv trunk width (one layer per value given)"),
        hidden=(int, 32, "dense trunk width"),
        seed=(int, 1, "seed for maze regeneration and training"),
    )
    import jax
    import jax.numpy as jnp

    import griduniverse_tpu as gu
    from griduniverse_tpu.core import semantics as S
    from griduniverse_tpu.core.types import Level
    from griduniverse_tpu.levels.maze import generate_mazes_device
    from griduniverse_tpu.models import (
        PPOConfig, greedy_success_rate, make_network, ppo_init, ppo_run,
    )

    sem = gu.make_semantics()
    cells = (args.cells, args.cells)
    side = 2 * args.cells + 1
    total_updates = args.chunks * args.updates_per_chunk

    def maze_levels(key, n):
        grids, start = generate_mazes_device(
            key, cells, n, algorithm="aldous_broder"
        )
        h, w = grids.shape[1], grids.shape[2]
        grids = grids.at[:, h - 2, w - 2].set(S.GOAL)
        return Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))

    eval_lv = maze_levels(jax.random.PRNGKey(99), args.eval_mazes)
    # ablation control: same agent, WRONG tile planes — success here is
    # motion prior, not maze reading
    abl_lv = Level(
        grid=jnp.roll(eval_lv.grid, 1, axis=0), start_idx=eval_lv.start_idx
    )

    # conv_channels=(c, c) for cells >= 4: at 9x9+ a second layer widens
    # the receptive field to 5x5 (the r5 recipe hunt's decisive lever)
    ch = (args.channels,) * (2 if args.cells >= 4 else 1)
    cfg = PPOConfig(
        rollout_len=16, max_episode_steps=48, obs="grid",
        conv_channels=ch, hidden=(args.hidden,),
        num_epochs=4, num_minibatches=4,
        lr=1e-3, lr_schedule="linear", lr_decay_updates=total_updates,
        ent_coef=0.05 if args.cells >= 4 else 0.03, gamma=0.97,
        compute_dtype="float32",
    )
    print(
        f"{side}x{side} fresh-maze curriculum: {args.chunks} chunks x "
        f"{args.updates_per_chunk} updates, "
        f"{args.chunks * args.mazes} distinct training mazes total"
    )

    t0 = time.perf_counter()
    params = opt_state = None
    lv = None
    for chunk in range(args.chunks):
        # fresh mazes every chunk — same compiled shape, new data
        lv = maze_levels(
            jax.random.fold_in(jax.random.PRNGKey(args.seed), chunk),
            args.mazes,
        )
        ts = ppo_init(
            sem, lv,
            jax.random.fold_in(jax.random.PRNGKey(1000 + args.seed), chunk),
            cfg, batch_size=args.mazes,
        )
        if params is not None:
            # warm start: params AND Adam state (incl. the schedule's
            # step count) survive the level swap
            ts = ts.replace(params=params, opt_state=opt_state)
        ts = ppo_run(sem, lv, ts, cfg, args.updates_per_chunk)
        params, opt_state = ts.params, ts.opt_state
    float(ts.last_loss)  # fence device work before timing
    print(
        f"trained {total_updates} updates in "
        f"{time.perf_counter() - t0:.1f}s ({int(ts.episodes)} episodes "
        f"in the last chunk)"
    )

    net = make_network(eval_lv, 4, cfg)
    budget = 60 if args.cells <= 4 else 100
    tr = float(greedy_success_rate(sem, net, params, lv, budget))
    he = float(greedy_success_rate(sem, net, params, eval_lv, budget))
    ab = float(
        greedy_success_rate(
            sem, net, params, eval_lv, budget, tiles_levels=abl_lv
        )
    )
    print(f"last-chunk train success:     {tr:.3f}")
    print(f"HELD-OUT success:             {he:.3f}")
    print(f"wrong-tiles ablation control: {ab:.3f}  (motion prior only)")


if __name__ == "__main__":
    main()
