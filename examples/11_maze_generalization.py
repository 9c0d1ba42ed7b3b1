"""One agent, thousands of mazes: per-env-level PPO with grid observations.

The flagship composition (BASELINE configs 4 + 5):
generate N DISTINCT perfect mazes ON DEVICE, train one conv-trunk PPO agent
across all of them simultaneously (each env lives in its own maze — the
level tiles enter the network as per-sample planes), then evaluate the
greedy policy on HELD-OUT mazes it never trained on.

Also shows the solver side of the same composition: batched value
iteration solves every training maze at once, giving the optimal success
ceiling for comparison.

Run (defaults are CPU-sized; scale up on a card — the GENERALIZATION.json
flagship setting is the second line):
    python examples/11_maze_generalization.py
    python examples/11_maze_generalization.py --platform gpu \
        --mazes 1024 --updates 1500 --channels 32 --hidden 64
"""

from __future__ import annotations

import time

from _common import parse_args


def main():
    args = parse_args(
        "PPO generalization across distinct on-device mazes",
        mazes=(int, 1024, "number of training mazes (= env batch)"),
        eval_mazes=(int, 64, "held-out mazes for the generalization check"),
        cells=(int, 3, "maze cells per side (grid is 2*cells+1 square)"),
        updates=(int, 200, "PPO updates"),
        channels=(int, 16, "conv trunk width"),
        hidden=(int, 32, "dense trunk width"),
    )
    import jax
    import jax.numpy as jnp

    import griduniverse_tpu as gu
    from griduniverse_tpu.algos import build_model_tables, value_iteration_batched
    from griduniverse_tpu.core import semantics as S
    from griduniverse_tpu.core.types import Level
    from griduniverse_tpu.levels.maze import generate_mazes_device
    from griduniverse_tpu.models import (
        PPOConfig, greedy_success_rate, greedy_success_rate_tabular,
        init_network_params, make_network, ppo_train,
    )

    sem = gu.make_semantics()
    cells = (args.cells, args.cells)

    def maze_levels(key, n):
        grids, start = generate_mazes_device(
            key, cells, n, algorithm="aldous_broder"
        )
        h, w = grids.shape[1], grids.shape[2]
        grids = grids.at[:, h - 2, w - 2].set(S.GOAL)
        return Level(grid=grids, start_idx=jnp.broadcast_to(start, (n,)))

    t0 = time.perf_counter()
    train_lv = maze_levels(jax.random.PRNGKey(0), args.mazes)
    eval_lv = maze_levels(jax.random.PRNGKey(99), args.eval_mazes)
    print(
        f"generated {args.mazes}+{args.eval_mazes} uniform mazes on device "
        f"in {time.perf_counter() - t0:.1f}s"
    )

    # the optimal ceiling: solve EVERY training maze at once (batched VI),
    # then roll the optimal tabular policies on the same engine + success
    # metric the PPO agent is scored with
    t0 = time.perf_counter()
    models = build_model_tables(sem, train_lv)
    _, pi_star, iters = value_iteration_batched(models)
    ceiling = float(greedy_success_rate_tabular(sem, train_lv, pi_star))
    print(
        f"batched VI solved all {args.mazes} mazes in "
        f"{time.perf_counter() - t0:.1f}s ({int(iters)} sweeps); "
        f"optimal-policy success ceiling {ceiling:.2f}"
    )

    # the GENERALIZATION.json 7x7 recipe (r5 artifact: held-out
    # 0.92-0.97 across three seeds at 256 eval mazes, --mazes 1024
    # --updates 1500 --channels 32 --hidden 64; the committed frontier
    # also carries a ch16 row and a 9x9 row -- tools/gen_artifact.py)
    cfg = PPOConfig(
        rollout_len=16, max_episode_steps=48, obs="grid",
        conv_channels=(args.channels,), hidden=(args.hidden,),
        num_epochs=4, num_minibatches=4, lr=1e-3, ent_coef=0.03, gamma=0.97,
        compute_dtype="float32",
    )
    net = make_network(train_lv, 4, cfg)

    def greedy_success(params, levels, max_steps=60):
        return float(greedy_success_rate(sem, net, params, levels, max_steps))

    p0 = init_network_params(net, jax.random.PRNGKey(7))
    print(f"untrained held-out success: {greedy_success(p0, eval_lv):.2f}")

    t0 = time.perf_counter()
    res = ppo_train(
        sem, train_lv, jax.random.PRNGKey(1), cfg,
        num_updates=args.updates, batch_size=args.mazes,
    )
    print(
        f"trained {args.updates} updates x {args.mazes} mazes in "
        f"{time.perf_counter() - t0:.1f}s ({int(res.episodes)} episodes)"
    )
    print(
        f"train-maze greedy success:    "
        f"{greedy_success(res.params, train_lv):.2f} "
        f"vs optimal ceiling {ceiling:.2f}"
    )
    print(f"HELD-OUT-maze greedy success: {greedy_success(res.params, eval_lv):.2f}")


if __name__ == "__main__":
    main()
