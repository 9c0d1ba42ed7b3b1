"""Example 6 — the bit-packed fast engine end to end: compiled random
rollout throughput, the matmul-form Q-learning trainer, and an animated-GIF
replay of the learned greedy policy (the headless 'graphic' render).

    python examples/06_fast_engine.py                    # CPU
    python examples/06_fast_engine.py --platform gpu     # on a card
"""

import time

import numpy as np

from _common import parse_args


def main():
    args = parse_args(
        "Bit-packed fast engine demo",
        envs=(int, 4096, "parallel envs"),
        steps=(int, 20_000, "rollout scan length"),
        train_steps=(int, 3000, "Q-learning training steps"),
        gif=(str, "", "optional path to write the greedy-episode GIF"),
    )
    import jax
    import jax.numpy as jnp

    import griduniverse_tpu as gu
    from griduniverse_tpu.algos.td_fast import compile_q_learning_fast
    from griduniverse_tpu.algos.utils import greedy_policy_from_q, run_greedy_episode
    from griduniverse_tpu.levels.builders import lava_level
    from griduniverse_tpu.ops.bitplane import compile_rollout_random, pack_level

    sem = gu.make_semantics()
    level = lava_level()
    bl = pack_level(level)

    # 1) compiled random-rollout throughput (fetch-fenced timing)
    fn = compile_rollout_random(
        sem, bl, args.envs, args.steps, max_episode_steps=200
    )
    _, stats = fn(jnp.uint32(0))
    float(stats["episodes"])  # warmup + sync
    t0 = time.perf_counter()
    _, stats = fn(jnp.uint32(1))
    eps = float(stats["episodes"])
    dt = time.perf_counter() - t0
    print(
        f"rollout: {args.envs * args.steps / dt:,.0f} env-steps/s "
        f"({eps:,.0f} episodes, mean return {float(stats['mean_return']):.1f})"
    )

    # 2) matmul-form Q-learning to the optimal policy
    train = compile_q_learning_fast(
        sem, bl, batch_size=256, num_steps=args.train_steps,
        alpha=0.2, epsilon=0.2, max_episode_steps=100,
    )
    t0 = time.perf_counter()
    res = train(jnp.uint32(0))
    n = int(res.episodes)
    dt = time.perf_counter() - t0
    print(
        f"q-learning: {256 * args.train_steps / dt:,.0f} transitions/s, "
        f"{n:,} episodes, mean return {float(res.mean_return):.1f}"
    )

    # 3) greedy replay (+ optional GIF — the headless 'graphic' mode)
    policy = greedy_policy_from_q(res.q)
    obs, total, length, reached = run_greedy_episode(
        sem, level, policy, jax.random.PRNGKey(0), max_steps=50
    )
    print(
        f"greedy episode: return {float(total):.1f} in {int(length)} steps "
        f"(reached terminal: {bool(reached)})"
    )
    if args.gif:
        from griduniverse_tpu.compat.rendering import episode_gif

        episode_gif(
            np.asarray(level.grid),
            np.asarray(obs)[: int(length) + 1],
            args.gif,
            start_idx=int(level.start_idx),
        )
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
