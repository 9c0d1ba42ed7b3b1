"""Example 7 — PPO: GAE + clipped surrogate, one jitted scan.

The whole training run (rollouts through the bit-packed env step, GAE,
epochs x minibatches of clipped-surrogate SGD) is a single XLA program;
pass --sharded to run it data-parallel over every visible device
(envs sharded, params replicated, grads pmean'd per minibatch step).

    python examples/07_ppo.py --updates 200 --envs 128
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/07_ppo.py --sharded
"""

from _common import parse_args


def main():
    args = parse_args(
        "PPO training",
        updates=(int, 200, "PPO updates"),
        envs=(int, 128, "parallel envs"),
        sharded=(int, 0, "1 = shard envs over all visible devices"),
    )
    import time

    import jax

    import griduniverse_tpu as gu
    from griduniverse_tpu.algos.utils import policy_arrows
    from griduniverse_tpu.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu.models import (
        PPOConfig,
        greedy_actions,
        make_network,
        ppo_train,
        ppo_train_sharded,
    )

    sem = gu.make_semantics()
    level = walls_and_goal_16x16()
    cfg = PPOConfig(
        rollout_len=16, lr=1e-3, num_epochs=2, num_minibatches=4,
        max_episode_steps=128,
    )

    t0 = time.perf_counter()
    if args.sharded:
        from griduniverse_tpu.parallel import make_env_mesh

        mesh = make_env_mesh()
        print(f"mesh: {mesh.shape}")
        res = ppo_train_sharded(
            mesh, sem, level, jax.random.PRNGKey(0), cfg,
            num_updates=args.updates, batch_size=args.envs,
        )
    else:
        res = ppo_train(
            sem, level, jax.random.PRNGKey(0), cfg,
            num_updates=args.updates, batch_size=args.envs,
        )
    jax.block_until_ready(res.params)
    dt = time.perf_counter() - t0
    total = args.updates * cfg.rollout_len * args.envs
    print(
        f"{args.updates} updates / {total:,} env transitions in {dt:.1f}s "
        f"(incl. compile)"
    )
    print(f"episodes: {int(res.episodes):,}  mean return: {float(res.mean_return):.2f}")

    # greedy policy over all states, rendered as arrows
    import jax.numpy as jnp

    net = make_network(level, 4, cfg)
    all_states = jnp.arange(level.num_states, dtype=jnp.int32)
    policy = greedy_actions(net, res.params, all_states)
    print("\ngreedy policy:")
    print(policy_arrows(policy, level))


if __name__ == "__main__":
    main()
