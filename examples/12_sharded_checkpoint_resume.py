"""Example 12 — long-run DISTRIBUTED training with checkpoint/resume.

The r4 resumable sharded path end to end: `ppo_init_sharded` builds the
full TrainState laid out over the mesh (params/Adam replicated, envs and
per-shard stats sharded), `ppo_run_sharded` advances it in chunks, and a
`CheckpointManager` persists every chunk — kill the script at ANY point
and rerun it: it restores the latest checkpoint and continues from the
last COMPLETED chunk (counter-based RNG makes the chunked run bit-equal
to an unbroken one; tests/test_sharded_resume.py pins it). Resume
granularity is the chunk: a kill mid-chunk replays that chunk, so pick
`updates_per_chunk` as your acceptable replay window — each chunk pays
one dispatch and one save, so chunks worth a few hundred ms of compute
amortize that to noise. Saves run in the
BACKGROUND (`async_=True`): the training loop only pays the
host-snapshot cost at the chunk boundary while the serialize+fsync
overlaps the next chunk, which makes small chunks cheap.

    python examples/12_sharded_checkpoint_resume.py
    # ... ctrl-C mid-run, then run the same command again: it resumes

On a multi-host slice the same code runs per host after
`jax.distributed.initialize()`; `parallel.distributed.fetch_global` is
the all-gather helper for writing checkpoints from one process
(tests/test_distributed_multiprocess.py drills the SIGKILL story).
"""

from __future__ import annotations

import time

from _common import parse_args


def main():
    args = parse_args(
        "Chunked, checkpointed, sharded PPO training",
        envs=(int, 512, "total env batch (sharded over the mesh)"),
        chunks=(int, 5, "number of training chunks"),
        updates_per_chunk=(int, 20, "PPO updates per chunk"),
        ckpt_dir=(str, "/tmp/griduniverse_ckpt_example", "checkpoint dir"),
        fresh=(int, 0, "1 = wipe the checkpoint dir first (no resume)"),
    )
    if args.fresh:
        import shutil

        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    import jax

    import griduniverse_tpu as gu
    from griduniverse_tpu.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu.models import (
        PPOConfig,
        ppo_init_sharded,
        ppo_result,
        ppo_run_sharded,
    )
    from griduniverse_tpu.parallel import make_env_mesh
    from griduniverse_tpu.utils.checkpoint import CheckpointManager

    sem = gu.make_semantics()
    level = walls_and_goal_16x16()
    mesh = make_env_mesh()
    cfg = PPOConfig(
        rollout_len=8, num_epochs=2, num_minibatches=2,
        hidden=(32,), embed_dim=8, max_episode_steps=64,
        compute_dtype="float32",
    )

    # the template also defines the restored state's sharded layout
    ts0 = ppo_init_sharded(
        mesh, sem, level, jax.random.PRNGKey(0), cfg, batch_size=args.envs
    )
    with CheckpointManager(
        args.ckpt_dir, max_to_keep=2, async_=True
    ) as mgr:
        start_update, ts = mgr.restore_latest(ts0)
        if start_update:
            print(f"resumed from checkpoint at update {start_update}")

        while int(ts.update) < args.chunks * args.updates_per_chunk:
            t0 = time.perf_counter()
            ts = ppo_run_sharded(
                mesh, sem, level, ts, cfg,
                num_updates=args.updates_per_chunk,
            )
            res = ppo_result(ts)
            t_save = time.perf_counter()
            mgr.save(int(ts.update), ts)  # background write
            t_save = time.perf_counter() - t_save
            print(
                f"update {int(ts.update):4d}: episodes "
                f"{int(res.episodes):6d} "
                f"mean_return {float(res.mean_return):7.2f} "
                f"({time.perf_counter() - t0:.1f}s/chunk, "
                f"save scheduled in {t_save * 1e3:.0f}ms)"
            )
        # context exit joins the last background write

    print(f"done — {int(ts.update)} updates, state in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
