"""Example 9 — true multi-process runtime (one OS process per "host").

Self-launching demo of `parallel.distributed`: run with no arguments and
it spawns `--procs` copies of itself, joins them into ONE global device
mesh via `jax.distributed.initialize`, and trains the sharded Q-learner
across the process boundary — every process executes the same program,
owns its addressable env shards, and the psums ride the collective
fabric (Gloo here; NCCL between cards).

    python examples/09_multiprocess.py --procs 2 --devices_per_proc 4

On real multi-host hardware, skip the launcher: run your per-host
command with `initialize(coordinator_address=..., num_processes=...,
process_id=...)`.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def worker(pid: int, nproc: int, port: int, devices: int, steps: int, envs: int):
    from griduniverse_tpu.parallel.distributed import fetch_replicated, initialize

    info = initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
        local_device_count=devices,
        platform="cpu",
    )
    import jax

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu.parallel import make_host_env_mesh, q_learning_sharded

    mesh = make_host_env_mesh()
    print(
        f"[proc {pid}] joined: {info['process_count']} processes × "
        f"{info['local_devices']} devices = {info['global_devices']} global; "
        f"mesh {mesh.devices.shape}",
        flush=True,
    )
    res = q_learning_sharded(
        mesh,
        make_semantics(),
        walls_and_goal_16x16(),
        jax.random.PRNGKey(0),
        num_steps=steps,
        batch_size=envs,
    )
    print(
        f"[proc {pid}] episodes={int(res.episodes)} "
        f"mean_return={float(res.mean_return):.2f} "
        f"(Q replicated: sum={float(fetch_replicated(res.q).sum()):.3f})",
        flush=True,
    )


def main():
    # NOTE: plain argparse here (not examples/_common.py) — the platform
    # must be selected by distributed.initialize BEFORE any backend exists.
    import argparse

    p = argparse.ArgumentParser(description="multi-process sharded training")
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--devices_per_proc", type=int, default=4)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--platform", default="cpu", choices=["cpu"])  # launcher demo is CPU-only
    p.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args()

    if args.worker >= 0:
        worker(
            args.worker, args.procs, args.port, args.devices_per_proc,
            args.steps, args.envs,
        )
        return

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers pick their own device count
    procs = [
        subprocess.Popen(
            [
                sys.executable, os.path.abspath(__file__),
                "--worker", str(i), "--port", str(port),
                "--procs", str(args.procs),
                "--devices_per_proc", str(args.devices_per_proc),
                "--steps", str(args.steps), "--envs", str(args.envs),
            ],
            env=env,
        )
        for i in range(args.procs)
    ]
    rcs = [q.wait() for q in procs]
    if any(rcs):
        sys.exit(f"worker exit codes: {rcs}")
    print(f"all {args.procs} processes completed")


if __name__ == "__main__":
    main()
