"""Multi-process runtime — the real multi-host path.

SURVEY.md §2.3 promises envs "sharded over hosts ... each host owns its
addressable shard of the env-state arrays", and §5's
failure-detection row says multi-host runs "rely on JAX distributed init
failure semantics". Everything in parallel/ is written against a global
`Mesh` and is process-count agnostic; this module supplies the missing
host-boundary plumbing:

  * `initialize(...)` — the `jax.distributed.initialize` bootstrap
    (coordinator address, process id, local device visibility). After it
    returns, `jax.devices()` is the GLOBAL device list and every
    parallel/ entry point (q_learning_sharded, compile_rollout_random
    _sharded, value_iteration_sharded, the neural learners) runs
    unchanged on the multi-process mesh: each process executes the same
    program, owns its addressable shard of env state, and the psums ride
    the real collective fabric (NCCL between cards; Gloo on the CPU test
    harness).
  * `make_global_array(...)` — per-process data feed: builds a global
    sharded array where each process materializes ONLY its addressable
    shards (the host-boundary I/O story; callback form of
    `jax.make_array_from_callback`).
  * `fetch_replicated(...)` / `local_shards(...)` — result I/O across the
    host boundary.

Failure semantics (exercised in tests/test_distributed_multiprocess.py):
losing a process makes the next collective fail with a backend error
(a Gloo or NCCL timeout) on the surviving processes rather than silently
corrupting state — recovery is checkpoint-restart (utils/checkpoint.py +
the SIGKILL drills in tests/test_fault_tolerance.py).

The tests validate the path with N OS processes × M virtual CPU devices.
On GPU hosts nothing tells JAX of a cluster: pass the coordinator
address, process count and process id explicitly.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_count: int | None = None,
    platform: str | None = None,
) -> dict:
    """Bootstrap this process into a multi-process JAX runtime.

    Pass all of (coordinator_address, num_processes, process_id); on a
    cluster whose scheduler JAX recognizes they may be left out. On the
    CPU test harness, also pass `local_device_count` to give each process
    that many virtual CPU devices (must be set BEFORE any JAX backend
    initializes).

    Returns a summary dict {process_id, process_count, local_devices,
    global_devices}. Idempotent-hostile: call exactly once per process.
    """
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" in flags:
            raise RuntimeError(
                "local_device_count given but XLA_FLAGS already pins "
                "xla_force_host_platform_device_count; pick one"
            )
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{local_device_count}"
        ).strip()

    import jax

    if platform is not None:
        # Plain config update, no jax.devices() check: that would
        # initialize a backend BEFORE jax.distributed.initialize.
        jax.config.update("jax_platforms", platform)

    kwargs: dict[str, Any] = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }


def shutdown() -> None:
    """Tear down the distributed runtime (end-of-job cleanup)."""
    import jax

    jax.distributed.shutdown()


def make_global_array(
    mesh,
    spec,
    global_shape: Sequence[int],
    fill: Callable[[tuple], np.ndarray],
    dtype=None,
):
    """Per-process data feed: a global array sharded per `spec` over `mesh`
    where each process materializes ONLY its addressable shards.

    `fill(index_tuple) -> np.ndarray` produces the data for one shard,
    given the global numpy-style index of that shard (a tuple of slices).
    It is called once per addressable shard on this process — a host never
    touches (or needs RAM for) another host's envs.
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)

    def cb(index):
        arr = np.asarray(fill(index))
        return arr if dtype is None else arr.astype(dtype)

    return jax.make_array_from_callback(tuple(global_shape), sharding, cb)


def fetch_global(mesh, tree):
    """Gather a pytree of (possibly sharded) GLOBAL arrays to host numpy on
    every process — one all-gather jit with replicated out_shardings. The
    serialization side of full-state checkpointing for the sharded
    trainers (ppo_init_sharded-family states): each process ends up with
    the complete global value of every leaf, so any process can write the
    checkpoint and a relaunched job can re-feed the restored host pytree
    straight into *_run_sharded (the in_specs re-shard it)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    repl = NamedSharding(mesh, PartitionSpec())
    gathered = jax.jit(
        lambda t: t,
        out_shardings=jax.tree.map(lambda _: repl, tree),
    )(tree)
    return jax.tree.map(lambda x: np.asarray(x), gathered)


def fetch_replicated(x) -> np.ndarray:
    """Fetch a replicated (PartitionSpec()) result to host numpy. Works on
    every process — replicated outputs are addressable everywhere."""
    return np.asarray(x)


def local_shards(x) -> list[tuple[tuple, np.ndarray]]:
    """This process's addressable shards of a sharded array, as
    (global_index, data) pairs — the host-boundary result I/O for
    env-state arrays (each host sees exactly the envs it owns)."""
    return [(s.index, np.asarray(s.data)) for s in x.addressable_shards]
