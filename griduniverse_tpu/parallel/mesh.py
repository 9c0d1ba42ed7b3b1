"""Device mesh construction — the framework's 'distributed backend'.

The reference has NO parallelism (SURVEY.md §2.3): single process, single
env. The distributed scope comes from the BASELINE north star: envs sharded
over hosts feeding a sharded learner via all-reduce. There is no NCCL/MPI
code to write — parallelism is a `jax.sharding.Mesh` + `PartitionSpec`s,
and the XLA runtime carries the collectives (NCCL over NVLink between
cards; Gloo between CPU processes; SURVEY.md §5 "Distributed
communication backend").

Mesh conventions:
  * 1-D `('env',)` mesh — pure env data-parallelism; the only collective is
    the psum combining learner updates / episode stats.
  * 2-D `('host', 'env')` mesh — same semantics, but the leading axis maps
    to hosts so array shards line up host-locally on multi-process runs
    (each host owns its addressable shard of the env-state arrays).

On cards the mesh follows the algorithm, not a torus: every axis shards
the env batch, so one host's cards, all-to-all over NVLink, serve any
mesh shape. The tests exercise meshes on a virtual 8-device CPU platform
(tests/conftest.py); the same code runs unchanged on four cards
(`python chip_smoke.py --four-cards`).
"""

from __future__ import annotations


import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"
HOST_AXIS = "host"


def make_env_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh over all (or the first `num_devices`) devices: axis 'env'."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def make_host_env_mesh(
    num_hosts: int | None = None, devices_per_host: int | None = None
) -> Mesh:
    """2-D ('host', 'env') mesh.

    With real multi-host topology, rows follow jax.devices() order (which
    groups by host); under CPU emulation the grouping is synthetic but the
    program is identical.
    """
    devices = jax.devices()
    n = len(devices)
    if num_hosts is None:
        num_hosts = max(1, jax.process_count())
        if num_hosts == 1 and n % 2 == 0 and n > 1:
            num_hosts = 2  # emulate ≥2 hosts on single-process CPU meshes
    if devices_per_host is None:
        devices_per_host = n // num_hosts
    use = num_hosts * devices_per_host
    grid = np.asarray(devices[:use]).reshape(num_hosts, devices_per_host)
    return Mesh(grid, (HOST_AXIS, ENV_AXIS))


def env_axes(mesh: Mesh) -> tuple[str, ...]:
    """All mesh axes that shard the env batch (every axis, by convention)."""
    return tuple(mesh.axis_names)


def env_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding a leading env-batch dim over the whole mesh."""
    axes = env_axes(mesh)
    return P(axes if len(axes) > 1 else axes[0])


def env_sharding(mesh: Mesh) -> NamedSharding:
    """NamedSharding for batched EnvState leaves (leading env axis)."""
    return NamedSharding(mesh, env_spec(mesh))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """NamedSharding replicating a value (levels, semantics, Q-tables)."""
    return NamedSharding(mesh, P())


def shard_env_state(mesh: Mesh, state):
    """Place a batched EnvState (or any pytree with leading env axis) with
    its batch dim sharded over the mesh."""
    sh = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)
