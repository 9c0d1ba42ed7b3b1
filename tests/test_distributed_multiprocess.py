"""True multi-process runtime tests.

Launches REAL OS processes (2 procs × 4 virtual CPU devices each) joined
through `jax.distributed.initialize` into one 8-device global mesh, and
asserts:

  * the parity-mode distributed learner equals the single-process 8-device
    run BIT-for-bit (the host boundary is semantically invisible);
  * the sharded fast rollout produces the exact per-env trajectories of
    the unsharded run (global-env-id xorshift lanes);
  * per-process data feed: each process materializes only its addressable
    shards (`make_global_array`) and global reductions see every shard;
  * failure detection: killing the coordinator process makes the survivor's
    next collective FAIL (error, not hang/corruption) — SURVEY.md §5's
    "rely on JAX distributed init failure semantics".

These run the same `parallel/` entry points the single-process tests use —
nothing is mocked; the collectives ride Gloo across the process boundary
as they ride NCCL between cards.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

NPROC = 2
LOCAL_DEVICES = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(script: Path, pid: int, port: int, out_dir: Path, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # the worker picks its own device count via distributed.initialize —
    # the harness's 8-device flag must not leak in
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        .replace("--xla_force_host_platform_device_count=8", "")
        .strip()
    )
    if not env["XLA_FLAGS"]:
        env.pop("XLA_FLAGS")
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), str(out_dir)],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


_PARITY_WORKER = textwrap.dedent(
    """
    import sys
    from pathlib import Path

    pid, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])

    from griduniverse_tpu.parallel.distributed import (
        fetch_replicated, initialize, local_shards, make_global_array,
    )

    info = initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=%(nproc)d,
        process_id=pid,
        local_device_count=%(local)d,
        platform="cpu",
    )
    assert info["process_count"] == %(nproc)d, info
    assert info["local_devices"] == %(local)d, info
    assert info["global_devices"] == %(nproc)d * %(local)d, info

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.ops.bitplane import pack_level
    from griduniverse_tpu.parallel import (
        compile_rollout_random_sharded, make_host_env_mesh, q_learning_sharded,
    )

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    mesh = make_host_env_mesh()  # (num_processes, local_devices)
    assert mesh.devices.shape == (%(nproc)d, %(local)d), mesh.devices.shape

    # 1) parity-mode distributed learner across the REAL process boundary
    res = q_learning_sharded(
        mesh, sem, level, jax.random.PRNGKey(0),
        num_steps=60, batch_size=16, parity=True,
    )
    np.save(out_dir / f"q_{pid}.npy", fetch_replicated(res.q))
    np.save(out_dir / f"eps_{pid}.npy", fetch_replicated(res.episodes))

    # 2) sharded fast rollout: global-env-id streams -> exact trajectories
    fast = compile_rollout_random_sharded(
        mesh, sem, pack_level(level), 64, 200, max_episode_steps=32
    )
    state, stats = fast(jnp.uint32(3))
    np.save(out_dir / f"fast_eps_{pid}.npy", fetch_replicated(stats["episodes"]))
    # each process owns exactly its addressable env shards
    mine = local_shards(state.agent_idx)
    assert sum(s.size for _, s in mine) == 64 // %(nproc)d, mine

    # 3) per-process data feed: fill ONLY addressable shards, reduce global
    full = np.arange(64, dtype=np.float32)
    x = make_global_array(mesh, P(("host", "env")), (64,), lambda ix: full[ix])
    total = float(jax.jit(jnp.sum, out_shardings=None)(x))
    assert total == float(full.sum()), total

    print("WORKER_OK", flush=True)
    """
)


@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    """Launch the 2-process parity workers once; share across asserts."""
    out_dir = tmp_path_factory.mktemp("dist")
    script = out_dir / "worker.py"
    script.write_text(
        _PARITY_WORKER % {"nproc": NPROC, "local": LOCAL_DEVICES}
    )
    port = _free_port()
    procs = [_launch(script, i, port, out_dir) for i in range(NPROC)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{so[-1500:]}\n{se[-3000:]}"
        assert "WORKER_OK" in so
    return out_dir


def test_multiprocess_learner_bitexact_vs_single_process(parity_run):
    """2 OS processes × 4 devices == 1 process × 8 devices, bit for bit
    (parity mode all_gathers raw increments and replays the identical
    segment_sum on every replica — mesh topology cannot matter)."""
    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.parallel import make_host_env_mesh, q_learning_sharded

    if len(jax.devices()) < NPROC * LOCAL_DEVICES:
        pytest.skip("needs the 8-device CPU harness")

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    ref = q_learning_sharded(
        make_host_env_mesh(NPROC, LOCAL_DEVICES), sem, level,
        jax.random.PRNGKey(0), num_steps=60, batch_size=16, parity=True,
    )

    for pid in range(NPROC):
        q = np.load(parity_run / f"q_{pid}.npy")
        np.testing.assert_array_equal(q, np.asarray(ref.q))
        assert int(np.load(parity_run / f"eps_{pid}.npy")) == int(ref.episodes)


def test_multiprocess_fast_rollout_matches_unsharded(parity_run):
    """Episode counts are integer-exact vs the unsharded single-device run:
    every env's xorshift lane is keyed by GLOBAL env id, so OS-process
    boundaries cannot alter any trajectory."""
    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.ops.bitplane import compile_rollout_random, pack_level

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    _, stats = compile_rollout_random(
        sem, pack_level(level), 64, 200, max_episode_steps=32
    )(jnp.uint32(3))

    for pid in range(NPROC):
        got = int(np.load(parity_run / f"fast_eps_{pid}.npy"))
        assert got == int(stats["episodes"])


_VICTIM_WORKER = textwrap.dedent(
    """
    import sys, time
    from pathlib import Path

    pid, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])

    from griduniverse_tpu.parallel.distributed import initialize

    initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=%(nproc)d,
        process_id=pid,
        local_device_count=%(local)d,
        platform="cpu",
    )
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("env",))
    f = jax.jit(jax.shard_map(
        lambda x: jax.lax.psum(x, "env"),
        mesh=mesh, in_specs=P("env"), out_specs=P(),
    ))
    x = jax.make_array_from_callback(
        (%(nproc)d * %(local)d,),
        jax.NamedSharding(mesh, P("env")),
        lambda ix: np.ones(1, np.float32),
    )
    assert float(f(x)[0]) == %(nproc)d * %(local)d  # healthy collective
    (out_dir / f"ready_{pid}").touch()

    if pid == 0:
        time.sleep(600)  # coordinator idles until the test SIGKILLs it
    else:
        while not (out_dir / "go_crash").exists():
            time.sleep(0.2)
        # Detection races between two paths, either acceptable:
        #   a) the coordination-service heartbeat notices the dead leader
        #      first and fail-fast TERMINATES this process (rc != 0);
        #   b) the collective itself fails and raises here (exit 3).
        try:
            float(f(x)[0])  # requires the (now dead) coordinator's shard
        except Exception as e:
            print(f"DETECTED {type(e).__name__}", flush=True)
            sys.exit(3)
        sys.exit(42)  # collective silently succeeded — must not happen
    """
)


def test_coordinator_loss_fails_survivor_collective(tmp_path):
    """Kill the coordinator process mid-job: the survivor's next collective
    must raise (detected failure), never hang past the backend timeout or
    silently produce data. Recovery from here is checkpoint-restart
    (tests/test_fault_tolerance.py)."""
    script = tmp_path / "victim.py"
    script.write_text(
        _VICTIM_WORKER % {"nproc": NPROC, "local": LOCAL_DEVICES}
    )
    port = _free_port()
    procs = [_launch(script, i, port, tmp_path) for i in range(NPROC)]
    try:
        deadline = time.time() + 180
        while not all(
            (tmp_path / f"ready_{i}").exists() for i in range(NPROC)
        ):
            assert time.time() < deadline, "workers never became ready"
            for p in procs:
                assert p.poll() is None, (
                    f"worker died early: rc={p.returncode}\n"
                    f"{p.communicate()[1][-3000:]}"
                )
            time.sleep(0.3)

        procs[0].kill()  # hard-SIGKILL the coordinator
        (tmp_path / "go_crash").touch()

        so, se = procs[1].communicate(timeout=150)
        rc = procs[1].returncode
        # rc==3 → the collective raised (caught in-worker); any other
        # nonzero rc must be JAX's coordination-service fail-fast abort.
        # rc==0 or the sentinel 42 would mean the failure went UNdetected.
        assert rc not in (0, 42), f"failure undetected: rc={rc}\n{so[-1500:]}"
        if rc == 3:
            assert "DETECTED" in so
        else:
            assert (
                "coordination" in se.lower() or "UNAVAILABLE" in se
            ), f"rc={rc} but no coordination-failure trace:\n{se[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


_PPO_WORKER = textwrap.dedent(
    """
    import os, sys
    from pathlib import Path

    pid, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    phase = os.environ["PPO_PHASE"]

    from griduniverse_tpu.parallel.distributed import (
        fetch_replicated, initialize,
    )

    initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=%(nproc)d,
        process_id=pid,
        local_device_count=%(local)d,
        platform="cpu",
    )
    import jax
    import numpy as np
    from tests._tree_bytes import tree_from_bytes, tree_to_bytes

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.models import PPOConfig, make_network, ppo_train_sharded
    from griduniverse_tpu.models.a2c import _net_init
    from griduniverse_tpu.parallel import make_host_env_mesh

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    mesh = make_host_env_mesh()
    cfg = PPOConfig(
        rollout_len=4, num_epochs=1, num_minibatches=2,
        hidden=(16,), embed_dim=8, max_episode_steps=8,
        compute_dtype="float32",
    )
    if phase == "train":
        res = ppo_train_sharded(
            mesh, sem, level, jax.random.PRNGKey(0), cfg,
            num_updates=8, batch_size=16,
        )
        if pid == 0:
            (out_dir / "params1.bytes").write_bytes(
                tree_to_bytes(res.params)
            )
        assert np.isfinite(fetch_replicated(res.final_loss))
        (out_dir / f"ppo_ready_{pid}").touch()
        # long second leg — the harness SIGKILLs both processes mid-flight
        ppo_train_sharded(
            mesh, sem, level, jax.random.PRNGKey(5), cfg,
            num_updates=1_000_000, batch_size=16,
        )
        sys.exit(9)  # must never complete
    else:  # phase == "resume": fresh runtime, warm-start from checkpoint
        net = make_network(level, 4, cfg)
        template = _net_init(net, jax.random.PRNGKey(7))
        params0 = tree_from_bytes(
            template, (out_dir / "params1.bytes").read_bytes()
        )
        res = ppo_train_sharded(
            mesh, sem, level, jax.random.PRNGKey(1), cfg,
            num_updates=6, batch_size=16, init_params=params0,
        )
        assert np.isfinite(fetch_replicated(res.final_loss))
        if pid == 0:
            (out_dir / "params2.bytes").write_bytes(
                tree_to_bytes(res.params)
            )
        print("WORKER_OK", flush=True)
    """
)


def _ppo_cfg_and_level():
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.models import PPOConfig

    return (
        PPOConfig(
            rollout_len=4, num_epochs=1, num_minibatches=2,
            hidden=(16,), embed_dim=8, max_episode_steps=8,
            compute_dtype="float32",
        ),
        make_level_from_indices((4, 4), start_idx=0, goals=[15]),
    )


def test_multiprocess_ppo_parity_and_sigkill_restart(tmp_path):
    """The neural layer across a REAL process boundary: (a) 2-process sharded PPO equals the single-process 8-device run
    (pmean across Gloo == pmean across the in-process mesh); (b) after
    SIGKILLing BOTH workers mid-training, relaunched processes
    re-initialize the distributed runtime and resume from the checkpointed
    params — and the resumed result again equals a single-process
    warm-started run."""
    from tests._tree_bytes import tree_from_bytes, tree_to_bytes

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.models import make_network, ppo_train_sharded
    from griduniverse_tpu.models.a2c import _net_init
    from griduniverse_tpu.parallel import make_host_env_mesh

    if len(jax.devices()) < NPROC * LOCAL_DEVICES:
        pytest.skip("needs the 8-device CPU harness")

    script = tmp_path / "ppo_worker.py"
    script.write_text(_PPO_WORKER % {"nproc": NPROC, "local": LOCAL_DEVICES})
    env = {"PPO_PHASE": "train"}
    port = _free_port()
    procs = [
        _launch(script, i, port, tmp_path, extra_env=env)
        for i in range(NPROC)
    ]
    try:
        deadline = time.time() + 600
        while not all(
            (tmp_path / f"ppo_ready_{i}").exists() for i in range(NPROC)
        ):
            assert time.time() < deadline, "PPO workers never became ready"
            for p in procs:
                assert p.poll() is None, (
                    f"worker died early: rc={p.returncode}\n"
                    f"{p.communicate()[1][-3000:]}"
                )
            time.sleep(0.5)
        # SIGKILL both mid-second-leg — the crash we recover from
        for p in procs:
            p.kill()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    sem = make_semantics()
    cfg, level = _ppo_cfg_and_level()
    net = make_network(level, 4, cfg)
    template = _net_init(net, jax.random.PRNGKey(7))
    params1 = tree_from_bytes(
        template, (tmp_path / "params1.bytes").read_bytes()
    )

    # (a) cross-process == single-process (same (2, 4) mesh linearization)
    ref = ppo_train_sharded(
        make_host_env_mesh(NPROC, LOCAL_DEVICES), sem, level,
        jax.random.PRNGKey(0), cfg, num_updates=8, batch_size=16,
    )
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5
        ),
        params1,
        ref.params,
    )

    # (b) relaunch on a fresh port; resume from the checkpoint
    port2 = _free_port()
    procs2 = [
        _launch(script, i, port2, tmp_path, extra_env={"PPO_PHASE": "resume"})
        for i in range(NPROC)
    ]
    outs = [p.communicate(timeout=600) for p in procs2]
    for p, (so, se) in zip(procs2, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{so[-1500:]}\n{se[-3000:]}"
        assert "WORKER_OK" in so

    params2 = tree_from_bytes(
        template, (tmp_path / "params2.bytes").read_bytes()
    )
    ref2 = ppo_train_sharded(
        make_host_env_mesh(NPROC, LOCAL_DEVICES), sem, level,
        jax.random.PRNGKey(1), cfg, num_updates=6, batch_size=16,
        init_params=params1,
    )
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5
        ),
        params2,
        ref2.params,
    )


_FULLSTATE_WORKER = textwrap.dedent(
    """
    import os, sys
    from pathlib import Path

    pid, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    phase = os.environ["PPO_PHASE"]

    from griduniverse_tpu.parallel.distributed import (
        fetch_global, initialize,
    )

    initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=%(nproc)d,
        process_id=pid,
        local_device_count=%(local)d,
        platform="cpu",
    )
    import jax
    import numpy as np
    from tests._tree_bytes import tree_from_bytes, tree_to_bytes

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.models import (
        PPOConfig, ppo_init_sharded, ppo_run_sharded,
    )
    from griduniverse_tpu.parallel import make_host_env_mesh

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    mesh = make_host_env_mesh()
    cfg = PPOConfig(
        rollout_len=4, num_epochs=1, num_minibatches=2,
        hidden=(16,), embed_dim=8, max_episode_steps=8,
        compute_dtype="float32",
    )
    ts0 = ppo_init_sharded(
        mesh, sem, level, jax.random.PRNGKey(0), cfg, batch_size=16
    )
    if phase == "train":
        ts = ppo_run_sharded(mesh, sem, level, ts0, cfg, num_updates=8)
        # FULL-state checkpoint: every leaf (params, Adam momenta, env
        # states, per-shard counters) gathered to host and written
        host_state = fetch_global(mesh, ts)
        if pid == 0:
            (out_dir / "state8.bytes").write_bytes(
                tree_to_bytes(host_state)
            )
        (out_dir / f"fs_ready_{pid}").touch()
        # long second leg — the harness SIGKILLs both processes mid-flight
        ppo_run_sharded(mesh, sem, level, ts, cfg, num_updates=1_000_000)
        sys.exit(9)  # must never complete
    else:  # phase == "resume": fresh runtime, FULL-state restore
        template = jax.tree.map(np.zeros_like, fetch_global(mesh, ts0))
        state8 = tree_from_bytes(
            template, (out_dir / "state8.bytes").read_bytes()
        )
        ts = ppo_run_sharded(mesh, sem, level, state8, cfg, num_updates=6)
        host_state = fetch_global(mesh, ts)
        if pid == 0:
            (out_dir / "state14.bytes").write_bytes(
                tree_to_bytes(host_state)
            )
        print("WORKER_OK", flush=True)
    """
)


def test_multiprocess_fullstate_sigkill_resume(tmp_path):
    """The full-state recovery drill: SIGKILL both
    workers mid-training, relaunch, restore the ENTIRE sharded TrainState
    (including Adam momenta, env states and counters) from the checkpoint,
    and the resumed cross-process run must equal an UNBROKEN in-process
    run(8+6) — not merely a warm-started one."""
    from tests._tree_bytes import tree_from_bytes, tree_to_bytes

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.models import ppo_init_sharded, ppo_run_sharded
    from griduniverse_tpu.parallel import make_host_env_mesh
    from griduniverse_tpu.parallel.distributed import fetch_global

    if len(jax.devices()) < NPROC * LOCAL_DEVICES:
        pytest.skip("needs the 8-device CPU harness")

    script = tmp_path / "fs_worker.py"
    script.write_text(_FULLSTATE_WORKER % {"nproc": NPROC, "local": LOCAL_DEVICES})
    port = _free_port()
    procs = [
        _launch(script, i, port, tmp_path, extra_env={"PPO_PHASE": "train"})
        for i in range(NPROC)
    ]
    try:
        deadline = time.time() + 600
        while not all(
            (tmp_path / f"fs_ready_{i}").exists() for i in range(NPROC)
        ):
            assert time.time() < deadline, "workers never became ready"
            for p in procs:
                assert p.poll() is None, (
                    f"worker died early: rc={p.returncode}\n"
                    f"{p.communicate()[1][-3000:]}"
                )
            time.sleep(0.5)
        for p in procs:
            p.kill()  # SIGKILL mid-second-leg
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    # relaunch on a fresh port; full-state resume
    port2 = _free_port()
    procs2 = [
        _launch(script, i, port2, tmp_path, extra_env={"PPO_PHASE": "resume"})
        for i in range(NPROC)
    ]
    outs = [p.communicate(timeout=600) for p in procs2]
    for p, (so, se) in zip(procs2, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{so[-1500:]}\n{se[-3000:]}"
        assert "WORKER_OK" in so

    # the unbroken single-process reference on the same (2, 4) mesh
    sem = make_semantics()
    cfg, level = _ppo_cfg_and_level()
    mesh = make_host_env_mesh(NPROC, LOCAL_DEVICES)
    ts0 = ppo_init_sharded(
        mesh, sem, level, jax.random.PRNGKey(0), cfg, batch_size=16
    )
    unbroken = fetch_global(
        mesh,
        ppo_run_sharded(
            mesh, sem, level,
            ppo_run_sharded(mesh, sem, level, ts0, cfg, num_updates=8),
            cfg, num_updates=6,
        ),
    )
    template = jax.tree.map(np.zeros_like, fetch_global(mesh, ts0))
    resumed = tree_from_bytes(
        template, (tmp_path / "state14.bytes").read_bytes()
    )

    # integer state must match exactly; float leaves (params AND the Adam
    # momenta — the thing the old drill lost) to collective tolerance
    assert int(resumed.update) == int(unbroken.update) == 14
    np.testing.assert_array_equal(resumed.episodes, unbroken.episodes)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5
        ),
        resumed.params,
        unbroken.params,
    )
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-5
        ),
        resumed.opt_state,
        unbroken.opt_state,
    )
    np.testing.assert_array_equal(
        resumed.env_state.agent_idx, unbroken.env_state.agent_idx
    )
