"""Failure detection / elastic recovery (SURVEY.md §5).

The reference has no failure story (single in-process run). The
new-framework plan from the survey table: checkpoint-restart IS the
recovery mechanism, plus "optional fault-injection test that kills and
rejoins a host process". These tests operationalize both:

  * hard-crash fault injection — a training worker process is SIGKILL'd
    mid-run (no cleanup, no atexit); a relaunched worker restores the
    latest checkpoint and completes. Because all learner state is an
    explicit pytree and per-step randomness is counter-based, the crashed-
    and-recovered run is BIT-EXACT equal to an unbroken run.
  * elastic topology change — a learner checkpointed under one mesh size
    resumes under a different device count (the Q-table is replicated and
    env streams are seeded by GLOBAL env id, so the learner is
    topology-portable) and still converges.
"""

import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from griduniverse_tpu import make_semantics
from griduniverse_tpu.algos.td import td_init, td_run
from griduniverse_tpu.levels.builders import make_level_from_indices
from griduniverse_tpu.utils.checkpoint import CheckpointManager

SEM = make_semantics()

# Worker: chunked TD training with a checkpoint per chunk. With
# GU_CRASH_AFTER_CHUNK=k it SIGKILLs ITSELF right after saving chunk k —
# a hard fault (no python cleanup), deterministic enough for CI.
_WORKER = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.algos.td import td_init, td_run
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.utils.checkpoint import CheckpointManager

    ckpt_dir = sys.argv[1]
    num_chunks = int(sys.argv[2])
    chunk_steps = int(sys.argv[3])
    crash_after = int(os.environ.get("GU_CRASH_AFTER_CHUNK", "-1"))

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    template = td_init(sem, level, jax.random.PRNGKey(0), batch_size=8)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    start_chunk, ts = mgr.restore_latest(template)

    for chunk in range(start_chunk, num_chunks):
        ts = td_run(sem, level, ts, chunk_steps)
        mgr.save(chunk + 1, ts)
        if chunk + 1 == crash_after:
            os.kill(os.getpid(), 9)  # simulated host failure: hard SIGKILL
    print("COMPLETED", int(ts.step))
    """
)


@pytest.mark.parametrize("crash_after", [1, 2])
def test_sigkill_recovery_is_bitexact(tmp_path, crash_after):
    num_chunks, chunk_steps = 3, 40
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    ckpt_dir = str(tmp_path / "ckpts")

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pythonpath = repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")
    env = dict(
        os.environ, GU_CRASH_AFTER_CHUNK=str(crash_after), PYTHONPATH=pythonpath
    )
    p1 = subprocess.run(
        [sys.executable, str(worker), ckpt_dir, str(num_chunks), str(chunk_steps)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    # the worker must have died by SIGKILL, not finished
    assert p1.returncode == -signal.SIGKILL, (p1.returncode, p1.stderr[-500:])
    assert "COMPLETED" not in p1.stdout

    # relaunch — detection of the partial run is CheckpointManager's
    # restore_latest; the rejoined worker finishes the remaining chunks
    env.pop("GU_CRASH_AFTER_CHUNK")
    p2 = subprocess.run(
        [sys.executable, str(worker), ckpt_dir, str(num_chunks), str(chunk_steps)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert p2.returncode == 0, p2.stderr[-2000:]
    assert f"COMPLETED {num_chunks * chunk_steps}" in p2.stdout

    # recovered run ≡ unbroken in-process run, bit for bit
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    ts = td_init(SEM, level, jax.random.PRNGKey(0), batch_size=8)
    ts = td_run(SEM, level, ts, num_chunks * chunk_steps)

    mgr = CheckpointManager(ckpt_dir)
    template = td_init(SEM, level, jax.random.PRNGKey(0), batch_size=8)
    step, recovered = mgr.restore_latest(template)
    assert step == num_chunks
    np.testing.assert_array_equal(np.asarray(ts.q), np.asarray(recovered.q))
    np.testing.assert_array_equal(
        np.asarray(ts.env_state.agent_idx),
        np.asarray(recovered.env_state.agent_idx),
    )
    assert int(ts.episodes) == int(recovered.episodes)
    np.testing.assert_array_equal(np.asarray(ts.ret_sum), np.asarray(recovered.ret_sum))


# Fast-engine worker: same chunk/checkpoint/self-SIGKILL protocol as
# _WORKER, on the fast engine (FastTDTrainState).
_FAST_WORKER = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.algos.td_fast import (
        compile_fast_td_run, fast_td_init,
    )
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.ops.bitplane import pack_level
    from griduniverse_tpu.utils.checkpoint import CheckpointManager

    ckpt_dir = sys.argv[1]
    num_chunks = int(sys.argv[2])
    chunk_steps = int(sys.argv[3])
    crash_after = int(os.environ.get("GU_CRASH_AFTER_CHUNK", "-1"))

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    bl = pack_level(level)
    template = fast_td_init(sem, bl, jnp.uint32(0), batch_size=8)
    run = compile_fast_td_run(sem, bl, chunk_steps, epsilon=0.2,
                              max_episode_steps=30)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    start_chunk, ts = mgr.restore_latest(template)

    for chunk in range(start_chunk, num_chunks):
        ts = run(ts)
        mgr.save(chunk + 1, ts)
        if chunk + 1 == crash_after:
            os.kill(os.getpid(), 9)  # simulated host failure: hard SIGKILL
    print("COMPLETED", int(ts.step))
    """
)


def test_sigkill_recovery_fast_engine_is_bitexact(tmp_path):
    """Mid-run hard crash on the FAST engine: the relaunched worker restores
    FastTDTrainState (env FastState + xorshift lanes + accumulators + Q) and
    the recovered run is bit-equal to an unbroken in-process run."""
    from griduniverse_tpu.algos.td_fast import (
        compile_fast_td_run,
        fast_td_init,
    )
    from griduniverse_tpu.levels.builders import make_level_from_indices as mk
    from griduniverse_tpu.ops.bitplane import pack_level

    num_chunks, chunk_steps, crash_after = 3, 40, 2
    worker = tmp_path / "fast_worker.py"
    worker.write_text(_FAST_WORKER)
    ckpt_dir = str(tmp_path / "ckpts")

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pythonpath = repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")
    env = dict(
        os.environ, GU_CRASH_AFTER_CHUNK=str(crash_after), PYTHONPATH=pythonpath
    )
    p1 = subprocess.run(
        [sys.executable, str(worker), ckpt_dir, str(num_chunks), str(chunk_steps)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert p1.returncode == -signal.SIGKILL, (p1.returncode, p1.stderr[-500:])
    assert "COMPLETED" not in p1.stdout

    env.pop("GU_CRASH_AFTER_CHUNK")
    p2 = subprocess.run(
        [sys.executable, str(worker), ckpt_dir, str(num_chunks), str(chunk_steps)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert p2.returncode == 0, p2.stderr[-2000:]
    assert f"COMPLETED {num_chunks * chunk_steps}" in p2.stdout

    # recovered ≡ unbroken, bit for bit, across the WHOLE train state
    level = mk((4, 4), start_idx=0, goals=[15])
    bl = pack_level(level)
    run = compile_fast_td_run(SEM, bl, chunk_steps, epsilon=0.2,
                              max_episode_steps=30)
    ts = fast_td_init(SEM, bl, jnp.uint32(0), batch_size=8)
    for _ in range(num_chunks):
        ts = run(ts)

    from griduniverse_tpu.utils.checkpoint import CheckpointManager

    template = fast_td_init(SEM, bl, jnp.uint32(0), batch_size=8)
    step, recovered = CheckpointManager(ckpt_dir).restore_latest(template)
    assert step == num_chunks
    for got, want in zip(jax.tree.leaves(recovered), jax.tree.leaves(ts)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_elastic_resume_across_mesh_sizes():
    """A Q-table trained under an 8-device mesh resumes under 2 devices
    (simulated shrunken slice after a host loss) and still reaches the
    optimal greedy policy."""
    from griduniverse_tpu.algos.utils import greedy_policy_from_q
    from griduniverse_tpu.ops.bitplane import pack_level
    from griduniverse_tpu.parallel.bitplane import compile_q_learning_fast_sharded
    from griduniverse_tpu.parallel.mesh import make_env_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU harness")

    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    bl = pack_level(level)

    fn8 = compile_q_learning_fast_sharded(
        make_env_mesh(8), SEM, bl, batch_size=64, num_steps=800
    )
    res8 = fn8(jnp.uint32(0))

    # topology change: the Q crosses meshes through the host, exactly as a
    # checkpoint restore onto the shrunken slice would
    q_ckpt = np.asarray(res8.q)
    fn2 = compile_q_learning_fast_sharded(
        make_env_mesh(2), SEM, bl, batch_size=64, num_steps=800
    )
    res2 = fn2(jnp.uint32(1), q0=jnp.asarray(q_ckpt))
    assert int(res2.episodes) > 0

    pi_learned = greedy_policy_from_q(res2.q)
    from griduniverse_tpu.algos.utils import run_greedy_episode

    _, total, length, reached = run_greedy_episode(
        SEM, level, pi_learned, jax.random.PRNGKey(0), max_steps=12
    )
    assert bool(reached)
    assert int(length) == 6  # Manhattan-optimal path on 4x4 corner-to-corner


# Neural worker: the same chunk/checkpoint/self-SIGKILL protocol on the
# DQN train state (params + optimizer + env batch + FULL replay buffer +
# PER priorities + counter-based RNG — models/dqn.py DQNTrainState).
_DQN_WORKER = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.models import DQNConfig, dqn_init, dqn_run
    from griduniverse_tpu.utils.checkpoint import CheckpointManager

    ckpt_dir = sys.argv[1]
    num_chunks = int(sys.argv[2])
    chunk_steps = int(sys.argv[3])
    crash_after = int(os.environ.get("GU_CRASH_AFTER_CHUNK", "-1"))

    sem = make_semantics()
    level = make_level_from_indices((2, 6), start_idx=0, goals=[5])
    cfg = DQNConfig(
        buffer_capacity=256, batch_size_train=32, learn_start=32,
        eps_anneal_steps=100, hidden=(32,), embed_dim=16,
        max_episode_steps=16, prioritized=True,
    )
    template = dqn_init(sem, level, jax.random.PRNGKey(7), cfg, batch_size=16)
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    start_chunk, ts = mgr.restore_latest(template)

    for chunk in range(start_chunk, num_chunks):
        ts = dqn_run(sem, level, ts, cfg, chunk_steps)
        mgr.save(chunk + 1, ts)
        if chunk + 1 == crash_after:
            os.kill(os.getpid(), 9)
    print("COMPLETED", int(ts.t))
    """
)


def test_dqn_sigkill_recovery_is_bitexact(tmp_path):
    from griduniverse_tpu.models import DQNConfig, dqn_init, dqn_run

    num_chunks, chunk_steps, crash_after = 3, 40, 1
    worker = tmp_path / "dqn_worker.py"
    worker.write_text(_DQN_WORKER)
    ckpt_dir = str(tmp_path / "ckpts")

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pythonpath = repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")
    env = dict(
        os.environ, GU_CRASH_AFTER_CHUNK=str(crash_after), PYTHONPATH=pythonpath
    )
    p1 = subprocess.run(
        [sys.executable, str(worker), ckpt_dir, str(num_chunks), str(chunk_steps)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert p1.returncode == -signal.SIGKILL, (p1.returncode, p1.stderr[-500:])
    assert "COMPLETED" not in p1.stdout

    env.pop("GU_CRASH_AFTER_CHUNK")
    p2 = subprocess.run(
        [sys.executable, str(worker), ckpt_dir, str(num_chunks), str(chunk_steps)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert p2.returncode == 0, p2.stderr[-2000:]
    assert f"COMPLETED {num_chunks * chunk_steps}" in p2.stdout

    # recovered run ≡ unbroken in-process run, bit for bit — params, the
    # whole replay buffer, PER priorities, env batch and counters
    level = make_level_from_indices((2, 6), start_idx=0, goals=[5])
    cfg = DQNConfig(
        buffer_capacity=256, batch_size_train=32, learn_start=32,
        eps_anneal_steps=100, hidden=(32,), embed_dim=16,
        max_episode_steps=16, prioritized=True,
    )
    ts = dqn_init(SEM, level, jax.random.PRNGKey(7), cfg, batch_size=16)
    ts = dqn_run(SEM, level, ts, cfg, num_chunks * chunk_steps)

    mgr = CheckpointManager(ckpt_dir)
    template = dqn_init(SEM, level, jax.random.PRNGKey(7), cfg, batch_size=16)
    step, recovered = mgr.restore_latest(template)
    assert step == num_chunks
    for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(recovered)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
