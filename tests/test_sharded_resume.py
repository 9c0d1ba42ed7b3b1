"""Resumable SHARDED neural training.

The sharded trainers carry the FULL TrainState through the shard_map
boundary — params, optimizer momenta, target nets, replay buffers, env
states, RNG base keys, counters, and (n_dev,) per-shard stats — so the
distributed path meets the framework's own bit-exact resume standard
(tests/test_checkpoint.py) instead of warm-starting fresh Adam/envs:

  * chunk invariance: run(2N) ≡ run(N) ∘ run(N) bit-for-bit on fixed
    meshes (1-D and 2-D), for PPO / DQN (both replay modes) / A2C;
  * the legacy one-shot `*_train_sharded` equals init+run+result exactly;
  * orbax round-trips the sharded state through disk mid-run;
  * per-env-BATCHED-level grid-obs PPO (the flagship composition) resumes
    bit-exactly too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from griduniverse_tpu import make_semantics
from griduniverse_tpu.core import semantics as S
from griduniverse_tpu.core.types import Level
from griduniverse_tpu.levels.builders import make_level_from_indices
from griduniverse_tpu.levels.maze import generate_mazes_device
from griduniverse_tpu.models import (
    A2CConfig,
    DQNConfig,
    PPOConfig,
    a2c_init_sharded,
    a2c_result,
    a2c_run_sharded,
    a2c_train_sharded,
    dqn_init_sharded,
    dqn_result,
    dqn_run_sharded,
    dqn_train_sharded,
    ppo_init_sharded,
    ppo_result,
    ppo_run_sharded,
    ppo_train_sharded,
)
from griduniverse_tpu.parallel import make_env_mesh, make_host_env_mesh
from griduniverse_tpu.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

SEM = make_semantics()


def small_level():
    return make_level_from_indices((4, 4), start_idx=0, goals=[15])


def assert_trees_bitequal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


PPO_CFG = PPOConfig(
    rollout_len=4, num_epochs=2, num_minibatches=2, hidden=(16,),
    embed_dim=8, max_episode_steps=8, compute_dtype="float32",
)
A2C_CFG = A2CConfig(
    rollout_len=4, hidden=(16,), embed_dim=8, max_episode_steps=8,
    compute_dtype="float32",
)
DQN_CFG = DQNConfig(
    buffer_capacity=64, batch_size_train=8, hidden=(16,), embed_dim=8,
    max_episode_steps=8, learn_start=4, compute_dtype="float32",
)


def meshes():
    return [make_env_mesh(), make_host_env_mesh(2, 4)]


class TestChunkInvariance:
    @pytest.mark.parametrize("mesh_i", [0, 1])
    def test_ppo(self, mesh_i):
        mesh = meshes()[mesh_i]
        level = small_level()
        ts = ppo_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(0), PPO_CFG, batch_size=16
        )
        full = ppo_run_sharded(mesh, SEM, level, ts, PPO_CFG, num_updates=6)
        half = ppo_run_sharded(mesh, SEM, level, ts, PPO_CFG, num_updates=3)
        resumed = ppo_run_sharded(
            mesh, SEM, level, half, PPO_CFG, num_updates=3
        )
        assert_trees_bitequal(full, resumed)
        assert int(full.update) == 6
        # per-shard episode counters live one-per-device
        assert full.episodes.shape == (mesh.size,)

    @pytest.mark.parametrize("prioritized", [False, True])
    def test_dqn_both_replay_modes(self, prioritized):
        mesh = make_env_mesh()
        level = small_level()
        cfg = dataclasses.replace(DQN_CFG, prioritized=prioritized)
        ts = dqn_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(1), cfg, batch_size=8
        )
        full = dqn_run_sharded(mesh, SEM, level, ts, cfg, num_steps=12)
        resumed = dqn_run_sharded(
            mesh, SEM, level,
            dqn_run_sharded(mesh, SEM, level, ts, cfg, num_steps=6),
            cfg, num_steps=6,
        )
        assert_trees_bitequal(full, resumed)
        assert int(full.t) == 12
        # replay buffer is globally (cap,), sharded cap/n per device
        assert full.buf.obs.shape == (cfg.buffer_capacity,)

    def test_a2c(self):
        mesh = make_host_env_mesh(2, 4)
        level = small_level()
        ts = a2c_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(2), A2C_CFG, batch_size=16
        )
        full = a2c_run_sharded(mesh, SEM, level, ts, A2C_CFG, num_updates=6)
        resumed = a2c_run_sharded(
            mesh, SEM, level,
            a2c_run_sharded(mesh, SEM, level, ts, A2C_CFG, num_updates=3),
            A2C_CFG, num_updates=3,
        )
        assert_trees_bitequal(full, resumed)


class TestTrainEqualsInitRun:
    """The one-shot `*_train_sharded` wrappers are exactly the composition
    init ∘ run ∘ result — no behavior change from the r4 refactor."""

    def test_ppo(self):
        mesh = make_env_mesh()
        level = small_level()
        r1 = ppo_train_sharded(
            mesh, SEM, level, jax.random.PRNGKey(3), PPO_CFG,
            num_updates=5, batch_size=16,
        )
        ts = ppo_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(3), PPO_CFG, batch_size=16
        )
        r2 = ppo_result(
            ppo_run_sharded(mesh, SEM, level, ts, PPO_CFG, num_updates=5)
        )
        assert_trees_bitequal(r1, r2)

    def test_dqn(self):
        mesh = make_env_mesh()
        level = small_level()
        r1 = dqn_train_sharded(
            mesh, SEM, level, jax.random.PRNGKey(4), DQN_CFG,
            num_steps=10, batch_size=8,
        )
        ts = dqn_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(4), DQN_CFG, batch_size=8
        )
        r2 = dqn_result(
            dqn_run_sharded(mesh, SEM, level, ts, DQN_CFG, num_steps=10)
        )
        assert_trees_bitequal(r1, r2)

    def test_a2c(self):
        mesh = make_env_mesh()
        level = small_level()
        r1 = a2c_train_sharded(
            mesh, SEM, level, jax.random.PRNGKey(5), A2C_CFG,
            num_updates=5, batch_size=16,
        )
        ts = a2c_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(5), A2C_CFG, batch_size=16
        )
        r2 = a2c_result(
            a2c_run_sharded(mesh, SEM, level, ts, A2C_CFG, num_updates=5)
        )
        assert_trees_bitequal(r1, r2)


class TestOrbaxRoundTrip:
    def test_ppo_resume_through_disk(self, tmp_path):
        """run(N) → orbax save → restore into a fresh template → run(N)
        ≡ run(2N): the full distributed checkpoint/restore story."""
        mesh = make_env_mesh()
        level = small_level()
        ts = ppo_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(6), PPO_CFG, batch_size=16
        )
        full = ppo_run_sharded(mesh, SEM, level, ts, PPO_CFG, num_updates=6)
        half = ppo_run_sharded(mesh, SEM, level, ts, PPO_CFG, num_updates=3)
        save_checkpoint(tmp_path / "ckpt", half)
        # a relaunched job rebuilds the template from init (cheap) and
        # restores the real state into it
        template = jax.tree.map(jnp.zeros_like, ts)
        restored = restore_checkpoint(tmp_path / "ckpt", template)
        resumed = ppo_run_sharded(
            mesh, SEM, level, restored, PPO_CFG, num_updates=3
        )
        assert_trees_bitequal(full, resumed)

    def test_dqn_resume_through_disk(self, tmp_path):
        mesh = make_env_mesh()
        level = small_level()
        cfg = dataclasses.replace(DQN_CFG, prioritized=True)
        ts = dqn_init_sharded(
            mesh, SEM, level, jax.random.PRNGKey(7), cfg, batch_size=8
        )
        full = dqn_run_sharded(mesh, SEM, level, ts, cfg, num_steps=12)
        half = dqn_run_sharded(mesh, SEM, level, ts, cfg, num_steps=6)
        save_checkpoint(tmp_path / "ckpt", half)
        template = jax.tree.map(jnp.zeros_like, ts)
        restored = restore_checkpoint(tmp_path / "ckpt", template)
        resumed = dqn_run_sharded(mesh, SEM, level, restored, cfg, num_steps=6)
        assert_trees_bitequal(full, resumed)


class TestBatchedLevels:
    def test_gridobs_ppo_over_batched_mazes_resumes(self):
        """The flagship composition (per-env levels + conv trunk) through
        the resumable sharded path."""
        mesh = make_env_mesh()
        grids, start = generate_mazes_device(
            jax.random.PRNGKey(8), (3, 3), 16, algorithm="binary_tree"
        )
        grids = grids.at[:, 5, 5].set(S.GOAL)
        levels = Level(grid=grids, start_idx=jnp.broadcast_to(start, (16,)))
        cfg = dataclasses.replace(
            PPO_CFG, obs="grid", conv_channels=(8,), hidden=(16,)
        )
        ts = ppo_init_sharded(
            mesh, SEM, levels, jax.random.PRNGKey(9), cfg, batch_size=16
        )
        full = ppo_run_sharded(mesh, SEM, levels, ts, cfg, num_updates=4)
        resumed = ppo_run_sharded(
            mesh, SEM, levels,
            ppo_run_sharded(mesh, SEM, levels, ts, cfg, num_updates=2),
            cfg, num_updates=2,
        )
        assert_trees_bitequal(full, resumed)
        assert np.isfinite(float(full.last_loss))


class TestElasticResume:
    """A sharded TrainState saved on one mesh size resumes on ANOTHER
    (models.reshard_stats): global leaves reshard automatically; the
    (n_dev,)-pinned stat accumulators are rebucketed total-preserving."""

    def test_ppo_8_to_2_and_back(self):
        import jax.numpy as jnp
        from jax.sharding import Mesh

        from griduniverse_tpu.models import reshard_stats

        mesh8 = make_env_mesh()
        mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("env",))
        level = small_level()
        ts = ppo_init_sharded(
            mesh8, SEM, level, jax.random.PRNGKey(10), PPO_CFG,
            batch_size=16,
        )
        ts = ppo_run_sharded(mesh8, SEM, level, ts, PPO_CFG, num_updates=4)
        eps_total = int(jnp.sum(ts.episodes))

        ts2 = reshard_stats(ts, mesh2)
        assert ts2.episodes.shape == (2,)
        assert int(jnp.sum(ts2.episodes)) == eps_total
        ts2 = ppo_run_sharded(mesh2, SEM, level, ts2, PPO_CFG, num_updates=3)
        assert int(ts2.update) == 7
        assert int(jnp.sum(ts2.episodes)) >= eps_total
        assert np.isfinite(float(ts2.last_loss))

        # ...and back up to 8 devices
        ts8 = reshard_stats(ts2, mesh8)
        ts8 = ppo_run_sharded(mesh8, SEM, level, ts8, PPO_CFG, num_updates=2)
        assert int(ts8.update) == 9
        r = ppo_result(ts8)
        assert np.isfinite(float(r.mean_return))

    def test_dqn_per_elastic(self):
        import dataclasses

        import jax.numpy as jnp
        from jax.sharding import Mesh

        from griduniverse_tpu.models import reshard_stats

        mesh8 = make_env_mesh()
        mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("env",))
        level = small_level()
        cfg = dataclasses.replace(DQN_CFG, prioritized=True)
        ts = dqn_init_sharded(
            mesh8, SEM, level, jax.random.PRNGKey(11), cfg, batch_size=8
        )
        ts = dqn_run_sharded(mesh8, SEM, level, ts, cfg, num_steps=8)
        p_max_global = float(jnp.max(ts.p_max))

        ts4 = reshard_stats(ts, mesh4)
        assert ts4.p_max.shape == (4,)
        assert float(jnp.max(ts4.p_max)) == p_max_global
        # replay contents survive the mesh change as data
        np.testing.assert_array_equal(
            np.asarray(ts4.buf.obs), np.asarray(ts.buf.obs)
        )
        ts4 = dqn_run_sharded(mesh4, SEM, level, ts4, cfg, num_steps=6)
        assert int(ts4.t) == 14
        assert np.isfinite(float(ts4.last_loss))

    def test_dqn_elastic_gated_on_full_buffer(self):
        """A partially-filled replay buffer must refuse to reshard: the
        per-shard valid-region derivation would expose never-written
        slots on the new mesh."""
        import pytest
        from jax.sharding import Mesh

        from griduniverse_tpu.models import reshard_stats

        mesh8 = make_env_mesh()
        mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("env",))
        level = small_level()
        ts = dqn_init_sharded(
            mesh8, SEM, level, jax.random.PRNGKey(12), DQN_CFG,
            batch_size=8,
        )
        # 4 steps × 8 envs = 32 written < capacity 64
        ts = dqn_run_sharded(mesh8, SEM, level, ts, DQN_CFG, num_steps=4)
        with pytest.raises(ValueError, match="FULL replay"):
            reshard_stats(ts, mesh4)

    def test_elastic_indivisible_batch_raises(self):
        import pytest
        from jax.sharding import Mesh

        from griduniverse_tpu.models import reshard_stats

        mesh8 = make_env_mesh()
        mesh3 = Mesh(np.asarray(jax.devices()[:3]), ("env",))
        level = small_level()
        ts = ppo_init_sharded(
            mesh8, SEM, level, jax.random.PRNGKey(13), PPO_CFG,
            batch_size=16,
        )
        with pytest.raises(ValueError, match="divisible"):
            reshard_stats(ts, mesh3)

    def test_reshard_returns_host_leaves(self):
        """The rebuilt stat leaves must be host (numpy) arrays so the
        next run_sharded on a DIFFERENT mesh can commit them freely."""
        from jax.sharding import Mesh

        from griduniverse_tpu.models import reshard_stats

        mesh8 = make_env_mesh()
        mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("env",))
        level = small_level()
        ts = ppo_init_sharded(
            mesh8, SEM, level, jax.random.PRNGKey(14), PPO_CFG,
            batch_size=16,
        )
        ts = ppo_run_sharded(mesh8, SEM, level, ts, PPO_CFG, num_updates=1)
        ts2 = reshard_stats(ts, mesh2)
        for leaf in jax.tree_util.tree_leaves(ts2):
            assert isinstance(leaf, np.ndarray), type(leaf)
