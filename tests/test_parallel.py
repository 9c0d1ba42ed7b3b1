"""Distributed tests on the virtual 8-device CPU mesh (SURVEY.md §4).

Gates (BASELINE config 5): sharded solver reaches the optimal policy;
distributed learner matches the single-device learner; sharded rollout
stats match unsharded semantics; works on 1-D and 2-D meshes.
"""

import jax
import numpy as np
import pytest

from griduniverse_tpu import build_model_table, make_semantics
from griduniverse_tpu.algos import (
    greedy_policy_from_q,
    q_learning,
    run_greedy_episode,
    value_iteration,
)
from griduniverse_tpu.levels.builders import (
    lava_level,
    make_level_from_indices,
    walls_and_goal_16x16,
)
from griduniverse_tpu.parallel import (
    episode_stats_sharded,
    make_env_mesh,
    make_host_env_mesh,
    q_learning_sharded,
    reset_batch_sharded,
    value_iteration_sharded,
)

SEM = make_semantics()


def small_level():
    return make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15])


@pytest.fixture(scope="module")
def mesh1d():
    return make_env_mesh()


@pytest.fixture(scope="module")
def mesh2d():
    return make_host_env_mesh()


def test_mesh_shapes(mesh1d, mesh2d):
    assert mesh1d.size == 8  # conftest forces 8 CPU devices
    assert mesh1d.axis_names == ("env",)
    assert mesh2d.axis_names == ("host", "env")
    assert mesh2d.size == 8


class TestShardedRollout:
    def test_state_is_sharded(self, mesh1d):
        level = lava_level()
        state = reset_batch_sharded(mesh1d, level, jax.random.PRNGKey(0), 64)
        assert state.agent_idx.shape == (64,)
        shardings = {
            str(d) for d in state.agent_idx.sharding.device_set
        }
        assert len(shardings) == 8  # spread over all devices

    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_episode_stats_sane(self, mesh_name, request):
        mesh = request.getfixturevalue(mesh_name)
        level = lava_level()
        state, stats = episode_stats_sharded(
            mesh, SEM, level, jax.random.PRNGKey(1), 256, 200
        )
        assert int(stats["episodes"]) > 0
        assert float(stats["mean_length"]) > 1.0

    def test_indivisible_batch_raises(self, mesh1d):
        with pytest.raises(ValueError, match="divisible"):
            reset_batch_sharded(mesh1d, lava_level(), jax.random.PRNGKey(0), 63)


class TestShardedVI:
    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_matches_single_device_vi(self, mesh_name, request):
        mesh = request.getfixturevalue(mesh_name)
        level = walls_and_goal_16x16()  # S=256, divides 8
        model = build_model_table(SEM, level)
        v1, p1, _ = value_iteration(model, gamma=0.99, theta=1e-6)
        v8, p8, iters = value_iteration_sharded(
            mesh, model, gamma=0.99, theta=1e-6
        )
        np.testing.assert_allclose(np.asarray(v8), np.asarray(v1), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(p8), np.asarray(p1))
        assert int(iters) > 1

    def test_padding_path(self, mesh1d):
        level = lava_level()  # S=81, does NOT divide 8 → exercises padding
        model = build_model_table(SEM, level)
        v1, p1, _ = value_iteration(model, gamma=0.99, theta=1e-6)
        v8, p8, _ = value_iteration_sharded(mesh1d, model, gamma=0.99, theta=1e-6)
        np.testing.assert_allclose(np.asarray(v8), np.asarray(v1), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(p8), np.asarray(p1))


class TestDistributedQLearning:
    def test_parity_mode_bitexact_vs_single_device(self, mesh1d):
        """parity=True: identical random streams + identical global
        segment_sum on every replica → Q tables and trajectories (episode
        counts) match the single-device run BIT-FOR-BIT."""
        level = small_level()
        key = jax.random.PRNGKey(0)
        res1 = q_learning(
            SEM, level, key, num_steps=500, batch_size=64,
            alpha=0.2, gamma=0.99, epsilon=0.2,
        )
        res8 = q_learning_sharded(
            mesh1d, SEM, level, key, num_steps=500, batch_size=64,
            alpha=0.2, gamma=0.99, epsilon=0.2, parity=True,
        )
        np.testing.assert_array_equal(np.asarray(res8.q), np.asarray(res1.q))
        assert int(res8.episodes) == int(res1.episodes)

    def test_psum_mode_close_and_converges(self, mesh1d):
        """Default psum mode: float association may flip greedy ties early
        on (trajectories diverge), but training still reaches the optimal
        policy."""
        level = small_level()
        res = q_learning_sharded(
            mesh1d, SEM, level, jax.random.PRNGKey(0),
            num_steps=2500, batch_size=128, alpha=0.2, gamma=0.99, epsilon=0.2,
        )
        policy = greedy_policy_from_q(res.q)
        _, _, length, done = run_greedy_episode(SEM, level, policy, max_steps=20)
        assert bool(done)
        assert int(length) == 6

    def test_2d_mesh_converges_to_goal(self, mesh2d):
        level = small_level()
        res = q_learning_sharded(
            mesh2d, SEM, level, jax.random.PRNGKey(3),
            num_steps=2500, batch_size=128, alpha=0.2, gamma=0.99, epsilon=0.2,
        )
        policy = greedy_policy_from_q(res.q)
        _, _, length, done = run_greedy_episode(SEM, level, policy, max_steps=20)
        assert bool(done)
        assert int(length) == 6

    def test_sarsa_variant_runs(self, mesh1d):
        level = small_level()
        res = q_learning_sharded(
            mesh1d, SEM, level, jax.random.PRNGKey(4),
            num_steps=300, batch_size=64, algo="sarsa",
        )
        assert np.isfinite(np.asarray(res.q)).all()

    def test_psum_every_converges_to_goal(self, mesh1d):
        """psum_every=k pools k steps of TD aggregates into one
        all-reduce against the window-start Q — different α-dynamics,
        same optimal policy."""
        level = small_level()
        res = q_learning_sharded(
            mesh1d, SEM, level, jax.random.PRNGKey(5),
            num_steps=2500, batch_size=128, alpha=0.2, gamma=0.99,
            epsilon=0.2, psum_every=5,
        )
        policy = greedy_policy_from_q(res.q)
        _, _, length, done = run_greedy_episode(
            SEM, level, policy, max_steps=20
        )
        assert bool(done)
        assert int(length) == 6

    def test_psum_every_one_is_the_per_step_path(self, mesh1d):
        """k=1 must be EXACTLY the default path (same program, same
        bits), so the windowed mode can never drift the baseline."""
        level = small_level()
        kw = dict(num_steps=200, batch_size=64, alpha=0.2, epsilon=0.2)
        a = q_learning_sharded(
            mesh1d, SEM, level, jax.random.PRNGKey(6), **kw
        )
        b = q_learning_sharded(
            mesh1d, SEM, level, jax.random.PRNGKey(6), psum_every=1, **kw
        )
        np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))

    def test_psum_every_validation(self, mesh1d):
        level = small_level()
        with pytest.raises(ValueError, match="parity"):
            q_learning_sharded(
                mesh1d, SEM, level, jax.random.PRNGKey(0),
                num_steps=10, batch_size=64, parity=True, psum_every=2,
            )
        with pytest.raises(ValueError, match="divisible"):
            q_learning_sharded(
                mesh1d, SEM, level, jax.random.PRNGKey(0),
                num_steps=7, batch_size=64, psum_every=2,
            )
        with pytest.raises(ValueError, match="psum_every"):
            q_learning_sharded(
                mesh1d, SEM, level, jax.random.PRNGKey(0),
                num_steps=10, batch_size=64, psum_every=0,
            )


class TestDeterminismAcrossMeshSizes:
    """SURVEY.md §5: determinism tests across device counts stand in for
    race-detection — parity mode must be invariant to HOW envs are sharded."""

    def test_parity_mode_invariant_to_mesh_size(self):
        level = small_level()
        key = jax.random.PRNGKey(0)
        results = []
        for n in (1, 2, 4, 8):
            mesh = make_env_mesh(num_devices=n)
            res = q_learning_sharded(
                mesh, SEM, level, key, num_steps=200, batch_size=64,
                alpha=0.2, gamma=0.99, epsilon=0.2, parity=True,
            )
            results.append(np.asarray(res.q))
        for other in results[1:]:
            np.testing.assert_array_equal(results[0], other)


class TestTDLambdaSharded:
    """Distributed TD(λ): per-env traces stay shard-local, Q replicated,
    psum'd trace-weighted updates (parallel/learner.py)."""

    def test_sarsa_lambda_sharded_converges(self):
        from griduniverse_tpu.parallel import td_lambda_sharded
        from griduniverse_tpu.algos import greedy_policy_from_q, run_greedy_episode

        mesh = make_env_mesh()
        level = small_level()
        res = td_lambda_sharded(
            mesh, SEM, level, jax.random.PRNGKey(5),
            num_steps=3000, batch_size=64,
            alpha=0.2, gamma=0.99, epsilon=0.2, lam=0.9,
        )
        assert int(res.episodes) > 50
        policy = greedy_policy_from_q(res.q)
        obs, _, length, done = run_greedy_episode(
            SEM, level, policy, jax.random.PRNGKey(1), max_steps=20
        )
        assert bool(done)
        assert int(length) == 6

    def test_watkins_sharded_deterministic_same_key(self):
        from griduniverse_tpu.parallel import td_lambda_sharded

        mesh = make_env_mesh()
        level = small_level()
        a = td_lambda_sharded(
            mesh, SEM, level, jax.random.PRNGKey(3),
            num_steps=300, batch_size=32, algo="watkins",
        )
        b = td_lambda_sharded(
            mesh, SEM, level, jax.random.PRNGKey(3),
            num_steps=300, batch_size=32, algo="watkins",
        )
        np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
        assert int(a.episodes) == int(b.episodes)


class TestShardedPolicyIteration:
    """parallel.dp.policy_iteration_sharded (r3: completes the distributed
    tabular DP family)."""

    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_matches_single_device_pi(self, mesh_name, request):
        from griduniverse_tpu.algos import policy_iteration
        from griduniverse_tpu.parallel import policy_iteration_sharded

        mesh = request.getfixturevalue(mesh_name)
        level = walls_and_goal_16x16()
        model = build_model_table(SEM, level)
        v1, p1, it1 = policy_iteration(model, gamma=0.99, theta=1e-6)
        v8, p8, it8 = policy_iteration_sharded(
            mesh, model, gamma=0.99, theta=1e-6
        )
        np.testing.assert_allclose(np.asarray(v8), np.asarray(v1), atol=1e-4)
        np.testing.assert_array_equal(np.asarray(p8), np.asarray(p1))
        assert int(it8) >= 2

    def test_padding_path(self, mesh1d):
        from griduniverse_tpu.algos import policy_iteration
        from griduniverse_tpu.parallel import policy_iteration_sharded

        level = lava_level()  # S=81 → exercises state padding
        model = build_model_table(SEM, level)
        v1, p1, _ = policy_iteration(model, gamma=0.99, theta=1e-6)
        v8, p8, _ = policy_iteration_sharded(
            mesh1d, model, gamma=0.99, theta=1e-6
        )
        np.testing.assert_allclose(np.asarray(v8), np.asarray(v1), atol=1e-4)
        np.testing.assert_array_equal(np.asarray(p8), np.asarray(p1))


class TestShardedMCControl:
    """parallel.learner.mc_control_sharded (r3: completes the distributed
    sampling-solver family)."""

    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_parity_mode_bitexact_vs_single_device(self, mesh_name, request):
        # mesh2d exercises the multi-axis all_gather ordering: the
        # host-major/env-minor concat must reproduce the single-device
        # env ordering exactly
        from griduniverse_tpu.algos import mc_control
        from griduniverse_tpu.parallel import mc_control_sharded

        mesh = request.getfixturevalue(mesh_name)
        level = small_level()
        key = jax.random.PRNGKey(3)
        r1 = mc_control(
            SEM, level, key, num_rounds=6, batch_size=64, max_steps=24
        )
        r8 = mc_control_sharded(
            mesh, SEM, level, key, num_rounds=6, batch_size=64,
            max_steps=24, parity=True,
        )
        np.testing.assert_array_equal(np.asarray(r8.q), np.asarray(r1.q))
        assert int(r8.episodes) == int(r1.episodes)

    def test_scalable_mode_converges_to_goal(self, mesh1d):
        from griduniverse_tpu.algos import greedy_policy_from_q, run_greedy_episode
        from griduniverse_tpu.parallel import mc_control_sharded

        level = small_level()
        res = mc_control_sharded(
            mesh1d, SEM, level, jax.random.PRNGKey(0),
            num_rounds=40, batch_size=256, max_steps=40, epsilon=0.2,
        )
        policy = greedy_policy_from_q(res.q)
        _, ret, _, done = run_greedy_episode(SEM, level, policy, max_steps=40)
        assert bool(done) and float(ret) > 0

    def test_indivisible_batch_raises(self, mesh1d):
        from griduniverse_tpu.parallel import mc_control_sharded

        with pytest.raises(ValueError, match="divisible"):
            mc_control_sharded(
                mesh1d, SEM, small_level(), jax.random.PRNGKey(0),
                num_rounds=1, batch_size=9,
            )


class TestShardedPrediction:
    """The prediction members of the distributed family:
    mc_prediction_sharded and td_lambda_prediction_sharded."""

    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_mc_prediction_parity_bitexact(self, mesh_name, request):
        from griduniverse_tpu.algos.mc import mc_prediction
        from griduniverse_tpu.parallel import mc_prediction_sharded

        mesh = request.getfixturevalue(mesh_name)
        level = small_level()
        key = jax.random.PRNGKey(5)
        r1 = mc_prediction(SEM, level, key, batch_size=64, max_steps=24)
        r8 = mc_prediction_sharded(
            mesh, SEM, level, key, batch_size=64, max_steps=24, parity=True
        )
        np.testing.assert_array_equal(
            np.asarray(r8.value), np.asarray(r1.value)
        )
        np.testing.assert_array_equal(
            np.asarray(r8.counts), np.asarray(r1.counts)
        )

    def test_mc_prediction_policy_q_parity(self, mesh1d):
        from griduniverse_tpu.algos.mc import mc_prediction
        from griduniverse_tpu.parallel import mc_prediction_sharded

        level = small_level()
        key = jax.random.PRNGKey(6)
        q = jax.random.normal(jax.random.PRNGKey(7), (16, 4))
        r1 = mc_prediction(
            SEM, level, key, policy_q=q, batch_size=64, max_steps=24
        )
        r8 = mc_prediction_sharded(
            mesh1d, SEM, level, key, policy_q=q, batch_size=64,
            max_steps=24, parity=True,
        )
        np.testing.assert_array_equal(
            np.asarray(r8.value), np.asarray(r1.value)
        )

    def test_mc_prediction_scalable_mode_sane(self, mesh1d):
        from griduniverse_tpu.parallel import mc_prediction_sharded

        res = mc_prediction_sharded(
            mesh1d, SEM, small_level(), jax.random.PRNGKey(0),
            batch_size=256, max_steps=40,
        )
        v = np.asarray(res.value)
        assert np.isfinite(v).all()
        # visited states under the random policy got samples
        assert float(np.asarray(res.counts).sum()) > 0

    def test_mc_prediction_rejects_batched_level(self, mesh1d):
        import jax.numpy as jnp

        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.parallel import mc_prediction_sharded

        grid = jnp.broadcast_to(small_level().grid, (8, 4, 4))
        with pytest.raises(ValueError, match="shared"):
            mc_prediction_sharded(
                mesh1d, SEM,
                Level(grid=grid, start_idx=jnp.zeros((8,), jnp.int32)),
                jax.random.PRNGKey(0), batch_size=8,
            )

    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_td_lambda_prediction_parity_bitexact(self, mesh_name, request):
        import jax.numpy as jnp

        from griduniverse_tpu.algos.td_lambda import td_lambda_prediction
        from griduniverse_tpu.parallel import td_lambda_prediction_sharded

        mesh = request.getfixturevalue(mesh_name)
        level = small_level()
        key = jax.random.PRNGKey(8)
        pol = jnp.full((16, 4), 0.25, jnp.float32)
        r1 = td_lambda_prediction(
            SEM, level, pol, key, num_steps=60, batch_size=16
        )
        r8 = td_lambda_prediction_sharded(
            mesh, SEM, level, pol, key, num_steps=60, batch_size=16,
            parity=True,
        )
        np.testing.assert_array_equal(np.asarray(r8.v), np.asarray(r1.v))
        assert int(r8.episodes) == int(r1.episodes)

    def test_td_lambda_prediction_scalable_close_to_dp(self, mesh1d):
        """V^π from sharded TD(λ) under the optimal policy should
        approach the DP policy-evaluation fixed point on visited states."""
        import jax.numpy as jnp

        from griduniverse_tpu.algos.dp import policy_evaluation
        from griduniverse_tpu.parallel import td_lambda_prediction_sharded

        level = small_level()
        model = build_model_table(SEM, level)
        _, pi_star, _ = value_iteration(model, gamma=0.95)
        pol = jax.nn.one_hot(pi_star, 4, dtype=jnp.float32)
        v_dp, _ = policy_evaluation(model, pol, gamma=0.95)
        res = td_lambda_prediction_sharded(
            mesh1d, SEM, level, pol, jax.random.PRNGKey(0),
            num_steps=3000, batch_size=64, alpha=0.08, gamma=0.95, lam=0.9,
        )
        start = int(np.asarray(level.start_idx))
        assert abs(float(res.v[start]) - float(v_dp[start])) < 0.3


class TestShardedGridVI:
    """value_iteration_batched_grid_sharded (r4): the static-candidate
    backup on the maze-sharded axis."""

    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_matches_unsharded_grid_form(self, mesh_name, request):
        import jax.numpy as jnp

        from griduniverse_tpu.algos import value_iteration_batched_grid
        from griduniverse_tpu.core import semantics as SEMA
        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.levels.maze import generate_mazes_device
        from griduniverse_tpu.parallel import (
            value_iteration_batched_grid_sharded,
        )

        mesh = request.getfixturevalue(mesh_name)
        grids, start = generate_mazes_device(
            jax.random.PRNGKey(4), (3, 3), 16, algorithm="binary_tree"
        )
        grids = grids.at[:, 5, 5].set(SEMA.GOAL)
        levels = Level(grid=grids, start_idx=jnp.broadcast_to(start, (16,)))
        v1, p1, i1 = value_iteration_batched_grid(SEM, levels)
        v8, p8, i8 = value_iteration_batched_grid_sharded(mesh, SEM, levels)
        np.testing.assert_allclose(
            np.asarray(v1), np.asarray(v8), atol=1e-5, rtol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p8))
        assert int(i8) >= int(i1)  # lockstep sweeps run to global max

    def test_indivisible_maze_count_raises(self, mesh1d):
        import jax.numpy as jnp

        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.parallel import (
            value_iteration_batched_grid_sharded,
        )

        grid = jnp.zeros((9, 4, 4), jnp.int32)
        with pytest.raises(ValueError, match="divisible"):
            value_iteration_batched_grid_sharded(
                mesh1d, SEM,
                Level(grid=grid, start_idx=jnp.zeros((9,), jnp.int32)),
            )


class TestShardedGridPI:
    """policy_iteration_batched_grid_sharded (r4): grid-form Howard PI on
    the maze-sharded axis."""

    @pytest.mark.parametrize("mesh_name", ["mesh1d", "mesh2d"])
    def test_matches_unsharded_grid_form(self, mesh_name, request):
        import jax.numpy as jnp

        from griduniverse_tpu.algos import policy_iteration_batched_grid
        from griduniverse_tpu.core import semantics as SEMA
        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.levels.maze import generate_mazes_device
        from griduniverse_tpu.parallel import (
            policy_iteration_batched_grid_sharded,
        )

        mesh = request.getfixturevalue(mesh_name)
        grids, start = generate_mazes_device(
            jax.random.PRNGKey(5), (3, 3), 16, algorithm="aldous_broder"
        )
        grids = grids.at[:, 5, 5].set(SEMA.GOAL)
        levels = Level(grid=grids, start_idx=jnp.broadcast_to(start, (16,)))
        v1, p1, i1 = policy_iteration_batched_grid(SEM, levels)
        v8, p8, i8 = policy_iteration_batched_grid_sharded(mesh, SEM, levels)
        np.testing.assert_allclose(
            np.asarray(v1), np.asarray(v8), atol=1e-5, rtol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p8))
        assert int(i8) >= int(i1)  # outer loop runs to global stability
