"""TD and MC solver tests — update-rule bit-parity vs a NumPy sequential
oracle, plus convergence gates (SURVEY.md §4: "MC/TD reach the goal after
training")."""

import jax
import jax.numpy as jnp
import numpy as np

from griduniverse_tpu import build_model_table, make_semantics
from griduniverse_tpu.algos import (
    apply_td_updates,
    double_q_learning,
    greedy_policy_from_q,
    mc_control,
    mc_prediction,
    q_learning,
    run_greedy_episode,
    sarsa,
    td_error_qlearning,
    value_iteration,
)
from griduniverse_tpu.algos.mc import discounted_returns, first_visit_mask
from griduniverse_tpu.levels.builders import make_level_from_indices
from griduniverse_tpu.utils.oracle import OracleGridEnv

SEM = make_semantics()


def small_level():
    # 4x4, goal bottom-right, one lava pit
    return make_level_from_indices((4, 4), start_idx=0, lava=[5], goals=[15])


class TestUpdateRuleParity:
    """B=1 batched update == the reference's sequential scalar update,
    bit-for-bit, on identical pre-drawn transition streams."""

    def test_q_learning_update_bitparity(self):
        level = small_level()
        env = OracleGridEnv(np.asarray(level.grid), int(level.start_idx), auto_reset=True)
        rng = np.random.default_rng(3)
        alpha, gamma = np.float32(0.5), np.float32(0.9)

        # NumPy sequential oracle
        q_np = np.zeros((16, 4), np.float32)
        transitions = []
        s = env.reset()
        for _ in range(500):
            a = int(rng.integers(0, 4))
            s2, r, d, _ = env.step(a)
            transitions.append((s, a, r, s2, d))
            target = r if d else r + gamma * q_np[s2].max()
            q_np[s, a] = q_np[s, a] + alpha * np.float32(target - q_np[s, a])
            s = env.agent_idx  # post-(auto)reset state
        q_np = q_np.astype(np.float32)

        # JAX: same transitions through the batched (B=1) update path
        ts = jnp.asarray([[t[0]] for t in transitions], jnp.int32)
        ta = jnp.asarray([[t[1]] for t in transitions], jnp.int32)
        tr = jnp.asarray([[t[2]] for t in transitions], jnp.float32)
        ts2 = jnp.asarray([[t[3]] for t in transitions], jnp.int32)
        td = jnp.asarray([[t[4]] for t in transitions], bool)

        def body(q, x):
            s, a, r, s2, d = x
            delta = td_error_qlearning(q, s, a, r, s2, d, gamma)
            return apply_td_updates(q, s, a, delta, alpha), None

        q_jax, _ = jax.lax.scan(
            body, jnp.zeros((16, 4), jnp.float32), (ts, ta, tr, ts2, td)
        )
        np.testing.assert_array_equal(np.asarray(q_jax), q_np)


class TestConvergence:
    def test_q_learning_reaches_optimal_policy(self):
        level = small_level()
        res = q_learning(
            SEM, level, jax.random.PRNGKey(0),
            num_steps=3000, batch_size=64, alpha=0.2, gamma=0.99, epsilon=0.2,
        )
        assert int(res.episodes) > 100
        policy = greedy_policy_from_q(res.q)
        obs, ret, length, done = run_greedy_episode(
            SEM, level, policy, jax.random.PRNGKey(1), max_steps=20
        )
        assert bool(done)
        grid = np.asarray(level.grid).reshape(-1)
        assert grid[int(np.asarray(obs)[int(length) - 1])] == 3  # GOAL
        assert int(length) == 6  # shortest path in 4x4 from 0 to 15

    def test_double_q_learning_reaches_optimal_policy(self):
        self._check_double_q("per_env")

    def test_double_q_learning_global_coin_mode(self):
        self._check_double_q("global")

    def _check_double_q(self, coin):
        level = small_level()
        res = double_q_learning(
            SEM, level, jax.random.PRNGKey(7),
            num_steps=4000, batch_size=64, alpha=0.2, gamma=0.99, epsilon=0.2,
            coin=coin,
        )
        assert int(res.episodes) > 100
        # both tables trained (the per-step coin picked each side)
        assert float(jnp.abs(res.q_a).sum()) > 0
        assert float(jnp.abs(res.q_b).sum()) > 0
        policy = greedy_policy_from_q(res.q)
        _, _, length, done = run_greedy_episode(
            SEM, level, policy, jax.random.PRNGKey(1), max_steps=20
        )
        assert bool(done)
        assert int(length) == 6  # optimal path length, as plain Q-learning

        # determinism: same seed, bit-identical tables
        res2 = double_q_learning(
            SEM, level, jax.random.PRNGKey(7),
            num_steps=4000, batch_size=64, alpha=0.2, gamma=0.99, epsilon=0.2,
            coin=coin,
        )
        np.testing.assert_array_equal(np.asarray(res.q), np.asarray(res2.q))

    def test_sarsa_reaches_goal(self):
        level = small_level()
        res = sarsa(
            SEM, level, jax.random.PRNGKey(2),
            num_steps=3000, batch_size=64, alpha=0.2, gamma=0.99, epsilon=0.2,
        )
        policy = greedy_policy_from_q(res.q)
        _, _, length, done = run_greedy_episode(
            SEM, level, policy, jax.random.PRNGKey(3), max_steps=20
        )
        assert bool(done)

    def test_q_learning_q_close_to_vi_optimal(self):
        level = small_level()
        model = build_model_table(SEM, level)
        v_star, _, _ = value_iteration(model, gamma=0.99, theta=1e-6)
        res = q_learning(
            SEM, level, jax.random.PRNGKey(4),
            num_steps=8000, batch_size=128, alpha=0.1, gamma=0.99, epsilon=0.3,
        )
        v_q = np.asarray(res.q).max(axis=1)
        # compare on states along the optimal path (well-visited ones)
        reachable = np.asarray(v_star) != 0.0
        np.testing.assert_allclose(
            v_q[reachable], np.asarray(v_star)[reachable], atol=0.6
        )


class TestMC:
    def test_discounted_returns(self):
        r = jnp.asarray([[1.0], [1.0], [1.0]])
        g = discounted_returns(r, 0.5)
        np.testing.assert_allclose(np.asarray(g)[:, 0], [1.75, 1.5, 1.0])

    def test_first_visit_mask(self):
        ids = jnp.asarray([[0], [1], [0], [2], [1]], jnp.int32)
        valid = jnp.asarray([[True], [True], [True], [True], [False]])
        m = first_visit_mask(ids, valid)
        np.testing.assert_array_equal(
            np.asarray(m)[:, 0], [True, True, False, True, False]
        )

    def test_mc_prediction_corridor_analytic(self):
        # 1x3 corridor s o g, deterministic RIGHT policy: V(0) = -1 + γ·10
        level = make_level_from_indices((1, 3), start_idx=0, goals=[2])
        q_right = jnp.zeros((3, 4), jnp.float32).at[:, 1].set(1.0)  # greedy=RIGHT
        res = mc_prediction(
            SEM, level, jax.random.PRNGKey(5),
            policy_q=q_right, gamma=0.99, epsilon=0.0,
            batch_size=8, max_steps=10,
        )
        v = np.asarray(res.value)
        np.testing.assert_allclose(v[0], -1 + 0.99 * 10.0, atol=1e-5)
        np.testing.assert_allclose(v[1], 10.0, atol=1e-5)

    def test_mc_prediction_truncation_unbiased(self):
        """With a binding step budget, unfinished
        episodes carry PARTIAL returns and must be excluded. Pin the exact
        semantics against a straight-line NumPy aggregation of the SAME
        rolled episodes (finished-only, first-visit), and prove the old
        everything-counts estimator actually differs here (the limit binds).
        """
        from griduniverse_tpu.algos.mc import _roll_episodes

        level = small_level()
        key = jax.random.PRNGKey(11)
        gamma, B, T = 0.9, 256, 6  # random policy, T=6 binds hard on 4x4

        s, _, r, valid, finished = (
            np.asarray(x)
            for x in _roll_episodes(SEM, level, None, key, B, T, 0.0)
        )
        assert 0 < finished.sum() < B  # both populations present

        # exact finished-episode-only first-visit aggregation
        g = np.zeros_like(r)
        acc = np.zeros(B, np.float32)
        for t in reversed(range(T)):
            acc = r[t] + np.float32(gamma) * acc
            g[t] = acc
        v_sum = np.zeros(16, np.float64)
        n = np.zeros(16, np.float64)
        for b in range(B):
            if not finished[b]:
                continue
            seen = set()
            for t in range(T):
                if not valid[t, b] or s[t, b] in seen:
                    continue
                seen.add(s[t, b])
                v_sum[s[t, b]] += g[t, b]
                n[s[t, b]] += 1
        v_np = np.where(n > 0, v_sum / np.maximum(n, 1), 0.0)

        res = mc_prediction(
            SEM, level, key, policy_q=None, gamma=gamma,
            batch_size=B, max_steps=T,
        )
        np.testing.assert_array_equal(np.asarray(res.counts), n)
        np.testing.assert_allclose(np.asarray(res.value), v_np, atol=1e-4)

        # the biased estimator measurably disagrees on this level
        res_biased = mc_prediction(
            SEM, level, key, policy_q=None, gamma=gamma,
            batch_size=B, max_steps=T, include_unfinished=True,
        )
        assert np.abs(np.asarray(res_biased.value) - v_np).max() > 0.05

    def test_mc_control_reaches_goal(self):
        level = small_level()
        res = mc_control(
            SEM, level, jax.random.PRNGKey(6),
            num_rounds=40, gamma=0.99, epsilon=0.2, alpha=0.1,
            batch_size=64, max_steps=30,
        )
        policy = greedy_policy_from_q(res.q)
        _, _, length, done = run_greedy_episode(
            SEM, level, policy, jax.random.PRNGKey(7), max_steps=20
        )
        assert bool(done)
        grid = np.asarray(level.grid).reshape(-1)
