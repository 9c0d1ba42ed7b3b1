"""Neural learner tests (A2C + PPO): single-device training learns the
task; sharded training matches semantics and converges (all-reduce grads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from griduniverse_tpu import make_semantics
from griduniverse_tpu.levels.builders import make_level_from_indices
from griduniverse_tpu.models import (
    A2CConfig,
    a2c_train,
    a2c_train_sharded,
    greedy_actions,
    make_network,
)
from griduniverse_tpu.parallel import make_env_mesh

SEM = make_semantics()


def corridor_level():
    # 2x6: short corridor to a goal — easy credit assignment
    return make_level_from_indices((2, 6), start_idx=0, goals=[5])


@pytest.fixture(scope="module")
def cfg():
    return A2CConfig(rollout_len=8, lr=3e-3, ent_coef=0.01, hidden=(64,), embed_dim=32)


def _greedy_rollout_reaches_goal(level, params, cfg, max_steps=12):
    from griduniverse_tpu.core.step import reset, step

    net = make_network(level, 4, cfg)
    state = reset(level, jax.random.PRNGKey(0))
    for _ in range(max_steps):
        a = greedy_actions(net, params, state.agent_idx[None])[0]
        state, out = step(SEM, level, state, a)
        if bool(out.done):
            return True, float(out.reward)
    return False, 0.0


def test_a2c_learns_corridor(cfg):
    level = corridor_level()
    res = a2c_train(
        SEM, level, jax.random.PRNGKey(0), cfg,
        num_updates=300, batch_size=64,
    )
    assert int(res.episodes) > 50
    assert np.isfinite(float(res.final_loss))
    done, r = _greedy_rollout_reaches_goal(level, res.params, cfg)
    assert done and r == 10.0


def test_a2c_sharded_converges(cfg):
    mesh = make_env_mesh()
    level = corridor_level()
    res = a2c_train_sharded(
        mesh, SEM, level, jax.random.PRNGKey(0), cfg,
        num_updates=300, batch_size=64,
    )
    assert int(res.episodes) > 50
    done, r = _greedy_rollout_reaches_goal(level, res.params, cfg)
    assert done and r == 10.0


def test_a2c_sharded_params_replicated(cfg):
    mesh = make_env_mesh()
    level = corridor_level()
    res = a2c_train_sharded(
        mesh, SEM, level, jax.random.PRNGKey(1), cfg,
        num_updates=5, batch_size=64,
    )
    # every leaf must be fully replicated (no device holds a shard)
    for leaf in jax.tree.leaves(res.params):
        assert leaf.sharding.is_fully_replicated


def test_a2c_batch_divisibility(cfg):
    mesh = make_env_mesh()
    with pytest.raises(ValueError, match="divisible"):
        a2c_train_sharded(
            mesh, SEM, corridor_level(), jax.random.PRNGKey(0), cfg,
            num_updates=1, batch_size=63,
        )


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

from griduniverse_tpu.models import (  # noqa: E402
    PPOConfig,
    gae_advantages,
    ppo_train,
    ppo_train_sharded,
)


@pytest.fixture(scope="module")
def ppo_cfg():
    return PPOConfig(
        rollout_len=8,
        lr=3e-3,
        num_epochs=2,
        num_minibatches=2,
        ent_coef=0.01,
        hidden=(64,),
        embed_dim=32,
    )


def test_gae_matches_numpy_reference():
    """GAE(λ) reverse scan equals a straightforward NumPy backward loop,
    including across auto-reset episode boundaries."""
    from griduniverse_tpu.models.ppo import _Traj

    rng = np.random.default_rng(0)
    T, B = 12, 5
    gamma, lam = 0.97, 0.9
    value = rng.normal(size=(T, B)).astype(np.float32)
    reward = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random(size=(T, B)) < 0.25
    bootstrap = rng.normal(size=(B,)).astype(np.float32)

    traj = _Traj(
        obs=jnp.zeros((T, B), jnp.int32),
        action=jnp.zeros((T, B), jnp.int32),
        logp=jnp.zeros((T, B), jnp.float32),
        value=jnp.asarray(value),
        reward=jnp.asarray(reward),
        done=jnp.asarray(done),
    )
    adv, targets = jax.jit(gae_advantages, static_argnums=(2, 3))(
        traj, jnp.asarray(bootstrap), gamma, lam
    )

    exp = np.zeros((T, B), np.float32)
    carry = np.zeros(B, np.float32)
    v_next = bootstrap
    for t in range(T - 1, -1, -1):
        nd = 1.0 - done[t].astype(np.float32)
        delta = reward[t] + gamma * v_next * nd - value[t]
        carry = delta + gamma * lam * nd * carry
        exp[t] = carry
        v_next = value[t]
    np.testing.assert_allclose(np.asarray(adv), exp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(targets), exp + value, rtol=1e-5, atol=1e-5)


def test_ppo_learns_corridor(ppo_cfg):
    level = corridor_level()
    res = ppo_train(
        SEM, level, jax.random.PRNGKey(0), ppo_cfg,
        num_updates=150, batch_size=64,
    )
    assert int(res.episodes) > 50
    assert np.isfinite(float(res.final_loss))
    done, r = _greedy_rollout_reaches_goal(level, res.params, ppo_cfg)
    assert done and r == 10.0


def test_ppo_sharded_converges(ppo_cfg):
    mesh = make_env_mesh()
    level = corridor_level()
    res = ppo_train_sharded(
        mesh, SEM, level, jax.random.PRNGKey(0), ppo_cfg,
        num_updates=150, batch_size=64,
    )
    assert int(res.episodes) > 50
    done, r = _greedy_rollout_reaches_goal(level, res.params, ppo_cfg)
    assert done and r == 10.0
    for leaf in jax.tree.leaves(res.params):
        assert leaf.sharding.is_fully_replicated


def test_ppo_minibatch_divisibility(ppo_cfg):
    import dataclasses as dc

    bad = dc.replace(ppo_cfg, num_minibatches=7)
    with pytest.raises(ValueError, match="divisible"):
        ppo_train(
            SEM, corridor_level(), jax.random.PRNGKey(0), bad,
            num_updates=1, batch_size=64,
        )


# ---------------------------------------------------------------------------
# DQN
# ---------------------------------------------------------------------------

from griduniverse_tpu.models import (  # noqa: E402
    DQNConfig,
    QNetwork,
    ReplayBuffer,
    buffer_init,
    buffer_sample,
    buffer_write,
    dqn_train,
    dqn_train_sharded,
    greedy_q_actions,
)


@pytest.fixture(scope="module")
def dqn_cfg():
    return DQNConfig(
        lr=2e-3,
        buffer_capacity=1024,
        batch_size_train=64,
        eps_anneal_steps=400,
        learn_start=64,
        hidden=(64,),
        embed_dim=32,
        max_episode_steps=32,
    )


def test_replay_buffer_circular_writes():
    buf = buffer_init(8)
    def batch(v):
        return ReplayBuffer(
            obs=jnp.full(4, v, jnp.int32),
            action=jnp.full(4, v, jnp.int32),
            reward=jnp.full(4, float(v), jnp.float32),
            next_obs=jnp.full(4, v, jnp.int32),
            done=jnp.zeros(4, bool),
        )
    # three writes of 4 into capacity 8: the third wraps onto slot 0
    for t, v in enumerate([1, 2, 3]):
        buf = buffer_write(buf, jnp.int32((t * 4) % 8), batch(v))
    np.testing.assert_array_equal(
        np.asarray(buf.obs), [3, 3, 3, 3, 2, 2, 2, 2]
    )
    mb = buffer_sample(buf, jax.random.PRNGKey(0), jnp.int32(8), 32)
    assert set(np.asarray(mb.obs)) <= {2, 3}


def _greedy_q_reaches_goal(level, params, cfg, max_steps=12):
    from griduniverse_tpu.core.step import reset, step

    net = QNetwork(
        num_states=level.num_states, num_actions=4,
        hidden=cfg.hidden, embed_dim=cfg.embed_dim,
    )
    state = reset(level, jax.random.PRNGKey(0))
    for _ in range(max_steps):
        a = greedy_q_actions(net, params, state.agent_idx[None])[0]
        state, out = step(SEM, level, state, a)
        if bool(out.done):
            return True, float(out.reward)
    return False, 0.0


def test_dqn_learns_corridor(dqn_cfg):
    level = corridor_level()
    res = dqn_train(
        SEM, level, jax.random.PRNGKey(0), dqn_cfg,
        num_steps=800, batch_size=64,
    )
    assert int(res.episodes) > 100
    assert np.isfinite(float(res.final_loss))
    done, r = _greedy_q_reaches_goal(level, res.params, dqn_cfg)
    assert done and r == 10.0


def test_dqn_sharded_converges(dqn_cfg):
    mesh = make_env_mesh()
    level = corridor_level()
    res = dqn_train_sharded(
        mesh, SEM, level, jax.random.PRNGKey(0), dqn_cfg,
        num_steps=800, batch_size=64,
    )
    assert int(res.episodes) > 100
    done, r = _greedy_q_reaches_goal(level, res.params, dqn_cfg)
    assert done and r == 10.0
    for leaf in jax.tree.leaves(res.params):
        assert leaf.sharding.is_fully_replicated


def test_dqn_capacity_divisibility(dqn_cfg):
    import dataclasses as dc

    bad = dc.replace(dqn_cfg, buffer_capacity=1000)  # not divisible by 64
    with pytest.raises(ValueError, match="multiple"):
        dqn_train(
            SEM, corridor_level(), jax.random.PRNGKey(0), bad,
            num_steps=4, batch_size=64,
        )


class TestPrioritizedReplay:
    """Gumbel-top-k proportional PER (models/dqn.py module docs)."""

    def test_sampling_frequency_tracks_priority(self):
        from griduniverse_tpu.models import prioritized_sample

        # 8 slots, one slot 20x the priority of the rest, alpha=1
        prio = jnp.asarray([1, 1, 1, 20, 1, 1, 1, 1], jnp.float32)
        size = jnp.asarray(8)
        counts = np.zeros(8)
        draw = jax.jit(
            lambda k: prioritized_sample(prio, k, size, 1, 1.0, jnp.asarray(0.4))[0]
        )
        for i in range(600):
            counts[int(draw(jax.random.PRNGKey(i))[0])] += 1
        # expected share of slot 3: 20/27 ≈ 0.74
        assert counts[3] / 600 > 0.55
        # every slot reachable
        assert (counts > 0).all()

    def test_uniform_priorities_give_unit_weights(self):
        from griduniverse_tpu.models import prioritized_sample

        prio = jnp.ones(16, jnp.float32)
        idx, w = prioritized_sample(
            prio, jax.random.PRNGKey(0), jnp.asarray(16), 4, 0.6, jnp.asarray(1.0)
        )
        np.testing.assert_allclose(np.asarray(w), 1.0, rtol=1e-6)
        assert len(set(np.asarray(idx).tolist())) == 4  # without replacement

    def test_invalid_slots_never_sampled(self):
        from griduniverse_tpu.models import prioritized_sample

        prio = jnp.ones(32, jnp.float32)
        for i in range(20):
            idx, _ = prioritized_sample(
                prio, jax.random.PRNGKey(i), jnp.asarray(5), 4, 0.6,
                jnp.asarray(1.0),
            )
            assert (np.asarray(idx) < 5).all()

    def test_dqn_prioritized_learns_corridor(self, dqn_cfg):
        import dataclasses as dc

        level = corridor_level()
        cfg = dc.replace(dqn_cfg, prioritized=True, per_beta_anneal_steps=600)
        res = dqn_train(
            SEM, level, jax.random.PRNGKey(0), cfg,
            num_steps=800, batch_size=64,
        )
        assert int(res.episodes) > 100
        assert np.isfinite(float(res.final_loss))
        done, r = _greedy_q_reaches_goal(level, res.params, cfg)
        assert done and r == 10.0

    def test_high_alpha_beta_matches_uniform_final_quality(self):
        """The with-replacement IS weights are kept for
        the without-replacement Gumbel-top-k draw — an approximation that
        could in principle bias learning at high α / low β₀ (max priority
        skew, weakest correction). Empirical check: at α=1.0, β₀=0.3 the
        PER learner must reach the SAME optimal greedy policy as uniform
        replay and a comparable training return, across seeds."""
        import dataclasses as dc

        from griduniverse_tpu.core.step import reset, step
        from griduniverse_tpu.levels.builders import make_level_from_indices
        from griduniverse_tpu.models import greedy_q_actions, make_q_network

        level = make_level_from_indices(
            (4, 4), start_idx=0, lava=[5], goals=[15]
        )
        base = DQNConfig(
            buffer_capacity=4096, batch_size_train=128, hidden=(64,),
            embed_dim=16, compute_dtype="float32", max_episode_steps=32,
            eps_anneal_steps=800,
        )
        per = dc.replace(
            base, prioritized=True, per_alpha=1.0, per_beta0=0.3,
            per_beta_anneal_steps=800,
        )

        def greedy_return(params, cfg):
            net = make_q_network(level, 4, cfg)
            st = reset(level, jax.random.PRNGKey(0))
            tot = 0.0
            for _ in range(50):
                a = greedy_q_actions(net, params, st.agent_idx[None])[0]
                st, out = step(SEM, level, st, a)
                tot += float(out.reward)
                if bool(out.done):
                    return tot
            return None  # never terminated

        for seed in (0, 1):
            ru = dqn_train(
                SEM, level, jax.random.PRNGKey(seed), base,
                num_steps=1200, batch_size=64,
            )
            rp = dqn_train(
                SEM, level, jax.random.PRNGKey(seed), per,
                num_steps=1200, batch_size=64,
            )
            gu_ret = greedy_return(ru.params, base)
            gp_ret = greedy_return(rp.params, per)
            # both must solve optimally (shortest path: 5.0 on this level;
            # measured both hit exactly 5.0 on seeds 0/1)
            assert gu_ret == gp_ret == 5.0, (seed, gu_ret, gp_ret)
            # whole-run training return comparable (measured gap <= 0.35)
            assert abs(float(rp.mean_return) - float(ru.mean_return)) < 1.0

    def test_fallback_when_topk_returns_invalid_slots(self, monkeypatch):
        # Forces top-k to surface unwritten (-inf score, zero-mass) slots,
        # as it must when size < n: the sampler must remap them to valid
        # slots with neutral weight, never emit inf/NaN weights.
        import griduniverse_tpu.models.dqn as dqn_mod
        from griduniverse_tpu.models import prioritized_sample

        real = jax.lax.top_k

        def poisoned(score, k, **kw):
            vals, idx = real(score, k, **kw)
            # corrupt half the results to point at invalid (zero-mass) slots
            bad = jnp.arange(k) % 2 == 0
            return vals, jnp.where(bad, score.shape[0] - 1, idx)

        monkeypatch.setattr(dqn_mod.jax.lax, "top_k", poisoned)
        try:
            prio = jnp.ones(64, jnp.float32)
            idx, w = prioritized_sample(
                prio, jax.random.PRNGKey(0), jnp.asarray(8), 16, 0.6,
                jnp.asarray(1.0),
            )
        finally:
            monkeypatch.setattr(dqn_mod.jax.lax, "top_k", real)
        assert (np.asarray(idx) < 8).all()          # all remapped to valid
        assert np.isfinite(np.asarray(w)).all()     # no inf/NaN weights
        assert (np.asarray(w) > 0).all()

    def test_fallback_rows_never_dominate_real_weights(self, monkeypatch):
        # With beta < 1 every REAL weight can be < 1, and a
        # post-normalization fallback weight of 1.0 would then be the batch
        # MAXIMUM. Real weights must be normalized first; fallback rows are
        # pinned at exactly 1.0 and real rows at <= 1.0.
        import griduniverse_tpu.models.dqn as dqn_mod
        from griduniverse_tpu.models import prioritized_sample

        real = jax.lax.top_k

        def poisoned(score, k, **kw):
            vals, idx = real(score, k, **kw)
            bad = jnp.arange(k) % 4 == 0
            return vals, jnp.where(bad, score.shape[0] - 1, idx)

        monkeypatch.setattr(dqn_mod.jax.lax, "top_k", poisoned)
        try:
            # strongly non-uniform priorities + beta < 1 → real w < 1
            prio = jnp.ones(64, jnp.float32).at[:8].set(50.0)
            idx, w = prioritized_sample(
                prio, jax.random.PRNGKey(3), jnp.asarray(8), 16, 1.0,
                jnp.asarray(0.4),
            )
        finally:
            monkeypatch.setattr(dqn_mod.jax.lax, "top_k", real)
        w = np.asarray(w)
        assert (w <= 1.0 + 1e-6).all()
        # the real rows' max is 1 after normalization, so fallback rows
        # (exactly 1.0) can tie but never exceed the best real row
        assert np.isclose(w.max(), 1.0, rtol=1e-6)

    def test_dqn_prioritized_sharded_smoke(self, dqn_cfg):
        import dataclasses as dc

        mesh = make_env_mesh()
        level = corridor_level()
        cfg = dc.replace(dqn_cfg, prioritized=True)
        res = dqn_train_sharded(
            mesh, SEM, level, jax.random.PRNGKey(0), cfg,
            num_steps=200, batch_size=64,
        )
        assert np.isfinite(float(res.final_loss))
        for leaf in jax.tree.leaves(res.params):
            assert leaf.sharding.is_fully_replicated


class TestGridObservations:
    """obs='grid': conv trunk over tile+agent planes (ConvActorCritic)."""

    def test_conv_net_shapes_and_leading_dims(self):
        from griduniverse_tpu.models import ConvActorCritic

        level = corridor_level()
        grid = tuple(int(v) for v in np.asarray(level.grid).reshape(-1))
        net = ConvActorCritic(
            height=2, width=6, grid=grid, num_actions=4,
            channels=(8,), hidden=(16,),
        )
        params = net.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))
        # (B,) and (T, B) leading shapes both supported, like ActorCritic
        logits, value = net.apply(params, jnp.zeros((5,), jnp.int32))
        assert logits.shape == (5, 4) and value.shape == (5,)
        logits, value = net.apply(params, jnp.zeros((3, 5), jnp.int32))
        assert logits.shape == (3, 5, 4) and value.shape == (3, 5)
        assert logits.dtype == jnp.float32

    def test_ppo_grid_obs_learns_corridor(self):
        from griduniverse_tpu.models import PPOConfig, ppo_train

        level = corridor_level()
        cfg = PPOConfig(
            rollout_len=8, lr=1e-3, max_episode_steps=32,
            obs="grid", conv_channels=(16,), hidden=(64,),
            num_epochs=2, num_minibatches=2,
        )
        res = ppo_train(
            SEM, level, jax.random.PRNGKey(0), cfg,
            num_updates=150, batch_size=64,
        )
        assert int(res.episodes) > 50
        assert np.isfinite(float(res.final_loss))
        done, r = _greedy_rollout_reaches_goal(level, res.params, cfg)
        assert done and r == 10.0

    def test_dqn_grid_obs_learns_corridor(self, dqn_cfg):
        import dataclasses as dc

        level = corridor_level()
        cfg = dc.replace(dqn_cfg, obs="grid", conv_channels=(16,), hidden=(32,))
        res = dqn_train(
            SEM, level, jax.random.PRNGKey(0), cfg,
            num_steps=800, batch_size=64,
        )
        assert int(res.episodes) > 100
        from griduniverse_tpu.models import make_q_network, greedy_q_actions
        from griduniverse_tpu.core.step import reset, step

        net = make_q_network(level, 4, cfg)
        state = reset(level, jax.random.PRNGKey(0))
        for _ in range(12):
            a = greedy_q_actions(net, res.params, state.agent_idx[None])[0]
            state, out = step(SEM, level, state, a)
            if bool(out.done):
                break
        assert bool(out.done) and float(out.reward) == 10.0

    def test_a2c_grid_obs_sharded_smoke(self):
        from griduniverse_tpu.models import A2CConfig, a2c_train_sharded

        mesh = make_env_mesh()
        level = corridor_level()
        cfg = A2CConfig(
            rollout_len=8, max_episode_steps=32, obs="grid",
            conv_channels=(8,), hidden=(16,),
        )
        res = a2c_train_sharded(
            mesh, SEM, level, jax.random.PRNGKey(0), cfg,
            num_updates=20, batch_size=64,
        )
        assert np.isfinite(float(res.final_loss))
        for leaf in jax.tree.leaves(res.params):
            assert leaf.sharding.is_fully_replicated

    def test_grid_obs_batched_level_builds_batched_net(self):
        # r2 fenced this off with NotImplementedError; r3 lifts it — a
        # batched level now builds the per-env-level conv trunk
        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.models import (
            A2CConfig, BatchedConvActorCritic, make_network,
        )

        g = jnp.asarray(np.zeros((3, 4, 4), np.int32))  # (B, H, W) per-env
        levels = Level(grid=g, start_idx=jnp.zeros((3,), jnp.int32))
        net = make_network(levels, 4, A2CConfig(obs="grid"))
        assert isinstance(net, BatchedConvActorCritic)

    def test_dqn_grid_obs_with_prioritized_replay_smoke(self, dqn_cfg):
        # interaction coverage: conv Q-network + Gumbel-top-k PER together
        import dataclasses as dc

        level = corridor_level()
        cfg = dc.replace(
            dqn_cfg, obs="grid", conv_channels=(8,), hidden=(16,),
            prioritized=True,
        )
        res = dqn_train(
            SEM, level, jax.random.PRNGKey(0), cfg,
            num_steps=200, batch_size=64,
        )
        assert np.isfinite(float(res.final_loss))
        assert int(res.episodes) > 0


class TestTargetUpdateModes:
    def test_hard_target_syncs_at_boundary(self, dqn_cfg):
        import dataclasses as dc

        from griduniverse_tpu.models import dqn_init, dqn_run

        level = corridor_level()
        cfg = dc.replace(
            dqn_cfg, target_update="hard", target_update_every=50
        )
        ts = dqn_init(SEM, level, jax.random.PRNGKey(0), cfg, batch_size=16)
        ts = dqn_run(SEM, level, ts, cfg, num_steps=50)  # ends ON a sync
        for tp, p in zip(
            jax.tree.leaves(ts.target_params), jax.tree.leaves(ts.params)
        ):
            np.testing.assert_array_equal(np.asarray(tp), np.asarray(p))
        # advance past the boundary: target must now lag the online net
        ts2 = dqn_run(SEM, level, ts, cfg, num_steps=10)
        diffs = [
            float(np.abs(np.asarray(tp) - np.asarray(p)).max())
            for tp, p in zip(
                jax.tree.leaves(ts2.target_params), jax.tree.leaves(ts2.params)
            )
        ]
        assert max(diffs) > 0

    def test_hard_target_learns_corridor(self, dqn_cfg):
        import dataclasses as dc

        level = corridor_level()
        cfg = dc.replace(
            dqn_cfg, target_update="hard", target_update_every=100
        )
        res = dqn_train(
            SEM, level, jax.random.PRNGKey(0), cfg,
            num_steps=800, batch_size=64,
        )
        assert int(res.episodes) > 100
        done, r = _greedy_q_reaches_goal(level, res.params, cfg)
        assert done and r == 10.0

    def test_unknown_target_update_rejected(self, dqn_cfg):
        import dataclasses as dc

        with pytest.raises(ValueError, match="target_update"):
            dqn_train(
                SEM, corridor_level(), jax.random.PRNGKey(0),
                dc.replace(dqn_cfg, target_update="bogus"),
                num_steps=4, batch_size=64,
            )


class TestPPORegularizers:
    def test_vf_clip_and_target_kl_learn_corridor(self, ppo_cfg):
        import dataclasses as dc

        level = corridor_level()
        cfg = dc.replace(ppo_cfg, vf_clip_eps=10.0, target_kl=0.05)
        res = ppo_train(
            SEM, level, jax.random.PRNGKey(0), cfg,
            num_updates=150, batch_size=64,
        )
        assert int(res.episodes) > 50
        assert np.isfinite(float(res.final_loss))
        done, r = _greedy_rollout_reaches_goal(level, res.params, cfg)
        assert done and r == 10.0

    def test_tiny_target_kl_freezes_most_updates(self, ppo_cfg):
        # an absurdly tight KL budget must mask nearly every minibatch
        # step after the first — training barely moves vs the default
        import dataclasses as dc

        level = corridor_level()
        # 16 SGD steps per update: the tight budget trips after the 1st,
        # masking the other 15 - movement should separate clearly
        tight = dc.replace(ppo_cfg, target_kl=1e-9, lr=1e-2,
                           num_epochs=4, num_minibatches=4)
        loose = dc.replace(ppo_cfg, lr=1e-2,
                           num_epochs=4, num_minibatches=4)
        r_t = ppo_train(SEM, level, jax.random.PRNGKey(0), tight,
                        num_updates=10, batch_size=64)
        r_l = ppo_train(SEM, level, jax.random.PRNGKey(0), loose,
                        num_updates=10, batch_size=64)
        # parameter movement from init is much smaller under the tight budget
        from griduniverse_tpu.models import ppo_init

        p0 = ppo_init(SEM, level, jax.random.PRNGKey(0), loose,
                      batch_size=64).params  # init only
        def dist(a, b):
            return float(sum(
                np.abs(np.asarray(x) - np.asarray(y)).sum()
                for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
            ))
        # The tight budget applies only ~2 of 16 SGD steps per update (the
        # first step's KL is exactly 0 - ratio=1 - and the trip lands after
        # step 2). Adam's normalized steps + global-norm clipping make
        # movement sublinear in applied steps, so assert a clear but
        # realistic separation (measured ~0.71x; ~0.98x without the
        # opt-state freeze).
        assert dist(r_t.params, p0) < 0.8 * dist(r_l.params, p0)

    def test_sharded_with_regularizers_smoke(self, ppo_cfg):
        import dataclasses as dc

        from griduniverse_tpu.models import ppo_train_sharded

        mesh = make_env_mesh()
        level = corridor_level()
        cfg = dc.replace(ppo_cfg, vf_clip_eps=10.0, target_kl=0.05)
        res = ppo_train_sharded(
            mesh, SEM, level, jax.random.PRNGKey(0), cfg,
            num_updates=10, batch_size=64,
        )
        assert np.isfinite(float(res.final_loss))
        for leaf in jax.tree.leaves(res.params):
            assert leaf.sharding.is_fully_replicated


def test_ppo_shuffle_none_is_distinct_and_deterministic():
    """r4 review regression: shuffle='none' must actually change the
    minibatch layout (the first implementation fell through to the roll
    branch, making it an alias of 'roll')."""
    import dataclasses

    from griduniverse_tpu import make_semantics
    from griduniverse_tpu.levels.builders import make_level_from_indices
    from griduniverse_tpu.models import PPOConfig, ppo_train

    sem = make_semantics()
    level = make_level_from_indices((4, 4), start_idx=0, goals=[15])
    base = PPOConfig(
        rollout_len=4, num_epochs=2, num_minibatches=2, hidden=(16,),
        embed_dim=8, max_episode_steps=8, compute_dtype="float32",
    )
    r_roll = ppo_train(
        sem, level, jax.random.PRNGKey(0), base, num_updates=4,
        batch_size=16,
    )
    cfg_none = dataclasses.replace(base, shuffle="none")
    r_none = ppo_train(
        sem, level, jax.random.PRNGKey(0), cfg_none, num_updates=4,
        batch_size=16,
    )
    r_none2 = ppo_train(
        sem, level, jax.random.PRNGKey(0), cfg_none, num_updates=4,
        batch_size=16,
    )
    # deterministic given the key...
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)
        ),
        r_none.params, r_none2.params,
    )
    # ...and NOT the same program as "roll" (offsets pinned to 0)
    leaves_roll = np.concatenate(
        [np.asarray(x).ravel() for x in jax.tree.leaves(r_roll.params)]
    )
    leaves_none = np.concatenate(
        [np.asarray(x).ravel() for x in jax.tree.leaves(r_none.params)]
    )
    assert not np.array_equal(leaves_roll, leaves_none)
