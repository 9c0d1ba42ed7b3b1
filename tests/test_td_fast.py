"""Matmul-form fast TD learner: convergence + sharded equivalence.

The fast learner (algos/td_fast.py) re-expresses table lookups and the
(s,a)-aggregated update as one-hot matmuls. On CPU, f32 one-hot matmuls
are exact, so lookup equivalence is bit-checkable here; the learning
contract everywhere is "converges to the optimal policy".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from griduniverse_tpu import build_model_table, make_semantics
from griduniverse_tpu.algos.dp import value_iteration
from griduniverse_tpu.algos.td_fast import compile_q_learning_fast
from griduniverse_tpu.algos.utils import greedy_policy_from_q, run_greedy_episode
from griduniverse_tpu.levels.builders import lava_level, walls_and_goal_16x16
from griduniverse_tpu.ops.bitplane import pack_level
from griduniverse_tpu.parallel.bitplane import compile_q_learning_fast_sharded
from griduniverse_tpu.parallel.mesh import make_env_mesh

SEM = make_semantics()


def test_one_hot_lookup_matches_gather_exactly(rng):
    q = jnp.asarray(rng.normal(size=(81, 4)).astype(np.float32))
    s = jnp.asarray(rng.integers(0, 81, size=256), jnp.int32)
    p = jax.nn.one_hot(s, 81, dtype=q.dtype)
    np.testing.assert_array_equal(np.asarray(p @ q), np.asarray(q[s]))


@pytest.mark.parametrize("algo", ["q_learning", "expected_sarsa"])
def test_fast_td_converges_to_optimal_policy(algo):
    level = lava_level()
    bl = pack_level(level)
    fn = compile_q_learning_fast(
        SEM, bl, batch_size=256, num_steps=3000, alpha=0.2, gamma=0.99,
        epsilon=0.2, algo=algo, max_episode_steps=100,
    )
    res = fn(jnp.uint32(0))
    assert int(res.episodes) > 0

    # the greedy policy from the learned Q must be OPTIMAL: its episode
    # return from the start equals the optimal undiscounted return from
    # gamma=1 value iteration (-5.0 on this level: 16 steps around the lava)
    policy = greedy_policy_from_q(res.q)
    _, total, length, reached = run_greedy_episode(
        SEM, level, policy, jax.random.PRNGKey(0), max_steps=50
    )
    model = build_model_table(SEM, level)
    v1, _, _ = value_iteration(model, gamma=1.0)
    assert bool(reached)
    assert float(total) == float(v1[int(level.start_idx)])


def test_fast_td_improves_return_over_training():
    level = walls_and_goal_16x16()
    bl = pack_level(level)
    short = compile_q_learning_fast(
        SEM, bl, 128, 200, epsilon=0.1, max_episode_steps=200
    )(jnp.uint32(1))
    long = compile_q_learning_fast(
        SEM, bl, 128, 4000, epsilon=0.1, max_episode_steps=200
    )(jnp.uint32(1))
    assert float(long.mean_return) > float(short.mean_return)


def test_sharded_fast_td_matches_unsharded():
    """Single-device mesh is bit-exact vs unsharded. Multi-device meshes
    can only be close: the psum's float reduction order perturbs Q in the
    low bits, greedy argmax ties can flip, and trajectories diverge — the
    learner couples envs through Q (unlike the independent-env rollout,
    test_parallel_bitplane.py, where sharded IS integer-exact). Contract:
    near-equal stats, and the sharded learner reaches an optimal policy."""
    level = lava_level()
    bl = pack_level(level)
    kw = dict(
        batch_size=64, num_steps=2000, alpha=0.2, gamma=0.99, epsilon=0.2,
        max_episode_steps=100,
    )
    ref = compile_q_learning_fast(SEM, bl, **kw)(jnp.uint32(3))

    mesh1 = make_env_mesh(1)
    res1 = compile_q_learning_fast_sharded(mesh1, SEM, bl, **kw)(jnp.uint32(3))
    assert int(res1.episodes) == int(ref.episodes)
    np.testing.assert_allclose(np.asarray(res1.q), np.asarray(ref.q), rtol=1e-6)

    model = build_model_table(SEM, level)
    v1, _, _ = value_iteration(model, gamma=1.0)
    v1_start = float(v1[int(level.start_idx)])

    for n in (2, 4, 8):
        if n > len(jax.devices()):
            continue
        mesh = make_env_mesh(n)
        res = compile_q_learning_fast_sharded(mesh, SEM, bl, **kw)(jnp.uint32(3))
        assert abs(int(res.episodes) - int(ref.episodes)) <= 0.02 * int(
            ref.episodes
        ), n
        np.testing.assert_allclose(
            float(res.mean_return), float(ref.mean_return), rtol=0.1
        )
        policy = greedy_policy_from_q(res.q)
        _, total, _, reached = run_greedy_episode(
            SEM, level, policy, jax.random.PRNGKey(0), max_steps=50
        )
        assert bool(reached) and float(total) == v1_start, n


def test_fast_td_chunked_run_is_bitexact():
    """The checkpointable API: N chunks of the
    compiled chunk-runner reproduce the one-shot compile_q_learning_fast
    run BIT-exactly — env FastState, xorshift lanes, accumulators and Q all
    live in FastTDTrainState, so a chunk boundary is invisible."""
    from griduniverse_tpu.algos.td_fast import (
        compile_fast_td_run,
        fast_td_init,
        fast_td_result,
    )

    level = lava_level()
    bl = pack_level(level)
    kw = dict(alpha=0.2, gamma=0.99, epsilon=0.2, max_episode_steps=100)

    ref = compile_q_learning_fast(
        SEM, bl, batch_size=64, num_steps=900, **kw
    )(jnp.uint32(5))

    run = compile_fast_td_run(SEM, bl, chunk_steps=300, **kw)
    ts = fast_td_init(SEM, bl, jnp.uint32(5), batch_size=64)
    for _ in range(3):
        ts = run(ts)
    res = fast_td_result(ts)

    assert int(ts.step) == 900
    np.testing.assert_array_equal(np.asarray(res.q), np.asarray(ref.q))
    assert int(res.episodes) == int(ref.episodes)
    np.testing.assert_array_equal(
        np.asarray(res.mean_return), np.asarray(ref.mean_return)
    )


def test_fast_td_state_checkpoint_roundtrip(tmp_path):
    """FastTDTrainState round-trips through orbax with every leaf bit-equal
    (the mid-run crash-recovery substrate; full SIGKILL drill lives in
    test_fault_tolerance.py)."""
    from griduniverse_tpu.algos.td_fast import (
        compile_fast_td_run,
        fast_td_init,
    )
    from griduniverse_tpu.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    bl = pack_level(lava_level())
    run = compile_fast_td_run(SEM, bl, chunk_steps=100, epsilon=0.2,
                              max_episode_steps=50)
    ts = run(fast_td_init(SEM, bl, jnp.uint32(9), batch_size=32))

    save_checkpoint(tmp_path / "fast_ts", ts)
    template = fast_td_init(SEM, bl, jnp.uint32(0), batch_size=32)
    restored = restore_checkpoint(tmp_path / "fast_ts", template)

    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(ts)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # resumed training continues identically to the uninterrupted run
    a = run(restored)
    b = run(ts)
    np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
    np.testing.assert_array_equal(np.asarray(a.rs), np.asarray(b.rs))


def test_fast_td_rejects_bad_algo():
    bl = pack_level(lava_level())
    with pytest.raises(ValueError):
        compile_q_learning_fast(SEM, bl, 32, 10, algo="dyna")
    mesh = make_env_mesh(2)
    with pytest.raises(ValueError):
        compile_q_learning_fast_sharded(mesh, SEM, bl, 32, 10, algo="dyna")
    with pytest.raises(ValueError):
        compile_q_learning_fast_sharded(mesh, SEM, bl, 33, 10)
