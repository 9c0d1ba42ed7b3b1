"""Bit-exact trajectory parity: JAX core vs the pure-NumPy oracle.

Operationalizes the BASELINE north star "bit-exact trajectory parity with
reference GridUniverse on fixed seeds" against the oracle (SURVEY.md §0) —
both sides driven by the SAME pre-drawn action arrays (SURVEY.md §7.3).

Covers BASELINE configs:
  1. 8×8 empty, single env, 10k random steps       (gate: bit-equal obs/rew/done)
  2. 16×16 walls+goal, batched envs w/ auto-reset  (gate: per-env trajectories equal oracle)
  3. lava/pit text level                           (gate: reward parity)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from griduniverse_tpu import make_semantics
from griduniverse_tpu.levels.builders import (
    empty_level,
    lava_level,
    walls_and_goal_16x16,
)
from griduniverse_tpu.ops.rollout import reset_batch, rollout_actions
from griduniverse_tpu.core.step import reset
from griduniverse_tpu.utils.oracle import OracleGridEnv

SEM = make_semantics()
KEY = jax.random.PRNGKey(42)


def run_jax(level, actions, auto_reset, batch=None):
    if batch is None:
        state = reset(level, KEY)
    else:
        state = reset_batch(level, KEY, batch)
    _, traj = jax.jit(
        rollout_actions, static_argnames=("auto_reset",)
    )(SEM, level, state, jnp.asarray(actions), auto_reset=auto_reset)
    return (
        np.asarray(traj.obs),
        np.asarray(traj.reward),
        np.asarray(traj.done),
    )


def oracle_rollout(level, actions, auto_reset):
    env = OracleGridEnv(
        np.asarray(level.grid), int(level.start_idx), auto_reset=auto_reset
    )
    return env.run_actions(np.asarray(actions))


@pytest.mark.parametrize("auto_reset", [False, True])
def test_config1_8x8_empty_single_env_10k_steps(auto_reset):
    """BASELINE config 1 gate: 10k random steps bit-equal to oracle."""
    level = empty_level(8, 8, goal=True)
    rng = np.random.default_rng(123)
    actions = rng.integers(0, 4, size=10_000).astype(np.int32)

    jo, jr, jd = run_jax(level, actions, auto_reset)
    oo, orr, od = oracle_rollout(level, actions, auto_reset)

    np.testing.assert_array_equal(jo, oo)
    np.testing.assert_array_equal(jr, orr)  # float32 bit-compare (table lookups)
    np.testing.assert_array_equal(jd, od)


@pytest.mark.parametrize("auto_reset", [False, True])
def test_config2_16x16_walls_batched(auto_reset):
    """BASELINE config 2 gate: per-env trajectories equal oracle."""
    level = walls_and_goal_16x16()
    batch, steps = 32, 500
    rng = np.random.default_rng(7)
    actions = rng.integers(0, 4, size=(steps, batch)).astype(np.int32)

    jo, jr, jd = run_jax(level, actions, auto_reset, batch=batch)
    for b in range(batch):
        oo, orr, od = oracle_rollout(level, actions[:, b], auto_reset)
        np.testing.assert_array_equal(jo[:, b], oo, err_msg=f"env {b} obs")
        np.testing.assert_array_equal(jr[:, b], orr, err_msg=f"env {b} reward")
        np.testing.assert_array_equal(jd[:, b], od, err_msg=f"env {b} done")


@pytest.mark.parametrize("auto_reset", [False, True])
def test_config3_lava_text_level(auto_reset):
    """BASELINE config 3 gate: reward parity on a lava/pit text level."""
    level = lava_level()
    rng = np.random.default_rng(99)
    actions = rng.integers(0, 4, size=2000).astype(np.int32)

    jo, jr, jd = run_jax(level, actions, auto_reset)
    oo, orr, od = oracle_rollout(level, actions, auto_reset)

    np.testing.assert_array_equal(jo, oo)
    np.testing.assert_array_equal(jr, orr)
    np.testing.assert_array_equal(jd, od)


def test_lookahead_matches_model_semantics():
    """Oracle's look_step_ahead vs JAX model table (SURVEY.md §3.3)."""
    from griduniverse_tpu import build_model_table

    level = lava_level()
    table = build_model_table(SEM, level)
    env = OracleGridEnv(np.asarray(level.grid), int(level.start_idx))
    ns = np.asarray(table.next_state)
    rw = np.asarray(table.reward)
    dn = np.asarray(table.done)
    for s in range(level.num_states):
        for a in range(4):
            s2, r, d = env.look_step_ahead(s, a)
            assert ns[s, a] == s2, (s, a)
            assert rw[s, a] == r, (s, a)
            assert dn[s, a] == d, (s, a)


def test_truncation_parity_with_oracle():
    """Time-limit truncation (auto-reset path) matches the oracle with the
    same max_episode_steps."""
    level = walls_and_goal_16x16()  # goal practically unreachable randomly
    rng = np.random.default_rng(11)
    actions = rng.integers(0, 4, size=500).astype(np.int32)

    state = reset(level, KEY)
    _, traj = jax.jit(
        rollout_actions, static_argnames=("auto_reset", "max_episode_steps")
    )(SEM, level, state, jnp.asarray(actions), auto_reset=True,
      max_episode_steps=50)

    env = OracleGridEnv(
        np.asarray(level.grid), int(level.start_idx),
        auto_reset=True, max_episode_steps=50,
    )
    oo, orr, od = env.run_actions(actions)
    np.testing.assert_array_equal(np.asarray(traj.obs), oo)
    np.testing.assert_array_equal(np.asarray(traj.reward), orr)
    np.testing.assert_array_equal(np.asarray(traj.done), od)
    # with a 50-step limit, every 50-step window has ≥1 done
    dones = np.asarray(traj.done)
    assert dones.reshape(10, 50).any(axis=1).all()


def test_large_grid_33x33_oracle_vs_jax_vs_bitplane():
    """r5 large-grid frontier: the parity contract must hold at S=1089
    (69 packed words — a 10× deeper word-select tree than the BASELINE
    levels exercise)."""
    from griduniverse_tpu.core.types import Level
    from griduniverse_tpu.levels.maze import generate_mazes_device
    from griduniverse_tpu.core import semantics as S
    from griduniverse_tpu.ops.bitplane import (
        pack_level,
        reset_bits,
        rollout_actions_bits,
    )

    grids, start = generate_mazes_device(
        jax.random.PRNGKey(13), (16, 16), 1, algorithm="binary_tree"
    )
    level = Level(
        grid=grids[0].at[31, 31].set(S.GOAL), start_idx=start
    )
    actions = np.random.default_rng(5).integers(0, 4, size=600).astype(
        np.int32
    )
    jo, jr, jd = run_jax(level, actions, True)
    oo, orr, od = oracle_rollout(level, actions, True)
    np.testing.assert_array_equal(jo, oo)
    np.testing.assert_array_equal(jr, orr)
    np.testing.assert_array_equal(jd, od)
    bl = pack_level(level)
    st = reset_bits(bl)
    _, (bo, br, bd) = jax.jit(
        rollout_actions_bits, static_argnames=("auto_reset",)
    )(SEM, bl, st, jnp.asarray(actions), auto_reset=True)
    np.testing.assert_array_equal(np.asarray(bo), oo)
    np.testing.assert_array_equal(np.asarray(br), orr)
    np.testing.assert_array_equal(np.asarray(bd), od)


@pytest.mark.parametrize("auto_reset", [False, True])
def test_random_grid_fuzz_oracle_vs_jax_vs_bitplane(auto_reset):
    """Property fuzz (SURVEY.md §4): RANDOM grids — random shapes, random
    wall/lava/goal placements, random start — must agree bit-for-bit
    between the oracle, the generic JAX step and the bit-packed fast
    engine over random action sequences. Catches semantics bugs that the
    fixed BASELINE levels can't reach (odd shapes, dense walls, start
    adjacent to terminals)."""
    from griduniverse_tpu.core import semantics as S
    from griduniverse_tpu.core.types import Level
    from griduniverse_tpu.ops.bitplane import (
        pack_level,
        reset_bits,
        rollout_actions_bits,
    )

    rng = np.random.default_rng(2024)
    for trial in range(12):
        h = int(rng.integers(2, 9))
        w = int(rng.integers(2, 9))
        grid = np.zeros((h, w), np.int32)
        n = h * w
        # sprinkle walls/lava/goals (possibly none; possibly dense)
        for code, frac in ((S.WALL, 0.25), (S.LAVA, 0.1), (S.GOAL, 0.1)):
            k = int(rng.integers(0, max(1, int(n * frac)) + 1))
            grid.flat[rng.choice(n, size=k, replace=False)] = code
        empties = np.flatnonzero(grid.reshape(-1) == S.EMPTY)
        if len(empties) == 0:
            continue
        start = int(rng.choice(empties))
        level = Level(
            grid=jnp.asarray(grid), start_idx=jnp.asarray(start, jnp.int32)
        )
        actions = rng.integers(0, 4, size=400).astype(np.int32)

        jo, jr, jd = run_jax(level, actions, auto_reset)
        oo, orr, od = oracle_rollout(level, actions, auto_reset)
        np.testing.assert_array_equal(jo, oo, err_msg=f"trial {trial} obs")
        np.testing.assert_array_equal(jr, orr, err_msg=f"trial {trial} rew")
        np.testing.assert_array_equal(jd, od, err_msg=f"trial {trial} done")

        bl = pack_level(level)
        st = reset_bits(bl)
        _, (bo, br, bd) = jax.jit(
            rollout_actions_bits, static_argnames=("auto_reset",)
        )(SEM, bl, st, jnp.asarray(actions), auto_reset=auto_reset)
        np.testing.assert_array_equal(np.asarray(bo), oo)
        np.testing.assert_array_equal(np.asarray(br), orr)
        np.testing.assert_array_equal(np.asarray(bd), od)


def test_large_grid_65x65_oracle_vs_jax_vs_bitplane():
    """Parity one size past the benched frontier: S=4225 packs to 265
    words. Same three-way contract as the 33×33 test."""
    from griduniverse_tpu.core.types import Level
    from griduniverse_tpu.levels.maze import generate_mazes_device
    from griduniverse_tpu.core import semantics as S
    from griduniverse_tpu.ops.bitplane import (
        pack_level,
        reset_bits,
        rollout_actions_bits,
    )

    grids, start = generate_mazes_device(
        jax.random.PRNGKey(19), (32, 32), 1, algorithm="binary_tree"
    )
    level = Level(
        grid=grids[0].at[63, 63].set(S.GOAL), start_idx=start
    )
    actions = np.random.default_rng(6).integers(0, 4, size=400).astype(
        np.int32
    )
    jo, jr, jd = run_jax(level, actions, True)
    oo, orr, od = oracle_rollout(level, actions, True)
    np.testing.assert_array_equal(jo, oo)
    np.testing.assert_array_equal(jr, orr)
    np.testing.assert_array_equal(jd, od)
    bl = pack_level(level)
    st = reset_bits(bl)
    _, (bo, br, bd) = jax.jit(
        rollout_actions_bits, static_argnames=("auto_reset",)
    )(SEM, bl, st, jnp.asarray(actions), auto_reset=True)
    np.testing.assert_array_equal(np.asarray(bo), oo)
    np.testing.assert_array_equal(np.asarray(br), orr)
    np.testing.assert_array_equal(np.asarray(bd), od)
