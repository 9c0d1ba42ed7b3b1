"""Maze-generation tests — reference coverage model (SURVEY.md §4):
generated maze is well-formed/solvable. Covers both the host parity path and
the on-device vmapped generator (BASELINE config 4)."""

import jax
import jax.numpy as jnp
import numpy as np

from griduniverse_tpu import make_semantics
from griduniverse_tpu.core import semantics as S
from griduniverse_tpu.core.types import Level
from griduniverse_tpu.levels.maze import (
    check_perfect_maze,
    generate_maze_numpy,
    generate_mazes_device,
    random_maze_level,
)
from griduniverse_tpu.ops.rollout import episode_stats, reset_batch

SEM = make_semantics()


class TestHostMaze:
    def test_numpy_maze_is_perfect(self):
        for seed in range(5):
            rng = np.random.default_rng(seed)
            grid = generate_maze_numpy((6, 6), rng)
            assert grid.shape == (13, 13)
            assert check_perfect_maze(grid, (6, 6))

    def test_numpy_maze_deterministic_under_seed(self):
        g1 = generate_maze_numpy((5, 5), np.random.default_rng(42))
        g2 = generate_maze_numpy((5, 5), np.random.default_rng(42))
        np.testing.assert_array_equal(g1, g2)

    def test_random_maze_level_has_goal_and_start(self):
        level = random_maze_level((4, 4), seed=0)
        grid = np.asarray(level.grid)
        assert grid[7, 7] == S.GOAL
        assert grid.reshape(-1)[int(level.start_idx)] == S.EMPTY


class TestDeviceMaze:
    def test_device_mazes_are_perfect(self):
        grids, start = generate_mazes_device(jax.random.PRNGKey(0), (5, 5), 8)
        assert grids.shape == (8, 11, 11)
        for b in range(8):
            g = np.asarray(grids[b])
            # goal cell replaces one EMPTY; flip back for the validator
            g_check = g.copy()
            g_check[g_check == S.GOAL] = S.EMPTY
            assert check_perfect_maze(g_check, (5, 5)), f"maze {b} not perfect"

    def test_device_mazes_differ_across_envs(self):
        grids, _ = generate_mazes_device(jax.random.PRNGKey(1), (5, 5), 8)
        g = np.asarray(grids)
        assert any(
            not np.array_equal(g[0], g[b]) for b in range(1, 8)
        ), "all mazes identical — keys not split?"

    def test_device_mazes_deterministic_under_key(self):
        g1, _ = generate_mazes_device(jax.random.PRNGKey(7), (4, 4), 4)
        g2, _ = generate_mazes_device(jax.random.PRNGKey(7), (4, 4), 4)
        np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))

    def test_large_maze_33x33_perfect_and_solvable(self):
        """The r5 large-grid frontier shape (16×16 cells → 33×33 grid,
        S=1089): generation stays perfect and the grid-form solver
        reaches every cell (V finite ⇒ goal reachable everywhere)."""
        from griduniverse_tpu.algos import value_iteration_batched_grid
        from griduniverse_tpu.core.types import Level

        grids, start = generate_mazes_device(
            jax.random.PRNGKey(11), (16, 16), 4, algorithm="binary_tree"
        )
        assert grids.shape == (4, 33, 33)
        for b in range(4):
            g = np.asarray(grids[b]).copy()
            g[g == S.GOAL] = S.EMPTY
            assert check_perfect_maze(g, (16, 16)), f"maze {b} not perfect"
        lv = Level(
            grid=grids.at[:, 31, 31].set(S.GOAL),
            start_idx=jnp.broadcast_to(start, (4,)),
        )
        v, policy, iters = value_iteration_batched_grid(
            SEM, lv, gamma=0.99, max_iters=400
        )
        assert int(iters) < 400  # converged, not capped
        # every empty cell's greedy value must see the goal (not the
        # pure step-cost fixed point -1/(1-γ) = -100)
        passable = np.asarray(lv.grid).reshape(4, -1) != S.WALL
        assert float(np.asarray(v)[passable].min()) > -99.0


class TestPerEnvLevelRollout:
    def test_rollout_on_per_env_mazes(self):
        """BASELINE config 4 end-to-end slice: per-env device mazes, batched
        auto-reset rollout, episode stats."""
        b = 16
        grids, start = generate_mazes_device(jax.random.PRNGKey(2), (4, 4), b)
        import jax.numpy as jnp

        levels = Level(
            grid=grids, start_idx=jnp.full((b,), start, jnp.int32)
        )
        state = reset_batch(levels, jax.random.PRNGKey(3), b)
        final, stats = episode_stats(
            SEM, levels, state, jax.random.PRNGKey(4), 512
        )
        assert int(stats["episodes"]) > 0
        # agents never stand on walls
        flat = np.asarray(grids).reshape(b, -1)
        pos = np.asarray(final.agent_idx)
        for i in range(b):
            assert flat[i, pos[i]] != S.WALL


class TestBinaryTreeMazes:
    """The fully-parallel mass-generation algorithm (no while_loop, no
    scatter — the path bench.py uses)."""

    def test_perfect_and_solvable(self):
        grids, start = generate_mazes_device(
            jax.random.PRNGKey(11), (4, 4), 16, algorithm="binary_tree"
        )
        assert int(start) == 1 * 9 + 1
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (4, 4))

    def test_non_square(self):
        grids, _ = generate_mazes_device(
            jax.random.PRNGKey(12), (3, 6), 8, algorithm="binary_tree"
        )
        assert grids.shape == (8, 7, 13)
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (3, 6))

    def test_deterministic_and_diverse(self):
        g1, _ = generate_mazes_device(
            jax.random.PRNGKey(7), (4, 4), 8, algorithm="binary_tree"
        )
        g2, _ = generate_mazes_device(
            jax.random.PRNGKey(7), (4, 4), 8, algorithm="binary_tree"
        )
        np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))
        flat = np.asarray(g1).reshape(8, -1)
        assert len({t.tobytes() for t in flat}) > 1  # not all identical

    def test_unknown_algorithm_raises(self):
        import pytest

        with pytest.raises(ValueError):
            generate_mazes_device(
                jax.random.PRNGKey(0), (4, 4), 2, algorithm="nope"
            )

    def test_goal_placed_bottom_right(self):
        from griduniverse_tpu.core import semantics as S

        grids, _ = generate_mazes_device(
            jax.random.PRNGKey(3), (4, 4), 4, algorithm="binary_tree"
        )
        assert np.all(np.asarray(grids)[:, -2, -2] == S.GOAL)


class TestSidewinderMazes:
    """The unbiased fully-parallel algorithm: scatter-free row-scan
    formulation like binary_tree, without its forced west-column corridor
    / diagonal texture."""

    def test_perfect_and_solvable(self):
        grids, start = generate_mazes_device(
            jax.random.PRNGKey(21), (4, 4), 64, algorithm="sidewinder"
        )
        assert int(start) == 1 * 9 + 1
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (4, 4))

    def test_non_square_perfect(self):
        grids, _ = generate_mazes_device(
            jax.random.PRNGKey(22), (3, 6), 32, algorithm="sidewinder"
        )
        assert grids.shape == (32, 7, 13)
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (3, 6))

    def test_deterministic_and_diverse(self):
        g1, _ = generate_mazes_device(
            jax.random.PRNGKey(23), (5, 5), 16, algorithm="sidewinder"
        )
        g2, _ = generate_mazes_device(
            jax.random.PRNGKey(23), (5, 5), 16, algorithm="sidewinder"
        )
        np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))
        flat = np.asarray(g1).reshape(16, -1)
        assert len({t.tobytes() for t in flat}) > 1

    def test_texture_less_biased_than_binary_tree(self):
        """binary_tree forces EVERY west-column cell to carve north (an
        unbroken west corridor); sidewinder opens each west-column north
        wall only when that cell's run-closing coin lands there (~<=50%).
        Also both must keep the forced top-row corridor (sidewinder's only
        structural bias)."""
        b, cells = 256, (6, 6)
        bt, _ = generate_mazes_device(
            jax.random.PRNGKey(31), cells, b, algorithm="binary_tree"
        )
        sw, _ = generate_mazes_device(
            jax.random.PRNGKey(31), cells, b, algorithm="sidewinder"
        )
        bt, sw = np.asarray(bt), np.asarray(sw)
        # north walls of west-column cells (r>=1): grid[2r, 1]
        rows = np.arange(1, cells[0]) * 2
        bt_open = (bt[:, rows, 1] != S.WALL).mean()
        sw_open = (sw[:, rows, 1] != S.WALL).mean()
        assert bt_open == 1.0          # binary tree: always carved
        assert sw_open < 0.75          # sidewinder: a coin, not a corridor
        # top-row corridor: east walls of row-0 cells all open in BOTH
        cols = np.arange(1, cells[1]) * 2
        assert np.all(bt[:, 1, cols] != S.WALL)
        assert np.all(sw[:, 1, cols] != S.WALL)

    def test_run_winner_is_roughly_uniform(self):
        """Within closed runs, the north-carving member is picked by random
        key argmax; across many mazes the column histogram of north carves
        must not collapse onto run boundaries (a uniformity smoke check)."""
        b, cells = 512, (2, 8)
        sw, _ = generate_mazes_device(
            jax.random.PRNGKey(41), cells, b, algorithm="sidewinder"
        )
        sw = np.asarray(sw)
        # north walls of row 1: grid[2, 2c+1]
        norths = sw[:, 2, 1::2] != S.WALL  # (B, 8)
        counts = norths.sum(axis=0)
        assert counts.sum() > 0
        # every column sometimes carries a north passage
        assert (counts > 0).all()


class TestWilson:
    """Wilson's algorithm — the uniform-spanning-tree (bias-free) host
    generator."""

    def test_wilson_mazes_are_perfect(self):
        from griduniverse_tpu.levels.maze import (
            check_perfect_maze,
            generate_maze_wilson,
        )

        for seed, cells in [(0, (4, 4)), (1, (5, 3)), (2, (6, 6))]:
            rng = np.random.default_rng(seed)
            grid = generate_maze_wilson(cells, rng)
            assert check_perfect_maze(grid, cells)

    def test_wilson_deterministic_and_diverse(self):
        from griduniverse_tpu.levels.maze import generate_maze_wilson

        a = generate_maze_wilson((5, 5), np.random.default_rng(7))
        b = generate_maze_wilson((5, 5), np.random.default_rng(7))
        c = generate_maze_wilson((5, 5), np.random.default_rng(8))
        np.testing.assert_array_equal(a, b)
        assert (a != c).any()

    def test_wilson_unbiased_vs_binary_tree_texture(self):
        # Binary-tree mazes ALWAYS carve the full top row and right column
        # (the classic bias); a uniform spanning tree does so with
        # vanishing probability. Checks Wilson's is measurably different.
        from griduniverse_tpu.levels.maze import generate_maze_wilson

        full_top_runs = 0
        for seed in range(10):
            grid = generate_maze_wilson((5, 5), np.random.default_rng(seed))
            # row 1 (first cell row): fully open across all passage columns?
            if (grid[1, 1:-1] == 0).all():
                full_top_runs += 1
        assert full_top_runs < 10  # binary-tree would be 10/10


class TestAldousBroderDevice:
    """Device Aldous-Broder (r3): lockstep first-entry random-walk trees —
    EXACTLY uniform over spanning trees, scatter-free (the unbiased
    on-device mass generator)."""

    def test_mazes_are_perfect(self):
        grids, start = generate_mazes_device(
            jax.random.PRNGKey(5), (4, 4), 64, algorithm="aldous_broder"
        )
        assert grids.shape == (64, 9, 9)
        assert int(start) == 10
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (4, 4))

    def test_non_square_perfect(self):
        grids, _ = generate_mazes_device(
            jax.random.PRNGKey(6), (3, 5), 32, algorithm="aldous_broder"
        )
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (3, 5))

    def test_deterministic_and_diverse(self):
        g1, _ = generate_mazes_device(
            jax.random.PRNGKey(7), (4, 4), 16, algorithm="aldous_broder"
        )
        g2, _ = generate_mazes_device(
            jax.random.PRNGKey(7), (4, 4), 16, algorithm="aldous_broder"
        )
        np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))
        flat = np.asarray(g1).reshape(16, -1)
        assert len({t.tobytes() for t in flat}) > 4

    def test_exactly_uniform_on_2x2(self):
        """The 2x2 cell graph is the 4-cycle: exactly 4 spanning trees
        (drop any one of the 4 edges). Aldous-Broder must hit all 4 with
        equal probability — THE distributional property neither
        binary_tree (always 1 tree shape class) nor sidewinder achieves.
        4096 samples, each tree expected ~1024; bound at 5 sigma
        (sigma = sqrt(4096 * 1/4 * 3/4) ~ 27.7)."""
        b = 4096
        grids, _ = generate_mazes_device(
            jax.random.PRNGKey(8), (2, 2), b, algorithm="aldous_broder"
        )
        g = np.asarray(grids)
        # the four carvable walls of the 2x2 lattice: north of (1,0)/(1,1)
        # at grid[2, 1]/[2, 3], west of (0,1)/(1,1) at grid[1, 2]/[3, 2]
        walls = np.stack(
            [g[:, 2, 1], g[:, 2, 3], g[:, 1, 2], g[:, 3, 2]], axis=1
        )
        open_mask = walls != S.WALL  # (B, 4); exactly 3 open per maze
        assert (open_mask.sum(axis=1) == 3).all()
        closed = np.argmin(open_mask, axis=1)  # which edge was dropped
        counts = np.bincount(closed, minlength=4)
        expect = b / 4
        sigma = np.sqrt(b * 0.25 * 0.75)
        assert np.all(np.abs(counts - expect) < 5 * sigma), counts

    def test_no_forced_corridors(self):
        """Unlike binary_tree (west column + top row) and sidewinder (top
        row), Aldous-Broder forces NO corridor: every boundary wall must be
        closed in a nontrivial fraction of mazes."""
        b, cells = 256, (5, 5)
        grids, _ = generate_mazes_device(
            jax.random.PRNGKey(9), cells, b, algorithm="aldous_broder"
        )
        g = np.asarray(grids)
        # top-row east walls: grid[1, 2c], c=1..cw-1
        cols = np.arange(1, cells[1]) * 2
        top_open = (g[:, 1, cols] != S.WALL).mean(axis=0)
        assert np.all(top_open < 0.95)
        # west-column north walls: grid[2r, 1]
        rows = np.arange(1, cells[0]) * 2
        west_open = (g[:, rows, 1] != S.WALL).mean(axis=0)
        assert np.all(west_open < 0.95)

    def test_truncation_repair_keeps_mazes_perfect(self):
        """r3 review: with a cap the walk can't reach (here: artificially
        tiny max_iters), the pre-fix generator silently emitted
        disconnected grids. The binary-tree repair net must keep every
        maze perfect no matter when the walk is cut off."""
        from griduniverse_tpu.levels.maze import _aldous_broder_mazes

        grids = _aldous_broder_mazes(
            jax.random.PRNGKey(4), (5, 5), 32, max_iters=20
        )
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (5, 5))

    def test_default_cap_scales_with_size(self):
        # the review's repro: 16x16-cell mazes need ~10-15k walk steps,
        # past the old fixed 32768-at-best margins; the scaled default
        # cap must cover them (and the repair net backstops the tail)
        grids, _ = generate_mazes_device(
            jax.random.PRNGKey(5), (16, 16), 8, algorithm="aldous_broder"
        )
        for g in np.asarray(grids):
            assert check_perfect_maze(g, (16, 16))


class TestLargeMaze65:
    def test_large_maze_65x65_perfect_and_solvable(self):
        """One size past the benched 33×33 frontier (32×32 cells →
        65×65 grid, S=4225): generation stays perfect and the grid-form
        solver still converges with every cell reaching the goal — the
        large-grid bench stops at 33×33 while correctness coverage
        extends here."""
        from griduniverse_tpu.algos import value_iteration_batched_grid
        from griduniverse_tpu.core.types import Level

        grids, start = generate_mazes_device(
            jax.random.PRNGKey(17), (32, 32), 2, algorithm="binary_tree"
        )
        assert grids.shape == (2, 65, 65)
        for b in range(2):
            g = np.asarray(grids[b]).copy()
            g[g == S.GOAL] = S.EMPTY
            assert check_perfect_maze(g, (32, 32)), f"maze {b} not perfect"
        lv = Level(
            grid=grids.at[:, 63, 63].set(S.GOAL),
            start_idx=jnp.broadcast_to(start, (2,)),
        )
        # At this size the 33×33 test's value-margin check breaks down
        # numerically: with a short-horizon γ, cells ≳230 steps from the
        # goal have V ≈ -1/(1-γ) ± float32-ε (measured: -19.99988 vs
        # the -20 no-goal fixed point at γ=0.95) — and the greedy ARGMAX
        # there ties, so the policy itself goes blind. The framework
        # lesson the test encodes: γ must scale with grid diameter
        # (γ=0.999 keeps neighbor-value gaps ≥γ^L ≈ 0.14 at L=2000,
        # far above float32 resolution ~0.06 near -1000). The robust
        # correctness check is then the POLICY: greedy from the start
        # must reach the goal within a diameter-scale budget.
        from griduniverse_tpu.models import greedy_success_rate_tabular

        v, policy, iters = value_iteration_batched_grid(
            SEM, lv, gamma=0.999, max_iters=4000
        )
        assert int(iters) < 4000
        success = float(
            greedy_success_rate_tabular(SEM, lv, policy, max_steps=2048)
        )
        assert success == 1.0
