"""Batched DP solvers: N mazes solved in one XLA program must agree
per-maze with the unbatched solver (itself oracle-checked in test_dp.py),
and the per-maze greedy policies must actually solve their mazes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from griduniverse_tpu import build_model_table, make_semantics
from griduniverse_tpu.algos import (
    build_model_tables,
    policy_evaluation,
    policy_evaluation_batched,
    policy_iteration_batched,
    value_iteration,
    value_iteration_batched,
)
from griduniverse_tpu.core import semantics as S
from griduniverse_tpu.core.types import Level
from griduniverse_tpu.levels.maze import generate_mazes_device

SEM = make_semantics()
N_MAZES = 16
CELLS = (4, 4)  # 9x9 grids, S = 81


@pytest.fixture(scope="module")
def maze_stack() -> Level:
    grids, start = generate_mazes_device(
        jax.random.PRNGKey(3), CELLS, N_MAZES, algorithm="sidewinder"
    )
    h, w = grids.shape[1], grids.shape[2]
    grids = grids.at[:, h - 2, w - 2].set(S.GOAL)  # per-maze goal
    return Level(grid=grids, start_idx=jnp.broadcast_to(start, (N_MAZES,)))


def _unbatch(levels: Level, i: int) -> Level:
    return Level(grid=levels.grid[i], start_idx=levels.start_idx[i])


def test_build_model_tables_matches_per_maze_build(maze_stack):
    models = build_model_tables(SEM, maze_stack)
    for i in range(0, N_MAZES, 3):
        single = build_model_table(SEM, _unbatch(maze_stack, i))
        np.testing.assert_array_equal(models.next_state[i], single.next_state)
        np.testing.assert_array_equal(models.reward[i], single.reward)
        np.testing.assert_array_equal(models.done[i], single.done)
        np.testing.assert_array_equal(models.terminal[i], single.terminal)


def test_build_model_tables_rejects_unbatched_level():
    from griduniverse_tpu.levels.builders import lava_level

    with pytest.raises(ValueError, match="batched"):
        build_model_tables(SEM, lava_level())


def test_batched_vi_equals_unbatched_vi_per_maze(maze_stack):
    models = build_model_tables(SEM, maze_stack)
    v_b, pol_b, iters = value_iteration_batched(models)
    assert v_b.shape == (N_MAZES, 81) and pol_b.shape == (N_MAZES, 81)
    assert int(iters) > 1
    for i in range(0, N_MAZES, 3):
        single = build_model_table(SEM, _unbatch(maze_stack, i))
        v_s, pol_s, _ = value_iteration(single)
        np.testing.assert_allclose(v_b[i], v_s, rtol=1e-5, atol=1e-5)
        # greedy argmax can differ only where Q ties; compare values of the
        # chosen actions instead of raw action ids
        from griduniverse_tpu.algos import action_values

        q = np.asarray(action_values(single, v_s, 0.99))
        np.testing.assert_allclose(
            q[np.arange(81), np.asarray(pol_b[i])],
            q[np.arange(81), np.asarray(pol_s)],
            rtol=1e-5, atol=1e-5,
        )


def test_select_tree_and_gather_lookups_agree(maze_stack):
    models = build_model_tables(SEM, maze_stack)
    v1, p1, _ = value_iteration_batched(models, lookup="select_tree")
    v2, p2, _ = value_iteration_batched(models, lookup="gather")
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_batched_greedy_policies_solve_their_mazes(maze_stack):
    """The optimality gate: following each maze's greedy policy from the
    start must reach that maze's goal."""
    from griduniverse_tpu.algos import run_greedy_episode

    models = build_model_tables(SEM, maze_stack)
    _, pol_b, _ = value_iteration_batched(models)
    goal_r = float(SEM.reward[S.GOAL])
    step_r = float(SEM.reward[S.EMPTY])
    for i in range(N_MAZES):
        level = _unbatch(maze_stack, i)
        _, ret, length, done = run_greedy_episode(
            SEM, level, pol_b[i], max_steps=200
        )
        # mazes have no lava, so done ⇒ the goal tile was reached; the
        # return must decompose as (length-1) step costs + the goal reward
        assert bool(done), f"maze {i}: greedy policy never terminated"
        expect = (int(length) - 1) * step_r + goal_r
        assert float(ret) == expect, f"maze {i}: {float(ret)} != {expect}"


def test_batched_policy_evaluation_matches_unbatched(maze_stack):
    models = build_model_tables(SEM, maze_stack)
    _, pol_b, _ = value_iteration_batched(models)
    v_b, _ = policy_evaluation_batched(models, pol_b)
    for i in range(0, N_MAZES, 5):
        single = build_model_table(SEM, _unbatch(maze_stack, i))
        v_s, _ = policy_evaluation(single, pol_b[i])
        np.testing.assert_allclose(v_b[i], v_s, rtol=1e-5, atol=1e-5)


def test_batched_pi_agrees_with_batched_vi(maze_stack):
    models = build_model_tables(SEM, maze_stack)
    v_vi, _, _ = value_iteration_batched(models)
    v_pi, _, iters = policy_iteration_batched(models)
    assert int(iters) >= 2
    np.testing.assert_allclose(np.asarray(v_pi), np.asarray(v_vi), atol=1e-3)


def test_batched_vi_sharded_matches_unsharded(maze_stack):
    from griduniverse_tpu.parallel import (
        make_env_mesh,
        value_iteration_batched_sharded,
    )

    mesh = make_env_mesh()
    models = build_model_tables(SEM, maze_stack)
    v_u, p_u, it_u = value_iteration_batched(models)
    v_s, p_s, it_s = value_iteration_batched_sharded(mesh, models)
    np.testing.assert_allclose(np.asarray(v_s), np.asarray(v_u), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(p_s), np.asarray(p_u))
    assert int(it_s) == int(it_u)


def test_batched_vi_sharded_rejects_indivisible():
    from griduniverse_tpu.parallel import (
        make_env_mesh,
        value_iteration_batched_sharded,
    )

    mesh = make_env_mesh()
    grids, start = generate_mazes_device(
        jax.random.PRNGKey(0), CELLS, 6, algorithm="binary_tree"
    )
    levels = Level(grid=grids, start_idx=jnp.broadcast_to(start, (6,)))
    models = build_model_tables(SEM, levels)
    if mesh.size > 1:
        with pytest.raises(ValueError, match="divisible"):
            value_iteration_batched_sharded(mesh, models)


def test_batched_pi_sharded_matches_unsharded(maze_stack):
    from griduniverse_tpu.parallel import (
        make_env_mesh,
        policy_iteration_batched_sharded,
    )

    mesh = make_env_mesh()
    models = build_model_tables(SEM, maze_stack)
    v_u, p_u, _ = policy_iteration_batched(models)
    v_s, p_s, it_s = policy_iteration_batched_sharded(mesh, models)
    np.testing.assert_allclose(np.asarray(v_s), np.asarray(v_u), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(p_s), np.asarray(p_u))
    assert int(it_s) >= 2


class TestGridFormVI:
    """value_iteration_batched_grid (r4): the static-candidate backup must
    be BIT-identical to the table + select-tree form."""

    def test_bitequal_to_table_form(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from griduniverse_tpu.algos import (
            build_model_tables,
            value_iteration_batched,
            value_iteration_batched_grid,
        )
        from griduniverse_tpu.core import semantics as S
        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.levels.maze import generate_mazes_device

        grids, start = generate_mazes_device(
            jax.random.PRNGKey(3), (3, 3), 32, algorithm="aldous_broder"
        )
        grids = grids.at[:, 5, 5].set(S.GOAL)
        levels = Level(grid=grids, start_idx=jnp.broadcast_to(start, (32,)))
        model = build_model_tables(SEM, levels)
        va, pa, ia = value_iteration_batched(model)
        vg, pg, ig = value_iteration_batched_grid(SEM, levels)
        # a SINGLE backup is bit-identical across the two forms (checked
        # below); across sweeps backend-specific FMA fusion can drift the
        # last ulp (CPU does)
        # — so assert V to float tolerance and policies by their chosen
        # action VALUES (ulp drift may flip exact ties)
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vg), atol=1e-4, rtol=1e-5
        )
        assert int(ia) == int(ig)
        from griduniverse_tpu.algos.dp_batched import action_values_batched

        q = np.asarray(action_values_batched(model, va, 0.99))
        qa = np.take_along_axis(q, np.asarray(pa)[..., None], -1)
        qg = np.take_along_axis(q, np.asarray(pg)[..., None], -1)
        np.testing.assert_allclose(qa, qg, atol=1e-4)

        # the single-backup bit-identity that grounds the claim
        import jax.numpy as _jnp

        v0 = _jnp.zeros_like(va)
        q_table = action_values_batched(model, v0, 0.99)
        from griduniverse_tpu.algos.dp_batched import (
            _static_geometry,
        )
        from griduniverse_tpu.ops.bitplane import _per_code

        h, w, cand_t, inb_t = _static_geometry(SEM, levels)
        s = h * w
        codes = levels.grid.reshape(-1, s)
        cand_idx = _jnp.asarray(cand_t, _jnp.int32).reshape(s, -1)
        in_b = _jnp.asarray(inb_t, bool).reshape(s, -1)
        cand_code = codes[:, cand_idx]
        blocked = ~in_b[None] | ~_per_code(SEM.passable, cand_code)
        new_code = _jnp.where(blocked, codes[:, :, None], cand_code)
        cont = _jnp.where(blocked, v0[:, :, None], v0[:, cand_idx])
        cont = _jnp.where(_per_code(SEM.terminal, new_code), 0.0, cont)
        q_grid = _jnp.where(
            _per_code(SEM.terminal, codes)[:, :, None],
            0.0,
            _per_code(SEM.reward, new_code) + 0.99 * cont,
        )
        np.testing.assert_array_equal(np.asarray(q_table), np.asarray(q_grid))

    def test_rejects_shared_level(self):
        import pytest as _pytest

        from griduniverse_tpu.algos import value_iteration_batched_grid
        from griduniverse_tpu.levels.builders import lava_level

        with _pytest.raises(ValueError, match="batched"):
            value_iteration_batched_grid(SEM, lava_level())

    def test_validated_solve_routes_around_bad_shapes(self):
        """r5 miscompile defense: `_validated_solve` re-solves a 64-maze
        slice as its own program and, on mismatch, splits the batch in
        half recursively — so a shape the toolchain miscompiles yields
        correct (slower) answers instead of silent garbage."""
        import jax.numpy as jnp
        import numpy as np

        from griduniverse_tpu.algos.dp_batched import _validated_solve
        from griduniverse_tpu.core.types import Level

        n, s = 256, 9
        grids = jnp.zeros((n, 3, 3), jnp.int32)
        lv = Level(grid=grids, start_idx=jnp.zeros((n,), jnp.int32))
        calls = []

        def solve(levels):
            m = levels.grid.shape[0]
            calls.append(m)
            v = jnp.broadcast_to(
                jnp.arange(s, dtype=jnp.float32), (m, s)
            )
            if m > 128:  # the "miscompiled shape": garbage everywhere
                v = v + 1000.0
            p = jnp.zeros((m, s), jnp.int32)
            return v, p, jnp.asarray(7, jnp.int32)

        v, p, iters = _validated_solve(solve, lv, True)
        # the 256-maze result was detected as corrupt and re-solved in
        # two good 128-maze halves (each slice-validated in turn)
        assert v.shape == (n, s)
        good = np.broadcast_to(np.arange(s, dtype=np.float32), (n, s))
        np.testing.assert_array_equal(np.asarray(v), good)
        assert 256 in calls and calls.count(128) >= 2
        assert int(iters) == 7

        # happy path: consistent solve → no splitting
        calls.clear()

        def solve_ok(levels):
            m = levels.grid.shape[0]
            calls.append(m)
            return (
                jnp.ones((m, s), jnp.float32),
                jnp.zeros((m, s), jnp.int32),
                jnp.asarray(3, jnp.int32),
            )

        v, _, _ = _validated_solve(solve_ok, lv, True)
        assert calls == [256, 64]
        np.testing.assert_array_equal(np.asarray(v), np.ones((n, s)))

        # validate=False: no slice call at all
        calls.clear()
        _validated_solve(solve_ok, lv, False)
        assert calls == [256]

    def test_fused_check_path(self):
        """r5b: when a fused `check(v, levels, k)` is supplied, the
        validation uses it instead of a second `solve` call (one
        piggybacked program), still splits on a failing check, and
        passes the check down into the half-batch recursion."""
        import jax.numpy as jnp
        import numpy as np

        from griduniverse_tpu.algos.dp_batched import _validated_solve
        from griduniverse_tpu.core.types import Level

        n, s = 256, 9
        lv = Level(
            grid=jnp.zeros((n, 3, 3), jnp.int32),
            start_idx=jnp.zeros((n,), jnp.int32),
        )
        solve_calls, check_calls = [], []

        def solve(levels):
            m = levels.grid.shape[0]
            solve_calls.append(m)
            return (
                jnp.ones((m, s), jnp.float32),
                jnp.zeros((m, s), jnp.int32),
                jnp.asarray(3, jnp.int32),
            )

        def check_ok(v, levels, k):
            check_calls.append((levels.grid.shape[0], k))
            return jnp.asarray(True)

        v, _, _ = _validated_solve(solve, lv, True, check_ok)
        # exactly ONE solve (no reference re-solve through `solve`) and
        # one check over the full arrays with k=64
        assert solve_calls == [256]
        assert check_calls == [(256, 64)]
        np.testing.assert_array_equal(np.asarray(v), np.ones((n, s)))

        # a failing check splits, and the HALVES are validated with the
        # same fused check (which then passes at 128)
        solve_calls.clear()
        check_calls.clear()

        def check_big_bad(v, levels, k):
            check_calls.append((levels.grid.shape[0], k))
            return jnp.asarray(levels.grid.shape[0] <= 128)

        v, _, iters = _validated_solve(solve, lv, True, check_big_bad)
        assert solve_calls == [256, 128, 128]
        assert check_calls == [(256, 64), (128, 64), (128, 64)]
        assert v.shape == (n, s)
        assert int(iters) == 3

    def test_vi_grid_check_matches_allclose_semantics(self):
        """The device-side comparison used by the fused check must agree
        with the old host-side np.allclose(atol=1e-4, rtol=1e-5)."""
        import jax.numpy as jnp
        import numpy as np

        from griduniverse_tpu.algos.dp_batched import _close

        a = jnp.asarray([1.0, 2.0, 3.0])
        for delta, want in ((5e-5, True), (5e-4, False)):
            b = a + delta
            assert bool(_close(a, b)) == want
            assert want == np.allclose(
                np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-5
            )


class TestGridFormPI:
    """policy_iteration_batched_grid (r4): the static-candidate backup
    driving Howard PI — same contract as the table form."""

    def test_matches_table_form(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from griduniverse_tpu.algos import (
            build_model_tables,
            policy_iteration_batched,
            policy_iteration_batched_grid,
            action_values_batched,
        )
        from griduniverse_tpu.core import semantics as SEMA
        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.levels.maze import generate_mazes_device

        grids, start = generate_mazes_device(
            jax.random.PRNGKey(6), (3, 3), 16, algorithm="aldous_broder"
        )
        grids = grids.at[:, 5, 5].set(SEMA.GOAL)
        levels = Level(grid=grids, start_idx=jnp.broadcast_to(start, (16,)))
        model = build_model_tables(SEM, levels)
        va, pa, ia = policy_iteration_batched(model)
        vg, pg, ig = policy_iteration_batched_grid(SEM, levels)
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vg), atol=1e-4, rtol=1e-5
        )
        assert int(ia) == int(ig)
        # policies equivalent by chosen action VALUES (ulp-tie tolerance)
        q = np.asarray(action_values_batched(model, va, 0.99))
        qa = np.take_along_axis(q, np.asarray(pa)[..., None], -1)
        qg = np.take_along_axis(q, np.asarray(pg)[..., None], -1)
        np.testing.assert_allclose(qa, qg, atol=1e-4)

    def test_agrees_with_grid_vi(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from griduniverse_tpu.algos import (
            policy_iteration_batched_grid,
            value_iteration_batched_grid,
        )
        from griduniverse_tpu.core import semantics as SEMA
        from griduniverse_tpu.core.types import Level
        from griduniverse_tpu.levels.maze import generate_mazes_device

        grids, start = generate_mazes_device(
            jax.random.PRNGKey(7), (3, 3), 8, algorithm="binary_tree"
        )
        grids = grids.at[:, 5, 5].set(SEMA.GOAL)
        levels = Level(grid=grids, start_idx=jnp.broadcast_to(start, (8,)))
        v_vi, _, _ = value_iteration_batched_grid(SEM, levels)
        v_pi, _, _ = policy_iteration_batched_grid(SEM, levels)
        np.testing.assert_allclose(
            np.asarray(v_vi), np.asarray(v_pi), atol=1e-4, rtol=1e-5
        )

    def test_rejects_shared_level(self):
        import pytest as _pytest

        from griduniverse_tpu.algos import policy_iteration_batched_grid
        from griduniverse_tpu.levels.builders import lava_level

        with _pytest.raises(ValueError, match="batched"):
            policy_iteration_batched_grid(SEM, lava_level())
