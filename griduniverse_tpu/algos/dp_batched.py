"""Batched DP solvers — value/policy iteration over N mazes AT ONCE.

The reference solves one env at a time (SURVEY.md §3.3). This framework can
generate 64k distinct mazes on device in milliseconds (levels/maze.py,
BASELINE config 4); these solvers close the loop by solving ALL of them in
one XLA program: the model table gains a leading maze axis N and every sweep
is a batched (N, S, A) backup. "On-device tabular solvers over the
vectorized model" (SURVEY.md §2.3 row 4) for the per-env-level case.

Design notes:

  * The successor-value lookup `V[n, next_state[n, s, a]]` is the only
    non-elementwise op in a sweep. The default lookup is the same
    branchless SELECT-TREE used by the bit-packed step: S-1 vectorized
    `jnp.where`s over (N, S, A) lanes that XLA fuses into the backup. It
    was chosen on the TPU, where a vmapped dynamic gather serializes;
    `lookup="auto"` switches to the gather past 2048 states, where
    PROGRAM SIZE (S−1 unrolled selects) becomes the cost; see
    _SELECT_TREE_MAX_STATES below. ROADMAP Design item 1 re-tests the
    choice on the GPU. On CPU pass `lookup="gather"` explicitly.
  * One `lax.while_loop` for ALL mazes, converged when the max |ΔV| over
    every maze is < theta. Per-maze early exit would buy nothing: lanes
    advance in lockstep on SIMD hardware, and a converged lane's extra
    sweeps are fixed points (V unchanged), so the global-max test is both
    correct and the fastest formulation.
  * Everything vmaps over the maze axis with NO collectives, so the
    sharded variant (parallel/dp.py value_iteration_batched_sharded) is an
    embarrassingly-parallel shard_map over N.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.model import ModelTable, build_model_table
from ..core.semantics import Semantics
from ..core.types import Level
from ..ops.bitplane import _select_tree

# Past this many states "auto" uses the gather instead of the select
# tree: the tree is S−1 unrolled selects per lookup, and the program (and
# its compile time) grows with it. Set on the TPU, where the gather
# serialized; ROADMAP Design item 1 re-tests it. Grid-shaped models should
# use the grid-form solvers instead — their static-reindex backup is
# S-independent per lane.
_SELECT_TREE_MAX_STATES = 2048

# Above this many N·S cells a grid-form solve is slice-validated by
# default: the loop miscompiles once seen on a TPU toolchain hit only
# large batches, and the check (a 64-maze re-solve + compare) is small
# beside a solve of that size. ROADMAP Design item 2 decides whether the
# guard stays.
_VALIDATE_MIN_CELLS = 1 << 23


def _close_expr(a, b):
    """Device-side `np.allclose(a, b, atol=1e-4, rtol=1e-5)` — the
    miscompile check of `_validated_solve`, kept on device so the only
    host round trip is one scalar bool."""
    return jnp.all(jnp.abs(a - b) <= 1e-4 + 1e-5 * jnp.abs(b))


_close = jax.jit(_close_expr)


@partial(jax.jit, static_argnames=("k", "geom", "max_iters"))
def _vi_grid_check(sem, v, grids, k, geom, gamma, theta, max_iters):
    """Fused validation program for the grid-form VI: slice the first
    k mazes, re-solve them, AND compare — all in ONE compiled program
    returning a scalar bool (full `v`/`grids` device arrays are passed
    so the slicing costs no separate dispatch). The reference solve
    still lives in a different program than the big solve (that
    separation is the diagnostic) but piggybacks the compare's
    dispatch."""
    v_ref, _, _ = _vi_grid_impl(
        sem, grids[:k], geom, gamma, theta, max_iters
    )
    return _close_expr(v[:k], v_ref)


@partial(
    jax.jit,
    static_argnames=("k", "geom", "max_eval_iters", "max_policy_iters"),
)
def _pi_grid_check(
    sem, v, grids, k, geom, gamma, theta, max_eval_iters, max_policy_iters
):
    """PI twin of `_vi_grid_check`."""
    v_ref, _, _ = _pi_grid_impl(
        sem, grids[:k], geom, gamma, theta, max_eval_iters, max_policy_iters
    )
    return _close_expr(v[:k], v_ref)


def _slice_levels(levels: Level, lo: int, hi: int) -> Level:
    n = levels.grid.shape[0]
    start = jnp.broadcast_to(jnp.reshape(levels.start_idx, (-1,)), (n,))
    return Level(grid=levels.grid[lo:hi], start_idx=start[lo:hi])


def _validated_solve(solve, levels: Level, validate: bool | None,
                     check=None):
    """Run `solve(levels) -> (v, policy, iters)` with miscompile
    detection: re-solve a 64-maze slice as its OWN program (the
    diagnostic that exposed both known codegen bugs — one loop-free /
    small-batch application of the same math is correct even where the
    large loop program is not) and compare. On mismatch, split the
    batch in half and recurse — each half re-validates, so any set of
    bad shapes is routed around, not just the cataloged ones.

    check — optional jit-cached `check(v, levels, k) -> bool array`
    (full arrays; slices the first k mazes internally) that fuses the
    slicing, the reference re-solve, and the comparison into one
    compiled program (still distinct from the big solve's program, so
    the diagnostic separation holds). With it, an armed validation
    costs one piggybacked dispatch instead of several; without it, the
    generic path re-solves via `solve` and compares with `_close`."""
    n = levels.grid.shape[0]
    v, policy, iters = solve(levels)
    if validate is None:
        validate = (
            n * levels.grid.shape[1] * levels.grid.shape[2]
            >= _VALIDATE_MIN_CELLS
        )
    if (
        not validate
        or n <= 64
        or isinstance(levels.grid, jax.core.Tracer)
    ):
        return v, policy, iters
    k = min(64, n)
    # compare ON DEVICE and fetch one scalar bool: everything is
    # already in flight (async dispatch), so the validation's serial
    # cost is a single fetch — and with a fused `check`, the reference
    # solve rides the compare's dispatch too
    if check is not None:
        ok = bool(check(v, levels, k))
    else:
        v_ref, _, _ = solve(_slice_levels(levels, 0, k))
        ok = bool(_close(v[:k], v_ref))
    if ok:
        return v, policy, iters
    # miscompiled shape: route around it in two half-batches
    half = n // 2
    v1, p1, i1 = _validated_solve(
        solve, _slice_levels(levels, 0, half), True, check
    )
    v2, p2, i2 = _validated_solve(
        solve, _slice_levels(levels, half, n), True, check
    )
    return (
        jnp.concatenate([v1, v2]),
        jnp.concatenate([p1, p2]),
        jnp.maximum(i1, i2),
    )


def build_model_tables(sem: Semantics, levels: Level) -> ModelTable:
    """Model tables for a BATCHED level (grid (N, H, W)) — leaves gain a
    leading N axis: next_state/reward/done (N, S, A), terminal (N, S).

    NOT a vmap of build_model_table: the candidate-successor geometry
    (which cell each (state, action) pair targets, and whether it is in
    bounds) is IDENTICAL for every maze, so it is computed once on the
    HOST and baked into the compiled build as a static index table — the
    per-maze work reduces to a constant-index reindex of the code grid
    plus tiny-table select trees, no dynamic gathers at all (the vmapped
    scalar-`_move` build compiles far slower). Bit-identical to per-maze
    build_model_table (tests/test_dp_batched.py).

    Requires a CONCRETE `sem` (the normal case — semantics tables are tiny
    host constants); under jit it falls back to the vmapped build.
    """
    if levels.grid.ndim != 3:
        raise ValueError(
            f"build_model_tables expects a batched (N, H, W) level grid; "
            f"got shape {levels.grid.shape} — use build_model_table"
        )
    import numpy as np

    try:
        deltas = np.asarray(sem.deltas)
    except jax.errors.TracerArrayConversionError:
        # traced sem (call under an outer jit): vmapped fallback
        start = jnp.broadcast_to(levels.start_idx, levels.grid.shape[:1])
        return jax.vmap(lambda g, s: build_model_table(sem, Level(g, s)))(
            levels.grid, start
        )

    return _build_tables_impl(sem, levels.grid, _static_geometry(sem, levels))


@partial(jax.jit, static_argnames=("geom",))
def _build_tables_impl(sem, grids, geom) -> ModelTable:
    from ..ops.bitplane import _per_code

    h, w, cand_tuple, inb_tuple = geom
    s = h * w
    a = len(cand_tuple) // s
    n = grids.shape[0]
    codes = grids.reshape(n, s)
    cand_idx = jnp.asarray(cand_tuple, jnp.int32).reshape(s, a)
    in_bounds = jnp.asarray(inb_tuple, bool).reshape(s, a)
    states = jnp.arange(s, dtype=jnp.int32)

    cand_code = codes[:, cand_idx]  # constant-index reindex, XLA-foldable
    blocked = ~in_bounds[None] | ~_per_code(sem.passable, cand_code)
    next_state = jnp.where(blocked, states[None, :, None], cand_idx[None])
    new_code = jnp.where(blocked, codes[:, :, None], cand_code)
    return ModelTable(
        next_state=next_state.astype(jnp.int32),
        reward=_per_code(sem.reward, new_code),
        done=_per_code(sem.terminal, new_code),
        terminal=_per_code(sem.terminal, codes),
    )


def _successor_values(
    v: jnp.ndarray, next_state: jnp.ndarray, lookup: str
) -> jnp.ndarray:
    """V[n, next_state[n, s, a]] → (N, S, A), per-maze."""
    s = v.shape[-1]
    if lookup == "auto":
        lookup = "select_tree" if s <= _SELECT_TREE_MAX_STATES else "gather"
    if lookup == "select_tree":
        leaves = [v[:, k, None, None] for k in range(s)]
        return _select_tree(leaves, next_state)
    if lookup == "gather":
        return jax.vmap(lambda vn, nn: vn[nn])(v, next_state)
    raise ValueError(f"unknown lookup mode: {lookup!r}")


def action_values_batched(
    model: ModelTable, v: jnp.ndarray, gamma: float, lookup: str = "auto"
) -> jnp.ndarray:
    """Batched Q(n, s, a) = r + γ·V(n, s') with no bootstrap through
    terminals — the (N,)-leading twin of algos.dp.action_values."""
    cont = jnp.where(model.done, 0.0, _successor_values(v, model.next_state, lookup))
    q = model.reward + gamma * cont
    return jnp.where(model.terminal[:, :, None], 0.0, q)


def _static_geometry(sem: Semantics, levels: Level):
    """Host-side candidate-successor geometry shared by every maze (the
    build_model_tables trick): (h, w, cand_idx tuple, in_bounds tuple)."""
    import numpy as np

    deltas = np.asarray(sem.deltas)
    h, w = int(levels.grid.shape[1]), int(levels.grid.shape[2])
    states = np.arange(h * w, dtype=np.int32)
    row, col = states // w, states % w
    nrow = row[:, None] + deltas[None, :, 0]
    ncol = col[:, None] + deltas[None, :, 1]
    in_bounds = (nrow >= 0) & (nrow < h) & (ncol >= 0) & (ncol < w)
    cand = np.clip(nrow, 0, h - 1) * w + np.clip(ncol, 0, w - 1)
    return (
        h,
        w,
        tuple(int(v) for v in cand.reshape(-1)),
        tuple(bool(v) for v in in_bounds.reshape(-1)),
    )


def value_iteration_batched_grid(
    sem: Semantics,
    levels: Level,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    validate: bool | None = None,
):
    """VI over N mazes DIRECTLY from the batched grid — the fastest exact
    form.

    validate — slice-validate the solve against a 64-maze re-solve and
    auto-split on mismatch (a defense against shape-specific loop
    miscompiles, first seen on a TPU toolchain).
    Default None = only for large solves (N·H·W ≥ 2^23). Skipped under
    an outer jit (traced grids).

    The generic batched sweep treats next_state as arbitrary (N, S, A)
    data and pays an S−1-node select tree per successor lookup. But the
    gridworld structure says next = blocked ? s : cand, and the candidate
    cell per (s, a) is STATIC — identical for every maze. So the backup
    collapses to one constant-index reindex `V[:, cand_idx]` (a
    compile-time shuffle, no dynamic gather) plus ONE select against the
    precomputed blocked mask: 80 selects → 2 ops per (n, s, a).

    A single backup is bit-identical to the table form on every backend;
    across sweeps, backend FMA fusion may drift the last ulp (CPU does).
    The select-tree form remains the engine for
    `value_iteration_batched`'s general (N, S, A) tables — e.g. models
    not built from a grid.

    Returns (V (N, S), policy (N, S), iters) — same contract as
    value_iteration_batched(build_model_tables(sem, levels))."""
    if levels.grid.ndim != 3:
        raise ValueError(
            f"expected a batched (N, H, W) level grid; got "
            f"{levels.grid.shape}"
        )
    try:
        geom = _static_geometry(sem, levels)
    except jax.errors.TracerArrayConversionError:
        # traced sem (call under an outer jit): the static-candidate
        # geometry can't be baked — keep the contract via the table form
        return value_iteration_batched(
            build_model_tables(sem, levels), gamma, theta, max_iters
        )
    def solve(lv):
        return _vi_grid_impl(sem, lv.grid, geom, gamma, theta, max_iters)

    def check(v, lv, k):
        return _vi_grid_check(
            sem, v, lv.grid, k, geom, gamma, theta, max_iters
        )

    return _validated_solve(solve, levels, validate, check)


def _grid_backup(sem, grids, geom, gamma):
    """The static-candidate backup closure shared by the grid-form
    solvers: `backup(v) -> Q (N, S, A)` plus the (N, S) shape."""
    from ..ops.bitplane import _per_code

    h, w, cand_tuple, inb_tuple = geom
    s = h * w
    n = grids.shape[0]
    codes = grids.reshape(n, s)
    cand_idx = jnp.asarray(cand_tuple, jnp.int32).reshape(s, -1)
    in_bounds = jnp.asarray(inb_tuple, bool).reshape(s, -1)

    cand_code = codes[:, cand_idx]
    blocked = ~in_bounds[None] | ~_per_code(sem.passable, cand_code)
    new_code = jnp.where(blocked, codes[:, :, None], cand_code)
    rew = _per_code(sem.reward, new_code)
    done = _per_code(sem.terminal, new_code)
    term = _per_code(sem.terminal, codes)

    def backup(v):
        vc = v[:, cand_idx]                     # static reindex, no gather
        cont = jnp.where(blocked, v[:, :, None], vc)
        cont = jnp.where(done, 0.0, cont)
        q = rew + gamma * cont
        return jnp.where(term[:, :, None], 0.0, q)

    return backup, (n, s)


@partial(jax.jit, static_argnames=("geom", "max_iters"))
def _vi_grid_impl(sem, grids, geom, gamma, theta, max_iters):
    backup, (n, s) = _grid_backup(sem, grids, geom, gamma)
    v0 = jnp.zeros((n, s), jnp.float32)

    def cond(carry):
        _, delta, i = carry
        return (delta >= theta) & (i < max_iters)

    def body(carry):
        v, _, i = carry
        v_new = jnp.max(backup(v), axis=-1)
        return v_new, jnp.max(jnp.abs(v_new - v)), i + 1

    v, _, iters = jax.lax.while_loop(
        cond, body, (v0, jnp.float32(jnp.inf), 0)
    )
    policy = jnp.argmax(backup(v), axis=-1).astype(jnp.int32)
    return v, policy, iters


@partial(jax.jit, static_argnames=("max_iters", "lookup"))
def value_iteration_batched(
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    lookup: str = "auto",
):
    """VI over all N mazes at once. Returns (V (N, S), policy (N, S),
    iters () — sweeps until EVERY maze converged)."""
    n, s = model.terminal.shape
    v0 = jnp.zeros((n, s), jnp.float32)

    def cond(carry):
        _, delta, i = carry
        return (delta >= theta) & (i < max_iters)

    def body(carry):
        v, _, i = carry
        q = action_values_batched(model, v, gamma, lookup)
        v_new = jnp.max(q, axis=-1)
        delta = jnp.max(jnp.abs(v_new - v))  # max over ALL mazes
        return v_new, delta, i + 1

    v, _, iters = jax.lax.while_loop(cond, body, (v0, jnp.float32(jnp.inf), 0))
    policy = jnp.argmax(
        action_values_batched(model, v, gamma, lookup), axis=-1
    ).astype(jnp.int32)
    return v, policy, iters


def _eval_sweep_loop(model, pi, gamma, theta, max_iters, lookup):
    """Shared eval while_loop: sweep V under fixed per-maze action probs
    `pi` (N, S, A) until max |dV| < theta. Returns (V (N, S), iters)."""
    n, s = model.terminal.shape

    def cond(carry):
        _, delta, i = carry
        return (delta >= theta) & (i < max_iters)

    def body(carry):
        v, _, i = carry
        q = action_values_batched(model, v, gamma, lookup)
        v_new = jnp.sum(pi * q, axis=-1)
        delta = jnp.max(jnp.abs(v_new - v))
        return v_new, delta, i + 1

    v, _, iters = jax.lax.while_loop(
        cond, body, (jnp.zeros((n, s), jnp.float32), jnp.float32(jnp.inf), 0)
    )
    return v, iters


@partial(jax.jit, static_argnames=("max_iters", "lookup"))
def policy_evaluation_batched(
    model: ModelTable,
    policy: jnp.ndarray,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    lookup: str = "auto",
):
    """Iterative evaluation of per-maze policies. `policy` — (N, S) int32
    deterministic or (N, S, A) float32 stochastic. Returns (V (N, S), iters)."""
    num_actions = model.next_state.shape[-1]
    if policy.ndim == 2:
        # one-hot sum, not take_along_axis — A is tiny, stays gather-free
        pi = jax.nn.one_hot(policy, num_actions, dtype=jnp.float32)
    else:
        pi = policy
    return _eval_sweep_loop(model, pi, gamma, theta, max_iters, lookup)


@partial(jax.jit, static_argnames=("max_eval_iters", "max_policy_iters", "lookup"))
def policy_iteration_batched(
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
    lookup: str = "auto",
):
    """Howard PI over all N mazes at once: evaluate-then-improve until the
    policy is stable in EVERY maze. Returns (V (N, S), policy (N, S), iters)."""
    n, s = model.terminal.shape
    num_actions = model.next_state.shape[-1]
    policy0 = jnp.zeros((n, s), jnp.int32)

    def cond(carry):
        _, _, stable, i = carry
        return jnp.logical_not(stable) & (i < max_policy_iters)

    def body(carry):
        policy, _, _, i = carry
        pi = jax.nn.one_hot(policy, num_actions, dtype=jnp.float32)
        v, _ = _eval_sweep_loop(model, pi, gamma, theta, max_eval_iters, lookup)
        new_policy = jnp.argmax(
            action_values_batched(model, v, gamma, lookup), axis=-1
        ).astype(jnp.int32)
        stable = jnp.all(new_policy == policy)
        return new_policy, v, stable, i + 1

    policy, v, _, iters = jax.lax.while_loop(
        cond,
        body,
        (policy0, jnp.zeros((n, s), jnp.float32), jnp.asarray(False), 0),
    )
    return v, policy, iters


def policy_iteration_batched_grid(
    sem: Semantics,
    levels: Level,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
    validate: bool | None = None,
):
    """Howard PI over N mazes directly from the batched grid — the
    static-candidate backup (`value_iteration_batched_grid`) driving the
    evaluate-then-improve loop: eval sweeps contract Q under the current
    per-maze policies (one-hot sum over the tiny action axis, gather
    free), improvement is an argmax, stop when every maze's policy is
    stable. Same contract as
    policy_iteration_batched(build_model_tables(sem, levels)).
    `validate` as in value_iteration_batched_grid (slice-validation
    against the toolchain's shape-specific loop miscompiles).

    Returns (V (N, S), policy (N, S), outer iters)."""
    if levels.grid.ndim != 3:
        raise ValueError(
            f"expected a batched (N, H, W) level grid; got "
            f"{levels.grid.shape}"
        )
    try:
        geom = _static_geometry(sem, levels)
    except jax.errors.TracerArrayConversionError:
        # traced sem: fall back to the table form (see the VI twin)
        return policy_iteration_batched(
            build_model_tables(sem, levels), gamma, theta, max_eval_iters,
            max_policy_iters,
        )
    def solve(lv):
        return _pi_grid_impl(
            sem, lv.grid, geom, gamma, theta, max_eval_iters,
            max_policy_iters,
        )

    def check(v, lv, k):
        return _pi_grid_check(
            sem, v, lv.grid, k, geom, gamma, theta, max_eval_iters,
            max_policy_iters,
        )

    return _validated_solve(solve, levels, validate, check)


@partial(jax.jit, static_argnames=("geom", "max_eval_iters", "max_policy_iters"))
def _pi_grid_impl(
    sem, grids, geom, gamma, theta, max_eval_iters, max_policy_iters
):
    backup, (n, s) = _grid_backup(sem, grids, geom, gamma)
    a = len(geom[2]) // s

    def eval_loop(pi):
        def cond(carry):
            _, delta, i = carry
            return (delta >= theta) & (i < max_eval_iters)

        def body(carry):
            v, _, i = carry
            v_new = jnp.sum(pi * backup(v), axis=-1)
            return v_new, jnp.max(jnp.abs(v_new - v)), i + 1

        v, _, _ = jax.lax.while_loop(
            cond, body, (jnp.zeros((n, s), jnp.float32),
                         jnp.float32(jnp.inf), 0)
        )
        return v

    def cond(carry):
        _, _, stable, i = carry
        return jnp.logical_not(stable) & (i < max_policy_iters)

    def body(carry):
        policy, _, _, i = carry
        v = eval_loop(jax.nn.one_hot(policy, a, dtype=jnp.float32))
        new_policy = jnp.argmax(backup(v), axis=-1).astype(jnp.int32)
        stable = jnp.all(new_policy == policy)
        return new_policy, v, stable, i + 1

    policy, v, _, iters = jax.lax.while_loop(
        cond,
        body,
        (jnp.zeros((n, s), jnp.int32), jnp.zeros((n, s), jnp.float32),
         jnp.asarray(False), 0),
    )
    return v, policy, iters
