"""Random maze generation — host-side parity path + on-device mass path.

Reference (SURVEY.md §2.1 #3, reconstructed): a `random_maze=True`-style
constructor flag running a DFS/recursive-backtracker-style generator seeded
by Python `random`.

Two implementations (SURVEY.md §7.3 "On-device maze generation"):

  * `generate_maze_numpy` — host NumPy ITERATIVE BACKTRACKER (the classic
    recursive backtracker with an explicit stack). This is the parity/golden
    path: deterministic under a NumPy seed, used for single-level construction
    and for cross-checking the device generator's well-formedness.

  * `generate_mazes_device` — on-device generator for the 64k-envs config
    (BASELINE config 4): one maze per env, vmapped. It runs the SAME
    iterative backtracker as a `lax.while_loop` with an explicit stack array
    (recursion → iteration, dynamic control flow → masked fixed-shape ops),
    so every env's maze is a perfect maze (spanning tree over the cell
    lattice: all cells reachable, no loops).

Maze layout convention (both paths): a maze of `cells = (ch, cw)` cells maps
to a grid of shape (2·ch+1, 2·cw+1): odd (row, col) are cells, even rows/cols
are wall lines, with passages carved between visited neighbors. Start is the
top-left cell; the goal is placed at the bottom-right cell.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import semantics as S
from ..core.types import Level, make_level


def _maze_shape(cells: tuple[int, int]) -> tuple[int, int]:
    ch, cw = cells
    return 2 * ch + 1, 2 * cw + 1


def generate_maze_numpy(
    cells: tuple[int, int], rng: np.random.Generator
) -> np.ndarray:
    """Iterative-backtracker perfect maze; returns (H, W) int32 tile codes
    (WALL / EMPTY). Host-side parity path."""
    ch, cw = cells
    h, w = _maze_shape(cells)
    grid = np.full((h, w), S.WALL, dtype=np.int32)
    visited = np.zeros((ch, cw), dtype=bool)

    stack = [(0, 0)]
    visited[0, 0] = True
    grid[1, 1] = S.EMPTY
    # fixed neighbor order (up, right, down, left) shuffled per expansion
    deltas = np.array([(-1, 0), (0, 1), (1, 0), (0, -1)])
    while stack:
        r, c = stack[-1]
        order = rng.permutation(4)
        for k in order:
            dr, dc = deltas[k]
            nr, nc = r + dr, c + dc
            if 0 <= nr < ch and 0 <= nc < cw and not visited[nr, nc]:
                visited[nr, nc] = True
                # carve passage wall between (r,c) and (nr,nc), and the cell
                grid[2 * r + 1 + dr, 2 * c + 1 + dc] = S.EMPTY
                grid[2 * nr + 1, 2 * nc + 1] = S.EMPTY
                stack.append((nr, nc))
                break
        else:
            stack.pop()
    return grid


def generate_maze_wilson(
    cells: tuple[int, int], rng: np.random.Generator
) -> np.ndarray:
    """Wilson's algorithm: loop-erased random walks from each untreed cell
    to the growing tree — a UNIFORM sample over ALL spanning trees of the
    cell lattice (Propp & Wilson 1996), i.e. the zero-texture-bias gold
    standard. Host-side; used to validate the on-device generators'
    texture statistics (binary-tree has its classic diagonal bias,
    sidewinder a mild row bias).

    Loop erasure via the standard "latest exit direction" trick: the walk
    overwrites the direction taken out of each visited cell; retracing
    those directions from the start yields exactly the loop-erased path.
    Returns (H, W) int32 tile codes (WALL / EMPTY).
    """
    ch, cw = cells
    h, w = _maze_shape(cells)
    grid = np.full((h, w), S.WALL, dtype=np.int32)
    in_tree = np.zeros((ch, cw), dtype=bool)
    in_tree[0, 0] = True
    grid[1, 1] = S.EMPTY
    deltas = ((-1, 0), (0, 1), (1, 0), (0, -1))

    for start in ((r, c) for r in range(ch) for c in range(cw)):
        if in_tree[start]:
            continue
        exit_dir = {}
        cur = start
        while not in_tree[cur]:
            k = int(rng.integers(4))
            dr, dc = deltas[k]
            nr, nc = cur[0] + dr, cur[1] + dc
            if not (0 <= nr < ch and 0 <= nc < cw):
                continue
            exit_dir[cur] = k
            cur = (nr, nc)
        cur = start
        while not in_tree[cur]:
            in_tree[cur] = True
            dr, dc = deltas[exit_dir[cur]]
            grid[2 * cur[0] + 1, 2 * cur[1] + 1] = S.EMPTY
            grid[2 * cur[0] + 1 + dr, 2 * cur[1] + 1 + dc] = S.EMPTY
            cur = (cur[0] + dr, cur[1] + dc)
    return grid


def random_maze_level(
    cells: tuple[int, int], seed: int, goal_bottom_right: bool = True
) -> Level:
    """Host path: the `random_maze=True` constructor equivalent."""
    rng = np.random.default_rng(seed)
    grid = generate_maze_numpy(cells, rng)
    h, w = grid.shape
    if goal_bottom_right:
        grid[h - 2, w - 2] = S.GOAL
    return make_level(grid, start_idx=1 * w + 1)


# ---------------------------------------------------------------------------
# On-device generator (vmapped iterative backtracker in lax.while_loop)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cells",))
def _generate_one_maze(key: jnp.ndarray, cells: tuple[int, int]) -> jnp.ndarray:
    """One perfect maze on device. Iterative backtracker with an explicit
    stack array inside `lax.while_loop` — static shapes throughout.

    State: visited (ch, cw) bool; stack (ch·cw, 2) int32 + stack pointer;
    grid (H, W) int32. Each iteration either advances to a random unvisited
    neighbor (carving the passage) or pops. Terminates when the stack is
    empty: exactly 2·cells−1 carves, so the loop bound is tight.
    """
    ch, cw = cells
    h, w = _maze_shape(cells)
    n_cells = ch * cw

    deltas = jnp.asarray([(-1, 0), (0, 1), (1, 0), (0, -1)], jnp.int32)

    grid0 = jnp.full((h, w), S.WALL, jnp.int32)
    grid0 = grid0.at[1, 1].set(S.EMPTY)
    visited0 = jnp.zeros((ch, cw), bool).at[0, 0].set(True)
    stack0 = jnp.zeros((n_cells, 2), jnp.int32)
    sp0 = jnp.int32(1)  # stack holds (0, 0)

    def cond(carry):
        _, _, _, sp, _ = carry
        return sp > 0

    def body(carry):
        grid, visited, stack, sp, key = carry
        key, k_perm = jax.random.split(key)
        rc = stack[sp - 1]
        r, c = rc[0], rc[1]

        # random neighbor order, then pick the first unvisited in-bounds one
        perm = jax.random.permutation(k_perm, 4)
        d = deltas[perm]                       # (4, 2)
        nr = r + d[:, 0]
        nc = c + d[:, 1]
        ok = (
            (nr >= 0) & (nr < ch) & (nc >= 0) & (nc < cw)
            & jnp.logical_not(visited[jnp.clip(nr, 0, ch - 1), jnp.clip(nc, 0, cw - 1)])
        )
        any_ok = jnp.any(ok)
        pick = jnp.argmax(ok)                  # first True
        dr = d[pick, 0]
        dc = d[pick, 1]
        tr = jnp.clip(r + dr, 0, ch - 1)
        tc = jnp.clip(c + dc, 0, cw - 1)

        # advance: carve wall + cell, push neighbor; else: pop
        wall_r = 2 * r + 1 + dr
        wall_c = 2 * c + 1 + dc
        cell_r = 2 * tr + 1
        cell_c = 2 * tc + 1
        grid = jnp.where(
            any_ok,
            grid.at[wall_r, wall_c].set(S.EMPTY).at[cell_r, cell_c].set(S.EMPTY),
            grid,
        )
        visited = jnp.where(any_ok, visited.at[tr, tc].set(True), visited)
        stack = jnp.where(
            any_ok, stack.at[sp].set(jnp.stack([tr, tc])), stack
        )
        sp = jnp.where(any_ok, sp + 1, sp - 1)
        return grid, visited, stack, sp, key

    grid, _, _, _, _ = jax.lax.while_loop(
        cond, body, (grid0, visited0, stack0, sp0, key)
    )
    grid = grid.at[h - 2, w - 2].set(S.GOAL)
    return grid


@partial(jax.jit, static_argnames=("cells", "batch_size"))
def _binary_tree_mazes(key: jnp.ndarray, cells: tuple[int, int], batch_size: int):
    """B perfect mazes via the binary-tree algorithm — the fully-parallel
    mass-generation path (SURVEY.md §7.3: "choose a parallel-friendly
    algorithm for throughput and keep backtracker for parity levels").

    Each cell independently carves a passage to its north OR west neighbor
    (top row forced west, left column forced north, origin carves nothing):
    every cell except the origin adds exactly one edge toward the origin, so
    the carved graph is a spanning tree — a perfect maze. One coin flip per
    cell, zero data-dependent control flow, zero scatters (the grid is
    assembled with static strided slices) — fully parallel elementwise
    work, unlike the while_loop backtracker.

    Distribution note: binary-tree mazes have the algorithm's classic
    bias (unbroken north row / west column corridors, diagonal texture) —
    fine for mass training envs; use the backtracker for parity levels.
    """
    ch, cw = cells
    h, w = _maze_shape(cells)
    coin = jax.random.bernoulli(key, 0.5, (batch_size, ch, cw))
    rows = jnp.arange(ch)[:, None]
    cols = jnp.arange(cw)[None, :]
    can_north = rows > 0
    can_west = cols > 0
    north = (coin & can_north & can_west) | (can_north & ~can_west)
    west = (~coin & can_north & can_west) | (can_west & ~can_north)

    grid = jnp.full((batch_size, h, w), S.WALL, jnp.int32)
    grid = grid.at[:, 1::2, 1::2].set(S.EMPTY)
    # north wall of cell (r, c) sits at grid (2r, 2c+1), r >= 1
    grid = grid.at[:, 2 : h - 1 : 2, 1::2].set(
        jnp.where(north[:, 1:, :], S.EMPTY, S.WALL)
    )
    # west wall of cell (r, c) sits at grid (2r+1, 2c), c >= 1
    grid = grid.at[:, 1::2, 2 : w - 1 : 2].set(
        jnp.where(west[:, :, 1:], S.EMPTY, S.WALL)
    )
    grid = grid.at[:, h - 2, w - 2].set(S.GOAL)
    return grid


@partial(jax.jit, static_argnames=("cells", "batch_size"))
def _sidewinder_mazes(key: jnp.ndarray, cells: tuple[int, int], batch_size: int):
    """B perfect mazes via sidewinder — the UNBIASED mass path (binary-tree
    has forced north-row/west-column corridors and a diagonal texture).

    Sidewinder per row (row 0 is one long east corridor): scan west→east
    maintaining a "run"; each cell either extends the run east or closes
    it, and a closing run carves north from ONE uniformly-random member.
    Every run adds exactly one edge toward row 0 ⇒ spanning tree ⇒ perfect
    maze. Texture: only the TOP row is a forced corridor (vs binary-tree's
    top row AND west column), no diagonal drift.

    Vectorized formulation — scatter-free and parallel over (B, rows):
      * close coins and per-cell random keys are drawn for all cells at
        once; close is forced at the last column;
      * the run's random member = the cell whose key equals the
        segmented max of keys over its run. Segmented max = one forward
        (prefix, reset at run starts) + one backward (broadcast from the
        closing cell) pass, each a STATIC unroll over the ≤64 columns of
        pure elementwise selects — no scatters, no while_loop, like
        binary_tree;
      * key uniqueness within a run (a tie would carve two norths ⇒ a
        loop) is guaranteed by packing the column index into the low bits:
        key = (rand26 << 6) | c. Uniform up to the negligible 2⁻²⁶
        rand-collision bias toward higher columns.
      * grid assembly is the same static strided-slice writes as
        binary_tree.
    """
    ch, cw = cells
    if cw > 64:
        raise ValueError(f"sidewinder: cw={cw} > 64 (column tie-break bits)")
    h, w = _maze_shape(cells)
    k_close, k_key = jax.random.split(key)
    # close[b, r, c]: cell ends its run (forced at the last column)
    close = jax.random.bernoulli(k_close, 0.5, (batch_size, ch, cw))
    close = close.at[:, :, cw - 1].set(True)
    rand = jax.random.bits(k_key, (batch_size, ch, cw), jnp.uint32)
    keys = ((rand >> 6) << 6) | jnp.arange(cw, dtype=jnp.uint32)[None, None, :]

    # forward pass: prefix max of keys within each run (reset after close)
    fwd = [None] * cw
    fwd[0] = keys[:, :, 0]
    for c in range(1, cw):
        fresh = close[:, :, c - 1]  # previous cell closed -> new run at c
        fwd[c] = jnp.where(
            fresh, keys[:, :, c], jnp.maximum(fwd[c - 1], keys[:, :, c])
        )
    # backward pass: broadcast the closing cell's prefix max over its run
    tot = [None] * cw
    tot[cw - 1] = fwd[cw - 1]
    for c in range(cw - 2, -1, -1):
        tot[c] = jnp.where(close[:, :, c], fwd[c], tot[c + 1])
    run_max = jnp.stack(tot, axis=-1)                      # (B, ch, cw)

    north = keys == run_max                                # one per run
    north = north.at[:, 0, :].set(False)                   # row 0: no norths
    east = jnp.logical_not(close)                          # carve east unless closed
    east = east.at[:, 0, :].set(True)                      # row 0: full corridor

    grid = jnp.full((batch_size, h, w), S.WALL, jnp.int32)
    grid = grid.at[:, 1::2, 1::2].set(S.EMPTY)
    # north wall of cell (r, c) sits at grid (2r, 2c+1), r >= 1
    grid = grid.at[:, 2 : h - 1 : 2, 1::2].set(
        jnp.where(north[:, 1:, :], S.EMPTY, S.WALL)
    )
    # east wall of cell (r, c) sits at grid (2r+1, 2c+2), c <= cw-2
    grid = grid.at[:, 1::2, 2 : w - 1 : 2].set(
        jnp.where(east[:, :, : cw - 1], S.EMPTY, S.WALL)
    )
    grid = grid.at[:, h - 2, w - 2].set(S.GOAL)
    return grid


@partial(jax.jit, static_argnames=("cells", "batch_size", "max_iters"))
def _aldous_broder_mazes(
    key: jnp.ndarray,
    cells: tuple[int, int],
    batch_size: int,
    max_iters: int | None = None,
):
    """B perfect mazes via Aldous–Broder first-entry trees — the
    EXACTLY-UNIFORM mass path (binary-tree and sidewinder are fully
    parallel but texture-biased; the unbiased host generators don't run on
    device).

    Theory: run a random walk on the cell graph; for every cell record the
    edge by which the walk FIRST entered it. Those first-entry edges form
    a spanning tree distributed EXACTLY uniformly over all spanning trees
    (Aldous 1990 / Broder 1989). Off-grid moves stay in place, which makes
    the walk lazy — but a lazy chain's jump chain is still the simple
    random walk (conditioned on moving, the neighbor is uniform), and
    self-loops never enter new cells, so the first-entry tree distribution
    is unchanged. Uniform over spanning trees ⇒ none of
    binary-tree/sidewinder's corridor or diagonal texture, and strictly
    more uniform than the backtracker (DFS trees are long-corridor-biased).

    Vectorized formulation — NO data-dependent scatters, NO gathers:
      * all B walks advance in lockstep inside one `lax.while_loop`;
      * "which cell is the walk at" is a (B, S) one-hot COMPARE
        (`arange(S) == q`), so visited-marking and parent-recording are
        pure elementwise selects on (B, S) lanes (the same
        constraint playbook as binary_tree/sidewinder);
      * the loop exits when EVERY maze is covered (`jnp.all(visited)`);
        the expected cover time of the S-cell grid walk is O(S log² S)
        (~2k steps at S=81), and the default `max_iters` scales as
        64·S·log₂(S)² — orders of magnitude past the covered tail at any
        supported size (the cap almost never binds; the loop exits at
        cover time).
      * SAFETY NET: if the cap ever DID bind, any still-unvisited cell is
        connected by the binary-tree rule (carve north, west for row 0) —
        its parent chain strictly decreases row+col, so the union with the
        first-entry tree is still a spanning tree and the maze is still
        PERFECT; only the uniformity claim degrades, and only in that
        astronomically-rare truncated tail. (An r3 review found the
        pre-fix behavior: a fixed 32768 cap silently returned
        disconnected mazes at 32×32 cells.)

    Per-step direction randomness is a counter-based `fold_in(key, t)` —
    a scalar threefry per iteration, negligible next to the (B, S) lane
    work (and a while_loop body can't stream pre-drawn keys).

    Returns (B, H, W) int32 grids with the goal at the bottom-right cell.
    """
    ch, cw = cells
    s = ch * cw
    if max_iters is None:
        log2s = max(1, math.ceil(math.log2(s)))
        max_iters = 64 * s * log2s * log2s
    h, w = _maze_shape(cells)
    states = jnp.arange(s, dtype=jnp.int32)

    p0 = jnp.zeros((batch_size,), jnp.int32)  # walk starts at cell (0, 0)
    visited0 = jnp.zeros((batch_size, s), bool).at[:, 0].set(True)
    parent0 = jnp.full((batch_size, s), -1, jnp.int8)

    def cond(carry):
        _, visited, _, t = carry
        return jnp.logical_not(jnp.all(visited)) & (t < max_iters)

    def body(carry):
        p, visited, parent, t = carry
        d = jax.random.randint(
            jax.random.fold_in(key, t), (batch_size,), 0, 4, jnp.int32
        )  # 0=N 1=E 2=S 3=W
        r, c = p // cw, p % cw
        dr = jnp.where(d == 0, -1, jnp.where(d == 2, 1, 0))
        dc = jnp.where(d == 1, 1, jnp.where(d == 3, -1, 0))
        nr, nc = r + dr, c + dc
        ok = (nr >= 0) & (nr < ch) & (nc >= 0) & (nc < cw)
        q = jnp.where(ok, jnp.clip(nr, 0, ch - 1) * cw + jnp.clip(nc, 0, cw - 1), p)
        at_q = states[None, :] == q[:, None]              # (B, S) one-hot
        moved = at_q & ok[:, None]
        newly = moved & jnp.logical_not(visited)
        # entry edge, recorded from the ENTERED cell's perspective
        opp = ((d + 2) % 4).astype(jnp.int8)
        parent = jnp.where(newly, opp[:, None], parent)
        visited = visited | moved
        return q, visited, parent, t + 1

    _, visited, parent, _ = jax.lax.while_loop(
        cond, body, (p0, visited0, parent0, jnp.zeros((), jnp.int32))
    )

    # safety net (see docstring): connect any cell the walk never reached
    # via the binary-tree rule; keeps the maze perfect if the cap binds
    rows = (states // cw)[None, :]
    bt_parent = jnp.where(rows > 0, jnp.int8(0), jnp.int8(3))  # north/west
    parent = jnp.where(visited, parent, bt_parent)

    par = parent.reshape(batch_size, ch, cw)
    # passage between (r, c) and (r-1, c) is open iff (r, c)'s first-entry
    # edge points north OR (r-1, c)'s points south; same for west/east
    north_open = (par[:, 1:, :] == 0) | (par[:, :-1, :] == 2)  # rows 1..
    west_open = (par[:, :, 1:] == 3) | (par[:, :, :-1] == 1)   # cols 1..

    grid = jnp.full((batch_size, h, w), S.WALL, jnp.int32)
    grid = grid.at[:, 1::2, 1::2].set(S.EMPTY)
    # north wall of cell (r, c) sits at grid (2r, 2c+1), r >= 1
    grid = grid.at[:, 2 : h - 1 : 2, 1::2].set(
        jnp.where(north_open, S.EMPTY, S.WALL)
    )
    # west wall of cell (r, c) sits at grid (2r+1, 2c), c >= 1
    grid = grid.at[:, 1::2, 2 : w - 1 : 2].set(
        jnp.where(west_open, S.EMPTY, S.WALL)
    )
    grid = grid.at[:, h - 2, w - 2].set(S.GOAL)
    return grid


@partial(jax.jit, static_argnames=("cells", "batch_size", "algorithm"))
def generate_mazes_device(
    key: jnp.ndarray,
    cells: tuple[int, int],
    batch_size: int,
    algorithm: str = "backtracker",
):
    """B independent perfect mazes on device (BASELINE config 4: procedural
    random-maze generation on-device, one maze per env, vmapped).

    algorithm — "backtracker" (iterative DFS in a lax.while_loop; matches
                the host parity generator's style), "binary_tree"
                (fully parallel, fastest, classic texture bias — see
                _binary_tree_mazes), "sidewinder" (fully parallel, nearly
                bias-free — see _sidewinder_mazes), or "aldous_broder"
                (lockstep random walks, EXACTLY uniform over spanning
                trees — see _aldous_broder_mazes; the recommended path
                when distributional uniformity matters).

    Returns (grids (B, H, W) int32, start_idx () int32 — shared: all mazes
    start at the top-left cell (1, 1)).
    """
    h, w = _maze_shape(cells)
    if algorithm == "binary_tree":
        grids = _binary_tree_mazes(key, cells, batch_size)
    elif algorithm == "sidewinder":
        grids = _sidewinder_mazes(key, cells, batch_size)
    elif algorithm == "aldous_broder":
        grids = _aldous_broder_mazes(key, cells, batch_size)
    elif algorithm == "backtracker":
        keys = jax.random.split(key, batch_size)
        grids = jax.vmap(lambda k: _generate_one_maze(k, cells))(keys)
    else:
        raise ValueError(f"unknown maze algorithm: {algorithm!r}")
    return grids, jnp.asarray(1 * w + 1, jnp.int32)


def check_perfect_maze(grid: np.ndarray, cells: tuple[int, int]) -> bool:
    """Host-side validator: all cells reachable AND exactly 2·cells−1 open
    tiles (cells + carved passages) ⇒ spanning tree ⇒ perfect maze."""
    ch, cw = cells
    grid = np.asarray(grid)
    open_mask = grid != S.WALL
    n_open = int(open_mask.sum())
    if n_open != ch * cw + (ch * cw - 1):
        return False
    # BFS flood fill from the start cell
    from collections import deque

    h, w = grid.shape
    seen = np.zeros_like(open_mask)
    dq = deque([(1, 1)])
    seen[1, 1] = True
    while dq:
        r, c = dq.popleft()
        for dr, dc in ((-1, 0), (0, 1), (1, 0), (0, -1)):
            nr, nc = r + dr, c + dc
            if 0 <= nr < h and 0 <= nc < w and open_mask[nr, nc] and not seen[nr, nc]:
                seen[nr, nc] = True
                dq.append((nr, nc))
    return bool((seen == open_mask).all())
