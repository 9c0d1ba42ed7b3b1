"""Sharded value iteration — state-space-parallel DP over the mesh.

BASELINE config 5's solver half. The (S, A) model table is sharded over the
mesh on the STATE dim; each sweep:

    all_gather(V)  →  local rows' Q = r + γ·V[s']  →  local max  →
    psum(max |ΔV|) for the global convergence test.

The V gather needs arbitrary successor states, hence the all_gather (an
(S,)-float vector — for gridworlds this is KBs; the pattern is what matters:
it is exactly the ring-allgather + local-compute shape of a sharded sweep,
and scales to state spaces that don't fit one device).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.model import ModelTable
from .mesh import env_axes


def _pad_to(x, n, fill=0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg, constant_values=fill)


@partial(jax.jit, static_argnames=("mesh", "max_iters"))
def value_iteration_sharded(
    mesh: Mesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """Sharded VI. Returns (V (S,), greedy policy (S,), iters) — identical
    to algos.dp.value_iteration up to float associativity (tested equal on
    the CPU mesh)."""
    axes = env_axes(mesh)
    n_dev = mesh.size
    s = model.num_states
    s_pad = ((s + n_dev - 1) // n_dev) * n_dev

    # Pad the state dim so it divides the mesh; padded rows are terminal
    # self-loops with 0 reward, so they never affect real values.
    next_state = _pad_to(model.next_state, s_pad)
    reward = _pad_to(model.reward, s_pad)
    done = _pad_to(model.done, s_pad, fill=True)
    terminal = _pad_to(model.terminal, s_pad, fill=True)

    def shard_fn(next_state, reward, done, terminal):
        local = next_state.shape[0]

        def local_q(v_full, v_local):
            cont = jnp.where(done, 0.0, v_full[next_state])
            q = reward + gamma * cont
            return jnp.where(terminal[:, None], 0.0, q)

        def cond(carry):
            _, delta, i = carry
            return (delta >= theta) & (i < max_iters)

        def body(carry):
            v_local, _, i = carry
            v_full = jax.lax.all_gather(v_local, axes, tiled=True)
            q = local_q(v_full, v_local)
            v_new = jnp.max(q, axis=1)
            delta = jax.lax.pmax(jnp.max(jnp.abs(v_new - v_local)), axes)
            return v_new, delta, i + 1

        v0 = jnp.zeros(local, jnp.float32)
        v_local, _, iters = jax.lax.while_loop(
            cond, body, (v0, jnp.float32(jnp.inf), 0)
        )
        v_full = jax.lax.all_gather(v_local, axes, tiled=True)
        policy_local = jnp.argmax(local_q(v_full, v_local), axis=1).astype(
            jnp.int32
        )
        return v_local, policy_local, iters

    spec = P(axes if len(axes) > 1 else axes[0])
    v, policy, iters = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )(next_state, reward, done, terminal)

    return v[:s], policy[:s], iters


@partial(jax.jit, static_argnames=("mesh", "max_eval_iters", "max_policy_iters"))
def policy_iteration_sharded(
    mesh: Mesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
):
    """Sharded Howard policy iteration — the state-space-parallel twin of
    `value_iteration_sharded` (completes the distributed tabular family).
    The model is sharded on the STATE dim; each eval
    sweep all_gathers V and backs up the local rows under the local policy
    slice; improvement is a local argmax; the stability test is a `pmin`
    of per-shard stability so every replica stops at the same outer
    iteration. Identical to algos.dp.policy_iteration up to float
    associativity (tested equal on the CPU mesh).

    Returns (V (S,), policy (S,), num_policy_iters).
    """
    axes = env_axes(mesh)
    n_dev = mesh.size
    s = model.num_states
    s_pad = ((s + n_dev - 1) // n_dev) * n_dev
    num_actions = model.next_state.shape[1]

    # Padded rows are terminal self-loops: Q-row pinned to 0, argmax = 0,
    # stable from the first sweep — they never affect real rows.
    next_state = _pad_to(model.next_state, s_pad)
    reward = _pad_to(model.reward, s_pad)
    done = _pad_to(model.done, s_pad, fill=True)
    terminal = _pad_to(model.terminal, s_pad, fill=True)

    def shard_fn(next_state, reward, done, terminal):
        local = next_state.shape[0]

        def local_q(v_full):
            cont = jnp.where(done, 0.0, v_full[next_state])
            q = reward + gamma * cont
            return jnp.where(terminal[:, None], 0.0, q)

        def eval_policy(policy_local):
            pi = jax.nn.one_hot(policy_local, num_actions, dtype=jnp.float32)

            def cond(carry):
                _, delta, i = carry
                return (delta >= theta) & (i < max_eval_iters)

            def body(carry):
                v_local, _, i = carry
                v_full = jax.lax.all_gather(v_local, axes, tiled=True)
                v_new = jnp.sum(pi * local_q(v_full), axis=1)
                delta = jax.lax.pmax(
                    jnp.max(jnp.abs(v_new - v_local)), axes
                )
                return v_new, delta, i + 1

            v_local, _, _ = jax.lax.while_loop(
                cond, body, (jnp.zeros(local, jnp.float32),
                             jnp.float32(jnp.inf), 0)
            )
            return v_local

        def cond(carry):
            _, _, stable, i = carry
            return jnp.logical_not(stable) & (i < max_policy_iters)

        def body(carry):
            policy_local, _, _, i = carry
            v_local = eval_policy(policy_local)
            v_full = jax.lax.all_gather(v_local, axes, tiled=True)
            new_policy = jnp.argmax(local_q(v_full), axis=1).astype(jnp.int32)
            stable_local = jnp.all(new_policy == policy_local)
            # every shard must agree before anyone stops
            stable = jax.lax.pmin(stable_local.astype(jnp.int32), axes) > 0
            return new_policy, v_local, stable, i + 1

        policy_local, v_local, _, iters = jax.lax.while_loop(
            cond,
            body,
            (jnp.zeros(local, jnp.int32), jnp.zeros(local, jnp.float32),
             jnp.asarray(False), 0),
        )
        return v_local, policy_local, iters

    spec = P(axes if len(axes) > 1 else axes[0])
    v, policy, iters = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )(next_state, reward, done, terminal)
    return v[:s], policy[:s], iters


@partial(jax.jit, static_argnames=("mesh", "max_iters", "lookup"))
def value_iteration_batched_sharded(
    mesh: Mesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
    lookup: str = "auto",
):
    """VI over N mazes sharded across the mesh on the MAZE axis — the
    embarrassingly-parallel composition of batched levels (BASELINE config
    4) with the solver family. Each device sweeps its own maze shard; the
    only collective is a per-sweep `pmax` of |ΔV| so all shards run the
    same number of sweeps (extra sweeps on converged shards are fixed
    points, so the result is identical to the unsharded
    algos.dp_batched.value_iteration_batched).

    model — batched tables from algos.dp_batched.build_model_tables; the
    mesh size must divide N. Returns (V (N, S), policy (N, S), iters)."""
    from ..algos.dp_batched import action_values_batched

    axes = env_axes(mesh)
    n_dev = mesh.size
    n = model.terminal.shape[0]
    if n % n_dev:
        raise ValueError(f"maze count {n} not divisible by mesh size {n_dev}")

    def shard_fn(model):
        s = model.terminal.shape[1]
        v0 = jnp.zeros((model.terminal.shape[0], s), jnp.float32)

        def cond(carry):
            _, delta, i = carry
            return (delta >= theta) & (i < max_iters)

        def body(carry):
            v, _, i = carry
            q = action_values_batched(model, v, gamma, lookup)
            v_new = jnp.max(q, axis=-1)
            delta = jax.lax.pmax(jnp.max(jnp.abs(v_new - v)), axes)
            return v_new, delta, i + 1

        v, _, iters = jax.lax.while_loop(
            cond, body, (v0, jnp.float32(jnp.inf), 0)
        )
        policy = jnp.argmax(
            action_values_batched(model, v, gamma, lookup), axis=-1
        ).astype(jnp.int32)
        return v, policy, iters

    spec = P(axes if len(axes) > 1 else axes[0])
    model_specs = ModelTable(
        next_state=spec, reward=spec, done=spec, terminal=spec
    )
    v, policy, iters = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(model_specs,),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )(model)
    return v, policy, iters


@partial(
    jax.jit,
    static_argnames=("mesh", "max_eval_iters", "max_policy_iters", "lookup"),
)
def policy_iteration_batched_sharded(
    mesh: Mesh,
    model: ModelTable,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
    lookup: str = "auto",
):
    """Howard PI over N mazes sharded on the MAZE axis — the PI twin of
    `value_iteration_batched_sharded` (completes the batched × sharded
    solver matrix). Per outer iteration each shard evaluates and improves
    its own maze shard; a `pmax` of |ΔV| keeps eval sweeps in lockstep and
    a `pmin` of per-shard stability stops every replica at the same outer
    iteration (extra iterations on stable shards are fixed points, so the
    result equals the unsharded algos.dp_batched.policy_iteration_batched).

    Returns (V (N, S), policy (N, S), iters)."""
    from ..algos.dp_batched import action_values_batched

    axes = env_axes(mesh)
    n_dev = mesh.size
    n = model.terminal.shape[0]
    if n % n_dev:
        raise ValueError(f"maze count {n} not divisible by mesh size {n_dev}")
    num_actions = model.next_state.shape[-1]

    def shard_fn(model):
        nl, s = model.terminal.shape
        policy0 = jnp.zeros((nl, s), jnp.int32)

        def eval_policy(policy):
            pi = jax.nn.one_hot(policy, num_actions, dtype=jnp.float32)

            def cond(carry):
                _, delta, i = carry
                return (delta >= theta) & (i < max_eval_iters)

            def body(carry):
                v, _, i = carry
                q = action_values_batched(model, v, gamma, lookup)
                v_new = jnp.sum(pi * q, axis=-1)
                delta = jax.lax.pmax(jnp.max(jnp.abs(v_new - v)), axes)
                return v_new, delta, i + 1

            v, _, _ = jax.lax.while_loop(
                cond, body,
                (jnp.zeros((nl, s), jnp.float32), jnp.float32(jnp.inf), 0),
            )
            return v

        def cond(carry):
            _, _, stable, i = carry
            return jnp.logical_not(stable) & (i < max_policy_iters)

        def body(carry):
            policy, _, _, i = carry
            v = eval_policy(policy)
            new_policy = jnp.argmax(
                action_values_batched(model, v, gamma, lookup), axis=-1
            ).astype(jnp.int32)
            stable_local = jnp.all(new_policy == policy)
            stable = jax.lax.pmin(stable_local.astype(jnp.int32), axes) > 0
            return new_policy, v, stable, i + 1

        policy, v, _, iters = jax.lax.while_loop(
            cond,
            body,
            (policy0, jnp.zeros((nl, s), jnp.float32), jnp.asarray(False), 0),
        )
        return v, policy, iters

    spec = P(axes if len(axes) > 1 else axes[0])
    model_specs = ModelTable(
        next_state=spec, reward=spec, done=spec, terminal=spec
    )
    v, policy, iters = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(model_specs,),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )(model)
    return v, policy, iters


def value_iteration_batched_grid_sharded(
    mesh: Mesh,
    sem,
    levels,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_iters: int = 10_000,
):
    """Maze-axis-sharded VI DIRECTLY from the batched grid — the r4
    static-candidate backup (algos.value_iteration_batched_grid, the
    fastest exact single-chip form, +27% over the select-tree tables)
    composed with the mesh. Grids shard on the maze axis; the static
    candidate geometry is identical on every shard (baked as compile-time
    constants); the only collective is the per-sweep `pmax` of |ΔV| that
    keeps shards in sweep-lockstep (extra sweeps on converged shards are
    fixed points). Returns (V (N, S), policy (N, S), iters)."""
    from ..algos.dp_batched import _static_geometry, build_model_tables

    if levels.grid.ndim != 3:
        raise ValueError(
            f"expected a batched (N, H, W) level grid; got "
            f"{levels.grid.shape}"
        )
    try:
        geom = _static_geometry(sem, levels)
    except jax.errors.TracerArrayConversionError:
        # traced sem (outer jit): same fallback contract as the unsharded
        # grid form — the table engine over the same mesh
        return value_iteration_batched_sharded(
            mesh, build_model_tables(sem, levels), gamma, theta, max_iters
        )
    return _vi_grid_sharded_impl(
        mesh, sem, levels.grid, geom, gamma, theta, max_iters
    )


@partial(jax.jit, static_argnames=("mesh", "geom", "max_iters"))
def _vi_grid_sharded_impl(mesh, sem, grids, geom, gamma, theta, max_iters):
    from ..algos.dp_batched import _grid_backup

    axes = env_axes(mesh)
    n_dev = mesh.size
    n = grids.shape[0]
    if n % n_dev:
        raise ValueError(f"maze count {n} not divisible by mesh size {n_dev}")

    def shard_fn(sem, grids):
        # the ONE static-candidate backup (algos.dp_batched._grid_backup),
        # applied to this shard's local grids — identical sweep semantics
        # to the unsharded form by construction
        backup, (n_local, s) = _grid_backup(sem, grids, geom, gamma)
        v0 = jnp.zeros((n_local, s), jnp.float32)

        def cond(carry):
            _, delta, i = carry
            return (delta >= theta) & (i < max_iters)

        def body(carry):
            v, _, i = carry
            v_new = jnp.max(backup(v), axis=-1)
            delta = jax.lax.pmax(jnp.max(jnp.abs(v_new - v)), axes)
            return v_new, delta, i + 1

        v, _, iters = jax.lax.while_loop(
            cond, body, (v0, jnp.float32(jnp.inf), 0)
        )
        policy = jnp.argmax(backup(v), axis=-1).astype(jnp.int32)
        return v, policy, iters

    spec = P(axes if len(axes) > 1 else axes[0])
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), spec),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )(sem, grids)


def policy_iteration_batched_grid_sharded(
    mesh: Mesh,
    sem,
    levels,
    gamma: float = 0.99,
    theta: float = 1e-6,
    max_eval_iters: int = 10_000,
    max_policy_iters: int = 100,
):
    """Maze-axis-sharded Howard PI directly from the batched grid — the
    static-candidate backup (algos.policy_iteration_batched_grid) on the
    mesh. Eval sweeps stay in lockstep via a per-sweep `pmax` of |ΔV|;
    the outer loop stops when EVERY shard's policies are stable (`pmin`
    of per-shard stability). Returns (V (N, S), policy (N, S), iters)."""
    from ..algos.dp_batched import _static_geometry, build_model_tables

    if levels.grid.ndim != 3:
        raise ValueError(
            f"expected a batched (N, H, W) level grid; got "
            f"{levels.grid.shape}"
        )
    try:
        geom = _static_geometry(sem, levels)
    except jax.errors.TracerArrayConversionError:
        # traced sem: fall back to the sharded table form (see VI twin)
        return policy_iteration_batched_sharded(
            mesh, build_model_tables(sem, levels), gamma, theta,
            max_eval_iters, max_policy_iters,
        )
    return _pi_grid_sharded_impl(
        mesh, sem, levels.grid, geom, gamma, theta, max_eval_iters,
        max_policy_iters,
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "geom", "max_eval_iters", "max_policy_iters"),
)
def _pi_grid_sharded_impl(
    mesh, sem, grids, geom, gamma, theta, max_eval_iters, max_policy_iters
):
    from ..algos.dp_batched import _grid_backup

    axes = env_axes(mesh)
    n_dev = mesh.size
    n = grids.shape[0]
    if n % n_dev:
        raise ValueError(f"maze count {n} not divisible by mesh size {n_dev}")
    a = len(geom[2]) // (geom[0] * geom[1])

    def shard_fn(sem, grids):
        backup, (n_local, s) = _grid_backup(sem, grids, geom, gamma)

        def eval_loop(pi):
            def cond(carry):
                _, delta, i = carry
                return (delta >= theta) & (i < max_eval_iters)

            def body(carry):
                v, _, i = carry
                v_new = jnp.sum(pi * backup(v), axis=-1)
                delta = jax.lax.pmax(jnp.max(jnp.abs(v_new - v)), axes)
                return v_new, delta, i + 1

            v, _, _ = jax.lax.while_loop(
                cond, body,
                (jnp.zeros((n_local, s), jnp.float32),
                 jnp.float32(jnp.inf), 0),
            )
            return v

        def cond(carry):
            _, _, stable, i = carry
            return jnp.logical_not(stable) & (i < max_policy_iters)

        def body(carry):
            policy, _, _, i = carry
            v = eval_loop(jax.nn.one_hot(policy, a, dtype=jnp.float32))
            new_policy = jnp.argmax(backup(v), axis=-1).astype(jnp.int32)
            stable_local = jnp.all(new_policy == policy)
            stable = jax.lax.pmin(stable_local.astype(jnp.int32), axes) > 0
            return new_policy, v, stable, i + 1

        policy, v, _, iters = jax.lax.while_loop(
            cond, body,
            (jnp.zeros((n_local, s), jnp.int32),
             jnp.zeros((n_local, s), jnp.float32), jnp.asarray(False), 0),
        )
        return v, policy, iters

    spec = P(axes if len(axes) > 1 else axes[0])
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), spec),
        out_specs=(spec, spec, P()),
        check_vma=False,
    )(sem, grids)
