"""Policy evaluation utilities for the neural learners.

The counterpart of algos/utils.run_greedy_episode for NETWORK policies at
batch scale: roll every env's greedy policy in lockstep (freeze-on-done)
and report which envs reached a terminal tile. Works uniformly over the
three network families (index MLP, shared-level conv, per-env-level
conv — tile planes are derived automatically for a needs-tiles net) and
over shared or batched levels, so a per-env-level generalization
measurement is one call.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..algos.dp_batched import _SELECT_TREE_MAX_STATES
from ..core.semantics import Semantics
from ..core.types import Level
from ..ops.bitplane import _select_tree, pack_level, reset_bits, step_bits
from .a2c import _net_apply, _tiles_for


@partial(jax.jit, static_argnames=("net", "max_steps"))
def greedy_reached(
    sem: Semantics,
    net,
    params,
    levels: Level,
    max_steps: int = 60,
    tiles_levels: Level | None = None,
):
    """(B,) bool: did each env's greedy rollout SUCCEED — terminate on a
    positively-rewarded terminal (the goal) — within `max_steps`?
    Terminating on a negative terminal (lava) counts as failure, not
    success (an r3 review caught the any-terminal version scoring a
    walk-into-lava policy at 100%). Levels may be shared ((H, W) grid →
    a single env) or batched ((N, H, W) → one env per level).

    `tiles_levels` (needs-tiles nets only): take the network's tile
    PLANES from a different Level than the step dynamics — the
    wrong-tiles ablation control (pass e.g. a roll-by-one of `levels`; a
    policy that actually reads the maze collapses, a motion prior does
    not)."""
    if tiles_levels is not None and not getattr(net, "needs_tiles", False):
        raise ValueError(
            "tiles_levels only applies to per-env-level (needs-tiles) "
            "networks; this net takes no tile planes, so the ablation "
            "would silently evaluate the UNROLLED planes"
        )
    bl = pack_level(levels)
    tiles = _tiles_for(net, levels if tiles_levels is None else tiles_levels)
    st = reset_bits(bl, None if bl.batched else 1)

    def body(carry, _):
        st, reached = carry
        logits, _ = _net_apply(net, params, st.agent_idx, tiles)
        a = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        st, (_, reward, done) = step_bits(sem, bl, st, a, False, None)
        # freeze mode emits the terminal reward exactly once, then zeros —
        # so (done & reward > 0) fires only on the goal-entering step
        return (st, reached | (done & (reward > 0))), None

    (_, reached), _ = jax.lax.scan(
        body,
        (st, jnp.zeros(st.agent_idx.shape, bool)),
        None,
        length=max_steps,
    )
    return reached


def greedy_success_rate(
    sem: Semantics,
    net,
    params,
    levels: Level,
    max_steps: int = 60,
    tiles_levels: Level | None = None,
) -> jnp.ndarray:
    """Scalar fraction of envs whose greedy policy reaches the GOAL (a
    positively-rewarded terminal) within `max_steps` — the held-out
    generalization metric of tests/test_perenv_levels.py and
    examples/11. `tiles_levels` — see greedy_reached (the wrong-tiles
    ablation control)."""
    return jnp.mean(
        greedy_reached(sem, net, params, levels, max_steps, tiles_levels)
    )


@partial(jax.jit, static_argnames=("max_steps",))
def greedy_reached_tabular(
    sem: Semantics,
    levels: Level,
    policy: jnp.ndarray,
    max_steps: int = 60,
):
    """(B,) bool: does each env's TABULAR policy reach the GOAL within
    `max_steps`? The twin of `greedy_reached` for the (N, S) / (S,) int
    policies that algos.dp / algos.dp_batched produce — rolled on the same
    bitplane engine with the same goal-only success semantics, so VI's
    optimal ceiling and PPO's learned score are directly comparable
    (closes examples/11's promised comparison).

    policy — (S,) int actions for a shared level, or (N, S): one policy
    per maze for a batched (N, H, W) level (e.g. from
    value_iteration_batched), or N policies each rolled in its own env
    of a SHARED level. The per-step action lookup `policy[env, state]`
    uses the package's branchless select tree, not a serializing per-env
    gather."""
    bl = pack_level(levels)
    if policy.shape[-1] != bl.height * bl.width:
        raise ValueError(
            f"policy last axis {policy.shape[-1]} != level state count "
            f"{bl.height * bl.width}"
        )
    if bl.batched and policy.ndim == 2:
        if policy.shape[0] != levels.grid.shape[0]:
            raise ValueError(
                f"policy batch {policy.shape[0]} != level batch "
                f"{levels.grid.shape[0]}"
            )
    if bl.batched:
        batch = None
    else:
        batch = policy.shape[0] if policy.ndim == 2 else 1
    st = reset_bits(bl, batch)

    # Per-step action lookup policy[..., state]: branchless select tree
    # up to algos.dp_batched's threshold, a gather above it (the select
    # tree's program size is linear in S; at 65×65 (S=4225) tracing a
    # 4225-leaf tree per scan step stalls compilation for minutes).
    n_states = policy.shape[-1]
    if n_states <= _SELECT_TREE_MAX_STATES:
        leaves = [policy[..., k] for k in range(n_states)]

        def lookup_action(idx):
            return _select_tree(leaves, idx)
    elif policy.ndim == 2:
        def lookup_action(idx):
            return jnp.take_along_axis(policy, idx[..., None], axis=-1)[
                ..., 0
            ]
    else:
        def lookup_action(idx):
            return policy[idx]

    def body(carry, _):
        st, reached = carry
        a = lookup_action(st.agent_idx).astype(jnp.int32)
        st, (_, reward, done) = step_bits(sem, bl, st, a, False, None)
        return (st, reached | (done & (reward > 0))), None

    (_, reached), _ = jax.lax.scan(
        body,
        (st, jnp.zeros(st.agent_idx.shape, bool)),
        None,
        length=max_steps,
    )
    return reached


def greedy_success_rate_tabular(
    sem: Semantics,
    levels: Level,
    policy: jnp.ndarray,
    max_steps: int = 60,
) -> jnp.ndarray:
    """Scalar fraction of envs whose tabular policy reaches the GOAL within
    `max_steps` — e.g. the optimal success ceiling from batched VI."""
    return jnp.mean(greedy_reached_tabular(sem, levels, policy, max_steps))
