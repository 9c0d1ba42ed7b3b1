"""Bit-packed step engine — the throughput hot path.

Why this exists: the generic step (core/step.py) looks up tile attributes
with dynamic gathers (`grid_flat[cand_idx]`). The engine was designed for a
TPU, whose vector unit has no cross-lane gather, so it stops gathering.
Whether that still pays on the GPU, where a gather from a table this small
is served from cache, is ROADMAP Speed item 4; `chip_smoke.py` times both
engines on the same rollout. The scheme:

  * Pack the level's tile codes into uint32 words, `16 codes × 2 bits` per
    word (`BitLevel`). A 16×16 level is 16 words; a 9×9 maze is 6.
  * Look a code up with a branchless binary SELECT TREE over those words
    (`ceil(S/16) − 1` vector selects) followed by a shift/mask — all plain
    elementwise ops that XLA fuses into the surrounding step.
  * Carry the agent's CURRENT tile code through the rollout scan, so each
    step performs exactly ONE packed lookup (the candidate cell).

Per-env levels (each env its own maze, BASELINE config 4) pay the same
cost as a shared level: the select tree is elementwise over the batch
either way.

Semantics are IDENTICAL to core/step.py (`_move`/`step`/`step_autoreset`/
`step_autoreset_truncated`) — same blocked rule, same reward/done tables,
same auto-reset convention; equivalence is property-tested against the
generic path and the NumPy oracle in tests/test_bitplane.py.

Scaling note: the select tree is linear in `ceil(S/16)`, so this path wins
for the gridworld regime (S up to a few thousand). For S in the hundreds of
thousands a real gather would win; `pack_level` refuses absurd sizes rather
than silently going slow.

Reference behavior recon: SURVEY.md §3.2 (step), §7.3–7.6 (throughput plan).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import struct
from ..core.semantics import Semantics
from ..core.types import Level

# 4 tile codes → 2 bits each → 16 codes per uint32 word.
CODE_BITS = 2
CODES_PER_WORD = 32 // CODE_BITS
CODE_MASK = (1 << CODE_BITS) - 1

# Refuse to build a select tree past this many states (the tree is linear in
# ceil(S/16); past this a dynamic gather is the better primitive).
MAX_PACKED_STATES = 16_384


@struct.dataclass
class BitLevel:
    """A level with tile codes bit-packed for gather-free lookup.

    code_words — (Wn,) uint32 (shared level) or (B, Wn) (per-env levels);
                 word k holds codes for states [16k, 16k+16), 2 bits each,
                 state 16k in the LSBs.
    start_idx  — () or (B,) int32 row-major start state.
    start_code — () or (B,) int32 tile code at the start state (precomputed
                 so auto-reset needs no lookup).
    height/width — static grid shape (not pytree leaves).
    """

    code_words: jnp.ndarray
    start_idx: jnp.ndarray
    start_code: jnp.ndarray
    height: int = dataclasses.field(metadata={"static": True})
    width: int = dataclasses.field(metadata={"static": True})

    @property
    def num_states(self) -> int:
        return self.height * self.width

    @property
    def batched(self) -> bool:
        return self.code_words.ndim == 2


def _select_tree(leaves, sel):
    """Branchless binary select: leaves[sel] without a gather.

    leaves — list of same-shape arrays (broadcastable against `sel`).
    sel    — integer array in [0, len(leaves)).
    Cost: len(leaves) − 1 vector selects (one `jnp.where` per tree node).
    """
    level = list(leaves)
    bit_pos = 0
    while len(level) > 1:
        bit = ((sel >> bit_pos) & 1).astype(bool)
        nxt = []
        for k in range(0, len(level), 2):
            lo = level[k]
            hi = level[k + 1] if k + 1 < len(level) else level[k]
            nxt.append(jnp.where(bit, hi, lo))
        level = nxt
        bit_pos += 1
    return level[0]


def pack_level(level: Level) -> BitLevel:
    """Pack a Level's tile codes into a BitLevel. Jit-compatible (used on
    device-generated per-env mazes) — pure reshape/shift/sum ops."""
    grid = level.grid
    h, w = int(grid.shape[-2]), int(grid.shape[-1])
    s = h * w
    if s > MAX_PACKED_STATES:
        raise ValueError(
            f"pack_level: {s} states exceeds MAX_PACKED_STATES "
            f"({MAX_PACKED_STATES}); use the gather-based core.step path"
        )
    codes = grid.reshape(*grid.shape[:-2], s).astype(jnp.uint32)
    n_words = -(-s // CODES_PER_WORD)
    pad = n_words * CODES_PER_WORD - s
    if pad:
        codes = jnp.pad(codes, [(0, 0)] * (codes.ndim - 1) + [(0, pad)])
    lanes = codes.reshape(*codes.shape[:-1], n_words, CODES_PER_WORD)
    shifts = (jnp.arange(CODES_PER_WORD, dtype=jnp.uint32) * CODE_BITS)
    # Fields are disjoint (each code < 2^CODE_BITS), so sum == bitwise OR.
    words = jnp.sum(lanes << shifts, axis=-1, dtype=jnp.uint32)

    start_idx = jnp.asarray(level.start_idx, jnp.int32)
    bl = BitLevel(
        code_words=words,
        start_idx=start_idx,
        start_code=jnp.zeros_like(start_idx),  # placeholder
        height=h,
        width=w,
    )
    return bl.replace(start_code=tile_code(bl, start_idx))


def tile_code(bl: BitLevel, idx: jnp.ndarray) -> jnp.ndarray:
    """Tile code at state `idx` — gather-free packed lookup.

    idx — int32, shape () / (B,) / any; for a batched BitLevel the leading
    axes of idx must match code_words' batch axes.
    """
    n_words = bl.code_words.shape[-1]
    wsel = idx >> 4  # idx // CODES_PER_WORD
    leaves = [bl.code_words[..., k] for k in range(n_words)]
    word = _select_tree(leaves, wsel)
    shift = ((idx & (CODES_PER_WORD - 1)).astype(jnp.uint32)) * CODE_BITS
    return ((word >> shift) & CODE_MASK).astype(jnp.int32)


def _per_code(table: jnp.ndarray, code: jnp.ndarray) -> jnp.ndarray:
    """table[code] for a tiny per-tile-code semantics table (4 entries) —
    a 3-select tree instead of a gather."""
    return _select_tree([table[k] for k in range(table.shape[0])], code)


def move_bits(
    sem: Semantics,
    bl: BitLevel,
    agent_idx: jnp.ndarray,
    agent_code: jnp.ndarray,
    action: jnp.ndarray,
):
    """Core transition, bit-exactly mirroring core.step._move:
    (idx, code, action) → (new_idx, new_code, reward, done).

    The caller carries `agent_code` (code at agent_idx) so a blocked move
    needs no second lookup.
    """
    h, w = bl.height, bl.width
    row = agent_idx // w
    col = agent_idx - row * w
    # Per-action (drow, dcol) via select tree over the (A, 2) delta table.
    drow = _select_tree([sem.deltas[a, 0] for a in range(sem.deltas.shape[0])], action)
    dcol = _select_tree([sem.deltas[a, 1] for a in range(sem.deltas.shape[0])], action)
    nrow = row + drow
    ncol = col + dcol
    in_bounds = (nrow >= 0) & (nrow < h) & (ncol >= 0) & (ncol < w)
    crow = jnp.clip(nrow, 0, h - 1)
    ccol = jnp.clip(ncol, 0, w - 1)
    cand_idx = crow * w + ccol

    cand_code = tile_code(bl, cand_idx)
    blocked = ~in_bounds | ~_per_code(sem.passable, cand_code)
    new_idx = jnp.where(blocked, agent_idx, cand_idx)
    new_code = jnp.where(blocked, agent_code, cand_code)

    reward = _per_code(sem.reward, new_code)
    done = _per_code(sem.terminal, new_code)
    return new_idx, new_code, reward, done


class FastState(NamedTuple):
    """Minimal rollout carry for the bitplane engine: the agent index, its
    tile code (saves the second lookup), the episode step counter, and the
    per-env done flag (used only by the freeze-on-done mode)."""

    agent_idx: jnp.ndarray
    agent_code: jnp.ndarray
    t: jnp.ndarray
    done: jnp.ndarray


def reset_bits(bl: BitLevel, batch_size: int | None = None) -> FastState:
    """All envs at the level start. batch_size=None → scalar state; a
    batched BitLevel implies its own batch size."""
    idx, code = bl.start_idx, bl.start_code
    if bl.batched:
        b = bl.code_words.shape[0]
        if batch_size is not None and batch_size != b:
            raise ValueError(
                f"batch_size {batch_size} != batched BitLevel's {b} levels"
            )
        idx = jnp.broadcast_to(idx, (b,))
        code = jnp.broadcast_to(code, (b,))
    elif batch_size is not None:
        idx = jnp.broadcast_to(idx, (batch_size,))
        code = jnp.broadcast_to(code, (batch_size,))
    return FastState(
        agent_idx=jnp.asarray(idx, jnp.int32),
        agent_code=jnp.asarray(code, jnp.int32),
        t=jnp.zeros(idx.shape, jnp.int32),
        done=jnp.zeros(idx.shape, bool),
    )


def step_bits(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    action: jnp.ndarray,
    auto_reset: bool = True,
    max_episode_steps: int | None = None,
):
    """One vectorized step; semantics match core.step exactly:

      auto_reset=True  → step_autoreset (+ optional time-limit truncation,
                         matching step_autoreset_truncated);
      auto_reset=False → step (freeze after termination; truncation
                         unsupported, as in core.step).

    Returns (new FastState, (obs, reward, done)) with obs/reward/done
    bit-equal to the generic path's StepResult fields.
    """
    if max_episode_steps is not None and not auto_reset:
        raise ValueError("max_episode_steps requires auto_reset=True")

    new_idx, new_code, reward, done = move_bits(
        sem, bl, state.agent_idx, state.agent_code, action
    )

    if auto_reset:
        if max_episode_steps is not None:
            done = done | ((state.t + 1) >= max_episode_steps)
        start_idx = jnp.broadcast_to(bl.start_idx, new_idx.shape)
        start_code = jnp.broadcast_to(bl.start_code, new_code.shape)
        next_state = FastState(
            agent_idx=jnp.where(done, start_idx, new_idx),
            agent_code=jnp.where(done, start_code, new_code),
            t=jnp.where(done, 0, state.t + 1),
            done=jnp.zeros_like(done),
        )
        return next_state, (new_idx, reward, done)

    was_done = state.done
    agent_idx = jnp.where(was_done, state.agent_idx, new_idx)
    agent_code = jnp.where(was_done, state.agent_code, new_code)
    reward = jnp.where(was_done, jnp.float32(0.0), reward)
    done = was_done | done
    t = jnp.where(was_done, state.t, state.t + 1)
    next_state = FastState(agent_idx=agent_idx, agent_code=agent_code, t=t, done=done)
    return next_state, (agent_idx, reward, done)


def rollout_actions_bits(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    actions: jnp.ndarray,
    auto_reset: bool = False,
    max_episode_steps: int | None = None,
):
    """Pre-drawn-action rollout (the equivalence-test driver; mirrors
    ops.rollout.rollout_actions). actions — (T,) or (T, B)."""

    def body(carry, action):
        new_state, out = step_bits(
            sem, bl, carry, action, auto_reset, max_episode_steps
        )
        return new_state, out

    return jax.lax.scan(body, state, actions)


# ---------------------------------------------------------------------------
# In-scan action RNG. jax.random's threefry is ~30 ops per draw — comparable
# to the entire bitplane step — so the throughput path uses a per-env
# xorshift32 stream (3 shifts + 3 xors per draw). Streams are seeded
# per-env via a Weyl/odd-multiplier hash of the env id. This is a DIFFERENT
# stream than jax.random (documented; parity tests always use pre-drawn
# actions, SURVEY.md §7.3).
# ---------------------------------------------------------------------------


def xorshift_init(seed: jnp.ndarray, batch_shape, offset=0) -> jnp.ndarray:
    """Per-env uint32 xorshift32 states from a scalar seed.

    `offset` shifts the env-id lane numbering — a sharded rollout passes its
    shard's GLOBAL env offset so every env gets the same stream it would
    have in an unsharded run (bit-exact sharded ≡ unsharded trajectories).
    """
    n = 1
    for d in batch_shape:
        n *= d
    lanes = (
        jnp.asarray(offset, jnp.uint32)
        + jnp.arange(n, dtype=jnp.uint32).reshape(batch_shape)
    )
    s = (lanes * jnp.uint32(2654435761)) ^ jnp.asarray(seed, jnp.uint32)
    return s | jnp.uint32(1)  # xorshift32 must never be seeded with 0


def xorshift_next(s: jnp.ndarray):
    """One xorshift32 round: (state) → (new state, random bits)."""
    s = s ^ (s << 13)
    s = s ^ (s >> 17)
    s = s ^ (s << 5)
    return s, s


def random_scan_bits(
    sem: Semantics,
    bl: BitLevel,
    state: FastState,
    rs: jnp.ndarray,
    keys: jnp.ndarray | None,
    num_steps: int,
    max_episode_steps: int | None,
    rng: str,
    unroll: int = 1,
):
    """The fused random-action auto-reset scan, returning PER-ENV episode
    accumulators (episode count, folded return sum, folded length sum) —
    the pre-reduction core shared by the single-device rollouts and the
    shard_map-sharded rollout (parallel/bitplane.py), which psums the
    accumulators instead of summing them locally.

    Statistics accumulate per env (pure elementwise adds) and reduce across
    envs once at the end, keeping cross-env reductions out of the scan.
    """
    num_actions = sem.deltas.shape[0]
    shape = state.agent_idx.shape

    def body(carry, key_t):
        state, rs, run_ret, n_eps, ret_sum, len_sum = carry
        if rng == "xorshift":
            rs, bits = xorshift_next(rs)
            # top bits are the strongest in xorshift32
            actions = ((bits >> 9) % jnp.uint32(num_actions)).astype(jnp.int32)
        else:
            actions = jax.random.randint(key_t, shape, 0, num_actions, jnp.int32)
        # the episode-length counter is state.t, maintained by step_bits —
        # the finished episode's length is the pre-step t + 1
        ep_len = state.t + 1
        state, (obs, reward, done) = step_bits(
            sem, bl, state, actions, True, max_episode_steps
        )
        run_ret = run_ret + reward
        n_eps = n_eps + done
        ret_sum = ret_sum + jnp.where(done, run_ret, 0.0)
        len_sum = len_sum + jnp.where(done, ep_len, 0)
        run_ret = jnp.where(done, 0.0, run_ret)
        return (state, rs, run_ret, n_eps, ret_sum, len_sum), None

    zf = jnp.zeros(shape, jnp.float32)
    zi = jnp.zeros(shape, jnp.int32)
    init = (state, rs, zf, zi, zf, zi)
    (state, _, _, n_eps, ret_sum, len_sum), _ = jax.lax.scan(
        body, init, keys, length=num_steps, unroll=unroll
    )
    return state, n_eps, ret_sum, len_sum


def _rollout_random_impl(
    sem: Semantics,
    bl: BitLevel,
    seed: jnp.ndarray,
    batch_size: int,
    num_steps: int,
    max_episode_steps: int | None,
    rng: str,
    unroll: int = 1,
):
    """Body shared by the traced (`rollout_random_bits`) and compiled
    (`compile_rollout_random`) entry points."""
    state = reset_bits(bl, None if bl.batched else batch_size)
    rs = xorshift_init(seed, state.agent_idx.shape)
    if rng == "threefry":
        keys = jax.random.split(
            jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32)), num_steps
        )
    else:
        keys = None
    state, n_eps, ret_sum, len_sum = random_scan_bits(
        sem, bl, state, rs, keys, num_steps, max_episode_steps, rng, unroll
    )
    n = jnp.sum(n_eps)
    stats = {
        "episodes": n,
        "mean_return": jnp.sum(ret_sum) / jnp.maximum(n, 1),
        "mean_length": jnp.sum(len_sum) / jnp.maximum(n, 1),
    }
    return state, stats


@partial(
    jax.jit,
    static_argnames=("num_steps", "batch_size", "max_episode_steps", "rng"),
)
def rollout_random_bits(
    sem: Semantics,
    bl: BitLevel,
    seed: jnp.ndarray,
    batch_size: int,
    num_steps: int,
    max_episode_steps: int | None = None,
    rng: str = "xorshift",
):
    """Fused random-action auto-reset rollout with on-device episode stats.

    sem/bl are TRACED here, so one compilation serves many levels — use this
    form when composing inside a larger jit. For peak single-level
    throughput use `compile_rollout_random`, which bakes the level/semantics
    tables in as compile-time constants so XLA folds the select trees.

    rng — "xorshift" (fast per-env stream, default) or "threefry"
          (jax.random, same draw pattern as ops.rollout.rollout_random).

    Returns (final FastState, stats dict of scalars). Only scalars leave the
    device; the whole T×B rollout is one XLA program.
    """
    return _rollout_random_impl(
        sem, bl, seed, batch_size, num_steps, max_episode_steps, rng
    )


def compile_rollout_random(
    sem: Semantics,
    bl: BitLevel,
    batch_size: int,
    num_steps: int,
    max_episode_steps: int | None = None,
    rng: str = "xorshift",
    unroll: int = 16,
):
    """Peak-throughput factory: returns a jitted `fn(seed) -> (state, stats)`
    with the semantics tables and packed level CLOSED OVER — they trace as
    compile-time constants, letting XLA constant-fold the select trees into
    the fused step (the benchmark engine).

    unroll — lax.scan unroll factor. Purely a scheduling knob (results are
    bit-identical for any value: the per-env op sequence is unchanged).
    The default 16 was tuned on the TPU to amortize its loop-trip
    overhead; ROADMAP Speed item 3 re-tunes it on the GPU.
    """

    @jax.jit
    def fn(seed):
        return _rollout_random_impl(
            sem, bl, seed, batch_size, num_steps, max_episode_steps, rng, unroll
        )

    return fn
