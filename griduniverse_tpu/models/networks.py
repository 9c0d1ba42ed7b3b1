"""Neural networks for gridworld learners, in plain JAX.

The reference has no neural nets (SURVEY.md §2.2); the actor-critic learner
comes from the BASELINE north star ("sharded tabular/actor-critic learner
via all-reduce"). Design notes:

  * Each network is a frozen, hashable dataclass of its hyperparameters,
    so trainers pass it to `jit` as a static argument. `net.init(key,
    *dummy_inputs)` returns `{"params": tree}`; `net.apply(variables,
    *inputs)` returns `(logits, value)`.
  * Observations are state indices; the network embeds them as
    one_hot(obs) @ table — a dense matmul instead of a gather. This
    was chosen for the TPU, whose gathers serialize; ROADMAP Speed item 6
    re-tests it on the GPU. Small discrete obs spaces (S = H·W ≤ a few
    thousand) make the one-hot cheap.
  * MLP trunk with separate policy/value heads.
  * Mixed precision: params live in f32, matmuls run in `compute_dtype`
    (default bf16). Heads cast back to f32 so losses/softmaxes/GAE stay
    full-precision.
  * Parameters are a plain dict pytree: replicated across the mesh by the
    distributed trainer, combined with psum'd grads (models.a2c).
  * Initializers: `lecun_normal` kernels, zero biases, and a fan-in
    `variance_scaling` embedding table. Each parameter's key is derived
    from its name (`_param_key`), so a seed gives the same initial weights
    whatever other layers a network has.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()
_embed_init = jax.nn.initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0
)
_DN = ("NHWC", "HWIO", "NHWC")


def _param_key(key, *path):
    """Key of the parameter at `path`: the scope names, then the 1-based
    count of parameters drawn in that scope, SHA-1 hashed and folded into
    `key`. This is flax.linen's derivation, so seeds give the same initial
    weights as the flax networks these replaced."""
    m = hashlib.sha1()
    for x in path:
        m.update(
            x.encode() if isinstance(x, str)
            else x.to_bytes((x.bit_length() + 7) // 8, "big")
        )
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big"))
    )


def _layer(key, name, kernel_shape):
    return {
        "kernel": _lecun_normal(
            _param_key(key, name, 1), kernel_shape, jnp.float32
        ),
        "bias": jnp.zeros((kernel_shape[-1],), jnp.float32),
    }


def _dense(p, x, cdt):
    return x.astype(cdt) @ p["kernel"].astype(cdt) + p["bias"].astype(cdt)


def _conv(kernel, x, cdt):
    return jax.lax.conv_general_dilated(
        x.astype(cdt), kernel.astype(cdt), (1, 1), "SAME",
        dimension_numbers=_DN,
    )


def _mlp_heads_init(key, fan_in, hidden, num_actions):
    """dense_i trunk + policy/value heads."""
    params = {}
    for i, width in enumerate(hidden):
        params[f"dense_{i}"] = _layer(key, f"dense_{i}", (fan_in, width))
        fan_in = width
    params["policy_head"] = _layer(key, "policy_head", (fan_in, num_actions))
    params["value_head"] = _layer(key, "value_head", (fan_in, 1))
    return params


def _mlp_heads(p, x, hidden, cdt):
    for i in range(len(hidden)):
        x = jax.nn.relu(_dense(p[f"dense_{i}"], x, cdt))
    logits = _dense(p["policy_head"], x, cdt)
    value = _dense(p["value_head"], x, cdt)[..., 0]
    return logits, value


def _conv_trunk_init(key, height, width, num_tile_types, channels, hidden,
                     num_actions):
    """conv_0 (split tile/agent kernel) + conv_i layers + the MLP heads."""
    params = {
        "conv_0_kernel": _lecun_normal(
            _param_key(key, 1),
            (3, 3, num_tile_types + 1, channels[0]), jnp.float32,
        ),
        "conv_0_bias": jnp.zeros((channels[0],), jnp.float32),
    }
    for i in range(1, len(channels)):
        params[f"conv_{i}"] = _layer(
            key, f"conv_{i}", (3, 3, channels[i - 1], channels[i])
        )
    params.update(_mlp_heads_init(
        key, height * width * channels[-1], hidden, num_actions
    ))
    return params


def _conv_tail(p, x, channels, cdt):
    """Layers conv_1.. over the post-ReLU conv_0 output."""
    for i in range(1, len(channels)):
        x = jax.nn.relu(
            _conv(p[f"conv_{i}"]["kernel"], x, cdt)
            + p[f"conv_{i}"]["bias"].astype(cdt)
        )
    return x


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """One-hot-matmul embedding → MLP trunk → (policy logits, value).

    num_states — size of the discrete observation space (H·W).
    num_actions — policy head width.
    hidden — trunk layer widths.
    """

    num_states: int
    num_actions: int
    hidden: Sequence[int] = (128, 128)
    embed_dim: int = 64
    compute_dtype: str = "bfloat16"  # matmul dtype; params stay f32

    def init(self, key, *dummy_inputs):
        params = {
            "embed": _embed_init(
                _param_key(key, 1), (self.num_states, self.embed_dim),
                jnp.float32,
            )
        }
        params.update(
            _mlp_heads_init(key, self.embed_dim, self.hidden, self.num_actions)
        )
        return {"params": params}

    def apply(self, variables, obs: jnp.ndarray):
        p = variables["params"]
        cdt = jnp.dtype(self.compute_dtype)
        table = p["embed"]
        # Embedding lookup: `one_hot(s) @ table`, routed through the
        # algos/td_fast.py hi/lo factorization when it SHRINKS the
        # materialized operand: with s = hi·L + lo, the lookup becomes a
        # (B, S/L) matmul against table.reshape(S/L, L·E) plus a tiny
        # lo-contraction — exact same math (one-hot products select exact
        # rows), but the biggest per-sample operand drops from S to
        # max(S/L, L·E) columns. The plain one-hot stays for shapes where
        # the factorization can't shrink it.
        lo_n = 4
        if (
            self.num_states % lo_n == 0
            and max(self.num_states // lo_n, lo_n * self.embed_dim)
            < self.num_states
        ):
            hi_n = self.num_states // lo_n
            p_hi = jax.nn.one_hot(obs // lo_n, hi_n, dtype=cdt)
            p_lo = jax.nn.one_hot(obs % lo_n, lo_n, dtype=cdt)
            y = (
                p_hi @ table.astype(cdt).reshape(hi_n, lo_n * self.embed_dim)
            ).reshape(*obs.shape, lo_n, self.embed_dim)
            x = jnp.sum(p_lo[..., None] * y, axis=-2)
        else:
            x = jax.nn.one_hot(obs, self.num_states, dtype=cdt) @ table.astype(cdt)
        logits, value = _mlp_heads(p, x, self.hidden, cdt)
        return logits.astype(jnp.float32), value.astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class BatchedConvActorCritic:
    """Grid-observation actor-critic for PER-ENV levels — the trunk that
    lets one agent train across 64k distinct mazes (BASELINE configs 4+5
    composed).

    Unlike ConvActorCritic (which bakes ONE shared level in as a static
    constant), the level enters at apply time as per-sample tile planes:
    `apply(params, obs, tiles)` with obs (...,) int32 state indices and
    tiles (Bl..., H, W, C) one-hot tile planes, where `Bl...` must equal a
    TRAILING suffix of obs's batch shape. The canonical case: obs (T, B)
    over a rollout with tiles (B, H, W, C) — each env keeps one level for
    the whole rollout, so the tile planes carry no time axis.

    Notes:
      * conv_0 is split exactly like ConvActorCritic: the tile planes
        convolve once PER LEVEL ROW (B samples), the agent plane once per
        (T, B) sample, summed pre-ReLU. With obs (T, B) and tiles (B, ...)
        this does 1/T-th of the naive tile-conv FLOPs and memory traffic
        while keeping gradients exact (the broadcast's transpose sums the
        kernel gradient over T — the same math as convolving every
        sample).
      * Parameter tree is IDENTICAL to ConvActorCritic's (same names,
        same shapes), so params transfer between the shared-level and
        per-env-level trunks (tested equivalent on a shared level in
        tests/test_perenv_levels.py).
    """

    height: int
    width: int
    num_actions: int
    num_tile_types: int = 4
    channels: Sequence[int] = (32, 32)
    hidden: Sequence[int] = (128,)
    compute_dtype: str = "bfloat16"
    # Agent-plane lowering. The agent input is a ONE-HOT image, so its
    # conv output is just the flipped 3×3 kernel stamped around the agent
    # cell:
    #   "stamp" (default) — precompute T = conv_0(identity images), an
    #     (S, S·ch0) table (~420 KB bf16 at 9×9/32ch; differentiable
    #     through the SAME conv_0_kernel param), then per sample
    #     y_agent = one_hot(p, S) @ T — ONE dense matmul replacing a
    #     1-input-channel conv. Chosen on the TPU; ROADMAP Design item 4
    #     re-tests it on the GPU.
    #   "conv" — the direct conv lowering (kept for A/B and parity tests).
    agent_plane: str = "stamp"

    # trainers key their wiring off this (models.a2c._tiles_for)
    needs_tiles = True

    def init(self, key, *dummy_inputs):
        self._check()
        return {"params": _conv_trunk_init(
            key, self.height, self.width, self.num_tile_types,
            self.channels, self.hidden, self.num_actions,
        )}

    def _check(self):
        if not self.channels:
            raise ValueError("BatchedConvActorCritic needs ≥1 conv layer")
        if self.agent_plane not in ("stamp", "conv"):
            raise ValueError(f"unknown agent_plane mode: {self.agent_plane!r}")

    def apply(self, variables, obs: jnp.ndarray, tiles: jnp.ndarray):
        self._check()
        p = variables["params"]
        cdt = jnp.dtype(self.compute_dtype)
        batch_shape = obs.shape
        lvl_shape = tiles.shape[:-3]
        if tiles.shape[-3:] != (self.height, self.width, self.num_tile_types):
            raise ValueError(
                f"tiles trailing dims {tiles.shape[-3:]} != "
                f"{(self.height, self.width, self.num_tile_types)}"
            )
        if lvl_shape != batch_shape[len(batch_shape) - len(lvl_shape):]:
            raise ValueError(
                f"tiles batch shape {lvl_shape} is not a trailing suffix "
                f"of obs batch shape {batch_shape}"
            )
        b = 1
        for d in batch_shape:
            b *= d
        nl = 1
        for d in lvl_shape:
            nl *= d
        s = self.height * self.width
        c = self.num_tile_types
        ch0 = self.channels[0]
        kernel = p["conv_0_kernel"]
        y_tiles = _conv(
            kernel[:, :, :c, :],
            tiles.reshape(nl, self.height, self.width, c), cdt,
        )  # (nl, H, W, ch0) — once per level row, broadcast over time
        p_hot = jax.nn.one_hot(obs.reshape(-1), s, dtype=cdt)
        if self.agent_plane == "stamp":
            # stamp table: row p = conv_0's response image to an agent at
            # cell p. S identity images through the conv (tiny, batch-
            # and loop-invariant given params — XLA hoists it out of
            # rollout scans), then the per-sample "conv" is a single
            # (B, S) @ (S, S·ch0) matmul.
            eye_imgs = jnp.eye(s, dtype=cdt).reshape(
                s, self.height, self.width, 1
            )
            stamp = _conv(kernel[:, :, c:, :], eye_imgs, cdt).reshape(
                s, s * ch0
            )
            y_agent = (p_hot @ stamp).reshape(
                b, self.height, self.width, ch0
            )
        else:
            agent = p_hot.reshape(b, self.height, self.width, 1)
            y_agent = _conv(kernel[:, :, c:, :], agent, cdt)
        y_sum = y_agent.reshape(
            *batch_shape, self.height, self.width, ch0
        ) + y_tiles.reshape(*lvl_shape, self.height, self.width, ch0)
        x = jax.nn.relu(y_sum + p["conv_0_bias"].astype(cdt)).reshape(
            b, self.height, self.width, ch0
        )
        x = _conv_tail(p, x, self.channels, cdt).reshape(b, -1)
        logits, value = _mlp_heads(p, x, self.hidden, cdt)
        return (
            logits.reshape(*batch_shape, self.num_actions).astype(jnp.float32),
            value.reshape(batch_shape).astype(jnp.float32),
        )


@dataclasses.dataclass(frozen=True)
class ConvActorCritic:
    """Grid-observation actor-critic: conv trunk over (H, W, C) planes.

    The state index is expanded INSIDE the network into C = num_tile_types
    tile one-hot planes plus an agent-position plane — so it is a drop-in
    for ActorCritic (same `apply(params, obs_indices)` signature, any
    leading batch shape) and every trainer/shard_map works unchanged.

    Notes:
      * The level grid is a STATIC field (a tuple of tile codes), so the
        tile planes constant-fold at trace time — the per-step cost is the
        agent one-hot + the convs.
      * Being static also makes the network hashable, so trainers pass it
        as a `jit` static argument (construction happens OUTSIDE jit; see
        models.a2c.make_network).
      * Spatial weight sharing is the point: unlike the index-embedding
        MLP, the conv trunk sees the maze structure, not a bag of state
        ids.
    """

    height: int
    width: int
    grid: tuple  # H·W tile codes, row-major (static — baked into the jit)
    num_actions: int
    num_tile_types: int = 4
    channels: Sequence[int] = (32, 32)
    hidden: Sequence[int] = (128,)
    compute_dtype: str = "bfloat16"

    def init(self, key, *dummy_inputs):
        self._check()
        return {"params": _conv_trunk_init(
            key, self.height, self.width, self.num_tile_types,
            self.channels, self.hidden, self.num_actions,
        )}

    def _check(self):
        if not self.channels:
            raise ValueError("ConvActorCritic needs at least one conv layer")

    def apply(self, variables, obs: jnp.ndarray):
        self._check()
        p = variables["params"]
        cdt = jnp.dtype(self.compute_dtype)
        batch_shape = obs.shape
        flat = obs.reshape(-1)
        b = flat.shape[0]
        s = self.height * self.width
        c = self.num_tile_types
        # conv_0 is split at apply time: its kernel logically covers the
        # C tile planes + 1 agent plane, but the tile planes are
        # batch-CONSTANT — convolving them per sample would broadcast
        # ~B·S·C of identical data per apply (164 MB at 64k envs / 16×16)
        # and redo C/(C+1) of conv_0's FLOPs. The conv is linear pre-ReLU,
        # so: conv the batch-1 tile image once (loop-invariant — XLA
        # hoists it out of rollout scans), conv the agent plane per
        # sample, add.
        kernel = p["conv_0_kernel"]
        tiles = jax.nn.one_hot(
            jnp.asarray(self.grid, jnp.int32), c, dtype=cdt
        ).reshape(1, self.height, self.width, c)  # compile-time constant
        agent = jax.nn.one_hot(flat, s, dtype=cdt).reshape(
            b, self.height, self.width, 1
        )
        y_tiles = _conv(kernel[:, :, :c, :], tiles, cdt)  # batch-constant
        y_agent = _conv(kernel[:, :, c:, :], agent, cdt)
        x = jax.nn.relu(y_agent + y_tiles + p["conv_0_bias"].astype(cdt))
        x = _conv_tail(p, x, self.channels, cdt).reshape(b, -1)
        logits, value = _mlp_heads(p, x, self.hidden, cdt)
        return (
            logits.reshape(*batch_shape, self.num_actions).astype(jnp.float32),
            value.reshape(batch_shape).astype(jnp.float32),
        )
