"""Advantage actor-critic (A2C) — on-device, env-batched, optionally sharded.

The neural counterpart of the tabular learners (BASELINE north star:
"sharded tabular/actor-critic learner via all-reduce"). Structure:

  * One `train` call = one jitted `lax.scan` over U updates; each update is
    a T-step rollout scan of B vmapped auto-reset envs, an n-step-return
    computation (reverse scan), one forward/backward pass over the (T, B)
    batch, and an optax update. Zero host round-trips inside.
  * Distributed: identical body inside `shard_map` — envs sharded over the
    mesh, params/opt-state replicated, gradients combined with ONE
    `jax.lax.pmean` per update (the all-reduce). This is
    textbook data-parallel SGD expressed in the mesh idiom — no
    parameter-server or NCCL code.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..utils import struct
from ..core.semantics import Semantics
from ..core.types import Level
import numpy as np

from ..ops.bitplane import FastState, pack_level, reset_bits, step_bits
from .optim import make_lr
from ..parallel.mesh import env_axes
from .networks import ActorCritic, BatchedConvActorCritic, ConvActorCritic


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    rollout_len: int = 16
    lr: float = 3e-4
    gamma: float = 0.99
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    max_episode_steps: int | None = None  # auto-reset time-limit truncation
    # Trunk widths 64x64 with a 16-wide embedding (which also activates
    # the factored hi/lo lookup, models/networks.py): gridworld state
    # spaces (S <= a few thousand) need no wider trunks, and the corridor
    # and lava-9x9 tasks converge as with 128x128/64.
    hidden: tuple[int, ...] = (64, 64)
    embed_dim: int = 16
    # matmul precision ("bfloat16" runs the matmuls in bf16; params and
    # losses stay f32 — models/networks.py). Set "float32" for bit-level
    # reproducibility studies.
    compute_dtype: str = "bfloat16"
    # Observation encoding: "index" (one-hot-matmul embedding MLP) or
    # "grid" (tile+agent planes through a conv trunk — ConvActorCritic;
    # needs a shared level and a concrete `level` at trainer call time).
    obs: str = "index"
    conv_channels: tuple[int, ...] = (32, 32)  # obs="grid" trunk widths
    # agent-plane lowering for per-env-level conv trunks
    # (networks.BatchedConvActorCritic.agent_plane)
    agent_plane: str = "stamp"
    # lr schedule — see PPOConfig.lr_schedule / models/optim.py. Unit:
    # A2C updates (one Adam step each). Chunk-invariant via opt_state.
    lr_schedule: str = "constant"
    lr_decay_updates: int | None = None
    lr_final_frac: float = 0.0


class A2CResult(NamedTuple):
    params: dict
    episodes: jnp.ndarray
    mean_return: jnp.ndarray
    final_loss: jnp.ndarray


def make_network(level: Level, num_actions: int, cfg: A2CConfig):
    """Build the (hashable, jit-static) policy network for `cfg.obs`.

    obs='grid' with a batched (N, H, W) level returns the per-env-level
    trunk (BatchedConvActorCritic) — the level enters at apply time as
    tile planes instead of being baked in, so one agent trains across N
    distinct mazes."""
    obs_mode = getattr(cfg, "obs", "index")
    if obs_mode == "grid":
        if level.grid.ndim == 3:
            return BatchedConvActorCritic(
                height=int(level.grid.shape[1]),
                width=int(level.grid.shape[2]),
                num_actions=num_actions,
                channels=getattr(cfg, "conv_channels", (32, 32)),
                hidden=cfg.hidden,
                compute_dtype=getattr(cfg, "compute_dtype", "bfloat16"),
                agent_plane=getattr(cfg, "agent_plane", "stamp"),
            )
        try:
            grid = np.asarray(level.grid)
        except jax.errors.TracerArrayConversionError as e:
            raise ValueError(
                "obs='grid' bakes the level into the network as a static "
                "constant; call the trainer with a concrete level, not "
                "under jax.jit"
            ) from e
        return ConvActorCritic(
            height=int(grid.shape[0]),
            width=int(grid.shape[1]),
            grid=tuple(int(v) for v in grid.reshape(-1)),
            num_actions=num_actions,
            channels=getattr(cfg, "conv_channels", (32, 32)),
            hidden=cfg.hidden,
            compute_dtype=getattr(cfg, "compute_dtype", "bfloat16"),
        )
    if obs_mode != "index":
        raise ValueError(f"unknown obs mode: {obs_mode!r}")
    return ActorCritic(
        num_states=level.num_states,
        num_actions=num_actions,
        hidden=cfg.hidden,
        embed_dim=cfg.embed_dim,
        compute_dtype=getattr(cfg, "compute_dtype", "bfloat16"),
    )


def _tiles_from_grids(net, grids):
    """Tile-code grids → the net's tile planes (the ONE place the
    grid→plane encoding lives; used directly by the sharded trainers'
    shard bodies on their local grid slices)."""
    return jax.nn.one_hot(
        grids, net.num_tile_types, dtype=jnp.dtype(net.compute_dtype)
    )


def _tiles_for(net, level: Level):
    """Per-env tile planes for a needs-tiles net (BatchedConvActorCritic);
    None for every other network. The env→level binding is fixed for the
    whole run, so the (N, H, W, C) planes are computed once and closed
    over the training scan (loop-invariant — XLA hoists them)."""
    if not getattr(net, "needs_tiles", False):
        return None
    return _tiles_from_grids(net, level.grid)


def init_network_params(net, key):
    """Public initializer for any network family built by make_network /
    make_q_network (index MLP, shared-grid conv, per-env-grid conv) — the
    way to get params OUTSIDE a trainer, e.g. for the untrained baseline
    of models.evaluation.greedy_success_rate (examples/11)."""
    return _net_init(net, key)


def _net_apply(net, params, obs, tiles):
    """Uniform apply across index/shared-grid/per-env-grid networks."""
    if tiles is None:
        return net.apply(params, obs)
    return net.apply(params, obs, tiles)


def _net_init(net, key):
    """Initialize any of the three network families with a dummy batch."""
    if getattr(net, "needs_tiles", False):
        return net.init(
            key,
            jnp.zeros((1,), jnp.int32),
            jnp.zeros(
                (1, net.height, net.width, net.num_tile_types), jnp.float32
            ),
        )
    return net.init(key, jnp.zeros((1,), jnp.int32))


def _level_specs(bl, batch_size: int, spec):
    """shard_map in_specs for a BitLevel: per-env leaves shard with their
    envs (the compile_rollout_random_sharded pattern via sharding instead
    of dynamic_slice); a shared level stays replicated. Rank-aware per
    leaf: a batched BitLevel may legally carry SCALAR start_idx/start_code
    next to (B,) code_words (the '() or (B,)' contract) — rank-0 leaves
    stay replicated, reset_bits broadcasts them in-shard."""
    if not bl.batched:
        return jax.tree.map(lambda _: P(), bl)
    if bl.code_words.shape[0] != batch_size:
        raise ValueError(
            f"batched BitLevel has {bl.code_words.shape[0]} levels; "
            f"expected batch_size={batch_size}"
        )
    return jax.tree.map(lambda x: spec if jnp.ndim(x) else P(), bl)


def _sharded_env_specs(mesh, bl, batch_size: int):
    """The env-sharded data layout every distributed trainer family uses:
    (axes, local_b, spec, bl_specs, es_spec). `spec` shards a leading env
    axis over all mesh axes; `es_spec` applies it to each (B,) FastState
    leaf; `bl_specs` shards a batched BitLevel's per-env leaves (shared
    levels stay replicated). The SAME `spec` also lays out the (n_dev,)
    per-shard-stats vectors of the sharded TrainStates (one element per
    device, in `idx` linearization order)."""
    axes = env_axes(mesh)
    n_dev = mesh.size
    if batch_size % n_dev:
        raise ValueError(
            f"batch_size {batch_size} not divisible by mesh size {n_dev}"
        )
    spec = P(axes if len(axes) > 1 else axes[0])
    bl_specs = _level_specs(bl, batch_size, spec)
    es_spec = FastState(agent_idx=spec, agent_code=spec, t=spec, done=spec)
    return axes, batch_size // n_dev, spec, bl_specs, es_spec


def _make_update_body(sem, bl, cfg, net, tx, batch_local, base_key, axes=None,
                      tiles=None):
    """Shared single-update body; `axes` non-None → psum/pmean collectives.
    `tiles` non-None → per-env-level conv trunk (planes enter every apply).

    Env transitions run through the bit-packed step (ops/bitplane.py) —
    with the network trunk this makes the whole update gather-free (the
    observation embedding is a one-hot matmul too, models/networks.py).
    """

    def rollout(params, env_state, key):
        def body(carry, key_t):
            env_state = carry
            obs = env_state.agent_idx
            logits, value = _net_apply(net, params, obs, tiles)
            a = jax.random.categorical(key_t, logits).astype(jnp.int32)
            new_state, (_, reward, done) = step_bits(
                sem, bl, env_state, a, True, cfg.max_episode_steps
            )
            return new_state, (obs, a, reward, done)

        keys = jax.random.split(key, cfg.rollout_len)
        env_state, traj = jax.lax.scan(body, env_state, keys)
        return env_state, traj

    def returns_from(traj, bootstrap):
        _, _, rewards, dones = traj

        def body(g_next, x):
            r, d = x
            g = r + cfg.gamma * jnp.where(d, 0.0, g_next)
            return g, g

        _, g = jax.lax.scan(body, bootstrap, (rewards, dones), reverse=True)
        return g

    def loss_fn(params, traj, returns):
        obs, actions, _, _ = traj
        # (T, B, A), (T, B); per-env tiles broadcast over the T axis
        logits, values = _net_apply(net, params, obs, tiles)
        logp = jax.nn.log_softmax(logits)
        # one-hot sum, not take_along_axis — no gathers anywhere
        p_a = jax.nn.one_hot(actions, logits.shape[-1], dtype=logp.dtype)
        logp_a = jnp.sum(logp * p_a, axis=-1)
        adv = jax.lax.stop_gradient(returns - values)
        pg_loss = -jnp.mean(logp_a * adv)
        vf_loss = jnp.mean((returns - values) ** 2)
        entropy = -jnp.mean(jnp.sum(jnp.exp(logp) * logp, axis=-1))
        loss = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * entropy
        return loss

    def update(carry, u):
        params, opt_state, env_state, run_ret, n_eps, ret_sum = carry
        # counter-based per-update key (chunk-invariant resume, A2CTrainState)
        key_roll, _ = jax.random.split(jax.random.fold_in(base_key, u))
        env_state, traj = rollout(params, env_state, key_roll)

        _, bootstrap = _net_apply(net, params, env_state.agent_idx, tiles)
        returns = returns_from(traj, jax.lax.stop_gradient(bootstrap))
        loss, grads = jax.value_and_grad(loss_fn)(params, traj, returns)
        if axes is not None:
            grads = jax.lax.pmean(grads, axes)  # the all-reduce
            loss = jax.lax.pmean(loss, axes)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        # episode stats from the trajectory
        _, _, rewards, dones = traj

        def stat_body(c, x):
            run_ret, n_eps, ret_sum = c
            r, d = x
            run_ret = run_ret + r
            n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
            ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
            run_ret = jnp.where(d, 0.0, run_ret)
            return (run_ret, n_eps, ret_sum), None

        (run_ret, n_eps, ret_sum), _ = jax.lax.scan(
            stat_body, (run_ret, n_eps, ret_sum), (rewards, dones)
        )
        return (params, opt_state, env_state, run_ret, n_eps, ret_sum), loss

    return update


def a2c_train(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: A2CConfig = A2CConfig(),
    num_updates: int = 500,
    batch_size: int = 256,
) -> A2CResult:
    """Single-device (vmapped) A2C training run.

    The network is built here, OUTSIDE jit, and passed to the compiled
    body as a static argument — required so obs='grid' can bake the level
    into the conv trunk as a constant; identical configs hash equal, so
    the jit cache behaves exactly as before."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _a2c_train_impl(sem, level, key, cfg, num_updates, batch_size, net)


@partial(
    jax.jit, static_argnames=("cfg", "num_updates", "batch_size", "net")
)
def _a2c_train_impl(
    sem, level, key, cfg, num_updates, batch_size, net
) -> A2CResult:
    ts = _a2c_init_impl(level, key, cfg, batch_size, net)
    ts = _a2c_run_impl(sem, level, ts, cfg, num_updates, net)
    return A2CResult(
        params=ts.params,
        episodes=ts.episodes,
        mean_return=ts.ret_sum / jnp.maximum(ts.episodes, 1),
        final_loss=ts.last_loss,
    )


@struct.dataclass
class A2CTrainState:
    """Full resumable A2C learner state; `fold_in(key, update)` randomness
    makes chunked training bit-exact (see PPOTrainState for the
    contract)."""

    params: dict
    opt_state: tuple
    env_state: object
    key: jnp.ndarray
    update: jnp.ndarray
    run_ret: jnp.ndarray
    episodes: jnp.ndarray
    ret_sum: jnp.ndarray
    last_loss: jnp.ndarray


def _a2c_tx(cfg):
    # One A2C update = one Adam step, so the schedule unit is updates
    # directly; indexed by the Adam count in opt_state (chunk-invariant,
    # see models/optim.py).
    lr = make_lr(cfg.lr, cfg.lr_schedule, cfg.lr_decay_updates,
                 cfg.lr_final_frac, "lr_decay_updates")
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(lr)
    )


def a2c_init(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: A2CConfig = A2CConfig(),
    batch_size: int = 256,
) -> A2CTrainState:
    """Build the initial resumable train state (see A2CTrainState)."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _a2c_init_impl(level, key, cfg, batch_size, net)


@partial(jax.jit, static_argnames=("cfg", "batch_size", "net"))
def _a2c_init_impl(level, key, cfg, batch_size, net) -> A2CTrainState:
    key, k_init = jax.random.split(key)
    params = _net_init(net, k_init)
    bl = pack_level(level)
    env_state = reset_bits(bl, None if bl.batched else batch_size)
    b = batch_size if not bl.batched else int(bl.code_words.shape[0])
    return A2CTrainState(
        params=params,
        opt_state=_a2c_tx(cfg).init(params),
        env_state=env_state,
        key=key,
        update=jnp.zeros((), jnp.int32),
        run_ret=jnp.zeros(b, jnp.float32),
        episodes=jnp.zeros((), jnp.int32),
        ret_sum=jnp.zeros((), jnp.float32),
        last_loss=jnp.zeros((), jnp.float32),
    )


def a2c_run(
    sem: Semantics,
    level: Level,
    ts: A2CTrainState,
    cfg: A2CConfig = A2CConfig(),
    num_updates: int = 500,
) -> A2CTrainState:
    """Advance training by `num_updates`; chunk-invariant (bit-exact)."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _a2c_run_impl(sem, level, ts, cfg, num_updates, net)


@partial(jax.jit, static_argnames=("cfg", "num_updates", "net"))
def _a2c_run_impl(sem, level, ts, cfg, num_updates, net) -> A2CTrainState:
    tx = _a2c_tx(cfg)
    bl = pack_level(level)
    batch_size = ts.run_ret.shape[0]
    update = _make_update_body(
        sem, bl, cfg, net, tx, batch_size, ts.key,
        tiles=_tiles_for(net, level),
    )
    init = (
        ts.params, ts.opt_state, ts.env_state,
        ts.run_ret, ts.episodes, ts.ret_sum,
    )
    us = ts.update + jnp.arange(num_updates, dtype=jnp.int32)
    (params, opt_state, env_state, run_ret, n_eps, ret_sum), losses = (
        jax.lax.scan(update, init, us)
    )
    return ts.replace(
        params=params,
        opt_state=opt_state,
        env_state=env_state,
        update=ts.update + num_updates,
        run_ret=run_ret,
        episodes=n_eps,
        ret_sum=ret_sum,
        last_loss=losses[-1],
    )


def a2c_init_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: A2CConfig = A2CConfig(),
    batch_size: int = 256,
) -> A2CTrainState:
    """Initial FULL train state for the sharded path.

    Same A2CTrainState pytree as the single-device path, laid out over the
    mesh: params/opt_state/key/update/last_loss replicated; env_state and
    run_ret sharded over the env axis; episodes/ret_sum stored as (n_dev,)
    device-sharded PER-SHARD accumulators (element d = shard d's local
    count, `idx` linearization order) so chunked resume stays bit-exact —
    they are only summed when converting to a result (`a2c_result`)."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _a2c_init_sharded_impl(mesh, level, key, cfg, batch_size, net)


@partial(jax.jit, static_argnames=("mesh", "cfg", "batch_size", "net"))
def _a2c_init_sharded_impl(
    mesh, level, key, cfg, batch_size, net
) -> A2CTrainState:
    bl = pack_level(level)
    _, local_b, spec, bl_specs, es_spec = _sharded_env_specs(
        mesh, bl, batch_size
    )
    key, k_init = jax.random.split(key)
    params = _net_init(net, k_init)

    def shard_init(bl):
        return (
            reset_bits(bl, local_b),
            jnp.zeros(local_b, jnp.float32),
            jnp.zeros((1,), jnp.int32),
            jnp.zeros((1,), jnp.float32),
        )

    env_state, run_ret, eps, rets = jax.shard_map(
        shard_init,
        mesh=mesh,
        in_specs=(bl_specs,),
        out_specs=(es_spec, spec, spec, spec),
        check_vma=False,
    )(bl)
    return A2CTrainState(
        params=params,
        opt_state=_a2c_tx(cfg).init(params),
        env_state=env_state,
        key=key,
        update=jnp.zeros((), jnp.int32),
        run_ret=run_ret,
        episodes=eps,
        ret_sum=rets,
        last_loss=jnp.zeros((), jnp.float32),
    )


def a2c_run_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    ts: A2CTrainState,
    cfg: A2CConfig = A2CConfig(),
    num_updates: int = 500,
) -> A2CTrainState:
    """Advance sharded training by `num_updates`, carrying the FULL state
    through the shard_map boundary — optimizer momenta, env batch, RNG
    base key, update counter and per-shard stats all round-trip, so
    run(2N) ≡ run(N)∘checkpoint∘restore∘run(N) bit-exactly on a fixed
    mesh (tests/test_sharded_resume.py). Randomness is
    fold_in(fold_in(key, shard), global_update) — counter-based on both
    axes."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _a2c_run_sharded_impl(mesh, sem, level, ts, cfg, num_updates, net)


@partial(jax.jit, static_argnames=("mesh", "cfg", "num_updates", "net"))
def _a2c_run_sharded_impl(
    mesh, sem, level, ts, cfg, num_updates, net
) -> A2CTrainState:
    tx = _a2c_tx(cfg)
    bl = pack_level(level)
    batch_size = ts.run_ret.shape[0]
    axes, local_b, spec, bl_specs, es_spec = _sharded_env_specs(
        mesh, bl, batch_size
    )
    grids = level.grid if getattr(net, "needs_tiles", False) else None

    def shard_fn(params, opt_state, env_state, run_ret, eps, rets, update0,
                 sem, bl, grids, key):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
        base_key = jax.random.fold_in(key, idx)
        tiles = None if grids is None else _tiles_from_grids(net, grids)

        update = _make_update_body(
            sem, bl, cfg, net, tx, local_b, base_key, axes=axes, tiles=tiles
        )
        init = (params, opt_state, env_state, run_ret, eps[0], rets[0])
        us = update0 + jnp.arange(num_updates, dtype=jnp.int32)
        (params, opt_state, env_state, run_ret, n_eps, ret_sum), losses = (
            jax.lax.scan(update, init, us)
        )
        return (
            params, opt_state, env_state, run_ret,
            n_eps[None], ret_sum[None], losses[-1],
        )

    params, opt_state, env_state, run_ret, eps, rets, last_loss = (
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                P(), P(), es_spec, spec, spec, spec, P(), P(), bl_specs,
                None if grids is None else spec, P(),
            ),
            out_specs=(P(), P(), es_spec, spec, spec, spec, P()),
            check_vma=False,
        )(
            ts.params, ts.opt_state, ts.env_state, ts.run_ret, ts.episodes,
            ts.ret_sum, ts.update, sem, bl, grids, ts.key,
        )
    )
    return ts.replace(
        params=params,
        opt_state=opt_state,
        env_state=env_state,
        update=ts.update + num_updates,
        run_ret=run_ret,
        episodes=eps,
        ret_sum=rets,
        last_loss=last_loss,
    )


def reshard_stats(ts, mesh: Mesh):
    """Adapt a SHARDED TrainState (PPO/A2C/DQN) saved on one mesh size to
    a DIFFERENT mesh — the elastic-resume story for the distributed
    neural path (docs/SCALING.md "Elastic recovery").

    Everything semantically global survives a mesh change untouched:
    params, optimizer momenta, target nets, the env batch and replay
    buffer (global (B,)/(cap,) arrays — the new mesh's in_specs reshard
    them, requiring B and cap divisible by the new size), the RNG base
    key and the update/step counter. The only mesh-SIZE-pinned leaves are
    the (n_dev,) per-shard accumulators; this rebuckets them:

      * episodes / ret_sum — totals moved to shard 0 (zeros elsewhere):
        the GLOBAL totals, which are all `*_result` ever reads, are
        exactly preserved; per-shard attribution is an accounting detail.
      * p_max (DQN PER) — every new shard gets the global max (a safe
        upper bound: fresh writes enter at-or-above every old shard's
        running max, preserving the sample-new-transitions-first
        property).

    NOT bit-exact vs staying on the old mesh (per-shard RNG streams are
    fold_in(key, shard) — a different mesh draws different streams, the
    same documented behavior as every scalable-mode learner here).

    DQN constraints (the replay buffer is the one leaf whose MEANING
    depends on the mesh, not just its placement):

      * The buffer must be FULL. Shard-local valid-region size is
        derived as min(t·B_local, cap_local); on the new mesh that range
        covers a different slice of the concatenated old-shard circular
        buffers, so a partially-filled buffer would expose never-written
        all-zero slots to uniform replay. This function RAISES if
        t·B < capacity. (PER masks the issue via zero priorities, but
        the gate applies uniformly — full is the only layout whose
        contents are mesh-independent.)
      * Index-obs networks only. BatchedConvQNetwork (per-env levels)
        recovers a slot's source env as `slot % B_local` to fetch its
        tile planes; resharding permutes slots across shards, so that
        recovery — and hence the sampled observations — would silently
        be wrong. Keep the mesh fixed (or run to buffer-refill before
        trusting samples) for grid-obs-over-batched-mazes DQN.
      * Write order: the new mesh's write pointer (t·B_local mod
        cap_local) overwrites a rotation of the old global FIFO order,
        not exactly the globally-oldest slots. Contents stay valid
        transitions; strict FIFO age order is not preserved across the
        mesh change.

    The returned leaves are HOST (numpy) arrays: a device array stays
    committed to its original mesh and jit refuses to move it to a
    different one, so the state is pulled through the host exactly as a
    real elastic restart (checkpoint restore) would — the new mesh's
    in_specs reshard it on the next `*_run_sharded` call. Multi-process
    jobs gather first (`parallel.distributed.fetch_global`) and restore
    from the checkpoint bytes."""
    ts = jax.device_get(ts)
    n_new = mesh.size
    batch = int(np.shape(ts.run_ret)[0])
    if batch % n_new:
        raise ValueError(
            f"env batch {batch} not divisible by the new mesh size "
            f"{n_new}; elastic resume needs every global (B,) leaf to "
            f"reshard evenly"
        )
    if hasattr(ts, "buf"):
        cap = int(np.shape(ts.buf.obs)[0])
        if cap % n_new:
            raise ValueError(
                f"replay capacity {cap} not divisible by the new mesh "
                f"size {n_new}"
            )
        if int(ts.t) * batch < cap:
            raise ValueError(
                f"DQN elastic resume requires a FULL replay buffer: "
                f"t*B = {int(ts.t) * batch} < capacity {cap}. A "
                f"partially-filled buffer's valid region is derived "
                f"per-shard from t and would cover never-written slots "
                f"on the new mesh (see reshard_stats docstring). Run "
                f"more steps on the old mesh first."
            )
    eps = np.zeros((n_new,), np.asarray(ts.episodes).dtype)
    eps[0] = np.sum(ts.episodes)
    rets = np.zeros((n_new,), np.asarray(ts.ret_sum).dtype)
    rets[0] = np.sum(ts.ret_sum)
    ts = ts.replace(episodes=eps, ret_sum=rets)
    if hasattr(ts, "p_max"):
        ts = ts.replace(
            p_max=np.full(
                (n_new,), np.max(ts.p_max), np.asarray(ts.p_max).dtype
            )
        )
    return ts


def a2c_result(ts: A2CTrainState) -> A2CResult:
    """TrainState → A2CResult. Works for single-device (scalar stats) and
    sharded ((n_dev,) per-shard stats) layouts — stats are summed here,
    never inside the resumable state."""
    n_eps = jnp.sum(ts.episodes)
    return A2CResult(
        params=ts.params,
        episodes=n_eps,
        mean_return=jnp.sum(ts.ret_sum) / jnp.maximum(n_eps, 1),
        final_loss=ts.last_loss,
    )


def a2c_train_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: A2CConfig = A2CConfig(),
    num_updates: int = 500,
    batch_size: int = 256,
    init_params=None,
    init_opt_state=None,
) -> A2CResult:
    """Data-parallel A2C: envs sharded over the mesh, params replicated,
    grads pmean'd — one all-reduce per update. A thin composition of
    a2c_init_sharded + a2c_run_sharded + a2c_result; use those directly
    for checkpoint/resume of long runs (full state round-trips there).
    `init_params` / `init_opt_state` warm-start from saved params only
    (fresh envs/optimizer unless init_opt_state is given — the
    coarse-grained multi-process restart story)."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    ts = _a2c_init_sharded_impl(mesh, level, key, cfg, batch_size, net)
    if init_params is not None:
        # opt_state needs no rebuild: adam/clip init is zeros_like(params),
        # identical for any param VALUES of the same shapes
        ts = ts.replace(params=init_params)
    if init_opt_state is not None:
        ts = ts.replace(opt_state=init_opt_state)
    ts = _a2c_run_sharded_impl(mesh, sem, level, ts, cfg, num_updates, net)
    return a2c_result(ts)


def greedy_actions(net: ActorCritic, params, obs: jnp.ndarray) -> jnp.ndarray:
    logits, _ = net.apply(params, obs)
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)
