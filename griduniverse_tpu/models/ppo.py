"""Proximal policy optimization (PPO) — on-device, env-batched, sharded.

The second policy-gradient family next to A2C (models/a2c.py), sharing the
same machinery: the bit-packed gather-free env step
(ops/bitplane.py), the one-hot-matmul ActorCritic trunk
(models/networks.py), and the data-parallel shard_map/pmean pattern. The
reference has no neural learners (SURVEY.md §2.2); this extends the
BASELINE north-star actor-critic with the production-standard on-policy
algorithm.

Structure (one jitted `lax.scan` over U updates; zero host round-trips):

  update = T-step rollout of B auto-reset envs (logp/value recorded)
         → GAE(λ) advantages by one reverse scan (bootstrapped)
         → E epochs × M minibatches of clipped-surrogate SGD
           (epoch shuffle = one `jax.random.permutation` gather per epoch —
            a cold per-update op, NOT the per-step hot path; the compute
            inside each minibatch is matmuls)

Distributed (`ppo_train_sharded`): envs sharded over the mesh, params and
optimizer state replicated, each worker shuffles its LOCAL trajectory slab
and gradients are `pmean`'d per minibatch step — the textbook distributed
PPO layout, expressed as one shard_map.
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
from ..ops.bitplane import pack_level, reset_bits, step_bits
from .optim import make_lr
from .a2c import (
    _net_apply,
    _net_init,
    _sharded_env_specs,
    _tiles_for,
    _tiles_from_grids,
    make_network,
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_len: int = 16
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    max_episode_steps: int | None = None  # auto-reset time-limit truncation
    num_epochs: int = 4
    num_minibatches: int = 4
    normalize_adv: bool = True
    # Optional production-PPO regularizers:
    #   vf_clip_eps — clip the value-function update around the behavior
    #     value (PPO2-style pessimistic max of clipped/unclipped VF loss).
    #   target_kl — once the (k3) approx KL exceeds 1.5×target_kl, the
    #     REMAINING minibatch updates of this update are masked out —
    #     branchless early stopping (grads scaled by an active flag; the
    #     KL is pmean'd across shards first so replicas stay in lockstep).
    vf_clip_eps: float | None = None
    target_kl: float | None = None
    # Epoch-shuffle granularity, in decreasing gather cost:
    #   "element": classic flat (T·B)-element permutation; its element-level
    #     gathers dominated the whole update on the TPU.
    #   "env": permute the ENV axis, minibatch = env block — envs are iid so
    #     this is statistically-equivalent minibatching with B gather
    #     indices instead of T·B. Still pays one B-column gather per epoch.
    #   "roll" (default): rotate the env axis by a per-epoch random offset —
    #     envs are EXCHANGEABLE, so a contiguous block after rotation is
    #     distributionally identical to a random subset; a roll lowers to
    #     two slices + concat (pure copies, no gather at all). Learning
    #     curves match "env".
    #   "none": FIXED contiguous env blocks, identical across epochs — zero
    #     shuffle copies at all. Statistical caveat: the same envs always
    #     share a minibatch, so epoch-to-epoch minibatch composition never
    #     varies (acceptable for iid envs at large B).
    # The modes were ranked on the TPU; ROADMAP Design item 4 re-tests
    # them on the GPU.
    shuffle: str = "roll"
    # Trunk widths 64x64 with a 16-wide embedding (which also activates
    # the factored hi/lo lookup, models/networks.py): gridworld state
    # spaces (S <= a few thousand) need no wider trunks, and the corridor
    # and lava-9x9 tasks converge as with 128x128/64.
    hidden: tuple[int, ...] = (64, 64)
    embed_dim: int = 16
    # matmul precision (see A2CConfig.compute_dtype)
    compute_dtype: str = "bfloat16"
    # observation encoding (see A2CConfig.obs)
    obs: str = "index"
    conv_channels: tuple[int, ...] = (32, 32)
    # agent-plane lowering for per-env-level conv trunks
    # (networks.BatchedConvActorCritic.agent_plane)
    agent_plane: str = "stamp"
    # Learning-rate schedule. "constant" (default) or "linear": decay
    # from lr to lr*lr_final_frac over lr_decay_updates PPO updates
    # (lr_decay_updates is REQUIRED for "linear"; steps past the horizon
    # hold the final lr). The schedule is driven by the Adam step count
    # carried in opt_state, so chunked/checkpointed runs consume exactly
    # the same lr sequence as one unbroken run — the same counter-based
    # chunk-invariance contract as the RNG (tests/test_checkpoint.py).
    lr_schedule: str = "constant"
    lr_decay_updates: int | None = None
    lr_final_frac: float = 0.0


class PPOResult(NamedTuple):
    params: dict
    episodes: jnp.ndarray
    mean_return: jnp.ndarray
    final_loss: jnp.ndarray


@struct.dataclass
class PPOTrainState:
    """Full resumable PPO learner state (SURVEY.md §5 checkpoint row: "the
    full learner pytree … + env-state + RNG keys"). Per-update randomness
    is `fold_in(key, update)` — counter-based — so training chunked across
    any checkpoint boundary consumes EXACTLY the same randoms as one
    unbroken run (bit-exact; tests/test_checkpoint.py)."""

    params: dict
    opt_state: tuple
    env_state: object       # bitplane env batch
    key: jnp.ndarray        # base PRNG key (never consumed, only folded)
    update: jnp.ndarray     # () int32 global update counter
    run_ret: jnp.ndarray    # (B,) running per-env episode returns
    episodes: jnp.ndarray   # () int32
    ret_sum: jnp.ndarray    # () float32
    last_loss: jnp.ndarray  # () float32 most recent epoch loss


class _Traj(NamedTuple):
    obs: jnp.ndarray      # (T, B) int32 state indices
    action: jnp.ndarray   # (T, B) int32
    logp: jnp.ndarray     # (T, B) behavior log-prob
    value: jnp.ndarray    # (T, B) V(s_t) under behavior params
    reward: jnp.ndarray   # (T, B)
    done: jnp.ndarray     # (T, B) bool


def gae_advantages(traj: _Traj, bootstrap: jnp.ndarray, gamma: float, lam: float):
    """GAE(λ) by one reverse scan. `bootstrap` — V(s_{T}) of the post-rollout
    state. Episode boundaries (auto-reset `done`) zero both the bootstrap
    and the advantage carry. Returns (advantages, value targets), (T, B)."""
    def body(adv_next, x):
        v, v_next, r, d = x
        notdone = 1.0 - d.astype(jnp.float32)
        delta = r + gamma * v_next * notdone - v
        adv = delta + gamma * lam * notdone * adv_next
        return adv, adv

    v_next = jnp.concatenate([traj.value[1:], bootstrap[None]], axis=0)
    _, adv = jax.lax.scan(
        body,
        jnp.zeros_like(bootstrap),
        (traj.value, v_next, traj.reward, traj.done),
        reverse=True,
    )
    return adv, adv + traj.value


def ppo_loss(net, cfg: PPOConfig, params, mb, mb_tiles=None):
    """Clipped-surrogate PPO loss of one minibatch `mb` = (obs, actions,
    logp_old, v_old, adv, targets); `mb_tiles` feeds per-env-level conv
    trunks. Returns (loss, approx_kl) — differentiate with
    `jax.value_and_grad(..., argnums=2, has_aux=True)`."""
    obs, actions, logp_old, v_old, adv, targets = mb
    logits, values = _net_apply(net, params, obs, mb_tiles)
    logp_all = jax.nn.log_softmax(logits)
    p_a = jax.nn.one_hot(actions, logits.shape[-1], dtype=logp_all.dtype)
    logp = jnp.sum(logp_all * p_a, axis=-1)
    log_ratio = logp - logp_old
    ratio = jnp.exp(log_ratio)
    pg = -jnp.mean(
        jnp.minimum(
            ratio * adv,
            jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv,
        )
    )
    if cfg.vf_clip_eps is not None:
        v_clip = v_old + jnp.clip(
            values - v_old, -cfg.vf_clip_eps, cfg.vf_clip_eps
        )
        vf = jnp.mean(
            jnp.maximum((targets - values) ** 2, (targets - v_clip) ** 2)
        )
    else:
        vf = jnp.mean((targets - values) ** 2)
    entropy = -jnp.mean(jnp.sum(jnp.exp(logp_all) * logp_all, axis=-1))
    # k3 estimator of KL(old ‖ new): E[(r − 1) − log r] ≥ 0, low variance
    approx_kl = jnp.mean((ratio - 1.0) - log_ratio)
    return pg + cfg.vf_coef * vf - cfg.ent_coef * entropy, approx_kl


def _make_update_body(
    sem, bl, cfg: PPOConfig, net, tx, batch_local, base_key, axes=None,
    tiles=None,
):
    """Shared single-update body, scanned over GLOBAL update indices.
    Randomness is `fold_in(base_key, u)` (counter-based → chunk-invariant
    resume, see PPOTrainState). `axes` non-None → pmean collectives.
    `tiles` non-None → per-env-level conv trunk: minibatches keep their
    (T, b_mb) env structure so each env block's tile planes ride along
    (gather-free under shuffle='roll' — the planes roll with the slab)."""
    if tiles is not None and cfg.shuffle not in ("roll", "none"):
        raise ValueError(
            "per-env-level grid observations require shuffle='roll' (or "
            "'none'): 'element'/'env' permutations would need a per-sample "
            "tile-plane gather, while a roll keeps minibatches as contiguous "
            "env blocks whose planes roll along with the trajectory slab"
        )

    def rollout(params, env_state, key):
        def body(carry, g_t):
            env_state = carry
            obs = env_state.agent_idx
            logits, value = _net_apply(net, params, obs, tiles)
            # Gumbel-max sampling with the noise drawn OUTSIDE the scan —
            # identical distribution to jax.random.categorical (which is
            # the same trick), but the per-step threefry leaves the scan's
            # critical path (same lever as dqn._keys_for_steps)
            a = jnp.argmax(logits + g_t, axis=-1).astype(jnp.int32)
            logp_all = jax.nn.log_softmax(logits)
            p_a = jax.nn.one_hot(a, logits.shape[-1], dtype=logp_all.dtype)
            logp = jnp.sum(logp_all * p_a, axis=-1)
            new_state, (_, reward, done) = step_bits(
                sem, bl, env_state, a, True, cfg.max_episode_steps
            )
            return new_state, _Traj(obs, a, logp, value, reward, done)

        gumbel = jax.random.gumbel(
            key, (cfg.rollout_len, batch_local, net.num_actions)
        )
        env_state, traj = jax.lax.scan(body, env_state, gumbel)
        return env_state, traj

    loss_fn = partial(ppo_loss, net, cfg)

    n_flat = cfg.rollout_len * batch_local
    if n_flat % cfg.num_minibatches:
        raise ValueError(
            f"rollout_len*batch ({n_flat}) not divisible by "
            f"num_minibatches ({cfg.num_minibatches})"
        )
    if cfg.shuffle not in ("env", "element", "roll", "none"):
        raise ValueError(f"unknown shuffle mode: {cfg.shuffle!r}")
    if cfg.shuffle in ("env", "roll", "none") and batch_local % cfg.num_minibatches:
        raise ValueError(
            f"shuffle={cfg.shuffle!r} needs batch ({batch_local}) divisible "
            f"by num_minibatches ({cfg.num_minibatches})"
        )
    mb_size = n_flat // cfg.num_minibatches

    def sgd_step(carry, xs):
        mb, mb_tiles = xs if tiles is not None else (xs, None)
        params, opt_state, active = carry
        (loss, kl), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, mb, mb_tiles
        )
        if axes is not None:
            grads = jax.lax.pmean(grads, axes)
            loss = jax.lax.pmean(loss, axes)
            kl = jax.lax.pmean(kl, axes)  # lockstep early-stop decisions
        # target_kl early stop, branchless: once tripped, the ENTIRE step
        # is frozen — params AND optimizer state (merely zeroing grads
        # would leave Adam momentum walking the params; measured)
        updates, new_opt_state = tx.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        if cfg.target_kl is not None:
            keep = active > 0.5
            params = jax.tree.map(
                lambda n, o: jnp.where(keep, n, o), new_params, params
            )
            opt_state = jax.tree.map(
                lambda n, o: jnp.where(keep, n, o), new_opt_state, opt_state
            )
            active = active * (kl <= 1.5 * cfg.target_kl).astype(jnp.float32)
        else:
            params, opt_state = new_params, new_opt_state
        return (params, opt_state, active), loss

    def epoch_step(carry, key_e):
        params, opt_state, active, slab = carry  # slab leaves (T, B_local)
        if cfg.shuffle == "element":
            perm = jax.random.permutation(key_e, n_flat)
            mbs = jax.tree.map(
                lambda x: x.reshape(n_flat)[perm].reshape(
                    cfg.num_minibatches, mb_size
                ),
                slab,
            )
        elif cfg.shuffle == "env":  # permute envs, minibatch = env block
            perm = jax.random.permutation(key_e, batch_local)
            b_mb = batch_local // cfg.num_minibatches

            def mk(x):
                x = x[:, perm].reshape(-1, cfg.num_minibatches, b_mb)
                return jnp.moveaxis(x, 1, 0).reshape(
                    cfg.num_minibatches, mb_size
                )

            mbs = jax.tree.map(mk, slab)
        else:  # "roll": rotate envs by a random offset — no gather at all
            # "none": offset pinned to 0 — the roll folds to the identity,
            # leaving FIXED contiguous env blocks (zero shuffle copies)
            if cfg.shuffle == "none":
                off = jnp.int32(0)
            else:
                off = jax.random.randint(key_e, (), 0, batch_local)
            b_mb = batch_local // cfg.num_minibatches

            if tiles is not None:
                # keep the (T, b_mb) env structure: each minibatch is a
                # contiguous env block after rotation, so its tile planes
                # are the SAME roll of the (B, H, W, C) planes — two
                # slices, no gather, exact gradients
                def mk(x):
                    x = jnp.roll(x, -off, axis=1)
                    x = x.reshape(x.shape[0], cfg.num_minibatches, b_mb)
                    return jnp.moveaxis(x, 1, 0)  # (M, T, b_mb)

                mbs = jax.tree.map(mk, slab)
                tiles_mb = jnp.roll(tiles, -off, axis=0).reshape(
                    cfg.num_minibatches, b_mb, *tiles.shape[1:]
                )
                (params, opt_state, active), losses = jax.lax.scan(
                    sgd_step, (params, opt_state, active), (mbs, tiles_mb)
                )
                return (params, opt_state, active, slab), losses[-1]

            def mk(x):
                x = jnp.roll(x, -off, axis=1)
                x = x.reshape(-1, cfg.num_minibatches, b_mb)
                return jnp.moveaxis(x, 1, 0).reshape(
                    cfg.num_minibatches, mb_size
                )

            mbs = jax.tree.map(mk, slab)
        (params, opt_state, active), losses = jax.lax.scan(
            sgd_step, (params, opt_state, active), mbs
        )
        return (params, opt_state, active, slab), losses[-1]

    def update(carry, u):
        params, opt_state, env_state, run_ret, n_eps, ret_sum = carry
        key_roll, key_perm = jax.random.split(jax.random.fold_in(base_key, u))
        env_state, traj = rollout(params, env_state, key_roll)

        _, bootstrap = _net_apply(net, params, env_state.agent_idx, tiles)
        adv, targets = gae_advantages(
            traj, jax.lax.stop_gradient(bootstrap), cfg.gamma, cfg.gae_lambda
        )
        if cfg.normalize_adv:
            mu = jnp.mean(adv)
            sd = jnp.std(adv) + 1e-8
            if axes is not None:
                mu = jax.lax.pmean(mu, axes)
                sd = jax.lax.pmean(sd, axes)  # mean-of-std approx across shards
            adv = (adv - mu) / sd

        slab = (
            traj.obs, traj.action, traj.logp, traj.value, adv, targets
        )  # (T, B) each
        keys_e = jax.random.split(key_perm, cfg.num_epochs)
        (params, opt_state, _, _), epoch_losses = jax.lax.scan(
            epoch_step,
            (params, opt_state, jnp.float32(1.0), slab),
            keys_e,
        )

        def stat_body(c, x):
            run_ret, n_eps, ret_sum = c
            r, d = x
            run_ret = run_ret + r
            n_eps = n_eps + jnp.sum(d, dtype=jnp.int32)
            ret_sum = ret_sum + jnp.sum(jnp.where(d, run_ret, 0.0))
            run_ret = jnp.where(d, 0.0, run_ret)
            return (run_ret, n_eps, ret_sum), None

        (run_ret, n_eps, ret_sum), _ = jax.lax.scan(
            stat_body, (run_ret, n_eps, ret_sum), (traj.reward, traj.done)
        )
        return (params, opt_state, env_state, run_ret, n_eps, ret_sum), epoch_losses[-1]

    return update


def _make_tx(cfg: PPOConfig):
    # One PPO update performs num_epochs*num_minibatches Adam steps; the
    # schedule is indexed by the Adam count in opt_state so it is
    # chunk-invariant (see PPOConfig.lr_schedule and models/optim.py).
    lr = make_lr(
        cfg.lr, cfg.lr_schedule,
        None if cfg.lr_decay_updates is None
        else cfg.lr_decay_updates * cfg.num_epochs * cfg.num_minibatches,
        cfg.lr_final_frac, "lr_decay_updates",
    )
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(lr)
    )


def ppo_init(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: PPOConfig = PPOConfig(),
    batch_size: int = 256,
) -> PPOTrainState:
    """Build the initial resumable train state (see PPOTrainState)."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _ppo_init_impl(level, key, cfg, batch_size, net)


@partial(jax.jit, static_argnames=("cfg", "batch_size", "net"))
def _ppo_init_impl(level, key, cfg, batch_size, net) -> PPOTrainState:
    # jitted: one dispatch instead of one per init op
    key, k_init = jax.random.split(key)
    params = _net_init(net, k_init)
    bl = pack_level(level)
    env_state = reset_bits(bl, None if bl.batched else batch_size)
    b = batch_size if not bl.batched else int(bl.code_words.shape[0])
    return PPOTrainState(
        params=params,
        opt_state=_make_tx(cfg).init(params),
        env_state=env_state,
        key=key,
        update=jnp.zeros((), jnp.int32),
        run_ret=jnp.zeros(b, jnp.float32),
        episodes=jnp.zeros((), jnp.int32),
        ret_sum=jnp.zeros((), jnp.float32),
        last_loss=jnp.zeros((), jnp.float32),
    )


def ppo_run(
    sem: Semantics,
    level: Level,
    ts: PPOTrainState,
    cfg: PPOConfig = PPOConfig(),
    num_updates: int = 500,
) -> PPOTrainState:
    """Advance training by `num_updates`. Chunk-invariant: two runs of N/2
    bit-equal one run of N (counter-based RNG; all state explicit)."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _ppo_run_impl(sem, level, ts, cfg, num_updates, net)


@partial(jax.jit, static_argnames=("cfg", "num_updates", "net"))
def _ppo_run_impl(sem, level, ts, cfg, num_updates, net) -> PPOTrainState:
    tx = _make_tx(cfg)
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


def ppo_train(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: PPOConfig = PPOConfig(),
    num_updates: int = 500,
    batch_size: int = 256,
) -> PPOResult:
    """Single-device (vmapped) PPO training run — ppo_init + ppo_run."""
    ts = ppo_init(sem, level, key, cfg, batch_size)
    ts = ppo_run(sem, level, ts, cfg, num_updates)
    return PPOResult(
        params=ts.params,
        episodes=ts.episodes,
        mean_return=ts.ret_sum / jnp.maximum(ts.episodes, 1),
        final_loss=ts.last_loss,
    )


def ppo_init_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: PPOConfig = PPOConfig(),
    batch_size: int = 256,
) -> PPOTrainState:
    """Initial FULL train state for the sharded path:
    the same PPOTrainState pytree as the single-device path, laid out over
    the mesh — params/opt_state/key/update/last_loss replicated; env_state
    and run_ret env-sharded; episodes/ret_sum as (n_dev,) device-sharded
    per-shard accumulators (summed only in ppo_result), so nothing is lost
    at the shard_map boundary and chunked resume is bit-exact."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _ppo_init_sharded_impl(mesh, level, key, cfg, batch_size, net)


@partial(jax.jit, static_argnames=("mesh", "cfg", "batch_size", "net"))
def _ppo_init_sharded_impl(
    mesh, level, key, cfg, batch_size, net
) -> PPOTrainState:
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
    return PPOTrainState(
        params=params,
        opt_state=_make_tx(cfg).init(params),
        env_state=env_state,
        key=key,
        update=jnp.zeros((), jnp.int32),
        run_ret=run_ret,
        episodes=eps,
        ret_sum=rets,
        last_loss=jnp.zeros((), jnp.float32),
    )


def ppo_run_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    ts: PPOTrainState,
    cfg: PPOConfig = PPOConfig(),
    num_updates: int = 500,
) -> PPOTrainState:
    """Advance sharded PPO by `num_updates`, carrying the FULL state
    through the shard_map boundary — Adam momenta, env batch, RNG base
    key, update counter and per-shard stats all round-trip. Chunk
    invariant: run(2N) ≡ run(N)∘checkpoint∘restore∘run(N) bit-exactly on
    a fixed mesh (tests/test_sharded_resume.py). Per-shard randomness is
    fold_in(fold_in(key, shard), global_update) — counter-based."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    return _ppo_run_sharded_impl(mesh, sem, level, ts, cfg, num_updates, net)


@partial(jax.jit, static_argnames=("mesh", "cfg", "num_updates", "net"))
def _ppo_run_sharded_impl(
    mesh, sem, level, ts, cfg, num_updates, net
) -> PPOTrainState:
    tx = _make_tx(cfg)
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


def ppo_result(ts: PPOTrainState) -> PPOResult:
    """TrainState → PPOResult; sums the (scalar or (n_dev,) per-shard)
    stats — the only place aggregation happens, never inside the state."""
    n_eps = jnp.sum(ts.episodes)
    return PPOResult(
        params=ts.params,
        episodes=n_eps,
        mean_return=jnp.sum(ts.ret_sum) / jnp.maximum(n_eps, 1),
        final_loss=ts.last_loss,
    )


def ppo_train_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: PPOConfig = PPOConfig(),
    num_updates: int = 500,
    batch_size: int = 256,
    init_params=None,
    init_opt_state=None,
) -> PPOResult:
    """Data-parallel PPO: envs sharded over the mesh, params/opt-state
    replicated, grads pmean'd per minibatch SGD step. A thin composition
    of ppo_init_sharded + ppo_run_sharded + ppo_result; use those
    directly for checkpoint/resume of long runs — the full TrainState
    (Adam momenta, env states, counters) round-trips there.

    `init_params` / `init_opt_state` warm-start training from saved
    params only (the coarse-grained multi-process restart: fresh envs,
    fresh optimizer unless init_opt_state is given —
    tests/test_distributed_multiprocess.py has both this and the
    full-state drill)."""
    net = make_network(level, int(sem.deltas.shape[0]), cfg)
    ts = _ppo_init_sharded_impl(mesh, level, key, cfg, batch_size, net)
    if init_params is not None:
        # opt_state needs no rebuild: adam/clip init is zeros_like(params)
        ts = ts.replace(params=init_params)
    if init_opt_state is not None:
        ts = ts.replace(opt_state=init_opt_state)
    ts = _ppo_run_sharded_impl(mesh, sem, level, ts, cfg, num_updates, net)
    return ppo_result(ts)
