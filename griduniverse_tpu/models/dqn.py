"""DQN — off-policy value learning with an on-device replay buffer.

Third neural family next to A2C/PPO, sharing the same machinery
(bit-packed env step, one-hot-matmul Q-network). The reference has no
neural learners (SURVEY.md §2.2); this rounds out the standard
value-based/on-policy/off-policy triad for users switching from other
frameworks.

Design choices:

  * **Replay buffer lives on device** as fixed-size arrays. Writes are
    `lax.dynamic_update_slice` of each step's B contiguous transitions at
    `(t*B) % capacity` — a circular buffer with NO scatters. Sampling is
    one small uniform gather per train step (minibatch-sized, cold path;
    the matmuls dominate).
  * **Polyak (soft) target updates** every step — branchless elementwise
    lerp instead of a `lax.cond`-guarded hard copy.
  * **Double-DQN targets** by default: argmax under the online net,
    evaluated under the target net — both as one-hot matmuls, no gathers.
  * **Prioritized replay WITHOUT a sum-tree** (`prioritized=True`):
    the classic PER structure (Schaul et al. 2015) is a binary sum-tree
    with O(log n) pointer chasing and scatters. Here proportional sampling
    is Gumbel-top-k: score every slot with `α·log p + Gumbel`, take the k
    best via the exact `lax.top_k`. One O(cap) vectorized pass, no tree, no
    data-dependent control flow; samples are drawn WITHOUT replacement
    (a stratified-like variant of PER's with-replacement draw — documented
    divergence). Importance weights `(N·P(i))^-β` with β annealed to 1;
    sampled slots' priorities refreshed from |δ|, new writes enter at the
    running max priority.
  * The whole run (env stepping, buffer writes, sampling, SGD, target
    updates) is ONE jitted `lax.scan`; the sharded variant runs the same
    body under `shard_map` with envs + buffer sharded per device and
    gradients `pmean`'d per step.
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
    _net_init,
    _sharded_env_specs,
    _tiles_for,
    _tiles_from_grids,
    make_network,
)
from .networks import ActorCritic, BatchedConvActorCritic, ConvActorCritic


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 16_384
    batch_size_train: int = 256     # minibatch sampled per train step
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_anneal_steps: int = 2_000
    tau: float = 0.01               # polyak target-update rate
    # target-network update rule: "polyak" (soft lerp every step, the
    # branchless default) or "hard" (classic DQN: full copy
    # every target_update_every steps — still branchless via jnp.where)
    target_update: str = "polyak"
    target_update_every: int = 500
    double: bool = True
    learn_start: int = 64           # env-steps before training begins
    max_grad_norm: float = 10.0
    max_episode_steps: int | None = None
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
    # lr schedule — see PPOConfig.lr_schedule / models/optim.py. Unit:
    # train-loop steps (dqn_run's num_steps; one Adam step each, grads
    # masked before learn_start). Chunk-invariant via opt_state.
    lr_schedule: str = "constant"
    lr_decay_steps: int | None = None
    lr_final_frac: float = 0.0
    # prioritized replay (Gumbel-top-k proportional sampling, module docs)
    prioritized: bool = False
    per_alpha: float = 0.6          # priority exponent
    per_beta0: float = 0.4          # initial importance-sampling exponent
    per_beta_anneal_steps: int = 10_000  # β: per_beta0 → 1 over this many steps
    per_eps: float = 1e-3           # priority floor added to |δ|


class DQNResult(NamedTuple):
    params: dict
    episodes: jnp.ndarray
    mean_return: jnp.ndarray
    final_loss: jnp.ndarray


class QNetwork(ActorCritic):
    """The ActorCritic trunk reused as a Q-network: the policy head's
    logits ARE the Q-values (value head unused)."""

    def q_values(self, params, obs):
        q, _ = self.apply(params, obs)
        return q


class ConvQNetwork(ConvActorCritic):
    """ConvActorCritic as a Q-network (obs='grid'; see models.networks)."""

    def q_values(self, params, obs):
        q, _ = self.apply(params, obs)
        return q


class BatchedConvQNetwork(BatchedConvActorCritic):
    """BatchedConvActorCritic as a Q-network — grid observations over
    PER-ENV levels (tile planes enter at apply time)."""

    def q_values(self, params, obs, tiles):
        q, _ = self.apply(params, obs, tiles)
        return q


def make_q_network(level: Level, num_actions: int, cfg: DQNConfig):
    """Build the (hashable, jit-static) Q-network for `cfg.obs` — the
    value-learning twin of a2c.make_network."""
    base = make_network(level, num_actions, cfg)
    kw = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    if isinstance(base, BatchedConvActorCritic):
        return BatchedConvQNetwork(**kw)
    if isinstance(base, ConvActorCritic):
        return ConvQNetwork(**kw)
    return QNetwork(**kw)


class ReplayBuffer(NamedTuple):
    """Fixed-size circular transition store, all device arrays."""

    obs: jnp.ndarray       # (cap,) int32
    action: jnp.ndarray    # (cap,) int32
    reward: jnp.ndarray    # (cap,) float32
    next_obs: jnp.ndarray  # (cap,) int32
    done: jnp.ndarray      # (cap,) bool


def buffer_init(capacity: int) -> ReplayBuffer:
    return ReplayBuffer(
        obs=jnp.zeros(capacity, jnp.int32),
        action=jnp.zeros(capacity, jnp.int32),
        reward=jnp.zeros(capacity, jnp.float32),
        next_obs=jnp.zeros(capacity, jnp.int32),
        done=jnp.zeros(capacity, bool),
    )


def buffer_write(buf: ReplayBuffer, at: jnp.ndarray, batch: ReplayBuffer) -> ReplayBuffer:
    """Insert B contiguous transitions at offset `at` (caller guarantees
    `at + B <= capacity`; the circular invariant `capacity % B == 0` makes
    every write non-wrapping)."""
    return ReplayBuffer(
        *(
            jax.lax.dynamic_update_slice_in_dim(full, part, at, 0)
            for full, part in zip(buf, batch)
        )
    )


def buffer_sample_idx(key: jnp.ndarray, size: jnp.ndarray, n: int):
    """Slot indices for a uniform sample of `n` transitions from the first
    `size` valid rows (size may be traced). The single home of the uniform
    draw — the train body uses it directly so the slot indices stay
    available for slot→env tile-plane recovery."""
    return jax.random.randint(key, (n,), 0, jnp.maximum(size, 1))


def buffer_sample(buf: ReplayBuffer, key: jnp.ndarray, size: jnp.ndarray, n: int):
    """Uniform sample of `n` transitions from the first `size` valid rows
    (size may be traced)."""
    idx = buffer_sample_idx(key, size, n)
    return jax.tree.map(lambda x: x[idx], buf)


def per_scores(prio: jnp.ndarray, key: jnp.ndarray, size: jnp.ndarray,
               alpha: float) -> jnp.ndarray:
    """Gumbel-perturbed PER scores `α·log p + G` over the first `size`
    slots, -inf past them: `prioritized_sample` takes their top n."""
    valid = jnp.arange(prio.shape[0]) < size
    logp = alpha * jnp.log(jnp.maximum(prio, 1e-30))
    return jnp.where(
        valid, logp + jax.random.gumbel(key, prio.shape), -jnp.inf
    )


def prioritized_sample(
    prio: jnp.ndarray,
    key: jnp.ndarray,
    size: jnp.ndarray,
    n: int,
    alpha: float,
    beta: jnp.ndarray,
):
    """Proportional PER draw of `n` slots ∝ prio^α from the first `size`
    valid rows, WITHOUT a sum-tree and WITHOUT replacement.

    Gumbel-top-k: argtop_n(α·log p_i + G_i) is an exact sample of n
    distinct slots with inclusion ∝ p^α (Gumbel-max trick); the top-k is
    the exact `lax.top_k`.

    Documented divergences from the paper's sum-tree draw: sampling is
    WITHOUT replacement — extra sampling noise on an already-stochastic
    draw; and the importance weights keep the paper's with-replacement
    form (n·P(i))^-β, which under-corrects slots holding a large share of
    the priority mass (their true without-replacement inclusion saturates
    at 1). Exact top-k inclusion probabilities have no closed form; the
    β-annealed weights converge to the same 1/p correction as β→1 either
    way.

    Robustness: any selected slot with zero sampling mass — the unwritten
    (-inf score) slots top-k must return when size < n — is replaced by a
    uniform random valid slot with NEUTRAL weight 1 (the uniform-replay
    weight), never fed to the loss at weight ∞/NaN.

    Returns (idx (n,), is_weights (n,) — max-normalized (size·P(i))^-β).
    """
    cap = prio.shape[0]
    valid = jnp.arange(cap) < size
    logp = alpha * jnp.log(jnp.maximum(prio, 1e-30))
    score = per_scores(prio, key, size, alpha)
    k_eff = min(n, cap)  # top_k needs k <= cap (tiny sharded buffers)
    _, idx = jax.lax.top_k(score, k_eff)
    if k_eff < n:
        idx = jnp.concatenate([idx, jnp.zeros(n - k_eff, idx.dtype)])

    pa = jnp.where(valid, jnp.exp(logp), 0.0)
    picked = pa[idx]
    ok = picked > 0.0  # selected slot actually carries sampling mass
    # Fallback slots: a multiplicative hash of the (already random) raw
    # indices spread over the valid region — pure vector int ops, no extra
    # in-scan threefry; fallback rows are warmup rarities at neutral
    # weight, so stream quality is immaterial
    h = (idx.astype(jnp.uint32) * jnp.uint32(2654435761)) + jnp.arange(
        n, dtype=jnp.uint32
    )
    fallback = (h % jnp.maximum(size, 1).astype(jnp.uint32)).astype(idx.dtype)
    idx = jnp.where(ok, idx, fallback)

    # weight from the PRE-remap mass: fallback rows get the neutral
    # uniform-replay weight 1, no second gather needed. REAL weights are
    # max-normalized first (over real rows only), THEN fallback rows are
    # pinned to exactly 1.0 — normalizing afterwards would let a fallback
    # row become the batch maximum whenever every real weight is < 1
    # (high-priority minibatch at beta < 1), inverting "neutral" into
    # "dominant".
    p_sel = picked / jnp.maximum(jnp.sum(pa), 1e-30)
    w = (jnp.maximum(size, 1).astype(jnp.float32) * p_sel) ** (-beta)
    w_real_max = jnp.max(jnp.where(ok, w, 0.0))
    return idx, jnp.where(ok, w / jnp.maximum(w_real_max, 1e-30), 1.0)


def _keys_for_steps(base_key, t0, num_steps):
    """Counter-based per-step keys, materialized in one vectorized threefry
    sweep: element i is exactly `fold_in(base_key, t0 + i)`, so chunked
    runs stay bit-exact — but the scan streams precomputed keys instead of
    hashing serially in its critical path."""
    ts = t0 + jnp.arange(num_steps, dtype=jnp.int32)
    return jax.vmap(lambda t: jax.random.fold_in(base_key, t))(ts)


def _make_train_body(
    sem, bl, cfg: DQNConfig, net: QNetwork, tx, batch_env, axes=None,
    tiles=None,
):
    """Single train-step body, scanned over per-step keys from
    `_keys_for_steps` (counter-based → chunk-invariant resume, see
    DQNTrainState). `tiles` non-None → per-env-level conv Q-network; the
    replay buffer's circular layout makes slot→env recovery free
    (env = slot % batch_env), so each minibatch's tile planes are one
    small (n, H, W, C) row gather — a cold per-train-step op."""
    num_actions = int(sem.deltas.shape[0])
    num_states = bl.height * bl.width

    def qv(params, obs, t):
        if tiles is None:
            return net.q_values(params, obs)
        return net.q_values(params, obs, t)
    if cfg.target_update not in ("polyak", "hard"):
        raise ValueError(f"unknown target_update mode: {cfg.target_update!r}")
    cap = cfg.buffer_capacity
    if cap % batch_env:
        raise ValueError(
            f"buffer_capacity ({cap}) must be a multiple of the env batch "
            f"({batch_env}) so circular writes never wrap mid-batch"
        )

    def epsilon_at(t):
        frac = jnp.clip(t / cfg.eps_anneal_steps, 0.0, 1.0)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    def loss_fn(params, target_params, mb: ReplayBuffer, w, valid_frac,
                mb_tiles=None):
        q = qv(params, mb.obs, mb_tiles)                      # (n, A)
        p_a = jax.nn.one_hot(mb.action, num_actions, dtype=q.dtype)
        q_sa = jnp.sum(q * p_a, axis=-1)

        q_next_t = qv(target_params, mb.next_obs, mb_tiles)
        if cfg.double:
            q_next_o = qv(params, mb.next_obs, mb_tiles)
            a_star = jnp.argmax(q_next_o, axis=-1)
            p_star = jax.nn.one_hot(a_star, num_actions, dtype=q_next_t.dtype)
            v_next = jnp.sum(q_next_t * p_star, axis=-1)
        else:
            v_next = jnp.max(q_next_t, axis=-1)
        v_next = jax.lax.stop_gradient(v_next)

        target = mb.reward + cfg.gamma * jnp.where(mb.done, 0.0, v_next)
        err = q_sa - target
        # w: PER importance weights (ones when uniform); valid_frac gates
        # the warmup (loss is zeroed until learn_start)
        loss = jnp.mean(w * err**2) * valid_frac
        return loss, jax.lax.stop_gradient(jnp.abs(err))

    def body(carry, key_t):
        if cfg.prioritized:
            (params, target_params, opt_state, env_state, buf, prio, p_max,
             t, run_ret, n_eps, ret_sum) = carry
        else:
            (params, target_params, opt_state, env_state, buf, t,
             run_ret, n_eps, ret_sum) = carry

        key_eps, key_a, key_mb = jax.random.split(key_t, 3)

        # --- act: ε-greedy under the online net
        obs = env_state.agent_idx
        q = qv(params, obs, tiles)
        greedy = jnp.argmax(q, axis=-1).astype(jnp.int32)
        rand_a = jax.random.randint(key_a, obs.shape, 0, num_actions, jnp.int32)
        explore = jax.random.uniform(key_eps, obs.shape) < epsilon_at(t)
        actions = jnp.where(explore, rand_a, greedy)

        env_state, (next_obs, reward, done) = step_bits(
            sem, bl, env_state, actions, True, cfg.max_episode_steps
        )

        # --- store
        at = (t * batch_env) % cap
        buf = buffer_write(
            buf, at, ReplayBuffer(obs, actions, reward, next_obs, done)
        )
        size = jnp.minimum((t + 1) * batch_env, cap)
        if cfg.prioritized:
            # fresh transitions enter at the running max priority so each
            # is sampled at least once with high probability
            prio = jax.lax.dynamic_update_slice_in_dim(
                prio, jnp.full((batch_env,), p_max, jnp.float32), at, 0
            )

        # --- learn. Gated on BOTH learn_start and the buffer actually
        # holding a full minibatch — with learn_start < batch_size_train
        # the first train steps would otherwise sample a half-empty buffer
        # whose oversampled (PER: deterministic-fallback) rows dominate
        # the opening gradients. min() with cap keeps tiny
        # sharded buffers (cap < batch_size_train) trainable.
        ready = size >= min(cfg.batch_size_train, cap)
        valid = (
            (t >= (cfg.learn_start // batch_env)) & ready
        ).astype(jnp.float32)
        if cfg.prioritized:
            beta = cfg.per_beta0 + (1.0 - cfg.per_beta0) * jnp.clip(
                t / cfg.per_beta_anneal_steps, 0.0, 1.0
            )
            idx, w = prioritized_sample(
                prio, key_mb, size, cfg.batch_size_train, cfg.per_alpha, beta
            )
        else:
            idx = buffer_sample_idx(key_mb, size, cfg.batch_size_train)
            w = jnp.ones((cfg.batch_size_train,), jnp.float32)
        mb = jax.tree.map(lambda x: x[idx], buf)
        mb_tiles = None if tiles is None else tiles[idx % batch_env]
        (loss, abs_err), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, target_params, mb, w, valid, mb_tiles
        )
        if axes is not None:
            grads = jax.lax.pmean(grads, axes)
            loss = jax.lax.pmean(loss, axes)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if cfg.target_update == "hard":
            sync = (t + 1) % cfg.target_update_every == 0
            target_params = jax.tree.map(
                lambda tp, p: jnp.where(sync, p, tp), target_params, params
            )
        else:  # "polyak"
            target_params = jax.tree.map(
                lambda tp, p: tp + cfg.tau * (p - tp), target_params, params
            )
        if cfg.prioritized:
            # refresh sampled slots' priorities from this step's |δ| —
            # a minibatch-sized scatter (256 elems), not a tree walk
            new_p = abs_err + cfg.per_eps
            prio = prio.at[idx].set(new_p)
            p_max = jnp.maximum(p_max, jnp.max(new_p))

        # --- episode stats
        run_ret = run_ret + reward
        n_eps = n_eps + jnp.sum(done, dtype=jnp.int32)
        ret_sum = ret_sum + jnp.sum(jnp.where(done, run_ret, 0.0))
        run_ret = jnp.where(done, 0.0, run_ret)

        if cfg.prioritized:
            carry = (params, target_params, opt_state, env_state, buf, prio,
                     p_max, t + 1, run_ret, n_eps, ret_sum)
        else:
            carry = (params, target_params, opt_state, env_state, buf, t + 1,
                     run_ret, n_eps, ret_sum)
        return carry, loss

    return body


def _init_extra(cfg: DQNConfig):
    """Carry fields between the buffer and the step counter: PER state
    (priorities + running max) when enabled, nothing otherwise."""
    if cfg.prioritized:
        return (
            jnp.zeros((cfg.buffer_capacity,), jnp.float32),
            jnp.ones((), jnp.float32),
        )
    return ()


@struct.dataclass
class DQNTrainState:
    """Full resumable DQN learner state — params, target, optimizer, env
    batch, the ENTIRE replay buffer (+ PER priorities), RNG base key and
    step counter. Per-step randomness is `fold_in(key, t)`, so chunked
    runs are bit-exact resumes of unbroken ones (tests/test_checkpoint.py).
    The uniform-replay state carries a (0,)-sized `prio` so one structure
    serves both modes."""

    params: dict
    target_params: dict
    opt_state: tuple
    env_state: object
    buf: ReplayBuffer
    prio: jnp.ndarray       # (cap,) f32 PER priorities; (0,) when uniform
    p_max: jnp.ndarray      # () f32 running max priority
    key: jnp.ndarray        # base PRNG key (never consumed, only folded)
    t: jnp.ndarray          # () int32 global step counter
    run_ret: jnp.ndarray    # (B,) running per-env episode returns
    episodes: jnp.ndarray   # () int32
    ret_sum: jnp.ndarray    # () float32
    last_loss: jnp.ndarray  # () float32


def _dqn_tx(cfg: DQNConfig):
    # DQN applies Adam once per train-loop step — the same unit as
    # dqn_run(num_steps); masked-to-zero grads before learn_start still
    # advance the count (branchless) — hence the field name
    # lr_decay_steps; indexed by the Adam count in opt_state
    # (chunk-invariant, see models/optim.py).
    lr = make_lr(cfg.lr, cfg.lr_schedule, cfg.lr_decay_steps,
                 cfg.lr_final_frac, "lr_decay_steps")
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(lr)
    )


def dqn_init(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: DQNConfig = DQNConfig(),
    batch_size: int = 64,
) -> DQNTrainState:
    """Build the initial resumable train state (see DQNTrainState)."""
    net = make_q_network(level, int(sem.deltas.shape[0]), cfg)
    return _dqn_init_impl(level, key, cfg, batch_size, net)


@partial(jax.jit, static_argnames=("cfg", "batch_size", "net"))
def _dqn_init_impl(level, key, cfg, batch_size, net) -> DQNTrainState:
    # jitted: one dispatch instead of one per init op
    key, k_init = jax.random.split(key)
    params = _net_init(net, k_init)
    bl = pack_level(level)
    env_state = reset_bits(bl, None if bl.batched else batch_size)
    b = batch_size if not bl.batched else int(bl.code_words.shape[0])
    extra = _init_extra(cfg)
    return DQNTrainState(
        params=params,
        target_params=jax.tree.map(jnp.copy, params),
        opt_state=_dqn_tx(cfg).init(params),
        env_state=env_state,
        buf=buffer_init(cfg.buffer_capacity),
        prio=extra[0] if extra else jnp.zeros((0,), jnp.float32),
        p_max=extra[1] if extra else jnp.ones((), jnp.float32),
        key=key,
        t=jnp.zeros((), jnp.int32),
        run_ret=jnp.zeros(b, jnp.float32),
        episodes=jnp.zeros((), jnp.int32),
        ret_sum=jnp.zeros((), jnp.float32),
        last_loss=jnp.zeros((), jnp.float32),
    )


def dqn_run(
    sem: Semantics,
    level: Level,
    ts: DQNTrainState,
    cfg: DQNConfig = DQNConfig(),
    num_steps: int = 2_000,
) -> DQNTrainState:
    """Advance training by `num_steps`. Chunk-invariant: two runs of N/2
    bit-equal one run of N (counter-based RNG; all state explicit)."""
    net = make_q_network(level, int(sem.deltas.shape[0]), cfg)
    return _dqn_run_impl(sem, level, ts, cfg, num_steps, net)


@partial(jax.jit, static_argnames=("cfg", "num_steps", "net"))
def _dqn_run_impl(sem, level, ts, cfg, num_steps, net) -> DQNTrainState:
    tx = _dqn_tx(cfg)
    bl = pack_level(level)
    batch_size = ts.run_ret.shape[0]
    body = _make_train_body(
        sem, bl, cfg, net, tx, batch_size, tiles=_tiles_for(net, level)
    )
    per = (ts.prio, ts.p_max) if cfg.prioritized else ()
    init = (
        ts.params, ts.target_params, ts.opt_state, ts.env_state, ts.buf,
        *per, ts.t, ts.run_ret, ts.episodes, ts.ret_sum,
    )
    keys = _keys_for_steps(ts.key, ts.t, num_steps)
    carry, losses = jax.lax.scan(body, init, keys)
    if cfg.prioritized:
        (params, target_params, opt_state, env_state, buf, prio, p_max,
         t, run_ret, n_eps, ret_sum) = carry
    else:
        (params, target_params, opt_state, env_state, buf, t,
         run_ret, n_eps, ret_sum) = carry
        prio, p_max = ts.prio, ts.p_max
    return ts.replace(
        params=params,
        target_params=target_params,
        opt_state=opt_state,
        env_state=env_state,
        buf=buf,
        prio=prio,
        p_max=p_max,
        t=t,
        run_ret=run_ret,
        episodes=n_eps,
        ret_sum=ret_sum,
        last_loss=losses[-1],
    )


def dqn_train(
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: DQNConfig = DQNConfig(),
    num_steps: int = 2_000,
    batch_size: int = 64,
) -> DQNResult:
    """Single-device DQN: `num_steps` scan iterations, each stepping
    `batch_size` envs once and doing one minibatch SGD step — dqn_init +
    dqn_run."""
    ts = dqn_init(sem, level, key, cfg, batch_size)
    ts = dqn_run(sem, level, ts, cfg, num_steps)
    return DQNResult(
        params=ts.params,
        episodes=ts.episodes,
        mean_return=ts.ret_sum / jnp.maximum(ts.episodes, 1),
        final_loss=ts.last_loss,
    )


def _dqn_sharded_layout(mesh, cfg, bl, batch_size):
    """(axes, local_b, local_cfg, spec, bl_specs, es_spec, prio_spec) for
    the env-sharded DQN layout. buffer_capacity is GLOBAL: the state's
    (cap,) buffer/priority arrays shard over the mesh, each worker owning
    cap/n_dev slots of its own experience."""
    axes, local_b, spec, bl_specs, es_spec = _sharded_env_specs(
        mesh, bl, batch_size
    )
    n_dev = mesh.size
    if cfg.buffer_capacity % n_dev:
        raise ValueError(
            f"buffer_capacity {cfg.buffer_capacity} not divisible by mesh "
            f"size {n_dev}"
        )
    local_cfg = dataclasses.replace(
        cfg, buffer_capacity=cfg.buffer_capacity // n_dev
    )
    prio_spec = spec if cfg.prioritized else P()
    return axes, local_b, local_cfg, spec, bl_specs, es_spec, prio_spec


def dqn_init_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: DQNConfig = DQNConfig(),
    batch_size: int = 64,
) -> DQNTrainState:
    """Initial FULL train state for the sharded path:
    the same DQNTrainState pytree as the single-device path, laid out
    over the mesh — params/target_params/opt_state/key/t/last_loss
    replicated; env_state, run_ret and the ENTIRE replay buffer (+ PER
    priorities) sharded; p_max/episodes/ret_sum as (n_dev,)
    device-sharded per-shard values. Nothing is discarded at the
    shard_map boundary, so crash recovery preserves Adam momenta, replay
    contents and the env distribution (dqn_run_sharded)."""
    net = make_q_network(level, int(sem.deltas.shape[0]), cfg)
    return _dqn_init_sharded_impl(mesh, level, key, cfg, batch_size, net)


@partial(jax.jit, static_argnames=("mesh", "cfg", "batch_size", "net"))
def _dqn_init_sharded_impl(
    mesh, level, key, cfg, batch_size, net
) -> DQNTrainState:
    bl = pack_level(level)
    _, local_b, local_cfg, spec, bl_specs, es_spec, prio_spec = (
        _dqn_sharded_layout(mesh, cfg, bl, batch_size)
    )
    key, k_init = jax.random.split(key)
    params = _net_init(net, k_init)
    buf_spec = jax.tree.map(lambda _: spec, buffer_init(0))

    def shard_init(bl):
        extra = _init_extra(local_cfg)
        return (
            reset_bits(bl, local_b),
            buffer_init(local_cfg.buffer_capacity),
            extra[0] if extra else jnp.zeros((0,), jnp.float32),
            (extra[1] if extra else jnp.ones((), jnp.float32))[None],
            jnp.zeros(local_b, jnp.float32),
            jnp.zeros((1,), jnp.int32),
            jnp.zeros((1,), jnp.float32),
        )

    env_state, buf, prio, p_max, run_ret, eps, rets = jax.shard_map(
        shard_init,
        mesh=mesh,
        in_specs=(bl_specs,),
        out_specs=(es_spec, buf_spec, prio_spec, spec, spec, spec, spec),
        check_vma=False,
    )(bl)
    return DQNTrainState(
        params=params,
        target_params=jax.tree.map(jnp.copy, params),
        opt_state=_dqn_tx(cfg).init(params),
        env_state=env_state,
        buf=buf,
        prio=prio,
        p_max=p_max,
        key=key,
        t=jnp.zeros((), jnp.int32),
        run_ret=run_ret,
        episodes=eps,
        ret_sum=rets,
        last_loss=jnp.zeros((), jnp.float32),
    )


def dqn_run_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    ts: DQNTrainState,
    cfg: DQNConfig = DQNConfig(),
    num_steps: int = 2_000,
) -> DQNTrainState:
    """Advance sharded DQN by `num_steps`, carrying the FULL state through
    the shard_map boundary — Adam momenta, target net, replay contents,
    PER priorities, env batch, RNG key and step counter all round-trip.
    Chunk invariant: run(2N) ≡ run(N)∘checkpoint∘restore∘run(N)
    bit-exactly on a fixed mesh (tests/test_sharded_resume.py)."""
    net = make_q_network(level, int(sem.deltas.shape[0]), cfg)
    return _dqn_run_sharded_impl(mesh, sem, level, ts, cfg, num_steps, net)


@partial(jax.jit, static_argnames=("mesh", "cfg", "num_steps", "net"))
def _dqn_run_sharded_impl(
    mesh, sem, level, ts, cfg, num_steps, net
) -> DQNTrainState:
    tx = _dqn_tx(cfg)
    bl = pack_level(level)
    batch_size = ts.run_ret.shape[0]
    axes, local_b, local_cfg, spec, bl_specs, es_spec, prio_spec = (
        _dqn_sharded_layout(mesh, cfg, bl, batch_size)
    )
    grids = level.grid if getattr(net, "needs_tiles", False) else None
    buf_spec = jax.tree.map(lambda _: spec, buffer_init(0))

    def shard_fn(params, target_params, opt_state, env_state, buf, prio,
                 p_max, t0, run_ret, eps, rets, sem, bl, grids, key):
        idx = jax.lax.axis_index(axes[0])
        for ax in axes[1:]:
            idx = idx * jax.lax.axis_size(ax) + jax.lax.axis_index(ax)
        base_key = jax.random.fold_in(key, idx)
        tiles = None if grids is None else _tiles_from_grids(net, grids)

        body = _make_train_body(
            sem, bl, local_cfg, net, tx, local_b, axes=axes, tiles=tiles
        )
        per = (prio, p_max[0]) if cfg.prioritized else ()
        init = (
            params, target_params, opt_state, env_state, buf, *per,
            t0, run_ret, eps[0], rets[0],
        )
        keys = _keys_for_steps(base_key, t0, num_steps)
        carry, losses = jax.lax.scan(body, init, keys)
        if cfg.prioritized:
            (params, target_params, opt_state, env_state, buf, prio, p_max_s,
             t, run_ret, n_eps, ret_sum) = carry
        else:
            (params, target_params, opt_state, env_state, buf, t,
             run_ret, n_eps, ret_sum) = carry
            p_max_s = p_max[0]
        return (
            params, target_params, opt_state, env_state, buf, prio,
            p_max_s[None], t, run_ret, n_eps[None], ret_sum[None],
            losses[-1],
        )

    (params, target_params, opt_state, env_state, buf, prio, p_max, t,
     run_ret, eps, rets, last_loss) = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), es_spec, buf_spec, prio_spec, spec, P(), spec,
            spec, spec, P(), bl_specs, None if grids is None else spec, P(),
        ),
        out_specs=(
            P(), P(), P(), es_spec, buf_spec, prio_spec, spec, P(), spec,
            spec, spec, P(),
        ),
        check_vma=False,
    )(
        ts.params, ts.target_params, ts.opt_state, ts.env_state, ts.buf,
        ts.prio, ts.p_max, ts.t, ts.run_ret, ts.episodes, ts.ret_sum,
        sem, bl, grids, ts.key,
    )
    return ts.replace(
        params=params,
        target_params=target_params,
        opt_state=opt_state,
        env_state=env_state,
        buf=buf,
        prio=prio,
        p_max=p_max,
        t=t,
        run_ret=run_ret,
        episodes=eps,
        ret_sum=rets,
        last_loss=last_loss,
    )


def dqn_result(ts: DQNTrainState) -> DQNResult:
    """TrainState → DQNResult; sums the (scalar or (n_dev,) per-shard)
    stats — aggregation happens only here, never inside the state."""
    n_eps = jnp.sum(ts.episodes)
    return DQNResult(
        params=ts.params,
        episodes=n_eps,
        mean_return=jnp.sum(ts.ret_sum) / jnp.maximum(n_eps, 1),
        final_loss=ts.last_loss,
    )


def dqn_train_sharded(
    mesh: Mesh,
    sem: Semantics,
    level: Level,
    key: jnp.ndarray,
    cfg: DQNConfig = DQNConfig(),
    num_steps: int = 2_000,
    batch_size: int = 64,
    init_params=None,
    init_opt_state=None,
) -> DQNResult:
    """Data-parallel DQN: envs AND replay buffer sharded per device (each
    worker learns from its own shard's experience), params/targets
    replicated, grads pmean'd per step. A thin composition of
    dqn_init_sharded + dqn_run_sharded + dqn_result; use those directly
    for checkpoint/resume of long runs — the full TrainState (Adam
    momenta, replay contents, targets) round-trips there.

    `init_params` / `init_opt_state` warm-start from saved params only
    (target net restarts as a copy of init_params; replay refills fresh —
    the coarse-grained multi-process restart at a step boundary)."""
    net = make_q_network(level, int(sem.deltas.shape[0]), cfg)
    ts = _dqn_init_sharded_impl(mesh, level, key, cfg, batch_size, net)
    if init_params is not None:
        # opt_state needs no rebuild: adam/clip init is zeros_like(params)
        ts = ts.replace(
            params=init_params,
            target_params=jax.tree.map(jnp.copy, init_params),
        )
    if init_opt_state is not None:
        ts = ts.replace(opt_state=init_opt_state)
    ts = _dqn_run_sharded_impl(mesh, sem, level, ts, cfg, num_steps, net)
    return dqn_result(ts)


def greedy_q_actions(
    net: QNetwork, params, obs: jnp.ndarray, tiles: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Greedy action(s) under the Q-network. `tiles` — per-env tile planes,
    required iff `net` is a BatchedConvQNetwork (per-env levels)."""
    q = net.q_values(params, obs) if tiles is None else net.q_values(
        params, obs, tiles
    )
    return jnp.argmax(q, axis=-1).astype(jnp.int32)
