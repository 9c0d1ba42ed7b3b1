"""Vectorized NumPy-facing env — batch stepping without writing any JAX.

For users of the reference who want the batched engine behind a familiar
imperative API (gymnasium-VectorEnv-flavored): actions in as a NumPy array,
observations/rewards/flags out as NumPy arrays, auto-reset handled
internally. Every step runs the SAME bit-packed kernel as the 64k-env
throughput path (ops/bitplane.py), jitted once with the level tables
closed over as compile-time constants.

Conventions (identical to the functional engine, which is oracle-parity
tested):
  * auto-reset is NEXT-step style: when an env terminates/truncates, the
    returned observation is the FINAL state of the finished episode and the
    env is already sitting at the start state for the next `step` call;
  * `terminated` (goal/lava) and `truncated` (time limit) are reported
    separately; both imply the auto-reset above.

Pinned to the host CPU backend: an imperative per-step API pays a
host↔device round trip per call, which would dominate on an accelerator. For
real throughput use the functional rollouts (`ops.bitplane`,
`parallel.bitplane`) — this wrapper is the migration on-ramp, not the
fast path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.semantics import SemanticsConfig, make_semantics
from ..core.types import Level
from ..ops.bitplane import move_bits, pack_level, reset_bits
from .spaces import Discrete


class VectorGridEnv:
    """B envs stepped in lockstep — B copies of one shared level, or one
    env per level of a BATCHED (N, H, W) level (e.g. N distinct
    device-generated mazes; `num_envs` then defaults to N).

    >>> venv = VectorGridEnv(level, num_envs=1024, max_episode_steps=200)
    >>> obs = venv.reset()
    >>> obs, reward, terminated, truncated = venv.step(actions)  # all (B,)
    """

    def __init__(
        self,
        level: Level,
        num_envs: int | None = None,
        max_episode_steps: int | None = None,
        config: SemanticsConfig | None = None,
    ):
        self.config = config or SemanticsConfig()
        if level.grid.ndim == 3:
            n_levels = int(level.grid.shape[0])
            if num_envs is None:
                num_envs = n_levels
            elif int(num_envs) != n_levels:
                raise ValueError(
                    f"batched level has {n_levels} levels; num_envs must "
                    f"match (got {num_envs}) — one env per level"
                )
        elif num_envs is None:
            raise ValueError("num_envs is required for a shared level")
        self.num_envs = int(num_envs)
        self.max_episode_steps = max_episode_steps
        self._cpu = jax.devices("cpu")[0]
        with jax.default_device(self._cpu):
            sem = make_semantics(self.config)
            bl = jax.tree.map(np.asarray, pack_level(level))
            self._bl = bl
            mes = max_episode_steps

            @jax.jit
            def _step(state, actions):
                new_idx, new_code, reward, term = move_bits(
                    sem, bl, state.agent_idx, state.agent_code, actions
                )
                t1 = state.t + 1
                trunc = (
                    (t1 >= mes) & ~term
                    if mes is not None
                    else jnp.zeros_like(term)
                )
                done = term | trunc
                start_idx = jnp.broadcast_to(bl.start_idx, new_idx.shape)
                start_code = jnp.broadcast_to(bl.start_code, new_code.shape)
                next_state = state._replace(
                    agent_idx=jnp.where(done, start_idx, new_idx),
                    agent_code=jnp.where(done, start_code, new_code),
                    t=jnp.where(done, 0, t1),
                    done=jnp.zeros_like(done),
                )
                return next_state, (new_idx, reward, term, trunc)

            self._step_jit = _step
            self._state = reset_bits(bl, self.num_envs)

        n = bl.height * bl.width
        self.single_action_space = Discrete(self.config.num_actions)
        self.single_observation_space = Discrete(n)

    def reset(self) -> np.ndarray:
        with jax.default_device(self._cpu):
            self._state = reset_bits(self._bl, self.num_envs)
        return np.asarray(self._state.agent_idx)

    def step(self, actions) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        actions = np.asarray(actions, np.int32)
        if actions.shape != (self.num_envs,):
            raise ValueError(
                f"actions must have shape ({self.num_envs},); got {actions.shape}"
            )
        if actions.min() < 0 or actions.max() >= self.config.num_actions:
            raise ValueError("action out of range")
        with jax.default_device(self._cpu):
            self._state, (obs, reward, term, trunc) = self._step_jit(
                self._state, jnp.asarray(actions)
            )
        return (
            np.asarray(obs),
            np.asarray(reward),
            np.asarray(term),
            np.asarray(trunc),
        )
