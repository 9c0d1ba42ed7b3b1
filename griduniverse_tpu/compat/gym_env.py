"""Gym-style single-env class wrapper — the reference's user-facing API.

Reference (SURVEY.md §2.1 #1, §3.1): `GridUniverseEnv(gym.Env)` with
`reset() → obs`, `step(action) → (obs, reward, done, info)` (classic 4-tuple
API of its era), `render(mode)`, `look_step_ahead(state, action)`,
`is_terminal(state)`, `action_space`, `observation_space`, and constructor
kwargs `grid_shape` / `walls` / `lava` / `goal_states` / `custom_world_fp` /
`random_maze`.

This wrapper is the BASELINE config-1 compatibility path (single env on
CPU). Two interchangeable backends:

  * `backend="numpy"` (default) — steps through the pure-NumPy oracle
    (`utils.oracle.OracleGridEnv`), which is proven bit-identical to the
    JAX core by tests/test_parity.py. A single imperative Python-loop env
    is exactly the regime where an interpreter-side step wins: the jitted
    path pays a dispatch round trip PER `step()` call, while the oracle
    is plain NumPy on the host.
  * `backend="jax"` — every step calls the SAME jitted `core.step` kernel
    the 64k-env path uses, pinned to the host CPU backend. Use when the
    env state must live in the JAX world (e.g. composing with other
    device-side code); parity is inherited from the core's oracle parity
    suite either way.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np

from ..core import semantics as S
from ..core.semantics import SemanticsConfig, make_semantics
from ..core.step import reset as core_reset
from ..core.step import step as core_step
from ..core.types import Level, make_level
from ..levels.builders import build_grid
from ..levels.maze import generate_maze_numpy
from ..levels.text import load_level_file, render_text
from ..utils.oracle import OracleGridEnv
from .spaces import Discrete


def _cpu_device():
    return jax.devices("cpu")[0]


class GridUniverseEnv:
    """Drop-in replacement for the reference's `GridUniverseEnv`.

    Constructor forms (mirroring SURVEY.md §3.1):
      * `GridUniverseEnv(grid_shape=(8, 8))` — empty grid
      * `GridUniverseEnv(grid_shape, walls=[…], lava=[…], goal_states=[…])`
      * `GridUniverseEnv(custom_world_fp="level.txt")`
      * `GridUniverseEnv(random_maze=True, grid_shape=(9, 9), seed=0)`
        (grid_shape must be odd-sized for a (2n+1) maze lattice)

    `backend` — "numpy" (default; oracle-backed imperative step, the fast
    path for a Python loop) or "jax" (jitted core.step pinned to CPU).
    Both are bit-identical (tests/test_compat.py, tests/test_parity.py).
    """

    metadata = {"render_modes": ["human", "ansi", "rgb_array"]}

    def __init__(
        self,
        grid_shape: tuple[int, int] = (8, 8),
        walls: Sequence[int] | None = None,
        lava: Sequence[int] | None = None,
        goal_states: Sequence[int] | None = None,
        start_state: int = 0,
        custom_world_fp: str | None = None,
        random_maze: bool = False,
        seed: int | None = None,
        config: SemanticsConfig | None = None,
        max_steps: int | None = None,
        backend: str = "numpy",
    ):
        if backend not in ("numpy", "jax"):
            raise ValueError(f"unknown backend: {backend!r}")
        self.backend = backend
        self.config = config or SemanticsConfig()
        self._cpu = _cpu_device()
        with jax.default_device(self._cpu):
            self._sem = make_semantics(self.config)

            if custom_world_fp is not None:
                self.level: Level = load_level_file(custom_world_fp)
            elif random_maze:
                h, w = grid_shape
                if h % 2 == 0 or w % 2 == 0:
                    raise ValueError(
                        "random_maze grids must be odd-sized (2n+1 lattice); "
                        f"got {grid_shape}"
                    )
                cells = ((h - 1) // 2, (w - 1) // 2)
                rng = np.random.default_rng(seed)
                grid = generate_maze_numpy(cells, rng)
                grid[grid.shape[0] - 2, grid.shape[1] - 2] = S.GOAL
                self.level = make_level(grid, start_idx=grid.shape[1] + 1)
            else:
                grid = build_grid(
                    grid_shape, walls or (), lava or (), goal_states or ()
                )
                if grid.reshape(-1)[start_state] != S.EMPTY:
                    raise ValueError("start_state must be an empty tile")
                self.level = make_level(grid, start_idx=start_state)

            self._key = jax.random.PRNGKey(0 if seed is None else seed)
            if backend == "jax":
                self._state = core_reset(self.level, self._key)

        if backend == "jax":
            self._step_jit = jax.jit(core_step)
        self.max_steps = max_steps

        n = self.level.num_states
        self.action_space = Discrete(self.config.num_actions, seed=seed)
        self.observation_space = Discrete(n, seed=seed)

        # host copy for render; the oracle serves lookahead/is_terminal and
        # (backend="numpy") the step loop itself
        self._grid_np = np.asarray(self.level.grid)
        self._oracle = OracleGridEnv(
            self._grid_np, int(self.level.start_idx), self.config
        )

    # ------------------------------------------------------------------ API
    def reset(self) -> int:
        if self.backend == "numpy":
            return self._oracle.reset()
        with jax.default_device(self._cpu):
            self._state = core_reset(self.level, self._key)
        return int(self._state.agent_idx)

    def step(self, action) -> tuple[int, float, bool, dict]:
        if not self.action_space.contains(action):
            raise ValueError(
                f"invalid action {action!r}; expected 0..{self.action_space.n - 1}"
            )
        if self.backend == "numpy":
            obs, reward, done, info = self._oracle.step(int(action))
            t = self._oracle.t
        else:
            with jax.default_device(self._cpu):
                self._state, out = self._step_jit(
                    self._sem, self.level, self._state, np.int32(action)
                )
            obs, reward, done = int(out.obs), float(out.reward), bool(out.done)
            info = {}
            t = int(self._state.t)
        if self.max_steps is not None and t >= self.max_steps and not done:
            done, info = True, {"TimeLimit.truncated": True}
        return int(obs), float(reward), bool(done), dict(info)

    def render(self, mode: str = "human"):
        if mode == "rgb_array":
            from .rendering import rgb_render

            return rgb_render(
                self._grid_np,
                agent_idx=self.current_state,
                start_idx=int(self.level.start_idx),
            )
        if mode == "graphic":
            # Reference parity: 'graphic' opened a pyglet window with tile
            # sprites (SURVEY.md §2.1 #4). pyglet needs a display; headless
            # environments get the same pixels via mode='rgb_array' or
            # compat.rendering.episode_gif.
            try:
                import pyglet  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "render(mode='graphic') needs pyglet + a display; this "
                    "environment has neither. Use mode='rgb_array' for the "
                    "same pixels, or compat.rendering.episode_gif for an "
                    "episode animation."
                ) from e
            return self._render_pyglet()
        text = render_text(
            self._grid_np,
            agent_idx=self.current_state,
            start_idx=int(self.level.start_idx),
        )
        if mode == "ansi":
            return text
        print(text)
        return None

    def _render_pyglet(self):  # pragma: no cover - needs a display
        """Blit the rgb_array frame into a pyglet window (reference
        'graphic' mode). Only reachable when pyglet imports (see render)."""
        import pyglet

        frame = self.render(mode="rgb_array")
        h, w, _ = frame.shape
        if not hasattr(self, "_window") or self._window is None:
            self._window = pyglet.window.Window(width=w, height=h)
        img = pyglet.image.ImageData(
            w, h, "RGB", np.ascontiguousarray(frame[::-1]).tobytes()
        )
        self._window.switch_to()
        self._window.dispatch_events()
        self._window.clear()
        img.blit(0, 0)
        self._window.flip()
        return self._window

    def close(self):
        win = getattr(self, "_window", None)
        if win is not None:  # pragma: no cover - needs a display
            win.close()
            self._window = None

    def seed(self, seed: int | None = None):
        self._key = jax.random.PRNGKey(0 if seed is None else seed)
        self.action_space.seed(seed)
        return [seed]

    # -------------------------------------------------- model helpers
    def look_step_ahead(self, state: int, action: int):
        """Pure model lookahead (the reference DP helper) — host NumPy, no
        device round trip; bit-identical to utils.oracle by delegation."""
        new_idx, reward, done = self._oracle.look_step_ahead(state, action)
        return new_idx, float(reward), bool(done)

    def is_terminal(self, state: int) -> bool:
        return self._oracle.is_terminal(state)

    @property
    def num_states(self) -> int:
        return self.level.num_states

    @property
    def current_state(self) -> int:
        if self.backend == "numpy":
            return int(self._oracle.agent_idx)
        return int(self._state.agent_idx)

    @property
    def done(self) -> bool:
        if self.backend == "numpy":
            return bool(self._oracle.done)
        return bool(self._state.done)
