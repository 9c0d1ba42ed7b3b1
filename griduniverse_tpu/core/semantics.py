"""Environment semantics table — the single source of truth for parity.

The reference (TheMTank/GridUniverse, reconstructed behavior — see SURVEY.md §0:
the reference mount was empty, so exact constants are unverified) defines a
discrete H×W gridworld: 4 actions (up/right/down/left), walls block movement,
lava/pit tiles are terminal with negative reward, goal tiles terminal with
positive reward, and a per-step cost otherwise. Reference behavior recon:
SURVEY.md §2.1 (component #1), §3.2.

Everything that could differ from the real reference (reward constants, tile
character alphabet, action ordering) lives HERE, in one config object, so that
parity constants can be snapped to the real reference later without touching
any kernel or algorithm code (SURVEY.md §0 "Action for the future session").

Design notes:
  * `Semantics` is a pytree of tiny device arrays. The per-tile-code tables
    (`passable`, `terminal`, `reward`) turn the reference's Python `if` chains
    into single gathers, which XLA fuses into the step kernel.
  * The reward table already folds the per-step cost into the non-terminal
    entries, so a step's reward is exactly ONE gather — no arithmetic, which
    also makes float bit-exactness with the NumPy oracle trivial.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils import struct

# ---------------------------------------------------------------------------
# Tile codes (int32 on device). START is a parser-level marker only: the
# parser records the start position and stores EMPTY in the grid.
# ---------------------------------------------------------------------------
EMPTY: int = 0
WALL: int = 1
LAVA: int = 2
GOAL: int = 3
NUM_TILE_TYPES: int = 4

# Action indices. Reference order unverified [R]; configurable via
# SemanticsConfig.action_deltas. Default: 0=UP 1=RIGHT 2=DOWN 3=LEFT.
UP: int = 0
RIGHT: int = 1
DOWN: int = 2
LEFT: int = 3
NUM_ACTIONS: int = 4

# Default text-level alphabet (reconstructed [R]; SURVEY.md §2.1 #2):
# wall '#', empty 'o' (alias '.'), lava 'l', goal 'g', start 's'/'x'.
DEFAULT_CHAR_TO_TILE: Mapping[str, int] = {
    "o": EMPTY,
    ".": EMPTY,
    " ": EMPTY,
    "#": WALL,
    "l": LAVA,
    "g": GOAL,
}
DEFAULT_START_CHARS: Tuple[str, ...] = ("s", "x")
DEFAULT_TILE_TO_CHAR: Mapping[int, str] = {
    EMPTY: "o",
    WALL: "#",
    LAVA: "l",
    GOAL: "g",
}


@dataclasses.dataclass(frozen=True)
class SemanticsConfig:
    """Host-side, hashable description of the environment semantics.

    All values are RECONSTRUCTED defaults [R] — see SURVEY.md §0. If the real
    reference becomes available, update these defaults (and only these) to
    snap the whole framework to exact parity.
    """

    step_reward: float = -1.0
    goal_reward: float = 10.0
    lava_reward: float = -10.0
    # (drow, dcol) per action, in action-index order.
    action_deltas: Tuple[Tuple[int, int], ...] = (
        (-1, 0),  # UP
        (0, 1),   # RIGHT
        (1, 0),   # DOWN
        (0, -1),  # LEFT
    )

    @property
    def num_actions(self) -> int:
        return len(self.action_deltas)

    def numpy_tables(self):
        """Build the per-tile-code tables as NumPy arrays (shared by the
        device `Semantics` and the NumPy oracle so both read identical bits).
        """
        passable = np.array([True, False, True, True], dtype=bool)
        terminal = np.array([False, False, True, True], dtype=bool)
        reward = np.array(
            [self.step_reward, 0.0, self.lava_reward, self.goal_reward],
            dtype=np.float32,
        )
        deltas = np.array(self.action_deltas, dtype=np.int32)
        return passable, terminal, reward, deltas


@struct.dataclass
class Semantics:
    """Device-resident semantics tables (a pytree of tiny arrays).

    passable[t] — can the agent enter a tile with code t?
    terminal[t] — does entering code t end the episode?
    reward[t]   — reward received on a step that ENDS on code t
                  (per-step cost folded into non-terminal entries).
    deltas[a]   — (drow, dcol) for action a.
    """

    passable: jnp.ndarray  # (T,) bool
    terminal: jnp.ndarray  # (T,) bool
    reward: jnp.ndarray    # (T,) float32
    deltas: jnp.ndarray    # (A, 2) int32

    @property
    def num_actions(self) -> int:
        return int(self.deltas.shape[0])


def make_semantics(config: SemanticsConfig | None = None) -> "Semantics":
    """Build the device semantics tables from a host config."""
    config = config or SemanticsConfig()
    passable, terminal, reward, deltas = config.numpy_tables()
    return Semantics(
        passable=jnp.asarray(passable),
        terminal=jnp.asarray(terminal),
        reward=jnp.asarray(reward),
        deltas=jnp.asarray(deltas),
    )


DEFAULT_CONFIG = SemanticsConfig()
