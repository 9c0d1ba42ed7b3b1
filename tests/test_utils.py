"""Package plumbing: the struct helper, the compile-cache helper, and a
main path that imports neither flax nor orbax."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from griduniverse_tpu.utils import struct
from griduniverse_tpu.utils.compile_cache import DEFAULT_CACHE_DIR

REPO = Path(__file__).resolve().parents[1]


@struct.dataclass
class _Pair:
    x: jnp.ndarray
    y: jnp.ndarray
    width: int = dataclasses.field(default=3, metadata={"static": True})


class TestStruct:
    def test_flatten_unflatten_roundtrip(self):
        p = _Pair(jnp.arange(3), jnp.ones((2, 2)))
        leaves, treedef = jax.tree.flatten(p)
        assert len(leaves) == 2
        q = jax.tree.unflatten(treedef, leaves)
        assert isinstance(q, _Pair) and q.width == 3
        np.testing.assert_array_equal(q.x, p.x)
        np.testing.assert_array_equal(q.y, p.y)

    def test_static_field_lives_in_treedef(self):
        a, b = _Pair(jnp.zeros(1), jnp.zeros(1), 3), _Pair(jnp.zeros(1), jnp.zeros(1), 4)
        assert jax.tree.structure(a) != jax.tree.structure(b)
        assert jax.tree.leaves(a) and all(
            isinstance(leaf, jax.Array) for leaf in jax.tree.leaves(a)
        )
        # static → a jit cache key: the traced function sees a Python int
        seen = []

        @jax.jit
        def f(p):
            seen.append(type(p.width))
            return p.x * p.width

        np.testing.assert_array_equal(f(b), jnp.zeros(1))
        assert seen == [int]

    def test_replace_and_frozen(self):
        p = _Pair(jnp.zeros(2), jnp.ones(2))
        q = p.replace(y=jnp.full(2, 5.0), width=7)
        assert q.width == 7 and p.width == 3
        np.testing.assert_array_equal(q.y, [5.0, 5.0])
        with pytest.raises(Exception):
            p.width = 9

    def test_tree_map_keeps_type(self):
        p = jax.tree.map(lambda v: v + 1, _Pair(jnp.zeros(2), jnp.ones(2)))
        assert isinstance(p, _Pair)
        np.testing.assert_array_equal(p.y, [2.0, 2.0])


def _run(code: str, env_updates: dict, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_updates, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()


_CACHE_PROBE = """
    import jax
    from griduniverse_tpu.utils.compile_cache import enable_compile_cache
    print(enable_compile_cache())
    print(jax.config.jax_compilation_cache_dir)
"""


class TestCompileCache:
    def test_honours_env_var(self, tmp_path):
        want = str(tmp_path / "cc")
        assert _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": want}) == [
            want, want,
        ]

    def test_default_is_fixed_in_checkout_and_ignored(self):
        got = _run(_CACHE_PROBE, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
        assert got == [str(DEFAULT_CACHE_DIR)] * 2
        assert DEFAULT_CACHE_DIR == REPO / ".jax_cache"
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


_NO_FLAX = """
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("flax", "orbax"):
                raise ImportError(f"blocked: {name}")

    sys.meta_path.insert(0, _Block())

    import jax
    import numpy as np
    import griduniverse_tpu as gu
    from griduniverse_tpu.levels.builders import walls_and_goal_16x16
    from griduniverse_tpu.models import DQNConfig, PPOConfig, dqn_train, ppo_train

    sem, level = gu.make_semantics(), walls_and_goal_16x16()
    ppo = ppo_train(
        sem, level, jax.random.PRNGKey(0),
        PPOConfig(rollout_len=4, num_minibatches=2, hidden=(16,), embed_dim=8),
        num_updates=2, batch_size=16,
    )
    dqn = dqn_train(
        sem, level, jax.random.PRNGKey(0),
        DQNConfig(buffer_capacity=64, batch_size_train=16, learn_start=0,
                  hidden=(16,), embed_dim=8),
        num_steps=2, batch_size=16,
    )
    assert np.isfinite(float(ppo.final_loss)) and np.isfinite(float(dqn.final_loss))
    assert not [m for m in sys.modules if m.split(".")[0] in ("flax", "orbax")]
    print("ok")
"""


def test_main_path_runs_without_flax_or_orbax():
    assert _run(_NO_FLAX, {}) == ["ok"]
