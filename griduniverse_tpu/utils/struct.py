"""Frozen dataclass pytrees — the one helper every state type is built on.

    @struct.dataclass
    class BitLevel:
        words: jnp.ndarray                                   # pytree leaf
        height: int = dataclasses.field(metadata={"static": True})  # treedef

A class decorated with `dataclass` is a frozen `dataclasses.dataclass`
registered through `jax.tree_util.register_dataclass`, so it vmaps,
shards, scans and checkpoints as a pytree. Fields marked static
(`metadata={"static": True}`) live in the treedef and key `jit`'s cache;
every other field is a leaf. `.replace(**changes)` returns a copy.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Make `cls` a frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
