"""Pytree ⇄ bytes for the multi-process tests' hand-offs between
processes: the leaves in `np.savez` form, restored into a template's
structure."""

import io

import jax
import numpy as np


def tree_to_bytes(tree) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, *[np.asarray(leaf) for leaf in jax.tree.leaves(tree)])
    return buf.getvalue()


def tree_from_bytes(template, data: bytes):
    with np.load(io.BytesIO(data)) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return jax.tree.unflatten(jax.tree.structure(template), leaves)
