"""Checkpoint / resume for chain states, generator states and statistics
(PyTorch port of ``mlmcpathintegral_tpu/utils/checkpoint.py``).

The reference has no resumption capability — ``SampleState::save_to_disk``
(samplestate.hh:45) dumps states for inspection only.  Here any nesting of
tensors (sampler states, two-level carries, ``StatsState`` accumulators,
``torch.Generator`` states) round-trips through one ``.npz`` file: the
leaves are stored as ``leaf_i`` numpy arrays in the JAX package's leaf
order (dict values by sorted key, tuple and NamedTuple fields in order),
beside a ``__meta__`` JSON record with the leaf count, the structure and
the caller's metadata.  The structure is rebuilt against a template of
the same structure (``like=``), and each restored leaf takes its
template's dtype and device, so a state saved on the card restores on the
CPU and back.  The format is the JAX package's, so a file that package
wrote of a state with the same fields (a ``StatsState``, a sampler state)
loads here.

A ``torch.Generator`` leaf is stored as its ``get_state()`` bytes; a
generator in the template is restored in place with ``set_state``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.utils.tree import (
    tree_flatten, tree_unflatten, treedef_str,
)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path, tree, metadata: dict | None = None) -> None:
    """Write every leaf of ``tree`` (+ optional JSON metadata)."""
    leaves, treedef = tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"n_leaves": len(leaves),
                    "treedef": treedef_str(treedef),
                    "metadata": metadata or {}}).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def _place(tmpl, arr: np.ndarray):
    """A saved array as the template leaf's kind, dtype and device."""
    # a copy keeps a 0-dim array 0-dim (np.ascontiguousarray would not)
    if isinstance(tmpl, torch.Generator):
        tmpl.set_state(torch.from_numpy(np.array(arr)))
        return tmpl
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(dtype=tmpl.dtype,
                                                  device=tmpl.device)
    return type(tmpl)(arr.item()) if isinstance(tmpl, (int, float, bool)) \
        else np.asarray(arr, dtype=np.asarray(tmpl).dtype)


def _shape(leaf) -> tuple:
    if isinstance(leaf, torch.Generator):
        return tuple(leaf.get_state().shape)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def load_checkpoint(path, like):
    """Restore a tree with the structure, dtypes and devices of ``like``;
    raises if the leaf count or shapes mismatch."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    like_leaves, treedef = tree_flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(like_leaves)} (saved structure: {meta['treedef']})")
    for tmpl, arr in zip(like_leaves, leaves):
        if _shape(tmpl) != tuple(arr.shape):
            raise ValueError(
                f"leaf shape mismatch: checkpoint {arr.shape} vs template "
                f"{_shape(tmpl)}")
    return tree_unflatten(treedef, [_place(t, a)
                                    for t, a in zip(like_leaves, leaves)])


def checkpoint_metadata(path) -> dict:
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    return meta.get("metadata", {})
