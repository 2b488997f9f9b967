"""Tree checkpoint and resume (torch counterpart of ``utils/checkpoint.py``).

A tree of nested dicts, tuples, lists and NamedTuples whose leaves are
tensors, NumPy arrays or Python scalars (``None`` holds no leaf) round-trips
through an atomic on-disk format, the JAX package's own:
``<path>/manifest.json`` (structure and leaf metadata) beside
``<path>/arrays.npz`` (the leaves, ``leaf_<i>``). Leaves are flattened in the
JAX package's order (dict keys sorted, sequences in order), so a checkpoint
written by either package restores in the other, and nothing is pickled.
Writes go to a temporary directory that is then ``os.replace``d, so a crash
during a save leaves the previous checkpoint whole.

Each process writes its own files: the rank is ``torch.distributed``'s
where a process group is initialised, else 0, and ranks above 0 add a
``.rank<r>`` suffix. Every leaf is saved whole: a rank of the multi-device
tier (``parallel``) holds its shard as a tensor of its own and saves it in
its own file (``per_host=True``), where the JAX package saves a sharded
array shard by shard. Such a JAX leaf restores here densely where this
rank's file covers the whole array, and raises otherwise, as a JAX restore
without the original sharding does.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree: Any) -> List[Any]:
    """The leaves in the JAX package's ``tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _flatten(child)]
    return [tree]


def _describe(tree: Any) -> str:
    """The structure, leaves written ``*``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_describe(tree[key])}" for key in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{name}={_describe(child)}" for name, child in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(child) for child in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like_leaf(arr: np.ndarray, like: Any) -> Any:
    """``arr`` as ``like``'s kind of leaf: a tensor on ``like``'s device in
    its dtype, an array in its dtype, or a Python scalar of its type."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=like.device,
                                                               dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return arr.astype(like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        restored = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: restored[key] for key in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(child, leaves) for child in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(child, leaves) for child in like)
    return next(leaves)


def save(path: str, tree: Any, *, step: Optional[int] = None, per_host: bool = True) -> str:
    """Atomically save ``tree`` to the directory ``path`` (or
    ``path/step_%08d`` with ``step``) and return that directory.
    ``per_host=False``: only rank 0 writes (a replicated tree)."""
    rank = _process_index()
    if not per_host and rank != 0:
        return path
    leaves = _flatten(tree)
    arrays = {}
    meta = []
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        meta.append({"index": i, "dtype": str(arr.dtype), "shape": list(arr.shape)})

    name = path if step is None else os.path.join(path, f"step_{step:08d}")
    final = name + (f".rank{rank}" if (per_host and rank > 0) else "")
    parent = os.path.dirname(os.path.abspath(final)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=parent)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "treedef": _describe(tree),
            "num_leaves": len(leaves),
            "leaves": meta,
            "step": step,
            "rank": rank,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def restore(path: str, like: Any, *, step: Optional[int] = None) -> Any:
    """Restore a checkpoint shaped like ``like``: each leaf comes back as
    ``like``'s leaf does (a tensor on its device and in its dtype, an array
    in its dtype, a Python scalar of its type). ``ValueError`` if the leaf
    counts differ."""
    rank = _process_index()
    name = path if step is None else os.path.join(path, f"step_{step:08d}")
    candidate = name + (f".rank{rank}" if rank > 0 else "")
    final = candidate if os.path.isdir(candidate) else name

    with open(os.path.join(final, "manifest.json")) as fh:
        manifest = json.load(fh)
    like_leaves = _flatten(like)
    if manifest["num_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, "
            f"'like' tree has {len(like_leaves)}"
        )
    with np.load(os.path.join(final, "arrays.npz")) as data:
        leaves = [_like_leaf(_assembled(i, entry, data) if entry.get("sharded")
                             else data[f"leaf_{i}"], like_leaf)
                  for i, (entry, like_leaf) in enumerate(zip(manifest["leaves"], like_leaves))]
    return _unflatten(like, iter(leaves))


def _assembled(i: int, entry: dict, data) -> np.ndarray:
    """A leaf that the JAX package saved shard by shard (``shard_keys`` such
    as ``0:4,0:8``, the global slice of each ``leaf_<i>_shard_<j>``),
    assembled densely; ``ValueError`` where this rank's file does not cover
    the whole array."""
    shape = tuple(entry["shape"])
    out = np.zeros(shape, dtype=entry["dtype"])
    covered = np.zeros(shape, dtype=bool)
    for j, key in enumerate(entry["shard_keys"]):
        slices = tuple(slice(int(a), int(b)) for a, b in (part.split(":")
                                                          for part in key.split(",")))
        out[slices] = data[f"leaf_{i}_shard_{j}"]
        covered[slices] = True
    if not covered.all():
        raise ValueError(
            f"leaf {i}: this rank's checkpoint holds only part of the sharded array; "
            "the other parts are in other ranks' files"
        )
    return out


def latest_step(path: str) -> Optional[int]:
    """Highest ``step_XXXXXXXX`` checkpoint under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for entry in os.listdir(path):
        base = entry.split(".rank")[0]
        if base.startswith("step_"):
            try:
                steps.append(int(base[len("step_"):]))
            except ValueError:
                pass
    return max(steps) if steps else None


def save_dataset_cache(path: str, **arrays: np.ndarray) -> None:
    """Save named arrays to one ``.npz``, atomically.

    [ref: GP_multi_classification.py:209-210 (np.save of X, y)]
    """
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=parent)
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_dataset_cache(path: str) -> Optional[Dict[str, np.ndarray]]:
    """The arrays of :func:`save_dataset_cache`, or None if ``path`` is
    absent. [ref: GP_multi_classification.py:215-220]"""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
