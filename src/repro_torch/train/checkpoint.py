"""Atomic checkpoints in the JAX package's layout.

One directory per step (``repro/train/checkpoint.py``)::

    <root>/step_00000420.tmp/      # written first
        manifest.json              # treedef, paths, shapes, dtypes, step, meta
        leaf_00000.npy ...         # one file per leaf
    <root>/step_00000420/          # atomic rename == commit

Leaves go in the JAX package's flatten order (dict keys sorted, tuples and
named tuples in field order: ``(params, OptState(step, m, v))``), so a
directory written by either package restores in the other, leaf for leaf.
A crash mid-save never corrupts the latest checkpoint: restore only sees
committed directories.  Leaves are stored as global arrays, so a restore
may lay them out on another mesh than the saving job's (the elastic path:
``shardings=``, each leaf a ``DTensor`` holding its local shard);
``device=`` places unsharded leaves.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def _flatten(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree.flatten`` order; a path holds
    ``("dict", key)``, ``("seq", index)`` or ``("attr", field)`` entries."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (("dict", k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, x in zip(tree._fields, tree):
            yield from _flatten(x, path + (("attr", name),))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _flatten(x, path + (("seq", i),))
    elif tree is not None:
        yield path, tree


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if like is None:
        return None
    return next(leaves)


_KEY = {"dict": lambda k: f"DictKey(key={k!r})",
        "seq": lambda i: f"SequenceKey(idx={i})",
        "attr": lambda n: f"GetAttrKey(name={n!r})"}


def _path_str(path) -> str:
    """A path as ``str`` of the JAX package's key path prints it."""
    keys = [_KEY[kind](k) for kind, k in path]
    return "(" + ", ".join(keys) + ("," if len(keys) == 1 else "") + ")"


def _treedef_str(tree) -> str:
    """The tree's structure as ``str`` of the JAX package's treedef prints
    it inside ``PyTreeDef(...)`` (leaves ``*``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_treedef_str(x) for x in tree) + "])")
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef_str(x) for x in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef_str(x) for x in tree) + "]"
    return "None" if tree is None else "*"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bfloat16 leaves have no numpy "
                            "dtype here; keep parameters in float32")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(root: str, step: int, tree, *, meta: dict | None = None,
         keep: int = 3) -> str:
    """Atomically persist a tree.  Returns the committed directory."""
    os.makedirs(root, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(root, name + ".tmp")
    final = os.path.join(root, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    items = list(_flatten(tree))
    arrays = [_to_numpy(x) for _, x in items]
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({_treedef_str(tree)})",
        "paths": [_path_str(p) for p, _ in items],
        "leaves": [{"file": f"leaf_{i:05d}.npy",
                    "shape": list(a.shape),
                    "dtype": str(a.dtype)}
                   for i, a in enumerate(arrays)],
        "meta": meta or {},
    }
    for i, a in enumerate(arrays):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # commit
    _retain(root, keep)
    return final


def _retain(root: str, keep: int):
    steps = sorted(all_steps(root))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


def all_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(root, d, "manifest.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = all_steps(root)
    return steps[-1] if steps else None


def restore(root: str, like, *, step: int | None = None, device="cuda",
            shardings=None) -> tuple[int, object, dict]:
    """Restore into the structure of ``like`` (values ignored), each leaf
    a tensor on ``device`` in its saved dtype.  Returns ``(step, tree,
    meta)``.

    ``shardings``: optional tree matching ``like`` with a ``(mesh,
    placements)`` pair per leaf — the *elastic* path: each saved global
    array becomes a ``DTensor`` on that mesh (its device type; any mesh,
    not only the saving job's) holding this rank's shard, cut locally from
    the array every rank reads (no collective)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n_like = sum(1 for _ in _flatten(like))
    if len(manifest["leaves"]) != n_like:
        raise ValueError(f"checkpoint {d} holds {len(manifest['leaves'])} "
                         f"leaves, the tree to restore {n_like}")
    arrays = (torch.from_numpy(np.load(os.path.join(d, rec["file"])))
              for rec in manifest["leaves"])
    if shardings is None:
        leaves = (a.to(device) for a in arrays)
    else:
        from torch.distributed.tensor import distribute_tensor
        leaves = (distribute_tensor(a.to(mesh.device_type), mesh, pl,
                                    src_data_rank=None)
                  for a, (mesh, pl) in zip(arrays,
                                           _leaves_like(like, shardings)))
    return step, _unflatten(like, leaves), manifest.get("meta", {})


def _leaves_like(like, tree):
    """The nodes of ``tree`` at the places of ``like``'s leaves, in
    :func:`_flatten` order."""
    if isinstance(like, dict):
        for k in sorted(like):
            yield from _leaves_like(like[k], tree[k])
    elif isinstance(like, (tuple, list)):
        for x, t in zip(like, tree):
            yield from _leaves_like(x, t)
    elif like is not None:
        yield tree
