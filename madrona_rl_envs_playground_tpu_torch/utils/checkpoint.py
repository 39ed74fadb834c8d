"""Checkpoint save/restore and weights-only export.

Counterpart of ``madrona_rl_envs_playground_tpu/utils/checkpoint.py``.  A
checkpoint is a tree of tensors and plain containers (dicts, lists, tuples,
numbers, strings, None) written with ``torch.save`` and read back with
``weights_only=True``, so loading runs no pickled code.  Tensors are moved
to the CPU on save, as JAX's ``device_get``; the caller moves them back.

The exporters flatten a nested mapping of arrays to ``{dotted.path: array}``
with the keys of each level sorted, which is how JAX's
``tree_flatten_with_path`` walks a dict: for a policy in flax's layout
(``models/cleanrl.py`` ``flax_params``) the names are JAX's
(``params.actor.Dense_0.kernel``), so the same weights export the same file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_to_cpu(tree), path)


def load_pytree(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _flatten(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k in sorted(params):
        v = params[k]
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, name + "."))
        elif isinstance(v, torch.Tensor):
            flat[name] = v.detach().cpu().numpy()
        else:
            flat[name] = np.asarray(v)
    return flat


def export_weights_json(path: str, params: Mapping) -> None:
    """``{dotted.path: nested list}`` JSON, consumable from JS."""
    flat = {k: v.tolist() for k, v in _flatten(params).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(flat, f)


def export_weights_npz(path: str, params: Mapping) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(params))
