"""Checkpoints in the reference's format (the port of
``repro.training.checkpoint``): a flat ``.npz`` keyed by '/'-joined tree
paths. ``bridge.numpy_from_params`` turns a port module into the
reference's tree (layers stacked on a leading axis) and
``bridge.params_from_numpy`` back, so weights trained in the port load
into the JAX package, and the reverse."""
from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_checkpoint(path: str, tree) -> None:
    """Write a nested dict (or list) of tensors or arrays to ``path``."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_checkpoint(path: str) -> dict:
    """Returns a nested dict of numpy arrays (list/tuple nodes become dicts
    with integer-string keys, as in the reference's loader)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.array(data[key])
    return root

