"""Weight bridge from the JAX reference: its checkpoints and param trees
into the port's modules.

The reference writes params with ``training/checkpoint.py::save_checkpoint``
as a flat ``.npz`` keyed by '/'-joined tree paths, and stacks each layer's
weights on a leading layer axis. The port keeps every tensor's layout, so
loading is a copy: a path ``layers/attn/wq`` of shape (L, D, H, Dh) becomes
the parameters ``layers.<i>.attn.wq`` of shape (D, H, Dh).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.decoder import Decoder
from repro_torch.models.encoder import RouterConfig, RouterEncoder


def load_checkpoint(path: str) -> dict:
    """Read a reference checkpoint into a nested dict of numpy arrays
    (list nodes come back as dicts with integer-string keys, as in the
    reference's loader)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.array(data[key])
    return root


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _state_from_tree(tree: dict, n_layers: int) -> dict:
    """Reference tree -> {module parameter name: array}, splitting the
    stacked ``layers`` subtree per layer."""
    state = {}
    for path, arr in _flatten(tree).items():
        name = path.replace("/", ".")
        if path.startswith("layers/"):
            if arr.shape[0] != n_layers:
                raise ValueError(f"{path}: leading axis {arr.shape[0]} is not "
                                 f"the {n_layers} stacked layers")
            for i in range(n_layers):
                state[f"layers.{i}.{name[len('layers.'):]}"] = arr[i]
        else:
            state[name] = arr
    return state


@torch.no_grad()
def params_from_numpy(tree: dict, cfg, device="cuda"):
    """The port's module for ``cfg`` holding the reference param ``tree``
    (numpy arrays, or anything ``np.asarray`` takes): a ``Decoder`` for an
    ``ArchConfig``, a ``RouterEncoder`` for a ``RouterConfig``, on
    ``device``. Raises on a missing, unexpected or mis-shaped tensor."""
    if isinstance(cfg, ArchConfig):
        model = Decoder(cfg, device)
    elif isinstance(cfg, RouterConfig):
        model = RouterEncoder(cfg, device)
    else:
        raise TypeError(f"no port module for config {type(cfg).__name__}")
    state = _state_from_tree(tree, cfg.n_layers)
    params = dict(model.named_parameters())
    if state.keys() != params.keys():
        raise ValueError(
            f"param tree does not match the port's {type(model).__name__}: "
            f"missing {sorted(params.keys() - state.keys())}, "
            f"unexpected {sorted(state.keys() - params.keys())}")
    for name, p in params.items():
        arr = state[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(arr, dtype=p.dtype))
    return model
