"""Weight bridge between the JAX reference and the port: the reference's
checkpoints and param trees into the port's modules
(``params_from_numpy``), and a port module back into the reference's tree
(``numpy_from_params``).

The reference writes params with ``training/checkpoint.py::save_checkpoint``
as a flat ``.npz`` keyed by '/'-joined tree paths, and stacks each layer's
weights on a leading layer axis. The port keeps every tensor's layout, so
loading is a copy: a path ``layers/attn/wq`` of shape (L, D, H, Dh) becomes
the parameters ``layers.<i>.attn.wq`` of shape (D, H, Dh), and
``numpy_from_params`` stacks them back. ``load_checkpoint`` (from
``training.checkpoint``) reads either side's ``.npz``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.decoder import Decoder
from repro_torch.models.encoder import RouterConfig, RouterEncoder
from repro_torch.training.checkpoint import _flatten
# re-exported: the bridge reads the reference's checkpoints
from repro_torch.training.checkpoint import load_checkpoint  # noqa: F401


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


def numpy_from_params(module: torch.nn.Module, cfg) -> dict:
    """The reference's param tree for the port's ``module`` (a ``Decoder``
    or a ``RouterEncoder`` for ``cfg``): nested dicts of numpy arrays, each
    layer's tensors stacked on a leading axis of ``cfg.n_layers``; every
    array is a copy. The inverse of ``params_from_numpy``; ``training.checkpoint.save_checkpoint``
    writes it as the reference's ``.npz``."""
    per_layer: dict = {}
    tree: dict = {}

    def put(node, dotted, value):
        *path, leaf = dotted.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    for name, p in module.state_dict().items():
        # a copy: on the CPU ``.numpy()`` shares the parameter's memory,
        # which training updates in place
        arr = p.detach().to("cpu", copy=True).numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            per_layer.setdefault(rest, {})[int(i)] = arr
        else:
            put(tree, name, arr)
    for rest, by_layer in per_layer.items():
        if sorted(by_layer) != list(range(cfg.n_layers)):
            raise ValueError(f"layers.*.{rest}: layers {sorted(by_layer)} "
                             f"are not the config's {cfg.n_layers}")
        put(tree, "layers." + rest,
            np.stack([by_layer[i] for i in range(cfg.n_layers)]))
    return tree
