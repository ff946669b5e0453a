"""Weight bridge between the JAX reference and the port: the reference's
checkpoints and param trees into the port's modules
(``params_from_numpy``), and a port module back into the reference's tree
(``numpy_from_params``).

The reference writes params with ``training/checkpoint.py::save_checkpoint``
as a flat ``.npz`` keyed by '/'-joined tree paths, and stacks each layer's
weights on a leading layer axis. The port keeps every tensor's layout, so
loading is a copy: a path ``layers/attn/wq`` of shape (L, D, H, Dh) becomes
the parameters ``layers.<i>.attn.wq`` of shape (D, H, Dh), and
``numpy_from_params`` stacks them back. The hybrid (Jamba) tree stacks on
two axes: ``blocks/mamba/ssm/w_in`` (n_blocks, n_mamba, ...) becomes
``blocks.<b>.mamba.<j>.ssm.w_in`` (``moe`` and ``mlp`` likewise), and
``blocks/attn/...`` has the block axis only. The encoder-decoder's
``enc_layers/...`` (``n_enc_layers``) and ``dec_layers/...``
(``n_layers``) stack on one axis each, as ``layers/...`` does; its
``enc_pos``, ``enc_ln_f``, ``ln_f``, ``embed`` and ``head`` are copied as
they are. ``load_checkpoint`` (from
``training.checkpoint``) reads either side's ``.npz``.

bf16 crosses bit for bit: the reference's bf16 arrays (``ml_dtypes``'
bfloat16, or the 2-byte ``V2`` records ``np.load`` gives back for them
from a ``.npz`` that ``save_checkpoint`` wrote) are read as their 16 bits
and viewed as ``torch.bfloat16`` (``tensor_from_numpy``), without
``ml_dtypes``; a bf16 parameter comes back as fp32 arrays, which hold
every bf16 value exactly.

A module moves to another dtype as the bridge loads it there: ``twin``
builds the module at the other config and copies each weight into the
parameter's own dtype, so a bf16 SSM keeps ``A_log``, ``D`` and
``dt_bias`` in fp32 (as the reference's bf16 config does, and a
module-wide ``.to(torch.bfloat16)`` would not); ``init_twin`` draws that
twin's weights from a seed without holding the fp32 module.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import init_params_
from repro_torch.models.config import ArchConfig
from repro_torch.models.decoder import Decoder
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.encoder import RouterConfig, RouterEncoder
from repro_torch.training.checkpoint import _flatten
# re-exported: the bridge reads the reference's checkpoints
from repro_torch.training.checkpoint import load_checkpoint  # noqa: F401


def is_bf16_bits(arr: np.ndarray) -> bool:
    """A 2-byte array of no numeric kind: the reference's bf16
    (``ml_dtypes.bfloat16``, or the ``V2`` records of a bf16 ``.npz``)."""
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor of ``arr`` (anything ``np.asarray`` takes), bf16 bits
    (``is_bf16_bits``) viewed as ``torch.bfloat16``, bit for bit."""
    arr = np.array(arr, order="C")     # a writable copy
    if is_bf16_bits(arr):
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _state_from_tree(tree: dict, n_layers: int) -> dict:
    """Reference tree -> {module parameter name: array}, splitting the
    stacked ``layers``, ``enc_layers`` and ``dec_layers`` subtrees per
    layer and the ``blocks`` subtree per block and, below
    ``blocks/<kind>`` (but ``attn``), per sub-layer. A count that does not
    fit the module shows as missing or unexpected names."""
    state = {}
    for path, arr in _flatten(tree).items():
        parts = path.split("/")
        if parts[0] == "layers" and arr.shape[0] != n_layers:
            raise ValueError(f"{path}: leading axis {arr.shape[0]} is not "
                             f"the {n_layers} stacked layers")
        # where each stacked axis's index goes in the name: after the
        # path's first part, and for the hybrid's per-kind stacks also
        # after the kind (``blocks.<b>.mamba.<j>``)
        cuts = {"layers": [1], "enc_layers": [1], "dec_layers": [1],
                "blocks": [1] if parts[1:2] == ["attn"]
                else [1, 3]}.get(parts[0], [])
        entries = [(parts, arr)]
        for cut in cuts:
            entries = [(p[:cut] + [str(i)] + p[cut:], a[i])
                       for p, a in entries for i in range(a.shape[0])]
        state.update((".".join(p), a) for p, a in entries)
    return state


def module_class(cfg):
    """The port's module class for ``cfg``: ``Decoder`` for an
    ``ArchConfig`` (``Hybrid`` for ``family="hybrid"``, ``EncDec`` for an
    encoder-decoder), ``RouterEncoder`` for a ``RouterConfig``."""
    if isinstance(cfg, ArchConfig):
        return (EncDec if cfg.is_encoder_decoder else Hybrid
                if cfg.family == "hybrid" else Decoder)
    if isinstance(cfg, RouterConfig):
        return RouterEncoder
    raise TypeError(f"no port module for config {type(cfg).__name__}")


@torch.no_grad()
def twin(module: torch.nn.Module, cfg) -> torch.nn.Module:
    """``module``'s weights in the module for ``cfg`` (its own config at
    another dtype, such as ``dataclasses.replace(c, dtype="bfloat16")``),
    on ``module``'s device: each parameter copied into that module's own
    dtype (rounded to nearest even where it narrows), as
    ``params_from_numpy`` loads the same weights at ``cfg``. Parameters
    the config keeps in fp32 (an SSM's ``A_log``, ``D``, ``dt_bias``) stay
    fp32."""
    out = module_class(cfg)(cfg, next(module.parameters()).device)
    out.load_state_dict(module.state_dict())
    return out


@torch.no_grad()
def init_twin(cfg, generator, device="cuda") -> torch.nn.Module:
    """``twin(build_model(c).init(generator, device), cfg)`` with ``c`` the
    fp32 config of ``cfg``, without the fp32 module: each parameter drawn
    in fp32 in the init's order, then stored in its own dtype
    (``init_params_(draw_dtype=torch.float32)``), so a seed names the same
    weights at each dtype."""
    return init_params_(module_class(cfg)(cfg, device), generator,
                        draw_dtype=torch.float32)


@torch.no_grad()
def params_from_numpy(tree: dict, cfg, device="cuda"):
    """The port's module for ``cfg`` holding the reference param ``tree``
    (numpy arrays, or anything ``np.asarray`` takes; bf16 as
    ``tensor_from_numpy`` reads it): a ``Decoder`` for an ``ArchConfig``
    (a ``Hybrid`` for ``family="hybrid"``, an ``EncDec`` for an
    encoder-decoder), a ``RouterEncoder`` for a ``RouterConfig``, on
    ``device``, each parameter in the config's dtype (a bf16 array into a
    bf16 parameter bit for bit, into an fp32 one exactly). Raises on a
    missing, unexpected or mis-shaped tensor."""
    model = module_class(cfg)(cfg, device)
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
        p.copy_(tensor_from_numpy(arr))
    return model


def numpy_from_params(module: torch.nn.Module, cfg) -> dict:
    """The reference's param tree for the port's ``module`` (a ``Decoder``,
    ``Hybrid``, ``EncDec`` or ``RouterEncoder`` for ``cfg``): nested dicts
    of numpy arrays, each stacked tensor on its leading axes (``layers``
    and ``dec_layers``: one of ``cfg.n_layers``; ``enc_layers``: one of
    ``cfg.n_enc_layers``; the hybrid's ``blocks``: blocks, then
    sub-layers); every array is a copy, a bf16 parameter's widened to fp32
    (exact: fp32 holds every bf16 value). The inverse of
    ``params_from_numpy``; ``training.checkpoint.save_checkpoint`` writes it
    as the reference's ``.npz``."""
    stacked: dict = {}
    tree: dict = {}
    for name, p in module.state_dict().items():
        # a copy: on the CPU ``.numpy()`` shares the parameter's memory,
        # which training updates in place
        arr = p.detach().to("cpu", torch.float32 if p.dtype == torch.bfloat16
                            else p.dtype, copy=True).numpy()
        parts = name.split(".")
        index = tuple(int(q) for q in parts if q.isdigit())
        path = tuple(q for q in parts if not q.isdigit())
        stacked.setdefault(path, {})[index] = arr
    for path, by_index in stacked.items():
        keys = sorted(by_index)
        count = {"layers": "n_layers", "dec_layers": "n_layers",
                 "enc_layers": "n_enc_layers"}.get(path[0])
        if count and keys != [(i,) for i in range(getattr(cfg, count))]:
            raise ValueError(f"{path[0]}.*.{'.'.join(path[1:])}: layers "
                             f"{keys} are not the config's {count} "
                             f"{getattr(cfg, count)}")
        lead = tuple(n + 1 for n in keys[-1])
        if keys != list(np.ndindex(*lead)):
            raise ValueError(f"{'.'.join(path)}: indices {keys} do not fill "
                             f"{lead}")
        arr = np.stack([by_index[i] for i in keys]).reshape(
            lead + by_index[keys[0]].shape)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return tree
