"""Step-function builders for the dry run, and entry points of their own
(the port of ``repro.launch.steps``).

``build_step(cfg, shape)`` returns (fn, arg_specs, trip_counts) where fn
is the step:
  train  : (model, opt_state, batch) -> (model, opt_state, loss)
  prefill: (model, batch)            -> (last_logits, cache)
  decode : (model, cache, token)     -> (logits, cache)

The model, the optimizer state and the cache are updated in place (the
reference donates them). On CUDA tensors the steps are real entry points:
decode launches the dense decode kernel (K5) a layer, prefill the flash
kernel (K4) or, on an SSM or hybrid stack, the SSD chunk kernel (K3); train
launches none (the kernels have no backward pass). K3, K4 and K5 take
fp32 or bf16, so the dry run's bf16 config (``dryrun_config``) runs its
decode and prefill steps on the card through their bf16 instances, an
SSM or hybrid stack's prefill too. ``trip_counts`` maps the layer loops'
trip counts; the port's counter sees every layer's ops as they dispatch,
so it needs no trip correction, and the dry run records them as
``while_trips``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import softmax_xent
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.model import build_model
from repro_torch.training.optim import AdamWConfig, adamw_update
from repro_torch.training.trainer import trainable
from .inputs import (cache_specs, dryrun_config, input_specs,
                     needs_windowed_decode, params_specs)

DRYRUN_OPT = AdamWConfig(state_dtype="bfloat16")  # memory fit for 100B+


def trip_counts(cfg: ArchConfig, kind: str) -> dict:
    """The layer loops' trip counts per program."""
    t = {}
    if cfg.family == "hybrid":
        t["layers"] = cfg.n_layers // cfg.attn_every
    else:
        t["layers"] = cfg.n_layers
    if cfg.is_encoder_decoder:
        t["enc_layers"] = cfg.n_enc_layers
    return t


def build_train_step(bundle, ocfg: AdamWConfig = DRYRUN_OPT,
                     aux_weight: float = 0.01) -> Callable:
    """train_step(model, opt_state, batch) -> (model, opt_state, loss):
    loss is the masked cross-entropy plus ``aux_weight`` times the MoE
    aux, as the reference returns it; one AdamW update in place."""
    def train_step(model, opt_state, batch):
        with trainable(model):
            params = dict(model.named_parameters())
            logits, aux = bundle.forward(model, batch)
            loss = softmax_xent(logits, batch["labels"],
                                batch.get("loss_mask")) + aux_weight * aux
            grads = torch.autograd.grad(loss, list(params.values()))
            adamw_update(params, dict(zip(params, grads)), opt_state, ocfg)
        return model, opt_state, loss.detach()
    return train_step


def build_prefill_step(bundle, max_seq: int) -> Callable:
    @torch.no_grad()
    def prefill_step(model, batch):
        return bundle.prefill(model, batch, max_seq)
    return prefill_step


def build_decode_step(bundle, windowed: bool) -> Callable:
    @torch.no_grad()
    def decode_step(model, cache, token):
        return bundle.decode_step(model, cache, token, windowed=windowed)
    return decode_step


def build_step(cfg: ArchConfig, shape: InputShape, mode=None):
    """Returns (fn, arg_specs, trips) for the dry-run config of ``cfg`` at
    ``shape`` (``dryrun_config``); see ``step_for``."""
    return step_for(dryrun_config(cfg, shape), shape, mode)


def step_for(rcfg: ArchConfig, shape: InputShape, mode=None,
             ocfg: AdamWConfig = DRYRUN_OPT):
    """``build_step`` for ``rcfg`` as it is given (the card's fp32 steps
    take this). arg_specs: params as {name: (shape, dtype)}, the optimizer
    state as {"m", "v": {name: (shape, dtype)}, "step": 0}, and the batch,
    cache and token as fake tensors made under ``mode``."""
    bundle = build_model(rcfg)
    p_specs = params_specs(rcfg)
    trips = trip_counts(rcfg, shape.kind)
    if shape.kind == "train":
        st = getattr(torch, ocfg.state_dtype)
        moments = {n: (s, st) for n, (s, _) in p_specs.items()}
        opt_specs = {"m": moments, "v": dict(moments), "step": 0}
        return (build_train_step(bundle, ocfg),
                (p_specs, opt_specs, input_specs(rcfg, shape, mode)), trips)
    if shape.kind == "prefill":
        return (build_prefill_step(bundle, shape.seq_len),
                (p_specs, input_specs(rcfg, shape, mode)), trips)
    fn = build_decode_step(bundle, needs_windowed_decode(rcfg, shape))
    c_specs = cache_specs(rcfg, shape, mode)
    tok = input_specs(rcfg, shape, mode)["tokens"]
    return fn, (p_specs, c_specs, tok), trips
