"""Router training (paper §3; the port of ``repro.core.router``): BCE on
a BERT-style encoder with hard or soft labels. The same trainer covers
r_det / r_prob / r_trans — only the labels differ, exactly as in the
paper.

Each epoch permutes the rows with ``np.random.default_rng(seed)`` as the
reference does, so a port step and a reference step see the same rows.
The initial encoder is the module the caller passes, or a fresh one drawn
through ``torch.Generator`` seeded with ``tcfg.seed``. The best validation
checkpoint is a copy of the weights taken at the end of its epoch, and
the returned module holds it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.encoder import (RouterConfig, init_router_encoder,
                                        router_encode)
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        init_opt_state)
from repro_torch.training.trainer import seeded_init, trainable


@dataclasses.dataclass(frozen=True)
class RouterTrainConfig:
    epochs: int = 5                # paper: 5 epochs, best checkpoint on val
    batch_size: int = 64
    lr: float = 3e-4
    weight_decay: float = 0.01
    seed: int = 0


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with soft labels (Eq. 1/2/4)."""
    logp = F.logsigmoid(logits)
    lognp = F.logsigmoid(-logits)
    return -torch.mean(labels * logp + (1.0 - labels) * lognp)


def make_train_step(rcfg: RouterConfig, ocfg: AdamWConfig):
    """step(model, opt_state, tokens, mask, labels) -> (model, opt_state,
    metrics {"loss", "grad_norm", "lr"}); the tensors on the model's
    device, its parameters with gradients on (``trainable``), updated in
    place."""
    def step(model, opt_state, tokens, mask, labels):
        params = dict(model.named_parameters())
        loss = bce_loss(router_encode(model, tokens, mask, rcfg), labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt_state, om = adamw_update(params, dict(zip(params, grads)),
                                        opt_state, ocfg)
        return model, opt_state, {"loss": loss.detach(), **om}
    return step


@torch.no_grad()
def _logits(model, rcfg: RouterConfig, tokens: np.ndarray, mask: np.ndarray,
            batch_size: int) -> torch.Tensor:
    """Router logits for a dataset in batches of ``batch_size``, on the
    model's device."""
    dev = next(model.parameters()).device
    out = []
    for i in range(0, len(tokens), batch_size):
        out.append(router_encode(
            model, torch.as_tensor(tokens[i:i + batch_size], device=dev)
            .long(), torch.as_tensor(mask[i:i + batch_size], device=dev)
            .float(), rcfg))
    return torch.cat(out)


def score_dataset(params, rcfg: RouterConfig, tokens: np.ndarray,
                  mask: np.ndarray, batch_size: int = 256) -> np.ndarray:
    """Router scores p_w(x) for a dataset, batched. ``params`` is the
    ``RouterEncoder``. Returns (N,) float32."""
    return torch.sigmoid(_logits(params, rcfg, tokens, mask, batch_size)) \
        .cpu().numpy()


def train_router(rcfg: RouterConfig, tokens: np.ndarray, mask: np.ndarray,
                 labels: np.ndarray,
                 tcfg: RouterTrainConfig = RouterTrainConfig(),
                 val: tuple | None = None, params=None, device="cuda"
                 ) -> tuple[torch.nn.Module, Dict[str, List[float]]]:
    """Train one router. ``val`` = (tokens, mask, labels) selects the best
    checkpoint across epochs (paper §4.1). ``params``: the
    ``RouterEncoder`` to train in place (its device is where training
    runs), or None for a fresh one on ``device`` (``seeded_init``).
    Returns (module, history); the module holds the best-val weights when
    ``val`` is given, else the last epoch's."""
    rng = np.random.default_rng(tcfg.seed)
    if params is None:
        params = seeded_init(lambda g, d: init_router_encoder(rcfg, g, d),
                             tcfg.seed, device)
    dev = next(params.parameters()).device
    n_steps = max(1, len(tokens) // tcfg.batch_size) * tcfg.epochs
    ocfg = AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                       warmup_steps=max(1, n_steps // 20), total_steps=n_steps)
    opt_state = init_opt_state(dict(params.named_parameters()), ocfg)
    step = make_train_step(rcfg, ocfg)
    T = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)

    history = {"train_loss": [], "val_loss": []}
    best_loss, best_state = np.inf, None
    N = len(tokens)
    with trainable(params):
        for epoch in range(tcfg.epochs):
            order = rng.permutation(N)
            losses = []
            for i in range(0, N - tcfg.batch_size + 1, tcfg.batch_size):
                idx = order[i:i + tcfg.batch_size]
                params, opt_state, m = step(
                    params, opt_state, T(tokens[idx], torch.long),
                    T(mask[idx], torch.float32),
                    T(labels[idx], torch.float32))
                losses.append(float(m["loss"]))
            history["train_loss"].append(float(np.mean(losses)))
            if val is not None:
                vt, vm, vl = val
                with torch.no_grad():
                    vloss = float(bce_loss(_logits(params, rcfg, vt, vm, 256),
                                           T(vl, torch.float32)))
                history["val_loss"].append(vloss)
                if vloss < best_loss:
                    best_loss = vloss
                    best_state = {k: v.detach().clone() for k, v in
                                  params.state_dict().items()}
    if best_state is not None:
        params.load_state_dict(best_state)
    return params, history
