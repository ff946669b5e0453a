"""LM training loop (the port of ``repro.training.trainer``): trains the
tiers of the routing pipeline, and takes one step of a full-width model
on the card.

``train_lm`` draws its batches with ``np.random.default_rng(tcfg.seed)``
exactly as the reference does, so a port step and a reference step see
the same rows. Its initial weights are the module the caller passes, or a
fresh one drawn through ``torch.Generator`` seeded with ``tcfg.seed`` (the
reference's init distributions, not its numbers). The module is trained
IN PLACE, with gradients switched on for the run and off again after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.common import softmax_xent
from repro_torch.models.model import ModelBundle
from .optim import AdamWConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 500
    batch_size: int = 64
    lr: float = 1e-3
    log_every: int = 50
    seed: int = 0


@contextlib.contextmanager
def trainable(module: torch.nn.Module):
    """Switch gradients on for every parameter of ``module`` for the
    block, and off again after it (the port builds parameters with
    gradients off, so serving builds no graph)."""
    params = list(module.parameters())
    for p in params:
        p.requires_grad_(True)
    try:
        yield module
    finally:
        for p in params:
            p.requires_grad_(False)


def lm_loss(bundle: ModelBundle, model, batch):
    """The masked token cross-entropy. The port builds no family with an
    auxiliary loss (the reference's MoE load-balance term), so the
    ``aux`` that ``forward`` returns is always zero and is left out."""
    logits, _ = bundle.forward(model, batch)
    return softmax_xent(logits, batch["labels"], batch.get("loss_mask"))


def make_lm_train_step(bundle: ModelBundle, ocfg: AdamWConfig):
    """step(model, opt_state, batch) -> (model, opt_state, metrics
    {"loss", "grad_norm", "lr"}). ``model``'s parameters must have
    gradients on (``trainable``); they are updated in place."""
    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss = lm_loss(bundle, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt_state, om = adamw_update(params, dict(zip(params, grads)),
                                        opt_state, ocfg)
        return model, opt_state, {"loss": loss.detach(), **om}
    return step


def batch_iterator(rng: np.random.Generator, arrays: dict, batch_size: int,
                   device="cuda") -> Iterator[dict]:
    """Endless batches of ``batch_size`` rows drawn with replacement by
    ``rng.integers``, as the reference draws them, as tensors on
    ``device``."""
    n = len(next(iter(arrays.values())))
    while True:
        idx = rng.integers(0, n, size=batch_size)
        yield {k: torch.as_tensor(v[idx], device=device)
               for k, v in arrays.items()}


def train_lm(bundle: ModelBundle, arrays: dict, tcfg: TrainConfig,
             params=None, device="cuda"):
    """Train an LM on teacher-forced arrays. ``params``: the ``Decoder``
    module to train in place (its device is where training runs), or None
    for a fresh one on ``device`` from ``torch.Generator`` seeded with
    ``tcfg.seed``. Returns (module, history)."""
    rng = np.random.default_rng(tcfg.seed)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        params = bundle.init(gen, device)
    dev = next(params.parameters()).device
    ocfg = AdamWConfig(lr=tcfg.lr, warmup_steps=max(1, tcfg.steps // 20),
                       total_steps=tcfg.steps)
    opt_state = init_opt_state(dict(params.named_parameters()), ocfg)
    step_fn = make_lm_train_step(bundle, ocfg)
    it = batch_iterator(rng, arrays, tcfg.batch_size, dev)
    history = []
    t0 = time.monotonic()
    with trainable(params):
        for step in range(tcfg.steps):
            params, opt_state, m = step_fn(params, opt_state, next(it))
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                history.append({"step": step, "loss": float(m["loss"]),
                                "t": time.monotonic() - t0})
    return params, history
