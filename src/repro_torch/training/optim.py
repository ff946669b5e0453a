"""AdamW and its schedule as plain functions on tensors (the port of
``repro.training.optim``).

Written out by hand, not ``torch.optim.AdamW`` with ``clip_grad_norm_``,
because the reference differs from those in three ways that change the
numbers: it clips only when the global norm exceeds ``grad_clip``, scaling
by ``grad_clip / (gnorm + 1e-9)``; its cosine schedule has a 0.1 floor;
and it decays every leaf, norms and biases included, through ``delta``.

``params`` and ``grads`` are mappings name -> tensor with the same keys
(``dict(module.named_parameters())`` and the matching gradients). The
update writes the parameters and the moments IN PLACE (the reference
returns new trees; a full-width model has no room for a second copy) and
returns them. The moments are stored in ``state_dtype`` and updated in
fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # "bfloat16" halves the moments' memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int), as a 0-d fp32 CPU tensor,
    computed in fp32 as the reference computes it."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: AdamWConfig) -> dict:
    """Zero first and second moments beside each parameter, in
    ``cfg.state_dtype``, and step 0."""
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt, requires_grad=False)
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": 0}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32 (a 0-d tensor
    on the tensors' device)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: dict,
                 cfg: AdamWConfig):
    """One AdamW step. Returns (params, state, metrics {"grad_norm",
    "lr"}), params and moments updated in place."""
    step = int(state["step"])
    gnorm = global_norm(grads)
    scale = torch.where(gnorm > cfg.grad_clip,
                        cfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = lr_at(cfg, step)
    t = torch.tensor(step + 1, dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** t)
    lr_f = float(lr)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        m32, v32 = m.float(), v.float()   # the moments themselves in fp32
        m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
        delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
        p32 = p.float()
        delta.add_(p32, alpha=cfg.weight_decay)
        p32.add_(delta, alpha=-lr_f)
        if p32 is not p:
            p.copy_(p32)
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}
