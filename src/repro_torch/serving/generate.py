"""Per-row token sampling for the continuous engines (the port of
``repro.serving.generate._sample_rows``)."""
from __future__ import annotations

import numpy as np
import torch


def _sample_rows(generator, logits: torch.Tensor,
                 temperatures: np.ndarray) -> torch.Tensor:
    """Per-row temperature sampling for mixed greedy/sampled batches: row b
    is argmax when ``temperatures[b] <= 0`` (the first index on ties, as
    ``jnp.argmax`` takes), else a categorical draw at its own temperature
    from ``generator`` (the engine's own stream). ``logits`` (B, V) on any
    device, ``temperatures`` (B,) host floats. Returns (B,) int32 tokens on
    the logits' device."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = np.asarray(temperatures, np.float32)
    rows = np.flatnonzero(temps > 0.0)
    if len(rows):
        idx = torch.as_tensor(rows, device=logits.device)
        t = torch.as_tensor(temps[rows], device=logits.device)
        probs = torch.softmax(logits[idx].float() / t[:, None], dim=-1)
        drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
        out[idx] = drawn.to(torch.int32)
    return out
