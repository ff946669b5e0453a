"""Stub modality frontends (the port of ``repro.models.frontends``).

For ``vlm``: a real deployment runs InternViT + projector and feeds patch
embeddings to the language model; here ``vision_stub_embeds`` synthesises
patch embeddings of the correct shape and dtype. For ``audio``: the
mel+conv codec of Whisper is stubbed by ``audio_stub_embeds``, producing
frame embeddings for the (fully implemented) transformer encoder.

Each draws ``normal * 0.02`` through an explicit ``torch.Generator`` on
``device`` and casts to the config's dtype, as the reference draws from its
key (the same distribution, not the same numbers).
"""
from __future__ import annotations

import torch

from .common import dtype_of


def vision_stub_embeds(generator, batch: int, cfg,
                       device="cuda") -> torch.Tensor:
    """(B, num_frontend_tokens, d_model) patch embeddings."""
    return (torch.randn((batch, cfg.num_frontend_tokens, cfg.d_model),
                        generator=generator, device=device) * 0.02) \
        .to(dtype_of(cfg))


def audio_stub_embeds(generator, batch: int, cfg,
                      device="cuda") -> torch.Tensor:
    """(B, enc_seq, d_model) conv-frontend frame embeddings."""
    return (torch.randn((batch, cfg.enc_seq, cfg.d_model),
                        generator=generator, device=device) * 0.02) \
        .to(dtype_of(cfg))


def make_batch(generator, cfg, batch: int, seq: int, for_train: bool = True,
               device="cuda") -> dict:
    """Random token batch with the correct frontend extras for the family:
    ``tokens`` (B, S) int64 in [0, vocab_size), then ``frontend_embeds``
    (vlm) or ``enc_embeds`` (encoder-decoder), and for training ``labels``
    (tokens rolled left by one) and an all-ones ``loss_mask``."""
    b = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=generator, device=device)}
    if cfg.frontend_positions:
        b["frontend_embeds"] = vision_stub_embeds(generator, batch, cfg,
                                                  device)
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = audio_stub_embeds(generator, batch, cfg, device)
    if for_train:
        b["labels"] = torch.roll(b["tokens"], -1, dims=1)
        b["loss_mask"] = torch.ones((batch, seq), dtype=torch.float32,
                                    device=device)
    return b
