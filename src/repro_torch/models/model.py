"""Model bundle API (the port of ``repro.models.model``): the dense-cache
and paged serving paths of the dense and SSM families.

``build_model(cfg)`` returns a ``ModelBundle`` of plain functions over a
``Decoder`` module, in the reference's argument order:

  init(generator, device="cuda") -> Decoder
  prefill(model, batch {"tokens": (B, S)}, max_seq=None)
      -> (last_logits (B, V), cache)
  decode_step(model, cache, token (B, 1), windowed=False)
      -> (logits (B, V), cache)
  init_cache(batch_size, max_seq, device="cuda") -> cache
  init_paged_cache(num_pages, page_size=None, device="cuda") -> pools
  prefill_paged_chunk(model, cache, tokens, page_table, start, n_new,
                      pages_bound=None, window_start=0, state_rows=None)
      -> x_last (B, 1, D)
  decode_step_paged(model, cache, token, page_table, seq_lens, active,
                    pages_bound=None, window_start=0) -> logits (B, V)
  lm_head(model, x (B, S, D)) -> logits (B, S, V)
  init_recurrent_state(n_rows, device="cuda") -> {"h", "conv"} row slabs
      (SSM family; None for attention stacks)
  forward(model, batch {"tokens": (B, S)}) -> (logits (B, S, V), aux)
      training's teacher-forced pass, differentiable (dense stacks; the
      SSM family raises until the slice that brings ``ssm_forward``)

Dense caches, page pools and recurrent-state rows are updated in place.
The paged calls of the SSM family take ``cache["rec"]``, the recurrent
state, beside the (zero-layer) pools, and ``state_rows`` names each
prefill row's state row. ``window_start`` is the first page of the
sliding-window layers' page walks (global layers walk from page 0). Dense
stacks, global or mixed with sliding-window layers (gemma3), and SSM stacks
are built so far; MoE layers and the other families raise and name the
slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import decoder
from .config import ArchConfig

_LATER = {
    "moe": "the MoE family comes with the MoE slice",
    "hybrid": "the hybrid (Jamba) family comes with the hybrid slice, "
              "after the MoE slice",
    "vlm": "the vlm family comes with the encoder-decoder and frontends "
           "slice",
    "audio": "the audio family comes with the encoder-decoder and "
             "frontends slice",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    init_paged_cache: Callable
    prefill_paged_chunk: Callable
    decode_step_paged: Callable
    lm_head: Callable
    init_recurrent_state: Optional[Callable] = None
    forward: Optional[Callable] = None


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet — "
            + _LATER.get(cfg.family,
                         "only the dense and SSM families are ported"))
    if cfg.n_experts or not cfg.supports_paged_kv:
        raise NotImplementedError(
            f"{cfg.name}: only dense stacks without MoE layers are ported "
            "yet — MoE layers come with the MoE slice, encoder-decoder "
            "stacks and frontends with the encoder-decoder and frontends "
            "slice")
    rec = None
    if cfg.family == "ssm":
        rec = lambda n_rows, device="cuda": \
            decoder.init_decoder_recurrent_state(cfg, n_rows, device)
    return ModelBundle(
        cfg=cfg,
        init=lambda generator, device="cuda":
            decoder.init_decoder(cfg, generator, device),
        prefill=lambda m, batch, max_seq=None:
            decoder.decoder_prefill(m, batch, cfg, max_seq),
        decode_step=lambda m, c, t, windowed=False:
            decoder.decoder_decode_step(m, c, t, cfg, windowed=windowed),
        init_cache=lambda batch_size, max_seq, device="cuda":
            decoder.init_decode_cache(cfg, batch_size, max_seq, device),
        init_paged_cache=lambda num_pages, page_size=None, device="cuda":
            decoder.init_paged_decode_cache(
                cfg, num_pages, page_size or cfg.kv_page_size, device),
        prefill_paged_chunk=lambda m, c, t, page_table, start, n_new,
            pages_bound=None, window_start=0, state_rows=None:
            decoder.decoder_prefill_paged_chunk(
                m, c, t, page_table, start, n_new, cfg, pages_bound,
                window_start, state_rows),
        decode_step_paged=lambda m, c, t, page_table, seq_lens, active,
            pages_bound=None, window_start=0:
            decoder.decoder_decode_step_paged(
                m, c, t, page_table, seq_lens, active, cfg, pages_bound,
                window_start),
        lm_head=lambda m, x: decoder._unembed(m, x, cfg),
        forward=lambda m, batch: decoder.decoder_forward(m, batch, cfg),
        init_recurrent_state=rec,
    )
