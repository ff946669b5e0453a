"""Model bundle API (the port of ``repro.models.model``): the dense-cache
and paged serving paths and training's teacher-forced pass of every
family: the decoder-only families (dense, MoE, SSM, the Jamba-style
hybrid and vlm) and the encoder-decoder (audio).

``build_model(cfg)`` returns a ``ModelBundle`` of plain functions over a
``Decoder`` module (a ``Hybrid`` for ``family="hybrid"``, an ``EncDec``
for encoder-decoder configs), in the reference's argument order:

  init(generator, device="cuda") -> Decoder | Hybrid | EncDec
  prefill(model, batch, max_seq=None) -> (last_logits (B, V), cache)
      batch {"tokens": (B, S)}, plus {"frontend_embeds": (B, n_front, D)}
      (vlm) or {"enc_embeds": (B, enc_seq, D)} (encoder-decoder), which
      the stub frontends supply (``models.frontends``)
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
  verify_paged_chunk(model, cache, tokens, page_table, start, n_new,
                     pages_bound=None, window_start=0) -> x (B, C, D)
      the speculative verify chunk: prefill_paged_chunk's compute and
      K/V writes, every position's hidden state kept (None for stacks
      that cannot roll back a rejected suffix: SSM, hybrid and window
      stacks)
  init_recurrent_state(n_rows, device="cuda") -> {"h", "conv"} row slabs
      (SSM and hybrid families; None for attention stacks)
  forward(model, batch) -> (logits (B, S, V), aux)
      training's teacher-forced pass, differentiable, over the token
      positions; aux is the MoE layers' load-balance loss summed over
      layers (0 without experts)

The five paged fields are None where the config has no paged path
(``cfg.paged_unsupported_reason``: encoder-decoder stacks and modality
frontends), as in the reference. Dense caches, page pools and
recurrent-state rows are updated in place. The paged calls of the SSM and
hybrid families take ``cache["rec"]``, the recurrent state, beside the
pools (zero layers for SSM stacks, one a block for the hybrid), and
``state_rows`` names each prefill row's state row. ``window_start`` is
the first page of the sliding-window layers' page walks (global layers
walk from page 0).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import decoder, encdec, hybrid
from .config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    init_paged_cache: Optional[Callable] = None
    prefill_paged_chunk: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    lm_head: Optional[Callable] = None
    init_recurrent_state: Optional[Callable] = None
    forward: Optional[Callable] = None
    verify_paged_chunk: Optional[Callable] = None


def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.is_encoder_decoder:
        return _encdec_bundle(cfg)
    if cfg.family == "hybrid":
        return _hybrid_bundle(cfg)
    dense = dict(
        cfg=cfg,
        init=lambda generator, device="cuda":
            decoder.init_decoder(cfg, generator, device),
        prefill=lambda m, batch, max_seq=None:
            decoder.decoder_prefill(m, batch, cfg, max_seq),
        decode_step=lambda m, c, t, windowed=False:
            decoder.decoder_decode_step(m, c, t, cfg, windowed=windowed),
        init_cache=lambda batch_size, max_seq, device="cuda":
            decoder.init_decode_cache(cfg, batch_size, max_seq, device),
        forward=lambda m, batch: decoder.decoder_forward(m, batch, cfg),
    )
    if not cfg.supports_paged_kv:     # the vlm family's frontend
        return ModelBundle(**dense)
    rec = verify = None
    if cfg.family != "ssm" and not cfg.has_window_layers:
        verify = lambda m, c, t, page_table, start, n_new, \
            pages_bound=None, window_start=0: \
            decoder.decoder_verify_paged_chunk(
                m, c, t, page_table, start, n_new, cfg, pages_bound,
                window_start)
    if cfg.family == "ssm":
        rec = lambda n_rows, device="cuda": \
            decoder.init_decoder_recurrent_state(cfg, n_rows, device)
    return ModelBundle(
        **dense,
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
        init_recurrent_state=rec,
        verify_paged_chunk=verify,
    )


def _encdec_bundle(cfg: ArchConfig) -> ModelBundle:
    """The encoder-decoder's bundle: the dense path and training's
    forward, no paged path (cross-attention reads fixed encoder memory)."""
    return ModelBundle(
        cfg=cfg,
        init=lambda generator, device="cuda":
            encdec.init_encdec(cfg, generator, device),
        prefill=lambda m, batch, max_seq=None:
            encdec.encdec_prefill(m, batch, cfg, max_seq),
        decode_step=lambda m, c, t, windowed=False:
            encdec.encdec_decode_step(m, c, t, cfg, windowed=windowed),
        init_cache=lambda batch_size, max_seq, device="cuda":
            encdec.init_encdec_cache(cfg, batch_size, max_seq, device),
        forward=lambda m, batch: encdec.encdec_forward(m, batch, cfg),
    )


def _hybrid_bundle(cfg: ArchConfig) -> ModelBundle:
    """The Jamba-style hybrid stack's bundle: recurrent-state rows for its
    Mamba layers, and no verify chunk (recurrent state cannot roll back)."""
    return ModelBundle(
        cfg=cfg,
        init=lambda generator, device="cuda":
            hybrid.init_hybrid(cfg, generator, device),
        prefill=lambda m, batch, max_seq=None:
            hybrid.hybrid_prefill(m, batch, cfg, max_seq),
        decode_step=lambda m, c, t, windowed=False:
            hybrid.hybrid_decode_step(m, c, t, cfg, windowed=windowed),
        init_cache=lambda batch_size, max_seq, device="cuda":
            hybrid.init_hybrid_cache(cfg, batch_size, max_seq, device),
        init_paged_cache=lambda num_pages, page_size=None, device="cuda":
            hybrid.init_hybrid_paged_cache(
                cfg, num_pages, page_size or cfg.kv_page_size, device),
        prefill_paged_chunk=lambda m, c, t, page_table, start, n_new,
            pages_bound=None, window_start=0, state_rows=None:
            hybrid.hybrid_prefill_paged_chunk(
                m, c, t, page_table, start, n_new, cfg, pages_bound,
                window_start, state_rows),
        decode_step_paged=lambda m, c, t, page_table, seq_lens, active,
            pages_bound=None, window_start=0:
            hybrid.hybrid_decode_step_paged(
                m, c, t, page_table, seq_lens, active, cfg, pages_bound,
                window_start),
        lm_head=lambda m, x: decoder._unembed(m, x, cfg),
        forward=lambda m, batch: hybrid.hybrid_forward(m, batch, cfg),
        init_recurrent_state=lambda n_rows, device="cuda":
            hybrid.init_hybrid_recurrent_state(cfg, n_rows, device),
    )
