"""Input stand-ins for every (arch x input-shape) combination (the port of
``repro.launch.inputs``).

No memory is allocated: inputs and caches are fake tensors
(``FakeTensorMode``) and parameters a name -> (shape, dtype) map read
from the model built on the ``meta`` device. Shapes follow the
reference:
  train_4k    : teacher-forced train step, (B=256, S=4096)
  prefill_32k : prompt prefill, (B=32, S=32768)
  decode_32k  : ONE new token against a 32768-entry KV cache, B=128
  long_500k   : ONE new token against a 524288-entry cache, B=1
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.models.decoder import Decoder
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.model import build_model


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def dryrun_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Production execution settings: bf16, remat for training,
    memory-bounded attention chunking sized to the actual sequence."""
    eff_seq = shape.seq_len
    if cfg.frontend == "vision_stub":
        eff_seq += cfg.num_frontend_tokens
    chunk = _largest_divisor_leq(eff_seq, 1024)
    return dataclasses.replace(
        cfg,
        dtype="bfloat16",
        remat=(shape.kind == "train"),
        attn_chunk=chunk,
        use_pallas=False,   # traced on fake CPU tensors: the plain versions
    )


def needs_windowed_decode(cfg: ArchConfig, shape: InputShape) -> bool:
    """long_500k: pure full-attention archs use the sliding-window +
    attention-sink serving mode; ssm / hybrid / local:global archs decode
    natively."""
    return (shape.name == "long_500k"
            and not cfg.has_subquadratic_path
            and not cfg.is_attention_free)


def _mode(mode):
    """``mode`` itself, or a fresh ``FakeTensorMode`` when None."""
    if mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        return FakeTensorMode()
    return mode


def input_specs(cfg: ArchConfig, shape: InputShape, mode=None) -> dict:
    """Fake tensors for the step function's ``batch``-like inputs, made
    under ``mode`` (a ``FakeTensorMode``; a new one when None)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)
    with _mode(mode):
        if shape.kind == "train":
            specs = {"tokens": torch.empty((B, S), dtype=i32),
                     "labels": torch.empty((B, S), dtype=i32),
                     "loss_mask": torch.empty((B, S), dtype=torch.float32)}
        elif shape.kind == "prefill":
            specs = {"tokens": torch.empty((B, S), dtype=i32)}
        else:   # decode: one token; the cache comes from cache_specs()
            specs = {"tokens": torch.empty((B, 1), dtype=i32)}
        if cfg.frontend == "vision_stub" and shape.kind != "decode":
            specs["frontend_embeds"] = torch.empty(
                (B, cfg.num_frontend_tokens, cfg.d_model), dtype=act)
        if cfg.is_encoder_decoder and shape.kind != "decode":
            specs["enc_embeds"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                              dtype=act)
    return specs


def cache_specs(cfg: ArchConfig, shape: InputShape, mode=None) -> dict:
    """The decode cache as fake tensors, through the bundle's
    ``init_cache`` under ``mode``. Its ``pos`` is the last entry, S - 1:
    the port's dense decode writes in place and refuses a position past
    the cache (the reference's traced ``pos`` clamps), so the step writes
    the last entry and reads every one."""
    bundle = build_model(cfg)
    with _mode(mode):
        cache = bundle.init_cache(shape.global_batch, shape.seq_len,
                                  device="cpu")
    cache["pos"] = shape.seq_len - 1
    return cache


def params_specs(cfg: ArchConfig) -> dict:
    """{param name: (shape, dtype)} of the model built on the ``meta``
    device (no memory, no weights drawn)."""
    module = build_meta(cfg)
    return {n: (tuple(p.shape), p.dtype) for n, p in
            module.named_parameters()}


def build_meta(cfg: ArchConfig) -> torch.nn.Module:
    """The config's module (a ``Decoder``, ``Hybrid`` or ``EncDec``, as
    ``build_model(cfg).init`` builds) with every parameter empty on the
    ``meta`` device."""
    cls = (EncDec if cfg.is_encoder_decoder else
           Hybrid if cfg.family == "hybrid" else Decoder)
    return cls(cfg, "meta")
