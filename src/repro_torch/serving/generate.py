"""Batched autoregressive generation (the port of
``repro.serving.generate``): prefill, then exactly ``max_new_tokens``
decode steps with temperature sampling and EOS termination masking, and
the per-row sampler of the continuous engines."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.data import tokenizer as tok
from repro_torch.models.model import ModelBundle


def _stream_seed(*words: int) -> int:
    """A 32-bit generator seed mixed from ``words`` (seed, salt, call)."""
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


def _sample(generator, logits: torch.Tensor,
            temperature: float) -> torch.Tensor:
    """Row-wise argmax at ``temperature <= 0`` (the first index on ties, as
    ``jnp.argmax`` takes), else a categorical draw from
    softmax(logits / temperature) through ``generator``. Returns (B,)
    int32 on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


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


def build_generate_fn(bundle: ModelBundle, max_new_tokens: int,
                      temperature: float, windowed: bool = False
                      ) -> Callable:
    """Returns fn(params, inputs {"tokens": (B, S)}, generator) ->
    (tokens (B, T) int32, lengths (B,) int32), both on the params' device.

    Every row runs exactly ``max_new_tokens`` decode steps, as the
    reference's scan does: rows past EOS emit PAD, and the last step's
    logits are computed and dropped. A row's length counts its tokens up to
    and including its first EOS, else the full budget."""
    T = max_new_tokens

    @torch.no_grad()
    def gen(params, inputs: Dict[str, torch.Tensor], generator):
        prompt_len = inputs["tokens"].shape[1]
        logits, cache = bundle.prefill(params, inputs, prompt_len + T)
        B = inputs["tokens"].shape[0]
        done = torch.zeros((B,), dtype=torch.bool, device=logits.device)
        toks = []
        for _ in range(T):
            nxt = _sample(generator, logits, temperature)
            nxt = torch.where(done, tok.PAD, nxt).to(torch.int32)
            done = done | (nxt == tok.EOS)
            logits, cache = bundle.decode_step(params, cache, nxt[:, None],
                                               windowed=windowed)
            toks.append(nxt)
        toks = torch.stack(toks, dim=1)
        steps = torch.arange(T, device=toks.device)[None, :] + 1
        lengths = torch.where(toks == tok.EOS, steps, T + 1).min(dim=1).values
        return toks, torch.clamp(lengths, max=T).to(torch.int32)

    return gen


def sample_responses(bundle: ModelBundle, params, query_tokens: np.ndarray,
                     n_samples: int, max_new_tokens: int,
                     temperature: float = 0.8, seed: int = 0,
                     batch_size: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Draw n_samples responses per query (paper §3.2 uses 10), on the
    params' device. Sample s of batch i draws from a generator seeded by
    (seed, s, i), so a call is reproducible under one seed.

    Returns (responses (N, n_samples, T) int32, lengths (N, n_samples))."""
    gen = build_generate_fn(bundle, max_new_tokens, temperature)
    dev = next(params.parameters()).device
    g = torch.Generator(device=dev)
    N = len(query_tokens)
    out = np.zeros((N, n_samples, max_new_tokens), np.int32)
    lens = np.zeros((N, n_samples), np.int32)
    for s in range(n_samples):
        for i in range(0, N, batch_size):
            chunk = torch.as_tensor(
                np.asarray(query_tokens[i:i + batch_size]), device=dev)
            g.manual_seed(_stream_seed(seed & 0xFFFFFFFF, s, i))
            toks, ln = gen(params, {"tokens": chunk}, g)
            out[i:i + batch_size, s] = toks.cpu().numpy()
            lens[i:i + batch_size, s] = ln.cpu().numpy()
    return out, lens
