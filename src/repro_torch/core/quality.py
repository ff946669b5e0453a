"""Response-quality metrics q(z) (paper §2.3; the port of
``repro.core.quality``).

The paper uses the BART score — the mean token log-likelihood a scorer LM
assigns to text. Offline there are two analogues:

  * ``edit_similarity``: -normalized Levenshtein distance between response
    and reference token sequences, in [-1, 0]. Cheap, deterministic, and
    monotone in correctness for the synthetic task suite — the primary
    metric (plays the role BART score plays in the paper). A copy of the
    reference's numpy code.
  * ``scorer_loglik``: mean token log-prob of the response under a trained
    scorer LM conditioned on the query — *exactly* BARTScore's functional
    form, through the scorer's teacher-forced ``forward``.
"""
from __future__ import annotations

import numpy as np
import torch


def edit_distance_batch(a: np.ndarray, a_len: np.ndarray,
                        b: np.ndarray, b_len: np.ndarray) -> np.ndarray:
    """Levenshtein distance between padded int sequences, vectorised over the
    batch with a numpy DP over the shorter axis. a: (N, La), b: (N, Lb)."""
    N, La = a.shape
    Lb = b.shape[1]
    # dp[j] for each batch row; iterate rows of the DP table
    dp = np.broadcast_to(np.arange(Lb + 1)[None, :], (N, Lb + 1)).astype(np.int32)
    dp = np.array(dp)
    # mask positions beyond b_len so they never help
    for i in range(1, La + 1):
        prev = dp
        dp = np.empty_like(prev)
        dp[:, 0] = i
        sub = (a[:, i - 1][:, None] != b).astype(np.int32)  # (N, Lb)
        dp[:, 1:] = np.minimum(
            np.minimum(prev[:, 1:] + 1,          # delete from a
                       prev[:, :-1] + sub),      # substitute
            np.full((N, Lb), 10 ** 9, np.int32))
        # insertion needs a left-to-right pass
        for j in range(1, Lb + 1):
            dp[:, j] = np.minimum(dp[:, j], dp[:, j - 1] + 1)
        # rows of a beyond a_len: freeze at previous values
        beyond = (i > a_len)
        dp[beyond] = prev[beyond]
    # result at column b_len per row
    return dp[np.arange(N), b_len]


def edit_similarity(resp: np.ndarray, resp_len: np.ndarray,
                    ref: np.ndarray, ref_len: np.ndarray) -> np.ndarray:
    """q(z) = -editdist(z, ref) / max(|z|, |ref|) ∈ [-1, 0]."""
    d = edit_distance_batch(resp, resp_len, ref, ref_len).astype(np.float64)
    denom = np.maximum(np.maximum(resp_len, ref_len), 1)
    return (-d / denom).astype(np.float32)


@torch.no_grad()
def scorer_loglik(scorer_bundle, scorer_params, queries, responses,
                  resp_mask) -> np.ndarray:
    """BARTScore-form quality: mean log p_scorer(z_t | x, z_<t).

    queries: (N, Lq); responses: (N, Lr); resp_mask: (N, Lr) 1=real token
    (arrays or tensors), run on the scorer's device. Returns (N,)
    float32."""
    dev = next(scorer_params.parameters()).device
    queries = torch.as_tensor(queries, device=dev).long()
    responses = torch.as_tensor(responses, device=dev).long()
    resp_mask = torch.as_tensor(resp_mask, device=dev).float()
    tokens = torch.cat([queries, responses], dim=1)
    logits, _ = scorer_bundle.forward(scorer_params, {"tokens": tokens})
    logits = logits.float()
    Lq = queries.shape[1]
    # logits at position i predict token i+1
    pred = logits[:, Lq - 1:-1]                      # predicts responses[:, :]
    logz = torch.logsumexp(pred, dim=-1)
    ll = torch.gather(pred, -1, responses[..., None])[..., 0]
    tok_ll = (ll - logz) * resp_mask
    denom = torch.clamp(resp_mask.sum(-1), min=1.0)
    return (tok_ll.sum(-1) / denom).cpu().numpy().astype(np.float32)
