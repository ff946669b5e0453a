"""Synthetic MixInstruct-analogue: instruction tasks with graded difficulty.

Queries span five task types; like MixInstruct's real-world mix, some are easy
enough that a small model matches the large one (copy/reverse of short
strings) and some reliably separate capacities (sorting, modular arithmetic,
long payloads). Query = [BOS, <task>, payload…, SEP]; reference = answer+[EOS].
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import tokenizer as tok


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    tid: int
    min_len: int
    max_len: int


TASKS = [
    TaskSpec("copy", 0, 2, 8),       # easy
    TaskSpec("reverse", 1, 2, 8),    # easy-medium
    TaskSpec("shift1", 2, 2, 8),     # medium: caesar-shift letters by 1
    TaskSpec("sort", 3, 3, 10),      # hard
    TaskSpec("sumdigits", 4, 3, 10), # hard: sum of digits mod 10
]


def _payload(rng: np.random.Generator, spec: TaskSpec) -> str:
    n = int(rng.integers(spec.min_len, spec.max_len + 1))
    if spec.name == "sumdigits":
        return "".join(rng.choice(list(tok.DIGITS), n))
    return "".join(rng.choice(list(tok.LETTERS), n))


def _answer(spec: TaskSpec, payload: str) -> str:
    if spec.name == "copy":
        return payload
    if spec.name == "reverse":
        return payload[::-1]
    if spec.name == "shift1":
        return "".join(chr((ord(c) - 97 + 1) % 26 + 97) for c in payload)
    if spec.name == "sort":
        return "".join(sorted(payload))
    if spec.name == "sumdigits":
        return str(sum(int(c) for c in payload) % 10)
    raise ValueError(spec.name)


@dataclasses.dataclass
class QueryDataset:
    """Padded arrays for N queries."""
    query: np.ndarray        # (N, Lq) int32
    query_len: np.ndarray    # (N,)
    query_mask: np.ndarray   # (N, Lq) float32
    ref: np.ndarray          # (N, Lr) int32  (answer + EOS)
    ref_len: np.ndarray      # (N,)
    task: np.ndarray         # (N,) task index

    def __len__(self):
        return len(self.query)

    def subset(self, idx) -> "QueryDataset":
        return QueryDataset(self.query[idx], self.query_len[idx],
                            self.query_mask[idx], self.ref[idx],
                            self.ref_len[idx], self.task[idx])


def generate_dataset(rng: np.random.Generator, n: int, q_len: int = 16,
                     r_len: int = 16, task_mix: list[float] | None = None
                     ) -> QueryDataset:
    probs = np.asarray(task_mix if task_mix is not None
                       else [1 / len(TASKS)] * len(TASKS))
    probs = probs / probs.sum()
    qs, qls, refs, rls, tids = [], [], [], [], []
    for _ in range(n):
        ti = int(rng.choice(len(TASKS), p=probs))
        spec = TASKS[ti]
        payload = _payload(rng, spec)
        ans = _answer(spec, payload)
        q_ids = [tok.BOS, tok.task_id(spec.tid)] + tok.encode_chars(payload) \
            + [tok.SEP]
        r_ids = tok.encode_chars(ans) + [tok.EOS]
        qa, ql = tok.pad_to(q_ids, q_len)
        ra, rl = tok.pad_to(r_ids, r_len)
        qs.append(qa)
        qls.append(ql)
        refs.append(ra)
        rls.append(rl)
        tids.append(ti)
    query = np.stack(qs)
    qlen = np.asarray(qls, np.int32)
    mask = (np.arange(q_len)[None, :] < qlen[:, None]).astype(np.float32)
    return QueryDataset(query, qlen, mask, np.stack(refs),
                        np.asarray(rls, np.int32), np.asarray(tids, np.int32))


def lm_training_arrays(ds: QueryDataset) -> dict:
    """Teacher-forced LM arrays: tokens = query + ref, loss on ref positions."""
    N, Lq = ds.query.shape
    Lr = ds.ref.shape[1]
    tokens = np.concatenate([ds.query, ds.ref], axis=1)
    labels = np.concatenate([tokens[:, 1:],
                             np.full((N, 1), tok.PAD, np.int32)], axis=1)
    pos = np.arange(Lq + Lr)[None, :]
    # Queries are padded to Lq; serving prefills the full padded query, so the
    # first answer token is predicted from position Lq-1. Supervise positions
    # Lq-1 .. Lq+ref_len-2 (the answer tokens incl. EOS).
    loss_mask = ((pos >= Lq - 1)
                 & (pos < Lq + ds.ref_len[:, None] - 1)
                 & (labels != tok.PAD))
    return {"tokens": tokens, "labels": labels,
            "loss_mask": loss_mask.astype(np.float32)}
