"""Symbol-level tokenizer for the synthetic instruction suite.

Fixed vocabulary: special tokens, task markers, digits, letters. Small enough
that in-framework LMs train to competence in a few hundred CPU steps, which is
what lets the reproduction use *real* model-behaviour quality gaps.
"""
from __future__ import annotations


import numpy as np

PAD, BOS, EOS, SEP = 0, 1, 2, 3
N_SPECIAL = 4
N_TASKS = 8  # task marker ids N_SPECIAL .. N_SPECIAL+N_TASKS-1
CHAR_BASE = N_SPECIAL + N_TASKS

DIGITS = "0123456789"
LETTERS = "abcdefghijklmnopqrstuvwxyz"
CHARS = DIGITS + LETTERS
VOCAB_SIZE = CHAR_BASE + len(CHARS)  # 48


def char_id(c: str) -> int:
    return CHAR_BASE + CHARS.index(c)


def task_id(t: int) -> int:
    return N_SPECIAL + t


def encode_chars(s: str) -> list[int]:
    return [char_id(c) for c in s]


def decode(ids) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i == EOS:
            break
        if i >= CHAR_BASE:
            out.append(CHARS[i - CHAR_BASE])
        elif N_SPECIAL <= i < CHAR_BASE:
            out.append(f"<task{i - N_SPECIAL}>")
        elif i == SEP:
            out.append("|")
    return "".join(out)


def pad_to(ids: list[int], length: int) -> tuple[np.ndarray, int]:
    n = min(len(ids), length)
    arr = np.full((length,), PAD, np.int32)
    arr[:n] = ids[:n]
    return arr, n
