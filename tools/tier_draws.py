#!/usr/bin/env python3
"""Greedy stream lengths of the tiered twin's LM zoo for one draw of its
initial weights.

Run from the root of a checkout:

    python3 tools/tier_draws.py [--device cuda] [--init cpu|device]

It trains the tiny, small and large tiers as
``examples/tiered_serving_torch.py`` does (``build_experiment(seed=1,
steps_scale=0.2)``: seed 1, the same numpy batches), from initial weights
drawn on the CPU's ``torch.Generator`` and moved (``--init cpu``, what
``train_lm`` does) or on the device's own generator (``--init device``,
which on a card draws another stream from the same seed). Each tier then
serves the twin's 64 test queries greedily, whole rows as
``ContinuousEngine.serve`` takes them, and the script prints its losses,
its length histogram (index = tokens emitted, EOS included), the share
of queries whose first token is EOS and, off the CPU, whether the same
weights served on the CPU emit the same tokens. It imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.experiment import TIERS
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import generate_dataset, lm_training_arrays
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.training.trainer import TrainConfig, seeded_init, train_lm

SEED, STEPS_SCALE = 1, 0.2


def _engine(cfg, module):
    return ContinuousEngine(build_model(dataclasses.replace(
        cfg, cache_layout="paged")), module, max_new_tokens=12, n_slots=8,
        max_seq=64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init", choices=("cpu", "device"), default="cpu")
    args = ap.parse_args(argv)
    dev = args.device
    arrays = lm_training_arrays(generate_dataset(
        np.random.default_rng(SEED), 4000))
    rng = np.random.default_rng(SEED + 1)      # the twin's three splits
    generate_dataset(rng, 300)
    generate_dataset(rng, 200)
    queries = generate_dataset(rng, 150).query[:64]
    for tier in ("tiny", "small", "large"):
        cfg, steps = TIERS[tier]
        bundle = build_model(cfg)
        if args.init == "cpu":
            module = seeded_init(bundle.init, SEED, dev)
        else:
            module = bundle.init(torch.Generator(device=dev)
                                 .manual_seed(SEED), dev)
        t0 = time.monotonic()
        module, hist = train_lm(bundle, arrays, TrainConfig(
            steps=max(20, int(steps * STEPS_SCALE)), batch_size=64, lr=2e-3,
            seed=SEED), params=module)
        wall = time.monotonic() - t0
        resp, lens = _engine(cfg, module).serve(queries)
        line = (f"{dev} init on {args.init} {tier}: {hist[-1]['step'] + 1} "
                f"steps in {wall:.1f} s, losses "
                f"{[round(h['loss'], 4) for h in hist]}; greedy lengths "
                f"{np.bincount(lens, minlength=13).tolist()}; first token "
                f"EOS on {float((resp[:, 0] == tok.EOS).mean()):.2f}")
        if dev != "cpu":
            r_cpu, _ = _engine(cfg, module.to("cpu")).serve(queries)
            line += (f"; the same weights on the cpu emit the same tokens: "
                     f"{bool(np.array_equal(resp, r_cpu))}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
