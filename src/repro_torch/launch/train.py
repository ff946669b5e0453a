"""Training launcher (the port of ``repro.launch.train``), on the card
unless ``--device cpu``.

Two modes:
  * --arch <id>: train the REDUCED variant of an assigned architecture on the
    synthetic instruction suite and optionally save it (``--out``) as the
    JAX package's flat ``.npz`` checkpoint.
  * --router PAIR: train the paper's routers for a capacity pair
    (e.g. --router tiny:large), including labels + t* transform.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --router tiny:large
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import bridge
from repro_torch.configs import ARCH_IDS
from repro_torch.core.experiment import build_experiment, train_pair_routers
from repro_torch.core.metrics import drop_at_cost_advantages
from repro_torch.data.tasks import generate_dataset, lm_training_arrays
from repro_torch.models.model import build_model
from repro_torch.serving.generate import check_token_only
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.trainer import TrainConfig, train_lm
from .serve import _reduced, require_device


def train_arch(arch: str, steps: int, out: str | None, device="cuda"):
    """Train ``arch``'s reduced config for ``steps`` steps on ``device``;
    with ``out``, save it in the JAX package's checkpoint layout. Returns
    the trained module."""
    cfg = _reduced(arch)
    bundle = build_model(cfg)
    check_token_only(bundle)   # train_lm feeds tokens only
    ds = generate_dataset(np.random.default_rng(0), 2000)
    model, hist = train_lm(bundle, lm_training_arrays(ds),
                           TrainConfig(steps=steps, batch_size=32, lr=2e-3),
                           device=device)
    print(f"{arch}: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"in {hist[-1]['t']:.0f}s")
    if out:
        save_checkpoint(out, bridge.numpy_from_params(model, cfg))
        print(f"saved {out}")
    return model


def train_router(pair: str, epochs: int, device="cuda"):
    """Train r_det / r_prob / r_trans for ``pair`` ("small:large" tier
    names) and print each one's t* and drops at 10/20/40% cost
    advantage."""
    s, l = pair.split(":")
    exp = build_experiment(seed=0, n_train_queries=600, n_test_queries=300,
                           n_samples=6, steps_scale=0.4, tiers=(s, l),
                           device=device)
    routers = train_pair_routers(exp, s, l, epochs=epochs, device=device)
    qs, ql = exp.qualities[s]["test"], exp.qualities[l]["test"]
    for kind, r in routers.items():
        d = drop_at_cost_advantages(r["scores"]["test"], qs, ql)
        print(f"r_{kind}: t*={r['t_star']:.3f} "
              + " ".join(f"drop@{int(ca*100)}%={d[ca]['drop_pct']:.2f}"
                         for ca in (0.1, 0.2, 0.4)))
    return routers


def main(argv=None):
    """Parse ``argv`` (None: the command line) and train. Returns the
    trained module (``--arch``) or the routers (``--router``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--router", help="small_tier:large_tier")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda",
                    help="where training runs (default: the card)")
    args = ap.parse_args(argv)
    if args.arch:
        return train_arch(args.arch, args.steps, args.out,
                          require_device(args.device))
    if args.router:
        return train_router(args.router, args.epochs,
                            require_device(args.device))
    ap.error("need --arch or --router")


if __name__ == "__main__":
    main()
