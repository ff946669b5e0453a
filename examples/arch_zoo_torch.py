"""Architecture-zoo demo through the PyTorch port, on the card by default:
every assigned architecture (reduced variant) runs a forward pass, a train
step, and a short generation through the SAME public API.

Run: PYTHONPATH=src python examples/arch_zoo_torch.py [--arch gemma3-4b]
     [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.frontends import make_batch
from repro_torch.models.model import build_model
from repro_torch.serving.generate import build_generate_fn
from repro_torch.training.optim import AdamWConfig, init_opt_state
from repro_torch.training.trainer import make_lm_train_step, trainable


def demo(arch: str, device="cuda"):
    """One forward, one AdamW step on softmax_xent + 0.01 * aux, and an
    8-token generation at temperature 0.7 for ``arch``'s reduced config.
    Returns (loss, generated tokens)."""
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    t0 = time.time()
    model = m.init(torch.Generator(device).manual_seed(0), device)
    batch = make_batch(torch.Generator(device).manual_seed(1), cfg, 2, 16,
                       device=device)
    with torch.no_grad():
        m.forward(model, batch)
    ocfg = AdamWConfig(lr=1e-3, total_steps=10)
    opt = init_opt_state(dict(model.named_parameters()), ocfg)
    step = make_lm_train_step(m, ocfg, aux_weight=0.01)
    with trainable(model):
        model, opt, met = step(model, opt, batch)
    loss = float(met["loss"] + 0.01 * met["aux"])

    gen = build_generate_fn(m, 8, temperature=0.7)
    inf = {k: v for k, v in batch.items() if k not in ("labels", "loss_mask")}
    toks, _ = gen(model, inf, torch.Generator(device).manual_seed(2))
    print(f"{arch:24s} [{cfg.family:6s}] loss={loss:6.2f} "
          f"gen={tuple(toks.shape)} ({time.time() - t0:.1f}s)")
    return loss, toks


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    for arch in ([args.arch] if args.arch else ARCH_IDS):
        demo(arch, args.device)


if __name__ == "__main__":
    main()
