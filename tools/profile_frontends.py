#!/usr/bin/env python3
"""Where the time goes on the port's encoder-decoder and vision-frontend
paths, on one CUDA card.

Run from the root of a checkout:  python3 tools/profile_frontends.py [whisper] [internvl2]

chip_smoke.py phase 4h's serves, through the bundle and
``build_generate_fn`` with each family's inputs, 16 requests and 32
greedy tokens: whisper-large-v3 as published (stub frame embeddings of
1500 frames, 48-token prompts) and internvl2-26b at every width cut to 8
layers (256 stub patch embeddings, 256-token prompts), or the families
named (both where none is). For each: the prefill alone (wall time,
device busy time and device time by kernel), then what
tools/profile_qwen.py measures over the whole serve: a warm-up serve, a
timed serve, a serve traced with device activity only (busy time, idle
share, device time by kernel) and one traced with host ops and shapes
(the host op behind each of the five largest kernels).

The traces go to build/profile/ (ignored by git); the last line of the
output is one JSON object with every number. It imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def frontend_setup(torch, cs, family: str):
    """Phase 4h's model and inputs for ``family`` on the card: (bundle,
    model, inputs)."""
    from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2
    from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER
    from repro_torch.models.frontends import make_batch
    from repro_torch.models.model import build_model
    dev = torch.device("cuda")
    if family == "whisper":
        cfg, seed, prompt = WHISPER, 600, 48
    else:
        cfg = dataclasses.replace(INTERNVL2, n_layers=cs.INTERNVL2_LAYERS)
        seed, prompt = 700, 256
    bundle = build_model(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(seed), dev)
    inputs = make_batch(torch.Generator(device=dev).manual_seed(seed + 1),
                        cfg, cs.N_PROMPTS, prompt, for_train=False,
                        device=dev)
    return bundle, model, inputs


def profile_family(torch, cs, profile_qwen, profile_ssm, family: str):
    from repro_torch.serving.generate import build_generate_fn
    bundle, model, inputs = frontend_setup(torch, cs, family)
    cfg = bundle.cfg
    max_seq = inputs["tokens"].shape[1] + cfg.frontend_positions \
        + cs.NEW_TOKENS

    def prefill():
        with torch.no_grad():
            bundle.prefill(model, inputs, max_seq)

    prefill()
    walls = [profile_ssm._wall_ms(torch, prefill)[0] for _ in range(3)]
    busy, by_name = profile_ssm._profiled(torch, f"{family}_prefill",
                                          prefill)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    log(f"[{family}] prefill alone: {', '.join(f'{w:.1f}' for w in walls)} "
        f"ms; traced: device busy {busy:.1f} ms")
    for k, (n, t) in top:
        log(f"[{family}]   prefill {t:9.3f} ms  {n:6d} x  {k[:150]}")
    gen = build_generate_fn(bundle, cs.NEW_TOKENS, 0.0)
    dev = inputs["tokens"].device

    def serve():
        toks, lens = gen(model, inputs,
                         torch.Generator(device=dev).manual_seed(0))
        return types.SimpleNamespace(lengths=lens.cpu().numpy())

    out = profile_qwen.profile_path(torch, profile_ssm, "serve", serve,
                                    prefix=family)
    out["prefill"] = dict(wall_ms=walls, busy_ms=busy,
                          kernels=[dict(name=k[:160], launches=n,
                                        device_ms=t) for k, (n, t) in top])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_frontends: no CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    import profile_qwen
    import profile_ssm
    families = sys.argv[1:] or ["whisper", "internvl2"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile_ssm.OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    from repro_torch.kernels import build
    build.build_all()
    result = dict(card=smi, serve={})
    for family in families:
        result["serve"][family] = profile_family(torch, cs, profile_qwen,
                                                 profile_ssm, family)
        torch.cuda.empty_cache()
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
