#!/usr/bin/env python3
"""Run the port's dry run (python -m repro_torch.launch.dryrun) over every
(arch x input shape x mesh) combination, several combinations at a time,
and print one markdown row a record.

Usage (from the root of a checkout; any host, no GPU):
  python3 tools/dryrun_table.py [--jobs 8] [--out build/dryrun_table]
      [--mesh both] [--arch A ...] [--shape S ...] [--no-run] [--by-arch]

Each combination is its own process (the fake process group's size is
the mesh's), started with CUDA hidden; a record already in --out is kept.
The table: arch, shape, mesh, ok, the trace's seconds (the wall a record
took), peak and argument GB a device, the three roofline terms in
seconds and the dominant one; a failed record shows its error.
``--no-run`` prints the table of the records already in --out;
``--by-arch`` prints one row an arch, a column a shape, each cell the
dominant term, peak GB a device and trace seconds on the single and the
multi mesh.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(arch: str, shape: str, mesh: str, out: Path) -> float:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", mesh,
                    "--out", str(out)], env=env, cwd=ROOT,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return time.monotonic() - t0


def row(rec: dict) -> str:
    head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |"
    if not rec.get("ok"):
        err = rec.get("error", "?").replace("|", "/").replace("\n", " ")
        return f"{head} no | | | | | | | {err[:160]} |"
    m, rl = rec["memory"], rec["roofline"]
    return (f"{head} yes | {rec['trace_s']} | {m['peak_gb']:.2f} | "
            f"{m['argument_gb']:.2f} | {rl['compute_s']:.4g} | "
            f"{rl['memory_s']:.4g} | {rl['collective_s']:.4g} | "
            f"{rl['dominant']} |")


def cell(rec: dict) -> str:
    """A record as "dominant peak GB, trace s" (or its failure)."""
    if not rec.get("ok"):
        return "failed"
    short = {"compute": "comp", "memory": "mem", "collective": "coll"}
    return (f"{short[rec['roofline']['dominant']]} "
            f"{rec['memory']['peak_gb']:.2f}, {rec['trace_s']}")


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import INPUT_SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun_table"))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--arch", nargs="*", default=list(ARCH_IDS))
    ap.add_argument("--shape", nargs="*", default=list(INPUT_SHAPES))
    ap.add_argument("--no-run", action="store_true")
    ap.add_argument("--by-arch", action="store_true")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    combos = [(a, s, m) for a in args.arch for s in args.shape
              for m in meshes]
    t0 = time.monotonic()
    if not args.no_run:
        with ThreadPoolExecutor(args.jobs) as pool:
            list(pool.map(lambda c: run(*c, out), combos))
    recs = {}
    for a, s, m in combos:
        path = out / f"{a}__{s}__{m}.json"
        recs[a, s, m] = json.loads(path.read_text()) if path.exists() \
            else {"arch": a, "shape": s, "mesh": m, "error": "no record"}
    failed = sum(not r.get("ok") for r in recs.values())
    if args.by_arch:
        print("| arch | " + " | ".join(args.shape) + " |")
        print("|---" * (len(args.shape) + 1) + "|")
        for a in args.arch:
            print(f"| {a} | " + " | ".join(
                " / ".join(cell(recs[a, s, m]) for m in meshes)
                for s in args.shape) + " |")
    else:
        print("| arch | shape | mesh | ok | trace s | peak GB/dev | "
              "args GB/dev | compute s | memory s | collective s | "
              "dominant |")
        print("|---|---|---|---|---|---|---|---|---|---|---|")
        for rec in recs.values():
            print(row(rec))
    print(f"{len(combos) - failed} of {len(combos)} ok in "
          f"{time.monotonic() - t0:.1f} s with {args.jobs} jobs")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
