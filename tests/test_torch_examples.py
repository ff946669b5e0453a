"""The port's example twins (``examples/*_torch.py``) on the CPU:
``arch_zoo_torch.demo`` for a decoder-only arch and for whisper-large-v3
(one forward, one AdamW step, an 8-token generation), and every twin's
``--help``. Their full runs train an experiment, CPU-minutes as the JAX
package's examples take; they run on the card."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("arch_zoo", "hybrid_serving", "router_comparison", "tiered_serving")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    """One PyTorch thread: the shapes are tiny, and the test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3"])
def test_arch_zoo_demo_on_the_cpu(arch, capsys, one_thread):
    loss, toks = _load("arch_zoo").demo(arch, "cpu")
    assert torch.isfinite(torch.tensor(loss))
    assert toks.shape == (2, 8)
    assert capsys.readouterr().out.startswith(f"{arch:24s} [")


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_and_helps(name):
    """Each twin imports without running (its work is under ``main``) and
    prints its usage with ``--device`` beside the reference's flags."""
    mod = _load(name)
    assert callable(mod.main)
    out = subprocess.run([sys.executable, str(ROOT / "examples"
                                              / f"{name}_torch.py"), "--help"],
                         capture_output=True, text=True, check=True,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")}).stdout
    assert "--device" in out

