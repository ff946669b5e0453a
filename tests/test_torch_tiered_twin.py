"""The tiered twin's (``examples/tiered_serving_torch.py``) cheaper tiers
as the JAX package trains them, served by the port on the CPU with the
reference's greedy tokens, request by request. fp32 at "highest" matmul
precision on both sides, one PyTorch thread."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.experiment import train_tier_lms as jax_train_tier_lms
from repro.models import build_model as jax_build_model
from repro.serving import ContinuousEngine as JaxContinuousEngine
from repro_torch import bridge
from repro_torch.data.tasks import generate_dataset
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ContinuousEngine
from test_torch_serving import _synchronous


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_tiered_twin_tiers_serve_the_reference_tokens(one_thread):
    """The tiered twin's tiny and small tiers as the JAX package trains
    them (``build_experiment(seed=1, steps_scale=0.2)``'s
    ``train_tier_lms``), bridged into the port, serve the twin's 64 test
    queries (PAD tails trimmed, as the pool trims them) with the
    reference's greedy tokens, request by request. The streams that stop
    at their first token are the reference's own; the twin's escalation
    pass calibrates on the small streams that decode past it."""
    rng = np.random.default_rng(2)        # the twin's splits: seed + 1
    generate_dataset(rng, 300)
    generate_dataset(rng, 200)
    test = generate_dataset(rng, 150)
    rows = [q[:np.flatnonzero(m)[-1] + 1].astype(np.int32)
            for q, m in zip(test.query[:64], test.query_mask[:64])]

    def serve(eng):
        reqs = [eng.submit(r) for r in rows]
        eng.run()
        return [[int(t) for t in r.out] for r in reqs]

    with jax.default_matmul_precision("highest"):
        lms, _ = jax_train_tier_lms(("tiny", "small"), 1, steps_scale=0.2)
        outs = {}
        for t, lm in lms.items():
            cfg = dataclasses.replace(lm.cfg, cache_layout="paged")
            kw = dict(max_new_tokens=12, n_slots=8, max_seq=64)
            want = serve(_synchronous(JaxContinuousEngine(
                jax_build_model(cfg), lm.params, **kw)))
            pcfg = ArchConfig(**dataclasses.asdict(cfg))
            module = bridge.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, lm.params), pcfg, "cpu")
            got = serve(ContinuousEngine(build_model(pcfg), module, **kw))
            assert got == want, t
            outs[t] = got
    assert any(len(o) > 1 for o in outs["small"])
