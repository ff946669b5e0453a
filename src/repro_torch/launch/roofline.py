"""Roofline terms from dry-run records (the port of
``repro.launch.roofline``), with an NVIDIA H100 SXM's constants in place
of the TPU v5e's.

All counter numbers are per device; the formulas divide global
quantities by the device count, which is identical.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: 989.4 TFLOPS dense
# BF16 on the tensor cores, twice the 494.7 TFLOPS dense TF32 figure
PEAK_FLOPS_BF16 = 989e12    # per device
# the same data sheet: 3.35 TB/s of HBM3 on the SXM5 80 GB
HBM_BW = 3.35e12            # bytes/s per device
# the same data sheet: NVLink 900 GB/s per GPU, both directions together
ICI_BW = 450e9              # bytes/s per direction


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float         # global analytic 6ND / 2ND
    hlo_flops_global: float    # the counter's per-device FLOPs x devices
    useful_ratio: float        # model_flops / hlo_flops_global

    def as_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs: 6·N_active·tokens (train) or
    2·N_active·tokens (inference); decode processes one token per
    sequence."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def roofline_terms(cfg, shape, *, flops_per_dev: float,
                   coll_bytes_per_dev: float, hbm_bytes_per_dev: float,
                   n_chips: int) -> Roofline:
    compute_s = flops_per_dev / PEAK_FLOPS_BF16
    memory_s = hbm_bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = flops_per_dev * n_chips
    return Roofline(compute_s, memory_s, collective_s, dominant, mf,
                    hlo_global, mf / hlo_global if hlo_global else 0.0)
