"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768. [hf:mistralai/Mistral-Large-Instruct-2407]

A copy of ``repro/configs/mistral_large_123b.py``, as the reference
declares it."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
)
