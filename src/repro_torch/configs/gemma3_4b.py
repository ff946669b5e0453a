"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt family card]

A copy of ``repro/configs/gemma3_4b.py``, as the reference declares it."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,       # gemma3 local-layer window
    local_global_ratio=5,      # 5 local : 1 global
    rope_theta=1e6,
    tie_embeddings=True,       # gemma ties embeddings
)
