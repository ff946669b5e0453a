"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no biases. [hf:CohereForAI/c4ai-command-r-v01 family]

A copy of ``repro/configs/command_r_plus_104b.py``, as the reference
declares it."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    tie_embeddings=True,   # command-r ties embeddings
    rope_theta=1e6,
)
