"""mamba2-130m [ssm] — 24L d_model=768, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280. [arXiv:2405.21060]

A copy of ``repro/configs/mamba2_130m.py``, as the reference declares it."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                # no FFN — SSD blocks only
    vocab_size=50280,      # padded to 50432 for sharding
    ssm_state=128,
    ssm_headdim=64,        # d_inner 1536 -> 24 SSD heads
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)
