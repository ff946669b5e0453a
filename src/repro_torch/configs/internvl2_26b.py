"""internvl2-26b [vlm] — language backbone (InternLM2-20B-class):
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. InternViT-6B vision
encoder + MLP projector are a stub frontend supplying 256 patch embeddings.
[arXiv:2404.16821]

A copy of ``repro/configs/internvl2_26b.py``, as the reference declares it."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,          # padded to 92672 for sharding (see DESIGN.md)
    frontend="vision_stub",
    num_frontend_tokens=256,   # 448px / 14 patch / pixel-shuffle 2x => 256
    rope_theta=1e6,
)
