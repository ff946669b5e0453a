"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave (one attn
layer per 8, at in-block offset 4), MoE every other layer. [arXiv:2403.19887]

Adaptation: the Mamba mixer is our SSD (Mamba-2) layer with Jamba's state
size 16 — see DESIGN.md §3.

A copy of ``repro/configs/jamba_v01_52b.py``, as the reference declares it."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    attn_every=8,
    attn_offset=4,
    moe_every=2,
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,   # §Perf: halves SSD decay-tile traffic (∝ S·l·H)
)
