"""whisper-large-v3 [audio] — encoder-decoder, 32+32L d_model=1280 20H
(kv=20) d_ff=5120 vocab=51866; mel+conv frontend is a stub supplying 1500
frame embeddings to the (fully implemented) transformer encoder.
[arXiv:2212.04356]

Shape adaptation (DESIGN.md): decode_32k / long_500k size the DECODER
self-attention cache (long-form segmented transcription); the cross-attention
memory stays enc_seq=1500.

A copy of ``repro/configs/whisper_large_v3.py``, as the reference
declares it."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,       # padded to 51968 for sharding
    is_encoder_decoder=True,
    enc_seq=1500,           # 30 s of audio after conv frontend
    frontend="audio_stub",
)
