"""Architecture configuration schema (a copy of ``repro.models.config``).

``ArchConfig`` keeps the reference's fields, names and defaults one for one,
so a reference config converts with ``ArchConfig(**dataclasses.asdict(c))``.
The helpers are those the port's serving path reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Configuration for one model architecture.

    Families: dense | moe | ssm | hybrid | vlm | audio (the port builds
    ``dense`` and ``ssm`` so far; see ``models.model.build_model``).

    ``use_pallas`` is kept for the 1:1 conversion and selects nothing here:
    in the port a tensor's device decides between a kernel and its plain
    version (CUDA tensors launch the kernel, CPU tensors take the plain
    PyTorch version).
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int  # logical vocabulary

    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0          # N: state size per head
    ssm_headdim: int = 64       # P: channels per SSD head
    ssm_expand: int = 2         # d_inner = expand * d_model
    ssm_chunk: int = 256        # SSD chunk length
    ssm_conv_width: int = 4     # short causal conv width

    # --- attention pattern ---
    sliding_window: int = 0       # >0: window size for "local" attention layers
    local_global_ratio: int = 0   # gemma3: N local layers per 1 global layer (=5)
    attn_every: int = 0           # jamba: one attention layer per this many layers (=8)
    attn_offset: int = 4          # jamba: index of the attn layer within each block
    moe_every: int = 0            # jamba: MoE FFN every this many layers (=2)
    qkv_bias: bool = False

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500           # encoder feature length (stub conv frontend output)

    # --- modality frontend stubs ---
    frontend: str = "none"        # none | vision_stub | audio_stub
    num_frontend_tokens: int = 0  # prepended embedding tokens (vlm)

    # --- misc ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "float32"        # activation / param dtype
    vocab_pad_multiple: int = 256

    # --- long-context serving (beyond-paper substrate feature) ---
    long_context_window: int = 8192
    attention_sink: int = 128

    # --- execution knobs ---
    remat: bool = False           # remat each scanned layer
    use_pallas: bool = False      # selects nothing in the port (see above)
    attn_chunk: int = 1024        # query-chunk size for memory-bounded attention

    # --- KV-cache layout (serving) ---
    cache_layout: str = "dense"   # dense: per-request (B, max_seq) slab;
    #                               paged: shared block pool + page table
    #                               (continuous-batching serving path)
    kv_page_size: int = 16        # tokens per KV page when cache_layout="paged"
    prefill_chunk: int = 16       # chunked-prefill width for the continuous
    #                               engine (query tokens admitted per chunk;
    #                               0 = one-shot whole-prompt prefill)

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def supports_paged_kv(self) -> bool:
        """True if the continuous-batching paged serving path covers this
        architecture (see ``paged_unsupported_reason``)."""
        return self.paged_unsupported_reason is None

    @property
    def paged_unsupported_reason(self) -> Optional[str]:
        """Why the continuous paged engine cannot serve this config, or
        None when it can: encoder–decoder stacks and modality frontends are
        excluded, as in the reference."""
        if self.is_encoder_decoder:
            return ("encoder-decoder: cross-attention reads fixed encoder "
                    "memory, not a per-token paged cache")
        if self.frontend != "none":
            return (f"frontend={self.frontend}: frontend embeddings occupy "
                    "cache entries outside the engine's token accounting")
        return None

    @property
    def has_window_layers(self) -> bool:
        """True when any attention layer masks by a sliding window."""
        return any(self.layer_window(i) > 0 for i in range(self.n_layers))

    def layer_window(self, i: int) -> int:
        """Sliding-window size of attention layer ``i`` (0 = global or not
        an attention layer)."""
        kind = self.layer_kind(i)
        if not kind["attn"] or kind["global_attn"]:
            return 0
        return self.sliding_window

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        D, H, K, Dh, F = self.d_model, self.n_heads, self.n_kv_heads, self.resolved_head_dim, self.d_ff
        emb = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
        if self.qkv_bias:
            attn += (H + 2 * K) * Dh
        dense_ffn = 3 * D * F
        moe_ffn = self.n_experts * 3 * D * F + D * self.n_experts  # experts + gate
        ssm = 0
        if self.ssm_state > 0:
            di, N, G = self.ssm_expand * D, self.ssm_state, 1
            nh = di // self.ssm_headdim
            ssm = D * (2 * di + 2 * G * N + nh) + di * self.ssm_conv_width \
                + 2 * nh + di + di * D
        norms = 2 * D
        total = emb
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            p = norms
            if kind["attn"]:
                p += attn
            if kind["ssm"]:
                p += ssm
            if kind["moe"]:
                p += moe_ffn
            elif kind["ffn"]:
                p += dense_ffn
            total += p
        if self.is_encoder_decoder:
            enc = self.n_enc_layers * (attn + dense_ffn + norms)
            cross = self.n_layers * (attn + D)
            total += enc + cross
        return int(total)

    def layer_kind(self, i: int) -> dict:
        """What layer ``i`` contains: attention / ssm mixer, moe or dense ffn."""
        if self.family == "ssm":
            return dict(attn=False, ssm=True, moe=False, ffn=False, global_attn=False)
        if self.family == "hybrid":
            is_attn = self.attn_every > 0 and (i % self.attn_every) == self.attn_offset
            is_moe = self.moe_every > 0 and (i % self.moe_every) == 1
            return dict(attn=is_attn, ssm=not is_attn, moe=is_moe, ffn=not is_moe,
                        global_attn=is_attn)
        is_moe = self.n_experts > 0
        if self.local_global_ratio > 0:
            is_global = (i % (self.local_global_ratio + 1)) == self.local_global_ratio
        else:
            is_global = True
        return dict(attn=True, ssm=False, moe=is_moe, ffn=not is_moe,
                    global_attn=is_global)
