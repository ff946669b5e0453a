"""Architecture config registry: --arch <id> resolution (the port of
``repro.configs``).

Each assigned architecture has a module with its exact published config;
``get_config(name)`` resolves by registry id. ``get_pair(name)`` returns the
(small-sibling, full) configs used by hybrid routing for that family.
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig

from .command_r_plus_104b import CONFIG as COMMAND_R_PLUS_104B
from .gemma3_4b import CONFIG as GEMMA3_4B
from .grok_1_314b import CONFIG as GROK_1_314B
from .internvl2_26b import CONFIG as INTERNVL2_26B
from .jamba_v01_52b import CONFIG as JAMBA_V01_52B
from .mamba2_130m import CONFIG as MAMBA2_130M
from .mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from .phi35_moe_42b import CONFIG as PHI35_MOE_42B
from .qwen15_32b import CONFIG as QWEN15_32B
from .whisper_large_v3 import CONFIG as WHISPER_LARGE_V3

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        GROK_1_314B, MISTRAL_LARGE_123B, GEMMA3_4B, INTERNVL2_26B,
        JAMBA_V01_52B, QWEN15_32B, WHISPER_LARGE_V3, MAMBA2_130M,
        COMMAND_R_PLUS_104B, PHI35_MOE_42B,
    ]
}

ARCH_IDS = tuple(ARCHS)


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_pair(name: str, scale: int = 4) -> tuple[ArchConfig, ArchConfig]:
    """(small sibling, large) configs for hybrid routing on this family."""
    large = get_config(name)
    return large.small_sibling(scale), large
