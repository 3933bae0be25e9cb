"""Assigned architecture configs (``--arch <id>``), the port's own copy of
``repro/configs``: data only, resolved inside ``repro_torch.configs``.

Each module defines ``config()`` — the exact assigned full-size
architecture (citation in its docstring) — and ``reduced()`` — a tiny
same-family variant (<= 2-layer-ish, d_model <= 512, <= 4 experts, small
vocab) for CPU smoke tests.  ``SUPPORTS_LONG`` marks architectures that run
the long_500k decode shape (sub-quadratic / bounded-KV; see DESIGN.md §6).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = [
    "mixtral_8x22b",
    "mamba2_130m",
    "jamba_1_5_large",
    "gemma_2b",
    "whisper_medium",
    "llama3_2_3b",
    "qwen1_5_4b",
    "gemma3_1b",
    "llama4_scout",
    "llama3_2_vision",
]

# canonical assignment ids -> module names
ALIASES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-130m": "mamba2_130m",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "gemma-2b": "gemma_2b",
    "whisper-medium": "whisper_medium",
    "llama3.2-3b": "llama3_2_3b",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma3-1b": "gemma3_1b",
    "llama4-scout-17b-a16e": "llama4_scout",
    "llama-3.2-vision-11b": "llama3_2_vision",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def supports_long(arch: str) -> bool:
    return getattr(_module(arch), "SUPPORTS_LONG", False)


def shape_applicable(arch: str, shape: str) -> bool:
    """DESIGN.md §6: long_500k only for sub-quadratic/bounded-KV archs."""
    if shape == "long_500k":
        return supports_long(arch)
    return True
