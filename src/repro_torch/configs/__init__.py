"""Architecture registry (a copy of the reference's ``repro.configs``,
without its workload-shape table): an architecture id resolves to its
:class:`~repro_torch.models.config.ModelConfig`.  The config files are
pure data.  The port runs the attention architectures; the others
resolve here but their mixers are not ported yet (ROADMAP queue 1
item 12)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "gemma3-12b": "gemma3_12b",
    "starcoder2-3b": "starcoder2_3b",
    "internlm2-1.8b": "internlm2_1_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "hubert-xlarge": "hubert_xlarge",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-2b": "internvl2_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str, **over) -> ModelConfig:
    return reduced(get_config(arch), **over)
