"""--arch registry: resolves architecture ids to configs.

Each ``configs/<id>.py`` exports ``CONFIG`` (published numbers) and
``smoke_config()``.  The dense models deepseek_7b, qwen1_5_110b,
qwen3_14b and stablelm_3b, the ssm model mamba2_130m, the hybrid
hymba_1_5b and the encoder-decoder seamless_m4t_medium are ported so far.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

ARCH_IDS: List[str] = ["deepseek_7b", "qwen1_5_110b", "stablelm_3b",
                       "qwen3_14b", "mamba2_130m", "seamless_m4t_medium",
                       "hymba_1_5b"]

_ALIASES = {"deepseek-7b": "deepseek_7b", "qwen1.5-110b": "qwen1_5_110b",
            "stablelm-3b": "stablelm_3b", "qwen3-14b": "qwen3_14b",
            "mamba2-130m": "mamba2_130m",
            "seamless-m4t-medium": "seamless_m4t_medium",
            "hymba-1.5b": "hymba_1_5b"}


def canonical(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch '{name}'; known: {ARCH_IDS}")
    return name


def get_config(name: str, smoke: bool = False, analog_policy=None):
    """Resolve an arch id; ``analog_policy`` (an AnalogPolicy or a textual
    spec) attaches per-layer analog rules to the returned config."""
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    if analog_policy is not None:
        if isinstance(analog_policy, str):
            from repro_torch.analog.presets import parse_policy
            analog_policy = parse_policy(analog_policy)
        cfg = dataclasses.replace(cfg, analog_policy=analog_policy)
    return cfg
