"""--arch registry: resolves architecture ids to configs.

Each ``configs/<id>.py`` exports ``CONFIG`` (published numbers) and
``smoke_config()``.  Only deepseek_7b is ported so far.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

ARCH_IDS: List[str] = ["deepseek_7b"]

_ALIASES = {"deepseek-7b": "deepseek_7b"}


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
