"""Named RPU device presets + textual policy specs for CLIs.

Same presets and spec grammar as the JAX package's ``analog/presets.py``:

  ``digital``            keep the matched layers digital (FP)
  ``rpu_baseline``       Table 1 verbatim
  ``nm_bm``              + noise & bound management (Fig. 6)
  ``managed``            + update management with BL=1 (NM+BM+UM)
  ``fig4_no_variation``  managed, device variations eliminated (Fig. 4 black)
  ``k2_multi_device``    managed + 13-device mapping (paper's K2 recipe)
  ``lm_managed``         managed, normalized for LM tiles (f32, seeded maps)
  ``noise_free``         analog data path with every stochastic/bounding
                         element off — equal to the digital dense layer

A preset reference may carry ``name:field=value:...`` modifiers
(``lm_managed:use_pallas=true:bm_mode=two_phase``).  :func:`parse_policy`
turns a full spec — a bare preset reference, inline ``pattern=spec`` rules,
or a JSON rules file — into an :class:`~repro_torch.analog.policy.
AnalogPolicy`.  A bare preset maps to rule ``*`` (every dense site).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

from repro_torch.analog.policy import REGEX_PREFIX, AnalogPolicy, AnalogRule
from repro_torch.core import device as dev
from repro_torch.core.device import RPUConfig

_PRESETS: Dict[str, Callable[[], Optional[RPUConfig]]] = {
    "digital": lambda: None,
    "rpu_baseline": dev.rpu_baseline,
    "nm_bm": dev.rpu_nm_bm,
    "managed": dev.rpu_nm_bm_um_bl1,
    "fig4_no_variation": lambda: dev.rpu_nm_bm_um_bl1().without_variations(),
    "k2_multi_device": lambda: dev.rpu_full(13),
    "lm_managed": lambda: dev.rpu_nm_bm_um_bl1().normalized_for_lm(),
    "noise_free": lambda: (dev.rpu_baseline().without_read_noise()
                           .without_out_bound().without_variations()),
}

def preset_names() -> List[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> Optional[RPUConfig]:
    try:
        factory = _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown analog preset {name!r}; known: "
                       f"{preset_names()}") from None
    return factory()


_FIELD_NAMES = {f.name for f in dataclasses.fields(RPUConfig)}


def _coerce(field: str, value: str):
    if field not in _FIELD_NAMES:
        raise KeyError(f"RPUConfig has no field {field!r}")
    v = value.strip()
    if field == "tile_grid":
        r, c = v.lower().split("x")
        return (int(r), int(c))
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("none", "null"):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v                      # strings (bm_mode=two_phase)


def resolve_spec(spec: str) -> Optional[RPUConfig]:
    """``name[:field=value]*`` -> config (None for the digital preset)."""
    parts = spec.split(":")
    cfg = get_preset(parts[0].strip())
    mods = [p for p in parts[1:] if p]
    if mods and cfg is None:
        raise ValueError(f"digital preset takes no modifiers: {spec!r}")
    for kv in mods:
        if "=" not in kv:
            raise ValueError(f"bad modifier {kv!r} in {spec!r} "
                             "(expected field=value)")
        k, v = kv.split("=", 1)
        k = k.strip()
        val = _coerce(k, v)
        # validated constructors where they exist
        if k == "tile_grid" and val is not None:
            cfg = cfg.with_tile_grid(*val)
        elif k in ("update_chunk", "conv_stream_chunk") and val is not None:
            cfg = cfg.with_streaming(**{k: val})
        else:
            cfg = dataclasses.replace(cfg, **{k: val})
    return cfg


def _rule(pattern: str, spec: str) -> AnalogRule:
    return AnalogRule(pattern.strip(), resolve_spec(spec), spec.strip())


def parse_policy(spec: str) -> AnalogPolicy:
    """CLI/text -> :class:`AnalogPolicy` (see module docstring)."""
    spec = spec.strip()
    if spec.endswith(".json") or os.path.isfile(spec):
        with open(spec) as f:
            data = json.load(f)
        entries = data["rules"] if isinstance(data, dict) else data
        rules = []
        for e in entries:
            if isinstance(e, dict):
                rules.append(_rule(e["pattern"], e.get("preset",
                                                       e.get("spec"))))
            else:
                rules.append(_rule(e[0], e[1]))
        return AnalogPolicy(rules=tuple(rules))
    if "," in spec:
        rules = tuple(_rule(*part.split("=", 1))
                      for part in spec.split(",") if part.strip())
        return AnalogPolicy(rules=rules)
    if "=" in spec:
        # a single inline rule ("*attn*=managed") vs a bare preset with
        # modifiers ("managed:bm_mode=two_phase"): glob patterns never
        # contain ':' (regex patterns announce themselves with 're:')
        head = spec.split("=", 1)[0]
        if ":" not in head or head.startswith(REGEX_PREFIX):
            return AnalogPolicy(rules=(_rule(*spec.split("=", 1)),))
    cfg = resolve_spec(spec)
    if cfg is None:
        return AnalogPolicy()          # all-digital: no rules
    return AnalogPolicy(rules=(AnalogRule("*", cfg, spec),))


def describe_cfg(cfg: Optional[RPUConfig]) -> str:
    """One-line knob summary for resolved-policy tables."""
    if cfg is None:
        return "fp (digital)"
    bits = [f"bl={cfg.bl}",
            f"nm={'on' if cfg.noise_management else 'off'}",
            f"bm={cfg.bm_mode if cfg.bound_management else 'off'}",
            f"um={'on' if cfg.update_management else 'off'}"]
    if cfg.devices_per_weight != 1:
        bits.append(f"#_d={cfg.devices_per_weight}")
    if cfg.dw_min_dtod == 0 and cfg.w_bound_dtod == 0:
        bits.append("no-dtod")
    if cfg.tile_grid and tuple(cfg.tile_grid) != (1, 1):
        bits.append(f"grid={cfg.tile_grid[0]}x{cfg.tile_grid[1]}")
    if cfg.update_chunk:
        bits.append(f"chunk={cfg.update_chunk}")
    if cfg.use_pallas:
        bits.append("cuda")
    if cfg.seeded_maps:
        bits.append("seeded")
    return " ".join(bits)
