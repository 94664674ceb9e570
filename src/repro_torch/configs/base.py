"""Model configuration dataclasses (the dense, ssm, hybrid and audio
families).

Each ``configs/<id>.py`` exports ``CONFIG`` (the published numbers) and
``smoke_config()`` (a reduced same-family config for CPU tests); the
``registry`` resolves ``--arch`` names.  The dense decoder (with QKV bias,
``qkv_bias``: qwen1.5), the Mamba-2 SSD stack (``ssm``) and Hymba's
parallel attention + SSD heads (``hybrid``) are ported, with
sliding-window attention (``swa_window``) and tied embeddings, and the
encoder-decoder (``audio``: ``encoder_layers`` bidirectional blocks over
stub frames through an ``adapter``, the decoder's blocks with cross
attention).  ``kv_cache_quant`` keeps the self-attention KV cache in int8
(``attention.quantize_kv``).  MoE and VLM stacks are not part of this
package yet.

Training: ``remat`` recomputes each layer block in the backward
(``torch.utils.checkpoint``; ``remat_policy='full'``).  The JAX package's
``'dots'`` policy saves the projection outputs through an XLA checkpoint
policy that has no PyTorch counterpart saving the same values; it raises
(ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.analog.policy import AnalogPolicy, AnalogRule
from repro_torch.core.device import RPUConfig

#: The projections the legacy ``ModelConfig.analog`` field forces analog
#: (never the unembed or an adapter).
LEGACY_ANALOG_SCOPE = ("*/attn/*", "*/cross/*", "*/mlp/*", "*/ssm/*",
                       "*/shared/*")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int                 # N (ssm_state)
    d_head: int = 64             # SSD head dim P
    expand: int = 2              # d_inner = expand * d_model
    chunk: int = 128             # SSD chunk length
    d_conv: int = 4              # short causal conv width


#: The families this package runs.
FAMILIES = ("dense", "ssm", "hybrid", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                # qwen1.5: a bias on q, k and v
    qk_norm: bool = False                 # qwen3: RMSNorm of q and k heads
    swa_window: int = 0                   # sliding-window attention (hymba)
    rope_theta: float = 1e4
    tie_embeddings: bool = False          # logits = x @ embed.table.T
    ssm: Optional[SSMConfig] = None       # ssm / hybrid families
    encoder_layers: int = 0               # enc-dec (seamless): encoder depth
    frontend: str = "none"                # none | audio_stub
    norm_eps: float = 1e-5
    # numerics
    param_dtype: torch.dtype = torch.bfloat16
    act_dtype: torch.dtype = torch.bfloat16
    kv_cache_quant: bool = False          # int8 self-attention KV cache
    use_flash_kernel: bool = False        # prefill attention through the
                                          # flash-attention kernel instead
                                          # of the chunked fallback
    # training
    remat: bool = True                    # recompute each layer block
    remat_policy: str = "full"            # 'full' ('dots' is not ported)
    # analog (RPU): dense projections matched by a rule are converted to
    # AnalogState tiles at init (repro_torch.analog.convert)
    analog_policy: Optional[AnalogPolicy] = None
    # analog: DEPRECATED single global RPUConfig on every block projection;
    # resolves to a uniform policy (resolved_analog_policy)
    analog: Optional[RPUConfig] = None

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise NotImplementedError(
                f"family {self.family!r}: the port runs {FAMILIES}; the "
                "moe and vlm families wait (ROADMAP Queue 1, item 6)")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")

    @property
    def uses_analog(self) -> bool:
        return self.analog is not None or self.analog_policy is not None

    def resolved_analog_policy(self) -> Optional[AnalogPolicy]:
        """The per-layer policy, with the legacy ``analog`` field shimmed
        to rules over exactly the block projections it forced analog."""
        if self.analog_policy is not None:
            return self.analog_policy
        if self.analog is not None:
            return AnalogPolicy(rules=tuple(
                AnalogRule(pat, self.analog, "ModelConfig.analog (legacy)")
                for pat in LEGACY_ANALOG_SCOPE))
        return None

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        ffn = 3 * d * self.d_ff
        ssm = 0
        if self.ssm is not None:
            din = self.ssm.expand * d
            ssm = d * (2 * din + 2 * self.ssm.d_state) + din * d
        block = {"ssm": ssm, "hybrid": attn + ffn + ssm}.get(self.family,
                                                             attn + ffn)
        return emb + (self.n_layers + self.encoder_layers) * block

    def active_param_count(self) -> int:
        """Active params per token: all of them (no MoE family here)."""
        return self.param_count()
