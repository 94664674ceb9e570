"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5, d_head=64)
d_ff=5504 vocab=32001, ssm_state=16 — parallel attention + mamba heads
within each layer [arXiv:2411.13676].  The attention branch uses Hymba's
sliding window (full-attention layers and meta tokens simplified away, as
in the JAX package)."""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_head=64, d_ff=5504, vocab=32001,
    swa_window=1024,
    ssm=SSMConfig(d_state=16, d_head=64, expand=2, chunk=128))


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=5, n_kv_heads=1,
        d_head=16, d_ff=128, vocab=256, swa_window=32,
        ssm=SSMConfig(d_state=8, d_head=16, expand=2, chunk=32))
