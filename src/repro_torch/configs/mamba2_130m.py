"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060]."""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_head=64, expand=2, chunk=128))


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256,
        ssm=SSMConfig(d_state=16, d_head=16, expand=2, chunk=32))
