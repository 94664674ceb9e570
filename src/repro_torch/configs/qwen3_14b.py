"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA, head_dim=128 [hf:Qwen/Qwen3 family]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=17408, vocab=151936,
    d_head=128, qk_norm=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=136, vocab=256)
