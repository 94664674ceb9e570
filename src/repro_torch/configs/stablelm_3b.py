"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm family]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab=50304,
    rope_theta=1e4)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=108, vocab=256)
