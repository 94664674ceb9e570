"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — encoder-decoder, multimodal; the speech frontend is a stub
(precomputed frame embeddings) [arXiv:2308.11596].  '12L' maps to 12
encoder + 12 decoder layers (the M4T-medium layout), as in the JAX
package."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio", n_layers=12,
    encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, frontend="audio_stub")


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256)
