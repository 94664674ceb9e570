"""repro_torch: the PyTorch + CUDA port of the RPU analog system.

Mirrors the layout of the JAX package ``repro`` module for module; each
Pallas TPU kernel there has a counterpart written by hand for Hopper under
``repro_torch/csrc``.  The port imports neither ``jax`` nor ``repro``.
"""

__version__ = "0.1.0"
