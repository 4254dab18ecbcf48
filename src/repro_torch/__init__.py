"""PyTorch/CUDA port of the repro package (see README, "PyTorch/CUDA port").

Imports torch and never jax, and nothing of the JAX package ``repro``.
"""
