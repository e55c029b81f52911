"""wenet_tpu_torch: the PyTorch/CUDA port of wenet_tpu for NVIDIA Hopper.

Mirrors the module layout of `wenet_tpu`.  The JAX package stays the
reference; this package imports torch and never jax.
"""

__version__ = '0.1.0'
