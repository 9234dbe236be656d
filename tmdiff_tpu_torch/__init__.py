"""PyTorch / CUDA port of tmdiff_tpu for NVIDIA Hopper (H100).

Same layouts and module names as the JAX package, which stays the reference
it is tested against. Entry points run on CUDA unless given `device="cpu"`.
"""
