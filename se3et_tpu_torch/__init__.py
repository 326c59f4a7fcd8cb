"""PyTorch port of the SE3ET serving forward for NVIDIA Hopper.

Mirrors the layout of the JAX package ``se3et_tpu`` (the reference) and
shares only its numpy-only modules; see README.md, "PyTorch / H100 port".
"""
