"""PyTorch port of the SE3ET serving forward for NVIDIA Hopper.

Mirrors the layout of the JAX package ``se3et_tpu`` (the reference) and
imports nothing of it: the numpy modules it needs (``core/{anchors,
kernel_points,harmonics}``, ``data/{pipeline,host_ops,native_bridge}`` and
the synthetic pair generator) are copies kept equal to the originals by
``tests/test_torch_shared_copies.py``; see README.md, "PyTorch / H100 port".
"""
