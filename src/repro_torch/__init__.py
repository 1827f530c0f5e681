"""PyTorch/CUDA port of the Aquifer snapshot data plane.

A second package beside the JAX reference ``repro``, laid out module for
module like it.  Page bytes live in ``torch.uint8`` tensors on a device
(``device="cuda"`` by default; pass ``device="cpu"`` explicitly to run the
plain versions on the CPU), control state stays in host numpy, and the hot
path runs through hand-written CUDA kernels (``kernels/``).  This package
never imports ``jax`` or ``repro``.
"""
