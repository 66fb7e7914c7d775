"""PyTorch + CUDA port of the hybrid dual-batch / cyclic-progressive
training system (the JAX package ``repro`` is its reference).

The port mirrors ``repro``'s layout and names.  Parameters are plain
dicts/lists of tensors in the JAX pytree structure and shapes (HWIO
convolutions, NHWC images at the public functions); every entry point
takes an explicit ``device`` and ``torch.Generator`` and runs on the card
unless the caller asks for the CPU.  The server-update kernels of the flat
store are hand-written for Hopper (``csrc/dbl_merge.cu``); their plain
PyTorch versions run only for tensors that lie on the CPU.

This package imports ``torch``, numpy and the standard library only —
never ``jax`` and nothing of ``repro``.
"""
__version__ = "0.1.0"
