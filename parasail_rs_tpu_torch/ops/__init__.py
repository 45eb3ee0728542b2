"""Kernels of the PyTorch port: the CUDA sources in ``csrc/``, their
wrappers, their plain PyTorch versions and the build that compiles them."""
