"""cartnet_tpu_torch: the PyTorch/CUDA port of cartnet_tpu for NVIDIA Hopper.

The JAX package ``cartnet_tpu`` is the reference; this package imports none
of it (nor JAX). Plain tensor code is PyTorch; every Pallas kernel on the
ported path is a hand-written CUDA kernel under ``csrc/``, built with nvcc at
first use (``ops/kernels/_build.py``). Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
