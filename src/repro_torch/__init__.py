"""repro_torch -- the SJPC similarity (self-)join size estimator in PyTorch.

A port of :mod:`repro` (JAX) to PyTorch with hand-written CUDA kernels for
Hopper (sm_90a).  Module names mirror the JAX package so each module's
counterpart is easy to find.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the kernel registry
(:mod:`.kernels.registry`) runs each kernel's plain PyTorch version on CPU
tensors and the kernel on CUDA tensors.
"""
