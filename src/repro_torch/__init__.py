"""repro_torch -- the SJPC similarity (self-)join size estimator in PyTorch.

A port of :mod:`repro` (JAX) to PyTorch with hand-written CUDA kernels for
Hopper (sm_90a).  Module names mirror the JAX package so each module's
counterpart is easy to find.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""
