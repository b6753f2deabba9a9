"""Hand-written CUDA kernels (``csrc/``) for the SJPC, estimator and
attention paths, their ctypes wrappers, the plain PyTorch versions in
:mod:`.ref`, and the registry (:mod:`.registry`) through which :mod:`.ops`
dispatches them."""
