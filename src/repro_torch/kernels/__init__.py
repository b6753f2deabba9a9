"""Hand-written CUDA kernels (``csrc/``) for the SJPC main path, their
ctypes wrappers, and the plain PyTorch versions in :mod:`.ref`."""
