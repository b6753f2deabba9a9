"""4-universal hashing over GF(2^31 - 1) on int64 tensors.

The JAX package computes ``a * b mod p`` in pure uint32 with 16-bit limbs
(the TPU has no 64-bit multiplier).  PyTorch's CPU kernels offer no shift,
add or comparison on ``uint32``, so the plain versions here carry field
elements as **int64**: for canonical a, b < 2^31 the product fits in int64
and ``a * b % p`` is the same canonical value the limb arithmetic gives.
Raw uint32 inputs (record columns) are int64 tensors in [0, 2^32).  The
CUDA kernels use 32x32->64-bit multiplies instead (``kernels/csrc/field.cuh``).

Degree-3 Carter-Wegman polynomials keep 4-universality exact over the
Mersenne-31 field; double fingerprinting compensates the narrow field.
"""
from __future__ import annotations

import numpy as np
import torch

# Mersenne prime 2^31 - 1.
P31 = 0x7FFFFFFF


def reduce_p31(x: torch.Tensor) -> torch.Tensor:
    """Reduce int64 values in [0, 2^32) into the canonical range [0, p)."""
    return torch.remainder(x, P31)


def mulmod_p31(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod p for canonical a, b in [0, p)."""
    return torch.remainder(a * b, P31)


def addmod_p31(a: torch.Tensor, b) -> torch.Tensor:
    """(a + b) mod p for canonical a, b in [0, p)."""
    return torch.remainder(a + b, P31)


def cw_hash(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Degree-3 Carter-Wegman polynomial hash: 4-universal on [0, p).

    ``coeffs``: (..., 4) canonical field elements, broadcast against ``x``.
    """
    h = coeffs[..., 3]
    h = addmod_p31(mulmod_p31(h, x), coeffs[..., 2])
    h = addmod_p31(mulmod_p31(h, x), coeffs[..., 1])
    return addmod_p31(mulmod_p31(h, x), coeffs[..., 0])


def cw_hash_pair(x: torch.Tensor, y: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """4-universal hash of a pair of field elements; ``coeffs`` (..., 2, 4)."""
    return addmod_p31(cw_hash(x, coeffs[..., 0, :]), cw_hash(y, coeffs[..., 1, :]))


def hash_bucket(h: torch.Tensor, width: int) -> torch.Tensor:
    """Bucket in [0, width) (int64, an index); width must be a power of two."""
    return torch.bitwise_and(h, width - 1)


def hash_sign(h: torch.Tensor) -> torch.Tensor:
    """±1 as int32."""
    return (1 - torch.bitwise_and(h, 1) * 2).to(torch.int32)


def random_field_elements(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform elements of [0, p) as a uint32 numpy array (host-side init)."""
    return rng.integers(0, P31, size=shape, dtype=np.uint32)


def as_field_tensor(x, device) -> torch.Tensor:
    """uint32 data (numpy array or tensor, any integer dtype) as an int64
    tensor in [0, 2^32) on ``device`` -- negative int32 wraps, like JAX's
    ``astype(uint32)``.  Host data goes to ``device`` as its 4-byte words
    and is widened there (half the bytes of an int64 upload:
    ``tools/ab_record_upload.py``)."""
    if not isinstance(x, torch.Tensor):
        words = np.require(np.asarray(x).astype(np.uint32, copy=False), requirements=("C", "W"))
        x = torch.from_numpy(words.view(np.int32)).to(device)
    return torch.bitwise_and(x.to(device=device, dtype=torch.int64), 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# NumPy uint64 oracles.
# ---------------------------------------------------------------------------

def np_mulmod_p31(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ((a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(P31)).astype(np.uint32)


def np_cw_hash(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    p = np.uint64(P31)
    x64 = x.astype(np.uint64)
    c = coeffs.astype(np.uint64)
    h = np.broadcast_to(c[..., 3], np.broadcast_shapes(x64.shape, c[..., 3].shape)).copy()
    for i in (2, 1, 0):
        h = (h * x64 + c[..., i]) % p
    return h.astype(np.uint32)
