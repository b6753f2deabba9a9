"""Public entry points of the SJPC kernels, dispatching on the device.

The same names and positional arguments as the JAX package's
``kernels.ops``.  Inputs may be tensors or numpy arrays; numpy arrays go to
the device of the first tensor argument (or the default device when there
is none).  Field data (records, masks, ids, bases, coefficients) is carried
as int64, weights and counters as int32.  CPU tensors run the plain PyTorch
versions; CUDA tensors run the hand-written kernels.
"""
from __future__ import annotations

import torch

from .. import platform
from ..core.hashing import as_field_tensor
from .fingerprint import fingerprint as _fingerprint
from .fused_ingest import fused_ingest as _fused_ingest
from .fused_query import fused_query as _fused_query


def _device(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return platform.default_device()


def _field(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.dtype == torch.int64:
        return x.to(device).contiguous()
    return as_field_tensor(x, device).contiguous()


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.int32).contiguous()


def fingerprint(values, combo_masks, combo_ids, bases):
    """(B, d) records -> two (B, M) sub-value fingerprints."""
    device = _device(values, combo_masks, combo_ids, bases)
    return _fingerprint(*(_field(x, device) for x in (values, combo_masks, combo_ids, bases)))


def fused_ingest(counters, values, masks, ids, bases, bucket_coeffs, sign_coeffs, weights):
    """Fused fingerprint -> multi-level sketch ingest, one launch.

    Padded-lattice layout (``projections.padded_lattice``): counters
    (L, t, w), values (B, d), masks (L, m_max, d), ids (L, m_max), coeffs
    (L, t, 2, 4), weights (B, L, m_max).  Returns new counters.
    """
    device = _device(counters, values)
    field = (_field(x, device) for x in (values, masks, ids, bases, bucket_coeffs, sign_coeffs))
    return _fused_ingest(_int32(counters, device), *field, _int32(weights, device))


def fused_query(counters_a, counters_b=None):
    """(N, L, t, w) counter stacks -> (N, L, t) float32 row moments: F2
    when ``counters_b`` is None, else the inner products."""
    device = _device(counters_a, counters_b)
    a = _int32(counters_a, device)
    b = a if counters_b is None else _int32(counters_b, device)
    return _fused_query(a, b)
