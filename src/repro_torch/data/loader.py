"""Host-side streaming loader: seeded token batches placed on a device.

``token_batches`` is the JAX package's infinite iterator of {tokens,
labels} numpy batches (labels = tokens shifted left), built on
``data.synthetic.zipf_tokens``: the same seed gives the same tokens, bit
for bit.  ``to_device`` takes the place of ``sharded_put`` without a
sharding.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import platform
from .synthetic import zipf_tokens


def token_batches(batch: int, seq: int, vocab: int, *, seed: int = 0,
                  dup_fraction: float = 0.05):
    rng = np.random.default_rng(seed)
    while True:
        toks = zipf_tokens(rng, batch, seq + 1, vocab, dup_fraction=dup_fraction)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def to_device(batch: dict, device=None) -> dict:
    """A host batch's arrays as tensors on ``device`` (None: the CUDA
    card), dtypes kept."""
    device = platform.resolve(device)
    return {k: torch.from_numpy(np.array(v, order="C")).to(device) for k, v in batch.items()}
