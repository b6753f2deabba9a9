"""Batched ingest of SJPC streams: the per-(stream, round) key grid and the
multi-round, multi-stream update (a partial port of the JAX package's
``service/ingest.py``; its ``IngestPipeline`` is not ported yet).

The JAX package consumes all R coalesced rounds of a flush for S streams in
one jit'd dispatch: ``lax.scan`` over rounds, ``vmap`` over streams.  Here
that is a Python loop over rounds and over streams, since the SJPC kernels
take one stream's counters: each (round, stream) cell is one
``sjpc.update_fused`` (the ``sample_weights`` and ``fused_ingest`` kernels
on the card, the cell's key read there from one upload of the key grid) or, with
``use_fused=False``, one per-level ``sjpc.update`` whose scatter is the
``sketch_update`` op (the conformance path).  Both give the same counters
for the same keys.

Sharding: with ``shards > 1`` every round's B rows split into ``shards``
slices, each folded into a shard-local delta sketch under the key
``fold_in(round_key, shard)``; the deltas merge once after all rounds
(counters add, n and steps sum), as in the JAX package.

Determinism: stream u's i-th consumed round uses ``ingest_key(cfg, uid,
i)``, a pure function, so a window can be rebuilt offline bit-exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import prng, sjpc
from ..core.hashing import as_field_tensor
from ..core.sjpc import SJPCConfig, SJPCParams, SJPCState
from ..kernels.ops import make_sjpc_update_fn

_INGEST_SALT = 0x5E41CE


def ingest_key(cfg: SJPCConfig, uid: int, round_idx: int) -> torch.Tensor:
    """The key stream u folds into its round_idx-th ingest round."""
    base = prng.PRNGKey(cfg.seed ^ _INGEST_SALT)
    return prng.fold_in(prng.fold_in(base, uid), round_idx)


def ingest_key_grid(seed: int, uids, round_idx) -> torch.Tensor:
    """Vectorized :func:`ingest_key`: uids (S,), round_idx (R, S) -> keys
    (R, S, 2) on the CPU, each ``fold_in(fold_in(PRNGKey(seed), uid),
    round)``."""
    round_idx = torch.tensor(np.asarray(round_idx), dtype=torch.int64)
    uids = torch.broadcast_to(torch.tensor(np.asarray(uids), dtype=torch.int64)[None, :],
                              round_idx.shape)
    base = torch.broadcast_to(prng.PRNGKey(seed), tuple(round_idx.shape) + (2,))
    return prng.fold_in(prng.fold_in(base, uids), round_idx)


def _one_stream(cfg, params, use_fused, impl, counters, n, step, values, mask, key):
    state = SJPCState(counters, n, step)
    if use_fused:
        state = sjpc.update_fused(cfg, params, state, values, key=key, row_mask=mask, impl=impl)
    else:
        state = sjpc.update(cfg, params, state, values, key=key, row_mask=mask, impl=impl,
                            update_fn=make_sjpc_update_fn(impl=impl))
    return state


def multi_round_update(cfg: SJPCConfig, params: SJPCParams, counters, n, steps, values,
                       row_mask, keys, *, impl: str | None = None, use_fused: bool = True,
                       shards: int = 1):
    """Every round of a flush for every stream of a group.

    counters (S, L, t, w) int32; n (S,) float32; steps (S,) int32 on the
    device of the counters; values (R, S, B, d) uint32 data; row_mask
    (R, S, B); keys (R, S, 2).  Returns the updated (counters, n, steps).
    ``impl`` names the kernel implementation of every op (None resolves
    from the device).  ``shards > 1`` needs B % shards == 0.
    """
    device = counters.device
    values = as_field_tensor(values, device)
    row_mask = torch.as_tensor(row_mask).to(device=device, dtype=torch.int32)
    keys = torch.as_tensor(keys, dtype=torch.int64).cpu()
    R, S, B, _ = values.shape
    if shards == 1:
        keys = keys.to(device)   # one upload; the draws read each cell's key there
        for r in range(R):
            states = [_one_stream(cfg, params, use_fused, impl, counters[s], n[s], steps[s],
                                  values[r, s], row_mask[r, s], keys[r, s])
                      for s in range(S)]
            counters = torch.stack([st.counters for st in states])
            n = torch.stack([st.n for st in states])
            steps = torch.stack([st.step for st in states])
        return counters, n, steps

    if B % shards:
        raise ValueError(f"batch of {B} rows does not split into {shards} shards")
    per = B // shards
    # every shard's key fold_in(round_key, shard), for all cells at once
    # on the host, then one upload
    shard_keys = torch.stack([prng.fold_in(keys, torch.full(keys.shape[:-1], j))
                              for j in range(shards)]).to(device)
    delta = [[SJPCState(torch.zeros_like(counters[s]), torch.zeros_like(n[s]),
                        torch.zeros_like(steps[s])) for s in range(S)] for _ in range(shards)]
    for r in range(R):
        for j in range(shards):
            rows = slice(j * per, (j + 1) * per)
            for s in range(S):
                st = delta[j][s]
                delta[j][s] = _one_stream(cfg, params, use_fused, impl, st.counters, st.n,
                                          st.step, values[r, s, rows], row_mask[r, s, rows],
                                          shard_keys[j, r, s])
    # the deferred merge: one reduction over the shard axis for all rounds
    dc = torch.stack([torch.stack([st.counters for st in shard]) for shard in delta])
    dn = torch.stack([torch.stack([st.n for st in shard]) for shard in delta])
    dstep = torch.stack([torch.stack([st.step for st in shard]) for shard in delta])
    return counters + dc.sum(dim=0, dtype=torch.int32), n + dn.sum(dim=0), \
        steps + dstep.sum(dim=0, dtype=torch.int32)
