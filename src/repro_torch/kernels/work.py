"""What one call of each kernel op moves and computes, the shapes it
returns, and the peak rates of the card that bound it.

:data:`WORK` maps each op of :mod:`.ops` to a function ``(args, kwargs,
out, exact) -> Work``: the bytes the function must move (each input read
once, each output written once, field data at its uint32 width) and the
operations it does, by the kind of unit that does them (``"int32"`` on
the CUDA cores; ``"bfloat16"`` on the tensor cores, where the f32 flash
kernels count the bf16 products of their split operands).  ``args`` and
``kwargs`` are those the op's implementation is called with (the
registry's calling convention, :mod:`.ref`), ``out`` its result.

Where the work depends on the data -- sampled weights of 0, which the
ingest and scatter kernels skip; a pair sample's valid slots; the records
whose sample keeps none or all of a level's combinations -- ``exact``
counts what these inputs need (the tensors must hold data).  Without it
the count is the part no data can remove, a lower bound that depends on
the shapes alone, so a call costs the same on ``meta``, on the CPU and on
the card (``launch/roofline.py`` counts so).

:data:`SHAPES` maps each op to its shape function: the output tensors, of
the right shapes and dtypes on the inputs' device, and nothing computed --
the registry's ``meta`` tier (``registry.META``), the counterpart of
``jax.eval_shape`` over a ``pallas_call``'s ``out_shape``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import projections as proj

# Peak rates of one H100 SXM5 (80 GB HBM3).
# HBM3 bandwidth: NVIDIA H100 Tensor Core GPU data sheet, "GPU memory
# bandwidth 3.35TB/s" (SXM).
HBM_BYTES_PER_S = 3.35e12
# Dense BF16 tensor-core rate: the same data sheet, "BF16 Tensor Core
# 1,979 teraFLOPS" with sparsity, half of it dense.
BF16_TENSOR_FLOPS_PER_S = 989e12
# FP32 FMA on the CUDA cores, no TF32: 132 SMs x 128 FP32 lanes x 2 flops
# x 1.98 GHz boost clock (NVIDIA H100 Tensor Core GPU Architecture white
# paper, the SM and clock tables).
F32_FLOPS_PER_S = 132 * 128 * 2 * 1.98e9
# 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98 GHz (the
# same white paper).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# NVLink 4: 900 GB/s total per GPU, 450 GB/s in each direction (the data
# sheet's "NVLink: 900GB/s").  A group that crosses an 8-GPU node runs
# over the network, slower than this.
NVLINK_BYTES_PER_S = 450e9

# Rate of each kind of operation :class:`Work` and the roofline count.
RATES = {"bfloat16": BF16_TENSOR_FLOPS_PER_S, "float16": BF16_TENSOR_FLOPS_PER_S,
         "float32": F32_FLOPS_PER_S, "int32": INT32_OPS_PER_S}

# A field element (record column, mask, id, base, hash coefficient,
# fingerprint) is a uint32 in the functions the kernels compute.
FIELD_BYTES = 4
# int32 operations of one threefry2x32 block: 20 rounds of add, rotate and
# xor, and 12 key additions.
THREEFRY_OPS = 72
# The f32 flash kernels do each matrix product as this many bf16 products
# of split operands (three parts each, the pairs whose indices add up to at
# most 2): their work on the tensor cores at f32 precision.
F32_SPLIT_PRODUCTS = 6


class Work(NamedTuple):
    """Bytes moved and operations by kind (a key of :data:`RATES`)."""
    nbytes: int
    ops: dict


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S
             ) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth or operations
    over their peak rate (default the INT32 one), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_ms(work: Work) -> tuple[float, str]:
    """:func:`bound_ms` of a :class:`Work`: each kind's operations at its
    own rate, summed."""
    t_ops = sum(n / RATES[kind] for kind, n in work.ops.items()) * 1e3
    t_bytes = work.nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# formulas
# ---------------------------------------------------------------------------

def attention_work(q, k, causal: bool) -> tuple[int, int]:
    """(bytes, flops) of attention over q (B, Sq, H, hd), k/v (B, Skv, KV,
    hd): q, k and v read once and the output written once; 4 * hd flops
    (two multiply-adds per dimension) per visible (query, key) pair, causal
    masking top-left aligned."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if causal:
        m = min(sq, skv)
        pairs = m * (m + 1) // 2 + (sq - m) * skv
    else:
        pairs = sq * skv
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * hd * b * h * pairs


def _tensor_core(flops: int, dtype) -> dict:
    """Tensor-core work of ``flops`` useful flops on ``dtype`` inputs: the
    f32 kernels' split does F32_SPLIT_PRODUCTS bf16 products for each."""
    return {"bfloat16": flops * (F32_SPLIT_PRODUCTS if dtype == torch.float32 else 1)}


def flash_attention_work(args, kwargs, out, exact=False) -> Work:
    q, k = args[0], args[1]
    nbytes, flops = attention_work(q, k, kwargs.get("causal", True))
    if kwargs.get("return_lse"):
        nbytes += out[1].numel() * 4
    return Work(nbytes, _tensor_core(flops, q.dtype))


def flash_attention_bwd_work(args, kwargs, out, exact=False) -> Work:
    """q, k, v, out and dout read, dq, dk and dv written, lse read; 10 *
    hd flops per visible pair (five products)."""
    q, k, _, _, lse = args[:5]
    _, fwd_flops = attention_work(q, k, kwargs.get("causal", True))
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
    return Work(nbytes, _tensor_core(fwd_flops // 4 * 10, q.dtype))


def _level_k(masks, exact: bool) -> int:
    """The number of columns in each of a level's combinations (masks (M,
    d)): read from the masks with ``exact``, else the fewest columns whose
    combinations number M (C(d, k) = C(d, d - k))."""
    m, d = masks.shape
    if exact:
        return int(masks[0].sum()) if m else 0
    return min((k for k in range(d + 1) if proj.comb(d, k) == m), default=0)


def fingerprint_work(args, kwargs, out, exact=False) -> Work:
    """The records, the level's tables, the bases and the two (B, M)
    fingerprints at uint32 width; two multiply-adds mod p per selected
    column per (record, combination)."""
    values, masks, ids = args[:3]
    b, m = values.shape[0], masks.shape[0]
    nbytes = (values.numel() + masks.numel() + ids.numel() + 2 + 2 * b * m) * FIELD_BYTES
    return Work(nbytes, {"int32": 2 * _level_k(masks, exact) * b * m})


def fused_ingest_work(args, kwargs, out, exact=False) -> Work:
    """The records, each level's C(d, k) live combinations of the tables
    and of the weights (the padded slots carry weight 0 by the op's
    contract and are never read), the coefficients, the counters read and
    written; per live (record, combination) 2k fingerprint and 12 t hash
    operations (``exact``: the weights that are not 0)."""
    counters, values, _, _, _, bucket_coeffs = args[:6]
    weights = args[7]
    L, t, _ = counters.shape
    B, d = values.shape
    s = d - L + 1
    n_live = sum(proj.padded_lattice(d, s).nums)
    nbytes = ((values.numel() + n_live * (d + 1) + 2 + 2 * bucket_coeffs.numel()) * FIELD_BYTES
              + B * n_live * 4 + 2 * counters.numel() * 4)
    ops = 0
    if exact:
        live = (weights != 0).sum(dim=(0, 2)).tolist()
        ops = sum(n * (2 * (s + i) + 12 * t) for i, n in enumerate(live))
    return Work(nbytes, {"int32": ops})


def sampling_blocks(d: int, s: int, ratio: float, batch: int, kept=None,
                    row_mask: bool = False) -> int:
    """threefry2x32 blocks that any implementation of one round's draws
    must run: 1 + 3L for the keys, and per record a level's Bernoulli when
    its sample size has a fraction and its M scores when the record keeps
    neither none nor all of them.  ``kept`` ((B, L), the combinations each
    record keeps) gives the latter from the data; without it a record
    counts its scores only where no draw can keep none or all (and none
    under a ``row_mask``, which may drop the record)."""
    parts = proj.level_sample_parts(d, s, ratio)
    blocks = 1 + 3 * len(parts)
    for idx, (m, lo, frac) in enumerate(parts):
        if lo >= m and frac == 0.0:
            continue
        blocks += batch * (frac > 0.0)
        if kept is not None:
            blocks += m * int(((kept[:, idx] > 0) & (kept[:, idx] < m)).sum())
        elif not row_mask and lo > 0 and lo + (frac > 0.0) < m:
            blocks += m * batch
    return blocks


def sample_weights_work(args, kwargs, out, exact=False) -> Work:
    """The (B, L, m_max) int32 output written once (and 12 bytes of key
    and step); THREEFRY_OPS per :func:`sampling_blocks` block.  The
    selection's compares are not counted: how many there are depends on
    the implementation (a sorting network needs fewer than one per pair of
    combinations)."""
    _, _, row_mask, batch, d, s, ratio = args
    kept = out.sum(dim=2) if exact else None
    blocks = sampling_blocks(d, s, ratio, batch, kept, row_mask is not None)
    return Work(out.numel() * 4 + 12, {"int32": THREEFRY_OPS * blocks})


def sketch_update_work(args, kwargs, out, exact=False) -> Work:
    """The keys (two fingerprints and a weight each), both coefficient
    tables and the counters read and written; 12 operations per row per
    key of weight not 0 (``exact``)."""
    counters, fp1, _, bucket_coeffs, _, weights = args
    t = counters.shape[0]
    n = fp1.numel()
    nbytes = (n * (2 * FIELD_BYTES + 4) + 2 * bucket_coeffs.numel() * FIELD_BYTES
              + 2 * counters.numel() * 4)
    ops = 12 * t * int((weights != 0).sum()) if exact else 0
    return Work(nbytes, {"int32": ops})


def moments_work(args, kwargs, out, exact=False) -> Work:
    """fused_query and sketch_moments: the counters (once for F2, both
    sketches for a join) and the moments written; one multiply-add per
    counter."""
    a, b = args
    reads = a.numel() if b is a else a.numel() + b.numel()
    return Work(reads * 4 + out.numel() * 4, {"int32": a.numel()})


def fused_pairs_work(args, kwargs, out, exact=False) -> Work:
    """The samples at uint32 width, the valid flags and the histograms;
    d compares per unordered valid pair (the histogram is symmetric;
    ``exact``: the valid slots of each sample)."""
    items, valid = args
    N, R, d = items.shape
    ops = 0
    if exact:
        m = (valid != 0).sum(dim=1).to(torch.int64)
        ops = d * int((m * (m - 1) // 2).sum())
    return Work(N * R * d * FIELD_BYTES + N * R * 4 + N * (d + 1) * 4, {"int32": ops})


WORK: dict[str, Callable] = {
    "fingerprint": fingerprint_work,
    "flash_attention": flash_attention_work,
    "flash_attention_bwd": flash_attention_bwd_work,
    "fused_ingest": fused_ingest_work,
    "fused_pairs": fused_pairs_work,
    "fused_query": moments_work,
    "sample_weights": sample_weights_work,
    "sketch_moments": moments_work,
    "sketch_update": sketch_update_work,
}


def op_work(op: str, args, kwargs, out, *, exact: bool = False) -> Work:
    """:class:`Work` of one call of ``op``."""
    return WORK[op](args, kwargs, out, exact)


# ---------------------------------------------------------------------------
# shape functions: the meta tier
# ---------------------------------------------------------------------------

def _empty(shape, dtype, like):
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


def fingerprint_shape(values, combo_masks, combo_ids, bases):
    shape = (values.shape[0], combo_masks.shape[0])
    return _empty(shape, torch.int64, values), _empty(shape, torch.int64, values)


def fused_ingest_shape(counters, values, masks, ids, bases, bucket_coeffs, sign_coeffs,
                       weights):
    return torch.empty_like(counters)


def sample_weights_shape(key, step, row_mask, batch, d, s, ratio):
    lat = proj.padded_lattice(d, s)
    return _empty((batch, len(lat.nums), max(lat.nums)), torch.int32, key)


def sketch_update_shape(counters, fp1, fp2, bucket_coeffs, sign_coeffs, weights):
    return torch.empty_like(counters)


def moments_shape(counters_a, counters_b):
    return _empty(counters_a.shape[:-1], torch.float32, counters_a)


def fused_pairs_shape(items, valid):
    return _empty((items.shape[0], items.shape[2] + 1), torch.int32, items)


def flash_attention_shape(q, k, v, *, causal=True, block_q=512, block_k=512,
                          probs_dtype=torch.float32, return_lse=False):
    out = torch.empty_like(q)
    if not return_lse:
        return out
    b, sq, h, _ = q.shape
    return out, _empty((b, h, sq), torch.float32, q)


def flash_attention_bwd_shape(q, k, v, out, lse, dout, *, causal=True, block_q=512,
                              block_k=512, probs_dtype=torch.float32):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


SHAPES: dict[str, Callable] = {
    "fingerprint": fingerprint_shape,
    "flash_attention": flash_attention_shape,
    "flash_attention_bwd": flash_attention_bwd_shape,
    "fused_ingest": fused_ingest_shape,
    "fused_pairs": fused_pairs_shape,
    "fused_query": moments_shape,
    "sample_weights": sample_weights_shape,
    "sketch_moments": moments_shape,
    "sketch_update": sketch_update_shape,
}


# ---------------------------------------------------------------------------
# observers: the roofline's count of each call
# ---------------------------------------------------------------------------

_OBSERVERS: list = []


def observe(op: str, fn: Callable) -> Callable:
    """``fn`` (one call's implementation of ``op``), reported to the
    innermost active observer (``launch.roofline.count_cost``) when there
    is one: ``observer.kernel_call(op, fn, args, kwargs)`` runs it."""
    if not _OBSERVERS:
        return fn
    observer = _OBSERVERS[-1]

    def call(*args, **kwargs):
        return observer.kernel_call(op, fn, args, kwargs)
    return call
