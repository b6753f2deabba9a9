"""Public entry points of the port's kernels (the SJPC kernels and flash
attention, forward and backward), dispatched through the kernel registry
(:mod:`.registry`).

The same names and positional arguments as the JAX package's
``kernels.ops``, and ``sample_weights``, SJPC's projection sampling (in the
JAX package plain jnp code that XLA compiles).  Every op registers two
implementations: ``torch_ref`` (the plain version of :mod:`.ref`, any
device) and ``cuda_sm90`` (the hand-written kernel, CUDA tensors only).  A
call goes by the device of its tensors -- CPU tensors run the plain
version, CUDA tensors the kernel, ``meta`` tensors the op's shape function
(``work.SHAPES``) -- unless the caller names ``impl=`` for
that call.  Every call counts
``kernel_dispatch_total{kernel, impl}`` in the default metrics registry.

Inputs may be tensors or numpy arrays; numpy arrays go to the device of the
first tensor argument (or the default device when there is none).  Field
data (records, masks, ids, bases, coefficients, fingerprints) is carried as
int64, weights and counters as int32.
"""
from __future__ import annotations

import torch

from .. import platform
from ..core.hashing import as_field_tensor
from ..obs.metrics import default_registry
from . import fingerprint as _fingerprint
from . import flash_attention as _flash_attention
from . import flash_attention_bwd as _flash_attention_bwd
from . import fused_ingest as _fused_ingest
from . import fused_pairs as _fused_pairs
from . import fused_query as _fused_query
from . import ref
from . import sample_weights as _sample_weights
from . import sketch_moments as _sketch_moments
from . import sketch_update as _sketch_update
from . import work
from .registry import kernel_registry

_REG = kernel_registry()
PROBS_DTYPES = (torch.float32, torch.bfloat16)   # flash attention's probs_dtype


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


def _dispatch(op: str, device: torch.device, impl: str | None):
    """Select one call's implementation and count it; under
    ``launch.roofline.count_cost`` the call is costed by the op's own
    formula (``work.WORK``), not by the operations the implementation
    issues."""
    name, fn = _REG.select(op, device, impl)
    metrics = default_registry()
    if metrics.enabled:
        metrics.inc("kernel_dispatch_total", kernel=op, impl=name)
    return work.observe(op, fn)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def fingerprint(values, combo_masks, combo_ids, bases, *, impl=None):
    """(B, d) records -> two (B, M) sub-value fingerprints."""
    device = _device(values, combo_masks, combo_ids, bases)
    run = _dispatch("fingerprint", device, impl)
    return run(*(_field(x, device) for x in (values, combo_masks, combo_ids, bases)))


def fused_ingest(counters, values, masks, ids, bases, bucket_coeffs, sign_coeffs, weights, *,
                 impl=None):
    """Fused fingerprint -> multi-level sketch ingest, one launch.

    Padded-lattice layout (``projections.padded_lattice``): counters
    (L, t, w), values (B, d), masks (L, m_max, d), ids (L, m_max), coeffs
    (L, t, 2, 4), weights (B, L, m_max), 0 in the padded slots (the kernel
    reads only each level's C(d, k) combinations).  Returns new counters.
    """
    device = _device(counters, values)
    run = _dispatch("fused_ingest", device, impl)
    field = (_field(x, device) for x in (values, masks, ids, bases, bucket_coeffs, sign_coeffs))
    return run(_int32(counters, device), *field, _int32(weights, device))


def sample_weights(key, batch, d, s, ratio, *, step=None, row_mask=None, impl=None):
    """SJPC's sampling weights of one round: (batch, L, m_max) int32 over
    the padded lattice of levels s..d, 0 in padded slots.

    ``key`` is (2,) key data; with ``step`` (an int32 scalar tensor) the
    round's key is ``fold_in(key, step)``, derived where the draws run, so
    a key and step on the card are never read on the host.  ``row_mask``
    ((batch,), optional) multiplies each row.  Runs on the key's device."""
    device = _device(key, step, row_mask)
    run = _dispatch("sample_weights", device, impl)
    key = _field(key, device).reshape(2)
    if step is not None:
        step = torch.as_tensor(step).to(device=device, dtype=torch.int32).reshape(())
    if row_mask is not None:
        row_mask = _int32(row_mask, device).reshape(batch)
    return run(key, step, row_mask, batch, d, s, ratio)


def fused_query(counters_a, counters_b=None, *, impl=None):
    """(N, L, t, w) counter stacks -> (N, L, t) float32 row moments: F2
    when ``counters_b`` is None, else the inner products."""
    device = _device(counters_a, counters_b)
    run = _dispatch("fused_query", device, impl)
    a = _int32(counters_a, device)
    b = a if counters_b is None else _int32(counters_b, device)
    return run(a, b)


def sketch_update(counters, fp1, fp2, params, weights=None, *, impl=None):
    """Fast-AGMS update of one (t, w) sketch with flat fingerprint keys;
    ``params`` has ``bucket_coeffs`` and ``sign_coeffs`` (t, 2, 4).
    ``weights`` None means weight 1 for every key."""
    device = _device(counters, fp1)
    run = _dispatch("sketch_update", device, impl)
    fp1 = _field(fp1, device).reshape(-1)
    fp2 = _field(fp2, device).reshape(-1)
    if weights is None:
        weights = torch.ones(fp1.shape, dtype=torch.int32, device=device)
    return run(_int32(counters, device), fp1, fp2,
                     _field(params.bucket_coeffs, device), _field(params.sign_coeffs, device),
                     _int32(weights, device).reshape(-1))


def sketch_moments(counters_a, counters_b=None, *, impl=None):
    """Row inner products of (t, w) sketches -> (t,) float32; F2 when
    ``counters_b`` is None."""
    device = _device(counters_a, counters_b)
    run = _dispatch("sketch_moments", device, impl)
    a = _int32(counters_a, device)
    b = a if counters_b is None else _int32(counters_b, device)
    return run(a, b)


def fused_pairs(items, valid, *, impl=None):
    """All-pairs similarity histograms of stacked samples.

    items (..., R, d) uint32 data, valid (..., R) -> (..., d+1) int32
    counts of ordered valid pairs agreeing on exactly k columns.  Extra
    leading dims collapse into the kernel's N axis and come back on the
    output, so the bootstrap's (streams, replicates) stack is one launch.
    An empty sample (R == 0) gives the zero histogram, and the call is
    still counted.
    """
    device = _device(items, valid)
    items = _field(items, device)
    valid = _int32(valid, device)
    lead = tuple(items.shape[:-2])
    R, d = items.shape[-2:]
    if tuple(valid.shape) != lead + (R,):
        raise ValueError(f"valid {tuple(valid.shape)} does not match items "
                         f"{tuple(items.shape)}")
    run = _dispatch("fused_pairs", device, impl)
    if R == 0:
        return torch.zeros(lead + (d + 1,), dtype=torch.int32, device=device)
    out = run(items.reshape(-1, R, d), valid.reshape(-1, R))
    return out.reshape(lead + (d + 1,))


def flash_attention(q, k, v, *, causal=True, block_q=512, block_k=512,
                    probs_dtype=torch.float32, impl=None):
    """Online-softmax attention in the model's layout: q (B, Sq, H, hd),
    k/v (B, Skv, KV, hd), float32 or bfloat16 -> (B, Sq, H, hd) in q's
    dtype; query head h reads KV head h // (H // KV); causal masking is
    top-left aligned.  ``probs_dtype`` (float32 or bfloat16) is the type P
    and V are rounded to before ``P V``; the softmax itself is float32.

    The JAX package's preconditions hold on both tiers and raise
    ``ValueError``: after ``min(block, length)``, Sq is a multiple of
    ``block_q`` and Skv of ``block_k``, and H a multiple of KV.  The plain
    version computes in those blocks; the kernel chooses its own tiles.
    With bf16 probabilities the kernel rounds P at its row's final max, the
    plain version at its key blocks' running maxima: the same where
    ``block_k`` covers Skv.

    Differentiable on both tiers: with grad mode on and an input that
    requires grad, the call goes through an ``autograd.Function`` whose
    forward also returns the rows' log-sum-exp and whose backward is the
    ``flash_attention_bwd`` op (dQ, dK, dV recomputed from it), of the
    same tier.  Otherwise it is the forward alone, with no saved tensors.
    """
    if probs_dtype not in PROBS_DTYPES:
        raise ValueError(f"probs_dtype {probs_dtype}: expected one of {PROBS_DTYPES}")
    device = _device(q, k, v)
    grad = torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                           for x in (q, k, v))
    q, k, v = (torch.as_tensor(x).to(device).contiguous() for x in (q, k, v))
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         f"expected (B, Sq, H, hd) and two equal (B, Skv, KV, hd)")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    skv, kv = k.shape[1], k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    block_q, block_k = min(block_q, sq), min(block_k, skv)
    if block_q <= 0 or block_k <= 0 or sq % block_q or skv % block_k:
        raise ValueError(f"blocks ({block_q}, {block_k}) do not tile ({sq}, {skv})")
    if grad:
        return _FlashAttention.apply(q, k, v, causal, block_q, block_k, probs_dtype, impl)
    run = _dispatch("flash_attention", device, impl)
    return run(q, k, v, causal=causal, block_q=block_q, block_k=block_k,
               probs_dtype=probs_dtype)


class _FlashAttention(torch.autograd.Function):
    """The flash op under autograd: the forward op of the call's tier
    returns ``(out, lse)`` and saves ``q, k, v, out, lse``; the backward
    runs the ``flash_attention_bwd`` op of the same tier.  Under
    ``torch.utils.checkpoint`` the recomputed forward comes here again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, probs_dtype, impl):
        run = _dispatch("flash_attention", q.device, impl)
        out, lse = run(q, k, v, causal=causal, block_q=block_q, block_k=block_k,
                       probs_dtype=probs_dtype, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block_q, block_k, probs_dtype, impl)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k, probs_dtype, impl = ctx.args
        run = _dispatch("flash_attention_bwd", q.device, impl)
        dq, dk, dv = run(q, k, v, out, lse, dout.to(q.dtype).contiguous(), causal=causal,
                         block_q=block_q, block_k=block_k, probs_dtype=probs_dtype)
        return dq, dk, dv, None, None, None, None, None


def make_sjpc_update_fn(*, impl=None):
    """An ``update_fn`` for :func:`repro_torch.core.sjpc.update` that runs
    the ``sketch_update`` op."""
    def fn(counters, fp1, fp2, level_params, weights):
        return sketch_update(counters, fp1, fp2, level_params, weights, impl=impl)
    return fn


# ---------------------------------------------------------------------------
# registrations: nine ops, each a kernel, its plain version and its shapes
# ---------------------------------------------------------------------------

def _register_all(reg=_REG) -> None:
    for op, oracle, kernel in (
            ("fingerprint", ref.fingerprint_ref, _fingerprint.fingerprint),
            ("flash_attention", ref.flash_attention_ref, _flash_attention.flash_attention),
            ("flash_attention_bwd", ref.flash_attention_bwd_ref,
             _flash_attention_bwd.flash_attention_bwd),
            ("fused_ingest", ref.fused_ingest_ref, _fused_ingest.fused_ingest),
            ("fused_pairs", ref.fused_pairs_ref, _fused_pairs.fused_pairs),
            ("fused_query", ref.fused_query_ref, _fused_query.fused_query),
            ("sample_weights", ref.sample_weights_ref, _sample_weights.sample_weights),
            ("sketch_moments", ref.sketch_moments_ref, _sketch_moments.sketch_moments),
            ("sketch_update", ref.sketch_update_ref, _sketch_update.sketch_update)):
        reg.register(op, kernel=kernel, oracle=oracle, shape=work.SHAPES[op])


_register_all()
