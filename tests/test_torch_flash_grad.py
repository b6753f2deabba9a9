"""The flash-attention op's gradients on the CPU: its plain tier through
the op's ``autograd.Function`` against ``jax.vjp`` of the JAX package's
``chunked_attention`` (the function ``jax.value_and_grad`` differentiates
above ``CHUNKED_THRESHOLD``), the forward's ``(out, lse)`` plain version,
and the backward's plain version against torch autograd of the port's own
``chunked_attention``.  The same numpy-seeded inputs and cotangent go to
both packages.  Then the numeric schemes of the backward kernel
(``csrc/flash_attention_bwd.cu``) emulated in plain torch: the f32 one
(three bf16 parts, six partial products, its tiles and order, the long
sums in the accumulator) against ``jax.vjp`` inside the card's f32 gate,
two parts missing it, and the bf16 one (hi/lo P and dS) against the
plain tier inside the card's bf16 gate.

    PYTHONPATH=src python -m pytest tests/test_torch_flash_grad.py
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as kfab  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# Gradients relative to each one's max |x|.  float32 end to end: the two
# packages sum the same products in other orders (observed <= 1e-6).  A
# bf16 input or probs_dtype puts bf16 roundings of dQ, dK, dV, dP and P
# at places that differ by a tile's rescale factor (the port rounds the
# normalised P and the unscaled dP, autograd through the online softmax
# the running ones), and JAX sums a bf16 input's cotangent over the scan
# in bf16: a few bf16 ulps (2^-8 = 3.9e-3 each) at most.
F32_TOL = 1e-5
BF16_TOL = 2e-2

# (b, sq, skv, h, kv, hd, causal, chunk): GQA 1, 2 and 4, Sq != Skv
# without a causal mask (cross-attention), several tiles each way
SHAPES = [(2, 16, 16, 4, 2, 16, True, 8),
          (1, 24, 24, 4, 4, 16, True, 8),
          (2, 16, 32, 8, 2, 32, False, 8),
          (1, 32, 16, 4, 1, 16, False, 16),
          (1, 32, 32, 8, 2, 16, True, 16)]


def _inputs(seed, b, sq, skv, h, kv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd), (b, sq, h, hd))]
    return ([jnp.asarray(a).astype(JAX[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays])


def _rel(got, want) -> float:
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want, np.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_grads(q, k, v, dout, causal, chunk, probs, **kw):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal, block_q=chunk, block_k=chunk,
                              probs_dtype=probs, **kw)
    return out, torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype,probs", [("float32", "float32"), ("float32", "bfloat16"),
                                         ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_plain_tier_gradients_match_jax_vjp(shape, dtype, probs):
    b, sq, skv, h, kv, hd, causal, chunk = shape
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(sum(shape), b, sq, skv, h, kv, hd, dtype)

    def fn(q, k, v):
        return jattn.chunked_attention(q, k, v, causal=causal, q_chunk=chunk, kv_chunk=chunk,
                                       probs_dtype=JAX[probs])

    jout, vjp = jax.vjp(fn, jq, jk, jv)
    jgrads = vjp(jdo)
    out, grads = _port_grads(tq, tk, tv, tdo, causal, chunk, TORCH[probs])
    tol = F32_TOL if dtype == probs == "float32" else BF16_TOL
    assert _rel(out, jout) <= tol
    for name, g, jg in zip("qkv", grads, jgrads):
        assert g.dtype == TORCH[dtype] and tuple(g.shape) == tuple(jg.shape), name
        assert _rel(g, jg) <= tol, (name, _rel(g, jg))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_ref_out_is_chunked_attention_and_lse_is_float64_logsumexp(shape, dtype):
    b, sq, skv, h, kv, hd, causal, chunk = shape
    _, (q, k, v, _) = _inputs(7 + sum(shape), b, sq, skv, h, kv, hd, dtype)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, block_q=chunk,
                                           block_k=chunk)
    want = tattn.chunked_attention(q, k, v, causal=causal, q_chunk=chunk, kv_chunk=chunk)
    assert out.dtype == want.dtype and torch.equal(out, want)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, sq)
    kd = k.double().repeat_interleave(h // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) / np.sqrt(hd)
    if causal:
        s = s.masked_fill(torch.ones(sq, skv, dtype=torch.bool).triu(1), -np.inf)
    exact = torch.logsumexp(s, dim=-1)
    # f32 scores and an f32 running max and sum: a few f32 ulps of |lse|
    assert float((lse.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max() + 1)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype,probs", [("float32", "float32"), ("float32", "bfloat16"),
                                         ("bfloat16", "float32")])
def test_bwd_ref_matches_torch_autograd_of_chunked_attention(shape, dtype, probs):
    b, sq, skv, h, kv, hd, causal, chunk = shape
    _, (q, k, v, dout) = _inputs(11 + sum(shape), b, sq, skv, h, kv, hd, dtype)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    want_out = tattn.chunked_attention(qg, kg, vg, causal=causal, q_chunk=chunk,
                                       kv_chunk=chunk, probs_dtype=TORCH[probs])
    want = torch.autograd.grad(want_out, (qg, kg, vg), dout)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, block_q=chunk,
                                           block_k=chunk, probs_dtype=TORCH[probs])
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, block_q=chunk,
                                      block_k=chunk, probs_dtype=TORCH[probs])
    tol = F32_TOL if dtype == probs == "float32" else BF16_TOL
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    # the ref's own tiles do not move the answer beyond f32 rounding
    other = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                        block_q=max(1, chunk // 2), block_k=chunk * 2,
                                        probs_dtype=TORCH[probs])
    for g, o in zip(got, other):
        assert _rel(o, g) <= tol


def test_no_grad_calls_save_nothing_and_grad_calls_dispatch_the_backward():
    """Without grad (no_grad, or no input that requires grad) the op is
    the forward alone: no graph, no backward dispatch.  With grad, one
    forward and, at backward time, one ``flash_attention_bwd`` dispatch,
    both of the plain tier on the CPU."""
    _, (q, k, v, dout) = _inputs(3, 1, 16, 16, 4, 2, 16, "float32")
    reg = metrics.MetricsRegistry()
    prev = metrics.set_default_registry(reg)
    try:
        plain = ops.flash_attention(q, k, v, block_q=8, block_k=8)
        with torch.no_grad():
            under_no_grad = ops.flash_attention(q.clone().requires_grad_(True), k, v,
                                                block_q=8, block_k=8)
        assert plain.grad_fn is None and under_no_grad.grad_fn is None
        assert torch.equal(plain, under_no_grad)
        out, grads = _port_grads(q, k, v, dout, True, 8, torch.float32)
        assert torch.equal(out, plain)
    finally:
        metrics.set_default_registry(prev)
    counts = {dict(key)["kernel"] + "/" + dict(key)["impl"]: n
              for key, n in reg.series("kernel_dispatch_total").items()}
    assert counts == {"flash_attention/torch_ref": 3, "flash_attention_bwd/torch_ref": 1}


def test_gradients_under_checkpoint_equal_and_recompute_through_the_op():
    """Under ``torch.utils.checkpoint`` the recomputed forward goes
    through the same Function: the gradients equal the plain call's bit
    for bit, and the forward is dispatched twice."""
    _, (q, k, v, dout) = _inputs(5, 2, 16, 16, 4, 1, 16, "float32")
    _, want = _port_grads(q, k, v, dout, True, 8, torch.float32)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    reg = metrics.MetricsRegistry()
    prev = metrics.set_default_registry(reg)
    try:
        out = torch.utils.checkpoint.checkpoint(
            lambda a, b_, c: ops.flash_attention(a, b_, c, block_q=8, block_k=8), qg, kg, vg,
            use_reentrant=False)
        got = torch.autograd.grad(out, (qg, kg, vg), dout)
    finally:
        metrics.set_default_registry(prev)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert reg.counter("kernel_dispatch_total", kernel="flash_attention", impl="torch_ref") == 2


def test_probs_dtype_other_than_f32_or_bf16_raises():
    _, (q, k, v, _) = _inputs(1, 1, 8, 8, 2, 1, 16, "float32")
    with pytest.raises(ValueError, match="probs_dtype"):
        ops.flash_attention(q, k, v, block_q=8, block_k=8, probs_dtype=torch.float16)


# ---------------------------------------------------------------------------
# The backward kernel's numeric schemes, emulated in plain torch on the CPU.
# ---------------------------------------------------------------------------

BWD_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
              / "flash_attention_bwd.cu")
LOG2E = np.float32(1.4426950408889634)


FLUSH_ROWS = 256   # f32: queries (keys) between two flushes of an accumulator


def _kernel_tiles(f32, hd):
    """(keys a dK/dV CTA takes, query rows a step of its walk, keys a step
    of the dQ walk): KvCfg::kKeys, KvCfg::kStep and QCfg::kStep of the
    source."""
    return ((64 if f32 and hd == 128 else 128), (32 if f32 or hd == 128 else 64),
            (32 if f32 and hd == 128 else 64))


def test_emulated_tiles_are_the_sources():
    """The emulation walks the tiles and flushes the kernel's configs name."""
    text = BWD_SOURCE.read_text()
    assert re.findall(r"static constexpr int kKeys = (.*);", text) == ["kRoles ? 64 : 128"]
    assert "static constexpr bool kRoles = kF32 && HD == 128;" in text
    steps = re.findall(r"static constexpr int kStep = (.*);", text)
    assert steps == ["kF32 || HD == 128 ? 32 : 64", "kF32 && HD == 128 ? 32 : 64"], steps
    assert f"constexpr int kFlushRows = {FLUSH_ROWS};" in text


def _split(x, n, keep=None):
    """x in n bf16 parts (f32 tensors), each the round-to-nearest bf16 of
    what the parts before it leave; parts from ``keep`` on are zeros."""
    parts = []
    for j in range(n):
        part = x.to(torch.bfloat16).float()
        parts.append(part if keep is None or j < keep else torch.zeros_like(part))
        x = x - part
    return parts


def _pairs(n_a, n_b):
    """The (left, right) part pairs a product sums, smallest first: part
    indices adding up to less than the larger count (hopper.cuh's term_a,
    term_b for three parts; lo then hi for bf16 fragments on one part)."""
    n = max(n_a, n_b)
    return sorted(((i, j) for i in range(n_a) for j in range(n_b) if i + j < n),
                  key=lambda ij: -sum(ij))


def _rz(x):
    """A float64 tensor in float32, rounded toward zero: the tensor cores'
    accumulating adder (its bias showed on the card, PERF.md)."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _ss(a_parts, b_parts, drop_a=False, drop_b=False):
    """A B^T of two split tiles as the kernel's shared-memory wgmma sums it:
    terms outer, 16-column k-steps inner, each step's 16 exact products
    added to the f32 accumulator and rounded toward zero; terms of a part
    known to be 0 dropped."""
    acc = None
    for i, j in _pairs(len(a_parts), len(b_parts)):
        if (drop_a and i) or (drop_b and j):
            continue
        for c in range(0, a_parts[0].shape[-1], 16):
            step = (a_parts[i][..., c:c + 16].double()
                    @ b_parts[j][..., c:c + 16].double().transpose(-1, -2))
            acc = _rz(step if acc is None else acc.double() + step)
    return acc


def _rs(acc, f_parts, b_parts, drop_a=False):
    """acc + F B of register fragments F (parts) and a split tile B, as the
    register wgmma sums it: into the accumulator, term by term and 16 rows
    of B at a time, each step rounded toward zero."""
    for i, j in _pairs(len(f_parts), len(b_parts)):
        if drop_a and i:
            continue
        for c in range(0, f_parts[0].shape[-1], 16):
            acc = _rz(acc.double() + f_parts[i][..., c:c + 16].double()
                      @ b_parts[j][..., c:c + 16, :].double())
    return acc


class _Sum:
    """A gradient's accumulator over a walk of tiles and, in f32, its
    running sum: every ``flush`` tiles the accumulator is added into the
    running sum (f32, round to nearest; the first flush stores it) and
    zeroed."""

    def __init__(self, shape, flush):
        self.acc, self.run, self.flush, self.tiles = torch.zeros(shape), None, flush, 0

    def tile(self):
        if self.flush and self.tiles and self.tiles % self.flush == 0:
            self.run = self.acc if self.run is None else self.run + self.acc
            self.acc = torch.zeros_like(self.acc)
        self.tiles += 1

    def total(self):
        return self.acc if self.run is None else self.run + self.acc


def _probs(s, lse, scale, visible):
    """P = 2^(fma(s, scale, -lse) * log2 e), 0 where not visible."""
    x = (s.double() * float(scale) - lse.double()).float()
    x = torch.where(visible, x, torch.tensor(-math.inf))
    return torch.exp2(x * torch.tensor(LOG2E))


def _bwd_scheme(q, k, v, out, lse, dout, *, causal, parts=3, frag_parts=3, probs_bf16=False):
    """The backward kernel's arithmetic in plain torch, for these tests only.
    Inputs in ``parts`` bf16 parts (1: bf16 inputs as they are), P and dS
    in ``frag_parts``; each dK/dV CTA's walk over the query tiles that see
    its keys (causal: from the diagonal's tile on) and the dQ walk over key
    tiles, of :func:`_kernel_tiles`, in order; S, dP by :func:`_ss`; dV,
    dK, dQ by :func:`_rs` into accumulators that, with three parts (f32),
    flush into running sums every FLUSH_ROWS rows of the walk (bf16 keeps
    the whole walk in the accumulator); dK and dV added over each KV
    group's heads in head order; dQ and dK times scale at the end.  With
    ``probs_bf16`` V, P where dV reads it, dP and dV are rounded to bf16
    (P's and V's other parts 0)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kv_keys, kv_step, q_step = _kernel_tiles(parts == 3, hd)

    def heads(x):
        return x.float().permute(0, 2, 1, 3)

    def rnd(x):
        return x.to(torch.bfloat16).float() if probs_bf16 else x

    def rows(xs, sl):
        return [x[:, :, sl] for x in xs]

    kv_of = torch.arange(h) // g            # each query head's KV head, by index
    qp, op = _split(heads(q), parts), _split(heads(dout), parts)
    kp = _split(heads(k)[:, kv_of], parts)
    vp = _split(rnd(heads(v)[:, kv_of]), parts)
    big_d = (heads(dout) * heads(out)).sum(-1)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    visible = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        visible = torch.arange(skv)[None, :] <= torch.arange(sq)[:, None]
    f32 = parts == 3
    dk = torch.zeros(b, h, skv, hd)
    dv = torch.zeros(b, h, skv, hd)
    for k0 in range(0, skv, kv_keys):
        ks = slice(k0, min(k0 + kv_keys, skv))
        kb, vb = rows(kp, ks), rows(vp, ks)
        sum_k = _Sum(kb[0].shape, FLUSH_ROWS // kv_step if f32 else 0)
        sum_v = _Sum(kb[0].shape, sum_k.flush)
        for q0 in range((k0 // kv_step if causal else 0) * kv_step, sq, kv_step):
            sl = slice(q0, min(q0 + kv_step, sq))
            sum_k.tile()
            sum_v.tile()
            st = _ss(kb, rows(qp, sl))
            dpt = _ss(vb, rows(op, sl), drop_a=probs_bf16)
            p = _probs(st, lse[:, :, None, sl], scale, visible[sl, ks].T)
            ds = p * (rnd(dpt) - big_d[:, :, None, sl])
            sum_v.acc = _rs(sum_v.acc, _split(p, frag_parts, keep=1 if probs_bf16 else None),
                            rows(op, sl), drop_a=probs_bf16)
            sum_k.acc = _rs(sum_k.acc, _split(ds, frag_parts), rows(qp, sl))
        dk[:, :, ks], dv[:, :, ks] = sum_k.total(), sum_v.total()
    sum_q = _Sum((b, h, sq, hd), FLUSH_ROWS // q_step if f32 else 0)
    for k0 in range(0, skv, q_step):
        sl = slice(k0, min(k0 + q_step, skv))
        sum_q.tile()
        s = _ss(qp, rows(kp, sl))
        dp = _ss(op, rows(vp, sl), drop_b=probs_bf16)
        p = _probs(s, lse[..., None], scale, visible[:, sl])
        sum_q.acc = _rs(sum_q.acc, _split(p * (rnd(dp) - big_d[..., None]), frag_parts),
                        rows(kp, sl))
    dq = sum_q.total()
    dk, dv = dk.reshape(b, kvh, g, skv, hd), dv.reshape(b, kvh, g, skv, hd)
    sk, sv = dk[:, :, 0], dv[:, :, 0]
    for j in range(1, g):
        sk, sv = sk + dk[:, :, j], sv + dv[:, :, j]
    return ((dq * scale).permute(0, 2, 1, 3).to(q.dtype),
            (sk * scale).permute(0, 2, 1, 3).to(k.dtype), rnd(sv).permute(0, 2, 1, 3).to(v.dtype))


def _gate(got, plain, exact, dtype):
    """Per gradient (dq, dk, dv): (distance of got, of plain, the limit) in
    the card's gate (kfab.GRAD_MULT, kfab.GRAD_FLOOR)."""
    floor = kfab.GRAD_FLOOR * max(float(x.abs().max()) for x in exact)
    out = []
    for g, p, x in zip(got, plain, exact):
        e_got = float((g.double() - x).abs().max())
        e_plain = float((p.double() - x).abs().max())
        out.append((e_got, e_plain, kfab.GRAD_MULT[TORCH[dtype]] * e_plain + floor))
    return out


def _jax_case(shape, seed, probs="float32"):
    """(torch inputs, the plain forward's out and lse, jax.vjp's gradients in
    f32) of one f32 case."""
    b, sq, skv, h, kv, hd, causal, chunk = shape
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(seed, b, sq, skv, h, kv, hd, "float32")

    def fn(q, k, v):
        return jattn.chunked_attention(q, k, v, causal=causal, q_chunk=chunk, kv_chunk=chunk,
                                       probs_dtype=JAX[probs])

    _, vjp = jax.vjp(fn, jq, jk, jv)
    jgrads = [torch.from_numpy(np.array(x, np.float32)) for x in vjp(jdo)]
    out, lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=causal, block_q=chunk,
                                           block_k=chunk, probs_dtype=TORCH[probs])
    return (tq, tk, tv, tdo), out, lse, jgrads


# (b, sq, skv, h, kv, hd, causal, chunk): GQA 1, 2 and 8, Sq != Skv both
# ways, causal and not, hd 64 and 128, ragged 32- and 64-row steps
BWD_SCHEME_SHAPES = [(1, 96, 96, 8, 1, 64, True, 32),
                     (1, 80, 144, 4, 2, 128, False, 16),
                     (2, 64, 64, 4, 4, 64, True, 32),
                     (1, 144, 80, 8, 4, 128, True, 16),
                     (1, 112, 48, 2, 1, 64, False, 16)]


@pytest.mark.parametrize("shape", BWD_SCHEME_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_f32_scheme_meets_the_card_gate_against_jax_vjp(shape):
    """Three bf16 parts, six partial products, the kernel's tiles and order
    and the long sums in the accumulator: each gradient is as close to the
    float64 gradient as the card's f32 gate asks of the kernel, with
    ``jax.vjp`` of ``chunked_attention`` in f32 as the plain path."""
    (q, k, v, dout), out, lse, jgrads = _jax_case(shape, 40 + sum(shape))
    got = _bwd_scheme(q, k, v, out, lse, dout, causal=shape[6])
    exact = ref.attention_grads_f64(q, k, v, dout, causal=shape[6])
    for name, (e_got, e_jax, limit) in zip("qkv", _gate(got, jgrads, exact, "float32")):
        assert e_got <= limit, (name, e_got, e_jax, limit)


def test_bwd_f32_scheme_with_bf16_probabilities_matches_jax_vjp():
    """probs_dtype bfloat16: V's and P's parts 1 and 2 are zeros and their
    products dropped; the scheme stays within the bf16-probability
    tolerance of ``jax.vjp`` and the card's gate against the plain tier."""
    shape = BWD_SCHEME_SHAPES[1]
    (q, k, v, dout), out, lse, jgrads = _jax_case(shape, 41 + sum(shape), probs="bfloat16")
    got = _bwd_scheme(q, k, v, out, lse, dout, causal=shape[6], probs_bf16=True)
    for name, g, jg in zip("qkv", got, jgrads):
        assert _rel(g, jg) <= BF16_TOL, (name, _rel(g, jg))
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=shape[6],
                                        block_q=shape[7], block_k=shape[7],
                                        probs_dtype=torch.bfloat16)
    for name, g, p in zip("qkv", got, plain):
        assert _rel(g, p) <= BF16_TOL, (name, _rel(g, p))


def test_bwd_f32_scheme_needs_three_parts():
    """The parts are exact (x0 + x1 + x2 == x); the same walk on two parts
    (about 16 bits) misses the card's f32 gate on a case three parts meet
    it on."""
    shape = BWD_SCHEME_SHAPES[0]
    (q, k, v, dout), out, lse, jgrads = _jax_case(shape, 40 + sum(shape))
    for x in (q, k, v, dout):
        assert torch.equal(sum(_split(x, 3)), x)
    exact = ref.attention_grads_f64(q, k, v, dout, causal=shape[6])
    three = _gate(_bwd_scheme(q, k, v, out, lse, dout, causal=True), jgrads, exact, "float32")
    two = _gate(_bwd_scheme(q, k, v, out, lse, dout, causal=True, parts=2, frag_parts=2),
                jgrads, exact, "float32")
    assert all(e <= limit for e, _, limit in three), three
    assert any(e > limit for e, _, limit in two), two


@pytest.mark.parametrize("shape", BWD_SCHEME_SHAPES[:4], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("probs", ["float32", "bfloat16"])
def test_bwd_bf16_scheme_meets_the_card_gate_against_the_plain_tier(shape, probs):
    """bf16 inputs, S and dP from one bf16 product each, P and dS as hi + lo
    fragments (P's lo 0 with bf16 probabilities), the kernel's tiles and
    order: each gradient within the card's bf16 gate of the float64
    gradient, with the plain tier's backward as the plain path."""
    b, sq, skv, h, kv, hd, causal, chunk = shape
    _, (q, k, v, dout) = _inputs(50 + sum(shape), b, sq, skv, h, kv, hd, "bfloat16")
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, block_q=chunk, block_k=chunk,
                                           probs_dtype=TORCH[probs])
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, block_q=chunk,
                                        block_k=chunk, probs_dtype=TORCH[probs])
    got = _bwd_scheme(q, k, v, out, lse, dout, causal=causal, parts=1, frag_parts=2,
                      probs_bf16=probs == "bfloat16")
    exact = ref.attention_grads_f64(q, k, v, dout, causal=causal)
    for name, g, (e_got, e_plain, limit) in zip("qkv", got, _gate(got, plain, exact,
                                                                  "bfloat16")):
        assert g.dtype == torch.bfloat16
        assert e_got <= limit, (name, e_got, e_plain, limit)


def _fwd_bf16_probs(q, k, v, *, causal, final_max, tile=128):
    """The forward kernels' bf16-probability path (``csrc/flash_attention_tc.cu``)
    in plain torch: S in f32, 128-key tiles, p = exp2(s log2 e - m log2 e)
    rounded to bf16 before P V, the running output rescaled by each tile's
    alpha.  ``final_max``: m is each row's max over all its keys from the
    start (the kernel's first sweep); otherwise the running max of the
    tiles seen so far.  Returns (out in q's dtype, lse)."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    log2e = torch.tensor(LOG2E)
    visible = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        visible = visible.tril()
    out = torch.zeros(b, sq, h, hd)
    lse = torch.zeros(b, h, sq)
    for i in range(b):
        for head in range(h):
            j = head // g
            s = torch.where(visible, (q[i, :, head].float() @ k[i, :, j].float().T) * scale,
                            torch.tensor(-1e30))
            m = s.amax(-1) if final_max else torch.full((sq,), -1e30)
            l, acc = torch.zeros(sq), torch.zeros(sq, hd)
            for k0 in range(0, skv, tile):
                st = s[:, k0:k0 + tile]
                mn = torch.maximum(m, st.amax(-1))
                p = torch.exp2(st * log2e - (mn * log2e)[:, None])
                alpha = torch.where(m > -5e29, torch.exp2((m - mn) * log2e), torch.tensor(0.0))
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + (p.to(torch.bfloat16).float()
                                              @ v[i, k0:k0 + tile, j].float())
                m = mn
            out[i, :, head] = acc / l.clamp_min(1e-30)[:, None]
            lse[i, head] = m + torch.log(l)
    return out.to(q.dtype), lse


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_bf16_probabilities_round_at_the_final_max(causal):
    """With bf16 probabilities the forward kernels round P at its row's
    final max (a first sweep over the K tiles finds it), where the plain
    version over one key chunk and JAX's ``chunked_attention`` round it:
    emulated, that forward differs from both in few bf16 outputs, and the
    plain backward on it stays inside the card's bf16 gate against the
    plain path end to end.  Rounded at the tiles' running maxima instead,
    many more outputs move by an ulp, and D = rowsum(dO * out) carries
    each into the gradients."""
    b, sq, skv, h, kv, hd = 2, 200, 1000, 8, 1, 16
    (jq, jk, jv, _), (q, k, v, dout) = _inputs(60 + causal, b, sq, skv, h, kv, hd, "bfloat16")
    kw = dict(causal=causal, block_q=sq, block_k=skv, probs_dtype=torch.bfloat16)
    p_out, p_lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    j_out = torch.from_numpy(np.array(jattn.chunked_attention(
        jq, jk, jv, causal=causal, q_chunk=sq, kv_chunk=skv, probs_dtype=jnp.bfloat16
    ).astype(jnp.float32))).to(torch.bfloat16)
    final, lse = _fwd_bf16_probs(q, k, v, causal=causal, final_max=True)
    running, _ = _fwd_bf16_probs(q, k, v, causal=causal, final_max=False)
    share = {name: [float((o != w).float().mean()) for w in (p_out, j_out)]
             for name, o in (("final", final), ("running", running))}
    assert max(share["final"]) <= 0.01, share
    assert min(share["running"]) >= 5 * max(share["final"]), share
    assert float(((lse - p_lse).abs() / p_lse.abs().clamp_min(1)).max()) <= 2e-5
    exact = ref.attention_grads_f64(q, k, v, dout, causal=causal)
    plain = ref.flash_attention_bwd_ref(q, k, v, p_out, p_lse, dout, **kw)
    got = ref.flash_attention_bwd_ref(q, k, v, final, lse, dout, **kw)
    for name, (e_got, e_plain, limit) in zip("qkv", _gate(got, plain, exact, "bfloat16")):
        assert e_got <= limit, (name, e_got, e_plain, limit)
