"""The numeric schemes of the flash-attention backward kernel
(``csrc/flash_attention_bwd.cu``) emulated in plain torch on the CPU: the
f32 one (three bf16 parts, six partial products, its tiles and order, the
long sums in the accumulator) against ``jax.vjp`` of the JAX package's
``chunked_attention`` inside the card's f32 gate, two parts missing it,
and the bf16 one (hi/lo P and dS) against the plain tier inside the
card's bf16 gate.  Inputs, tolerances and the gate are
``tests/test_torch_flash_grad.py``'s.

    PYTHONPATH=src python -m pytest tests/test_torch_flash_grad_schemes.py
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_flash_grad import (BF16_TOL, JAX, LOG2E, TORCH, _gate, _inputs,  # noqa: E402
                                   _rel)

# ---------------------------------------------------------------------------
# The backward kernel's numeric schemes, emulated in plain torch on the CPU.
# ---------------------------------------------------------------------------

BWD_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
              / "flash_attention_bwd.cu")


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
