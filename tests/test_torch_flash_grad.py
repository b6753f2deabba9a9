"""The flash-attention op's gradients on the CPU: its plain tier through
the op's ``autograd.Function`` against ``jax.vjp`` of the JAX package's
``chunked_attention`` (the function ``jax.value_and_grad`` differentiates
above ``CHUNKED_THRESHOLD``), the forward's ``(out, lse)`` plain version,
and the backward's plain version against torch autograd of the port's own
``chunked_attention``.  The same numpy-seeded inputs and cotangent go to
both packages.  Then the forward kernels' rounding of bf16 probabilities
emulated in plain torch.  The backward kernel's numeric schemes are
emulated in ``tests/test_torch_flash_grad_schemes.py``.

    PYTHONPATH=src python -m pytest tests/test_torch_flash_grad.py
"""
import math

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
# The gate the card holds the backward to, and the forward kernels' bf16
# probabilities emulated in plain torch.
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)


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
