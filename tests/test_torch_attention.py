"""The port's attention against the JAX package on the CPU: the plain tier
of ``ops.flash_attention`` against the Pallas flash kernel (interpret
mode) on the grid of ``tests/test_flash_attention.py``, ``chunked_attention``
against the JAX one (the flash kernel's oracle, <= 1e-6 in f32),
``full_attention`` with a query offset and a cache mask, and the numeric
schemes of the tensor-core kernels emulated in plain torch against the
Pallas kernel: the bf16 kernel's (``csrc/flash_attention_tc.cu``) on bf16
inputs, the f32 kernel's split operands (``csrc/flash_attention_f32.cu``)
on f32 inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.obs.metrics import default_registry  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(seed, b, sq, skv, h, kv, hd, dtype="float32"):
    """The same q, k, v for both packages (numpy draws, as the JAX test
    makes them): (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, sq, h, hd)).astype(np.float32),
              rng.normal(size=(b, skv, kv, hd)).astype(np.float32),
              rng.normal(size=(b, skv, kv, hd)).astype(np.float32)]
    jax_in = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    torch_in = [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]
    return jax_in, torch_in


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd", [
    (2, 64, 64, 4, 2, 16),      # GQA 2:1
    (1, 128, 128, 8, 8, 32),    # MHA
    (2, 64, 128, 4, 1, 16),     # MQA, cross lengths
    (1, 96, 96, 6, 3, 64),      # non-pow2 block count
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_tier_matches_jax_flash(b, sq, skv, h, kv, hd, causal):
    jin, tin = _rand(0, b, sq, skv, h, kv, hd)
    want = jflash(*jin, causal=causal, block_q=32, block_k=32)
    got = ops.flash_attention(*tin, causal=causal, block_q=32, block_k=32)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 64), (64, 32), (128, 128)])
def test_block_shapes_match_jax_flash(block_q, block_k):
    jin, tin = _rand(1, 2, 128, 128, 4, 2, 32)
    want = jflash(*jin, causal=True, block_q=block_q, block_k=block_k)
    got = ops.flash_attention(*tin, causal=True, block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_bf16_inputs_match_jax_flash():
    jin, tin = _rand(2, 1, 64, 64, 4, 2, 32, "bfloat16")
    want = jflash(*jin, causal=True, block_q=32, block_k=32)
    got = ops.flash_attention(*tin, causal=True, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_first_token_sees_only_itself():
    """Causal row 0 attends to position 0 only -> output = v[0], in both
    packages."""
    jin, tin = _rand(3, 1, 32, 32, 2, 2, 16)
    got = ops.flash_attention(*tin, causal=True, block_q=16, block_k=16)
    want = jflash(*jin, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(_np(got[:, 0]), _np(tin[2][:, 0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_attention_matches_jax(causal, chunk):
    """The flash kernel's oracle against the JAX one at equal chunks:
    <= 1e-6 in f32 (kernels/ref.py's contract)."""
    jin, tin = _rand(4, 2, 64, 64, 8, 2, 32)
    want = jattn.chunked_attention(*jin, causal=causal, q_chunk=chunk, kv_chunk=chunk)
    got = tattn.chunked_attention(*tin, causal=causal, q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_full_attention_offset_and_cache_mask_match_jax():
    jin, tin = _rand(5, 3, 8, 40, 4, 1, 16)
    rng = np.random.default_rng(6)
    valid = rng.random((3, 40)) < 0.7
    valid[:, 0] = True
    for kw in ({"causal": True, "q_offset": 20}, {"causal": False},
               {"causal": True, "q_offset": 32, "with_mask": True}):
        kw = dict(kw)
        with_mask = kw.pop("with_mask", False)
        want = jattn.full_attention(*jin, kv_valid=jnp.asarray(valid) if with_mask else None,
                                    **kw)
        got = tattn.full_attention(*tin, kv_valid=torch.from_numpy(valid) if with_mask else None,
                                   **kw)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_preconditions_raise_on_both_tiers():
    """Blocks that do not tile the sequence and heads that do not group
    raise, whichever implementation is named; a CPU call resolves to the
    plain version and is counted."""
    _, (q, k, v) = _rand(7, 1, 48, 48, 4, 2, 16)
    for impl in (None, "torch_ref", "cuda_sm90"):
        with pytest.raises(ValueError, match="tile"):
            ops.flash_attention(q, k, v, block_q=32, block_k=16, impl=impl)
        with pytest.raises(ValueError, match="group"):
            ops.flash_attention(q[:, :, :3], k, v, block_q=16, block_k=16, impl=impl)
    with pytest.raises(ValueError, match="cuda"):
        ops.flash_attention(q, k, v, block_q=16, block_k=16, impl="cuda_sm90")
    metrics = default_registry()
    before = metrics.counter("kernel_dispatch_total", kernel="flash_attention", impl="torch_ref")
    ops.flash_attention(q, k, v, block_q=48, block_k=48)
    assert metrics.counter("kernel_dispatch_total", kernel="flash_attention",
                           impl="torch_ref") == before + 1


def test_bf16_probabilities_match_jax():
    """``probs_dtype=bfloat16`` rounds the probabilities before the product
    with V in both attention forms, as the JAX package does (2e-2, its
    bf16 tolerance)."""
    jin, tin = _rand(8, 2, 32, 32, 4, 2, 16)
    for causal in (True, False):
        want = jattn.full_attention(*jin, causal=causal, probs_dtype=jnp.bfloat16)
        got = tattn.full_attention(*tin, causal=causal, probs_dtype=torch.bfloat16)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
        want = jattn.chunked_attention(*jin, causal=causal, q_chunk=16, kv_chunk=16,
                                       probs_dtype=jnp.bfloat16)
        got = tattn.chunked_attention(*tin, causal=causal, q_chunk=16, kv_chunk=16,
                                      probs_dtype=torch.bfloat16)
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def _tc_scheme(q, k, v, *, causal, block_k=128):
    """The bf16 tensor-core kernel's arithmetic in plain torch, for this
    test only: bf16 q, k, v; f32 scores (exact bf16 products, f32 sums)
    times 1/sqrt(hd); an online softmax over 128-key tiles with the
    kernel's masking; P split into p_hi = bf16(p) and p_lo = bf16(p - p_hi),
    and P_hi V + P_lo V summed in f32; out = acc / max(l, 1e-30) in bf16."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kvh, h // kvh, hd)
    kf, vf = k.float(), v.float()
    scale = np.float32(1.0 / np.sqrt(hd))
    m = torch.full((b, kvh, h // kvh, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, h // kvh, sq, hd))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kt) * scale
        kpos = k0 + torch.arange(kt.shape[1])[None, :]
        if causal:
            s = torch.where(kpos > qpos, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where((m_new > -5e29)[..., None], torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.where(m > -5e29, torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        acc = (acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p_hi, vt)
               + torch.einsum("bkgqs,bskh->bkgqh", p_lo, vt))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(torch.bfloat16)


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal", [
    (1, 200, 200, 8, 2, 128, True),      # ragged 128-key tiles, GQA 4:1
    (2, 63, 129, 4, 1, 64, False),       # Sq < Skv, MQA
])
def test_tensor_core_scheme_matches_jax_flash_in_bf16(b, sq, skv, h, kv, hd, causal):
    """The hi/lo split keeps the probabilities at f32 precision, so the
    scheme meets the card's bf16 gate against the Pallas kernel (interpret
    mode): per element within one bf16 ulp of the JAX value plus 2e-5."""
    jin, tin = _rand(9, b, sq, skv, h, kv, hd, "bfloat16")
    want = torch.from_numpy(_np(jflash(*jin, causal=causal, block_q=sq, block_k=skv)))
    got = _tc_scheme(*tin, causal=causal).float()
    _, e = torch.frexp(want)
    limit = torch.ldexp(torch.ones_like(want), e - 8) * (want != 0) + 2e-5
    diff = (got - want).abs()
    assert not bool((diff > limit).any()), (float(diff.max()), int((diff > limit).sum()))


def _parts(x, n):
    """x split into n bf16 parts (as f32 tensors), each the round-to-nearest
    bf16 of what the parts before it leave: the f32 kernel's split."""
    parts = []
    for _ in range(n):
        part = x.to(torch.bfloat16).float()
        parts.append(part)
        x = x - part
    return parts


def _products(n):
    """The (i, j) part pairs of a product of two n-part operands that the
    f32 kernel sums, i + j <= n - 1, smallest first."""
    return sorted(((i, j) for i in range(n) for j in range(n) if i + j < n),
                  key=lambda ij: -sum(ij))


def _f32_scheme(q, k, v, *, causal, parts=3):
    """The f32 tensor-core kernel's arithmetic in plain torch, for this
    test only: q, k, v and each tile's probabilities split into ``parts``
    bf16 parts; S and each tile's O = P V sum the partial products of
    :func:`_products` (exact bf16 products, f32 sums) into a fresh f32
    accumulator, smallest first; 32-key tiles at hd 128, 64 below; the
    online softmax with the kernel's masking; acc = acc * alpha + O; out =
    acc / max(l, 1e-30).  ``parts=1`` is the same arithmetic on operands
    rounded to bf16 once."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    block_k = 32 if hd == 128 else 64
    qp = [x.reshape(b, sq, kvh, h // kvh, hd) for x in _parts(q, parts)]
    kp, vp = _parts(k, parts), _parts(v, parts)
    scale = np.float32(1.0 / np.sqrt(hd))
    m = torch.full((b, kvh, h // kvh, sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, h // kvh, sq, hd))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, block_k):
        s = sum(torch.einsum("bqkgh,bskh->bkgqs", qp[i], kp[j][:, k0:k0 + block_k])
                for i, j in _products(parts)) * scale
        kpos = k0 + torch.arange(s.shape[-1])[None, :]
        if causal:
            s = torch.where(kpos > qpos, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where((m_new > -5e29)[..., None], torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.where(m > -5e29, torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pp = _parts(p, parts)
        o = sum(torch.einsum("bkgqs,bskh->bkgqh", pp[i], vp[j][:, k0:k0 + block_k])
                for i, j in _products(parts))
        acc = acc * alpha[..., None] + o
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


F32_SCHEME_CASES = [
    (1, 200, 200, 8, 2, 128, True),      # ragged 32-key tiles, GQA 4:1
    (2, 63, 129, 4, 1, 64, False),       # Sq < Skv, MQA
    (1, 129, 63, 4, 4, 64, True),        # Sq > Skv, MHA
    (2, 96, 96, 6, 3, 128, False),       # GQA 2:1
]


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal", F32_SCHEME_CASES)
def test_f32_tensor_core_scheme_matches_jax_flash(b, sq, skv, h, kv, hd, causal):
    """Three bf16 parts per operand and six partial products per matrix
    product keep f32 precision: the scheme meets the card's f32 gate (2e-5)
    against the Pallas kernel (interpret mode) on f32 inputs."""
    jin, tin = _rand(10, b, sq, skv, h, kv, hd)
    want = _np(jflash(*jin, causal=causal, block_q=sq, block_k=skv))
    got = _f32_scheme(*tin, causal=causal)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-5)


def test_f32_scheme_needs_the_split():
    """The parts are exact (x0 + x1 + x2 == x); the same arithmetic on q, k,
    v and p rounded to bf16 once misses the 2e-5 gate on the inputs the
    split meets it on."""
    b, sq, skv, h, kv, hd, causal = F32_SCHEME_CASES[0]
    jin, tin = _rand(10, b, sq, skv, h, kv, hd)
    for x in tin:
        assert torch.equal(sum(_parts(x, 3)), x)
    want = _np(jflash(*jin, causal=causal, block_q=sq, block_k=skv))
    split = np.abs(_np(_f32_scheme(*tin, causal=causal)) - want).max()
    once = np.abs(_np(_f32_scheme(*tin, causal=causal, parts=1)) - want).max()
    assert split <= 2e-5 < once, (split, once)
