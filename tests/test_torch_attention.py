"""The port's attention against the JAX package on the CPU: the plain tier
of ``ops.flash_attention`` against the Pallas flash kernel (interpret
mode) on the grid of ``tests/test_flash_attention.py``, ``chunked_attention``
against the JAX one (the flash kernel's oracle, <= 1e-6 in f32), and
``full_attention`` with a query offset and a cache mask."""
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
