"""The port's kernel registry: the conformance matrix generated from it
(every registered implementation of every op against its oracle), the
registration contract, and selection by device or by a per-call ``impl=``.

The ``cuda_sm90`` rows of the matrix are marked ``gpu`` and skip without a
card.  The file imports neither jax nor the JAX package, so the card runs it
too:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_registry.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import projections as proj
from repro_torch.core import sjpc
from repro_torch.core.hashing import P31
from repro_torch.kernels import ops, ref
from repro_torch.kernels.registry import (CUDA_SM90, IMPLS, TORCH_REF, KernelRegistry,
                                          RegistryError, kernel_registry)
from repro_torch.obs.metrics import default_registry

REG = kernel_registry()
OPS = ("fingerprint", "flash_attention", "flash_attention_bwd", "fused_ingest", "fused_pairs",
       "fused_query", "sample_weights", "sketch_moments", "sketch_update")
# Every op's kernel equals its oracle bit for bit, except flash attention:
# the kernel sums in its own tiles and order, within FLASH_F32_TOL of the
# oracle in f32 (the JAX package's flash-kernel tolerance).  A bf16 output
# is that value rounded, so in bf16 it may differ by one bf16 ulp of the
# oracle's on top, and never by more than 2e-2 (the JAX package's bf16
# limit).
FLASH_F32_TOL = 2e-5
FLASH_BF16_TOL = 2e-2
# The backward's gradients, relative to each one's max |x|: f32 sums in
# another order (FLASH_F32_TOL); bf16 outputs, or bf16 probabilities (dP
# rounded to bf16), are those values rounded, one bf16 ulp (2^-8 of the
# max) and a little more.
GRAD_BF16_TOL = 1e-2


def assert_flash_close(got, want):
    diff = (got.float() - want.float()).abs()
    limit = torch.full_like(diff, FLASH_F32_TOL)
    if want.dtype == torch.bfloat16:
        _, e = torch.frexp(want.float())
        limit += torch.ldexp(torch.ones_like(diff), e - 8) * (want != 0)
        assert float(diff.max()) <= FLASH_BF16_TOL
    assert not bool((diff > limit).any()), (float(diff.max()), int((diff > limit).sum()))


def assert_grads_close(got, want, probs):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        rel = float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
        f32 = w.dtype == probs == torch.float32
        assert rel <= (FLASH_F32_TOL if f32 else GRAD_BF16_TOL), rel


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _i32(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _cases(op: str, rng):
    """A few small canonical-argument cases per op (CPU tensors)."""
    cfg = sjpc.SJPCConfig(d=5, s=3, width=128, depth=2, seed=int(rng.integers(1 << 16)))
    params, _ = sjpc.init(cfg, device="cpu")
    if op == "fingerprint":
        level = proj.lattice(5, 3)[0]
        return [(_i64(rng.integers(0, 2**32, size=(b, 5), dtype=np.uint64)),
                 _i64(level.masks), _i64(level.ids), params.fp_bases) for b in (1, 37)]
    if op == "flash_attention":
        out = []
        for (b, sq, skv, h, kv, hd), dtype, causal in (
                ((2, 64, 64, 4, 2, 16), torch.float32, True),
                ((1, 96, 128, 16, 2, 128), torch.float32, False),
                ((1, 128, 128, 8, 1, 64), torch.bfloat16, True)):
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                       for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
            out.append((q, k, v, causal))
        return out
    if op == "flash_attention_bwd":
        out = []
        for (b, sq, skv, h, kv, hd), dtype, causal, probs in (
                ((2, 64, 64, 4, 2, 16), torch.float32, True, torch.float32),
                ((1, 96, 128, 16, 2, 128), torch.float32, False, torch.bfloat16),
                ((1, 128, 128, 8, 1, 64), torch.bfloat16, True, torch.float32)):
            q, k, v, dout = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                             for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd),
                                           (b, sq, h, hd)))
            o, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, block_q=32, block_k=32,
                                                 probs_dtype=probs)
            out.append(((q, k, v, o, lse, dout), causal, probs))
        return out
    if op == "fused_ingest":
        pad = proj.padded_lattice(5, 3)
        out = []
        for b in (1, 50):
            weights = rng.integers(0, 2, size=(b, pad.num_levels, pad.m_max)) * pad.valid[None]
            out.append((_i32(rng.integers(-9, 9, size=(3, 2, 128))),
                        _i64(rng.integers(0, 2**32, size=(b, 5), dtype=np.uint64)),
                        _i64(pad.masks), _i64(pad.ids), params.fp_bases,
                        params.bucket_coeffs, params.sign_coeffs, _i32(weights)))
        return out
    if op == "fused_pairs":
        return [(_i64(rng.integers(0, 3, size=(n, r, d))), _i32(rng.random((n, r)) < 0.8))
                for n, r, d in ((1, 1, 3), (2, 64, 5), (1, 130, 6))]
    if op == "fused_query":
        return [(_i32(rng.integers(-60, 60, size=shape)), _i32(rng.integers(-60, 60, size=shape)))
                for shape in ((1, 1, 1, 128), (3, 2, 3, 256))]
    if op == "sample_weights":
        # (key, step, row_mask, batch, d, s, ratio); d=9, s=4 has levels of
        # 126 combinations, the kernel's large-level path
        return [(_i64([0, 77]), None, None, 37, 6, 3, 0.5),
                (_i64([123, 4567]), _i32(3).reshape(()), _i32(rng.random(50) < 0.7), 50, 5, 2,
                 0.75),
                (_i64([9, 2**32 - 1]), _i32(2**31 - 1).reshape(()), None, 3, 9, 4, 0.3),
                (_i64([1, 2]), None, _i32(rng.random(5) < 0.5), 5, 4, 4, 1.0)]
    if op == "sketch_moments":
        return [(_i32(rng.integers(-60, 60, size=(t, w))), _i32(rng.integers(-60, 60, size=(t, w))))
                for t, w in ((1, 128), (5, 512))]
    assert op == "sketch_update"
    out = []
    for n, t, w in ((1, 3, 128), (257, 2, 256)):
        coeffs = sjpc.sk.make_sketch_params(rng, t, device="cpu")
        out.append((_i32(rng.integers(-9, 9, size=(t, w))), _i64(rng.integers(0, P31, size=n)),
                    _i64(rng.integers(0, P31, size=n)), coeffs.bucket_coeffs,
                    coeffs.sign_coeffs, _i32(rng.integers(-2, 3, size=n))))
    return out


def _matrix():
    params = []
    for op in REG.ops():
        for name in IMPLS:
            marks = (pytest.mark.gpu,) if name == CUDA_SM90 else ()
            params.append(pytest.param(op, name, marks=marks, id=f"{op}-{name}"))
    return params


def _to(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.parametrize("op,name", _matrix())
def test_impl_matches_its_oracle(op, name):
    entry = REG.get(op)
    device = torch.device("cpu")
    if name == CUDA_SM90:
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        device = torch.device("cuda")
    for args in _cases(op, np.random.default_rng(sum(map(ord, op)))):
        if op == "flash_attention":
            q, k, v, causal = args
            got = entry.impl(name)(*_to((q, k, v), device), causal=causal, block_q=32, block_k=32)
            want = entry.oracle(q, k, v, causal=causal, block_q=32, block_k=32)
            assert got.dtype == want.dtype == q.dtype
            assert_flash_close(got.cpu(), want)
            continue
        if op == "flash_attention_bwd":
            tensors, causal, probs = args
            kw = dict(causal=causal, block_q=32, block_k=32, probs_dtype=probs)
            got = entry.impl(name)(*_to(tensors, device), **kw)
            assert_grads_close([g.cpu() for g in got], entry.oracle(*tensors, **kw), probs)
            continue
        got, want = entry.impl(name)(*_to(args, device)), entry.oracle(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (op, name)


def test_every_op_has_both_tiers():
    assert REG.ops() == OPS
    for op in OPS:
        entry = REG.get(op)
        assert entry.impl(TORCH_REF) is entry.oracle is getattr(ref, f"{op}_ref")
        assert entry.impl(CUDA_SM90) is entry.kernel is not entry.oracle


def test_registering_without_an_oracle_is_refused():
    reg = KernelRegistry()
    with pytest.raises(RegistryError, match="oracle"):
        reg.register("op", kernel=lambda: 0, oracle=None)
    with pytest.raises(RegistryError, match="kernel"):
        reg.register("op", kernel=None, oracle=lambda: 0)
    reg.register("op", kernel=lambda: 0, oracle=lambda: 0)
    with pytest.raises(RegistryError, match="already registered"):
        reg.register("op", kernel=lambda: 0, oracle=lambda: 0)
    assert reg.ops() == ("op",)


def test_resolution_follows_the_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    for op in OPS:
        entry = REG.get(op)
        assert REG.select(op, cpu) == (TORCH_REF, entry.oracle)
        assert REG.select(op, cuda) == (CUDA_SM90, entry.kernel)
    with pytest.raises(RegistryError):
        REG.select("no_such_op", cpu)
    with pytest.raises(RegistryError):
        REG.get("no_such_op")


def test_explicit_impl_is_per_call_and_checked():
    """``impl=`` decides one call only; an unknown name raises instead of
    being ignored."""
    cuda = torch.device("cuda", 0)
    entry = REG.get("fused_pairs")
    assert REG.select("fused_pairs", cuda, TORCH_REF) == (TORCH_REF, entry.oracle)
    assert REG.select("fused_pairs", cuda) == (CUDA_SM90, entry.kernel)
    with pytest.raises(RegistryError, match="no_such_impl"):
        REG.select("fused_pairs", cuda, "no_such_impl")
    args = _cases("fused_pairs", np.random.default_rng(3))[0]
    with pytest.raises(RegistryError, match="no_such_impl"):
        ops.fused_pairs(*args, impl="no_such_impl")


def test_forced_kernel_on_cpu_tensors_raises_instead_of_falling_back():
    """A cuda_sm90 implementation never runs the plain version: on CPU
    tensors it raises."""
    args = _cases("fused_query", np.random.default_rng(1))[0]
    with pytest.raises(ValueError, match="cuda"):
        ops.fused_query(*args, impl=CUDA_SM90)
    with pytest.raises(ValueError, match="cuda"):
        REG.get("fused_query").kernel(*args)


def test_dispatch_is_counted_with_the_impl_label():
    metrics = default_registry()
    args = _cases("sketch_moments", np.random.default_rng(2))[0]
    before = metrics.counter("kernel_dispatch_total", kernel="sketch_moments", impl=TORCH_REF)
    ops.sketch_moments(*args)
    ops.sketch_moments(*args, impl=TORCH_REF)
    assert metrics.counter("kernel_dispatch_total", kernel="sketch_moments",
                           impl=TORCH_REF) == before + 2
