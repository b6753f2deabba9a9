"""The port's optimizers, schedules and gradient compression against the
JAX package's on the CPU: ``warmup_cosine`` and ``constant``, the int8
compression and the Q8 quantizers bit for bit (the stochastic-rounding
draws included), ``global_norm`` and clipping, AdamW's trajectory and its
weight decay on stacked leaves, and a three-step Q8Adam trajectory whose
codes agree with JAX's; then the reference's own optimizer checks
(``tests/test_optim.py``) through the port.  The JAX functions run
compiled, as the reference's train step runs them: XLA multiplies by the
reciprocal of a constant divisor and fuses multiply-adds, so its eager
and compiled results differ in the last bit, and the port follows the
compiled ones."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import q8adam as jq8  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.optim import adamw, compression, q8adam, schedules  # noqa: E402

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


@pytest.mark.parametrize("peak,warmup,total,final", [(3e-4, 20, 100, 0.1),
                                                     (1e-3, 100, 1000, 0.1),
                                                     (3e-4, 0, 7, 0.0),
                                                     (5e-2, 5, 5, 0.25)])
def test_warmup_cosine_bit_for_bit(peak, warmup, total, final):
    jfn = jax.jit(jsched.warmup_cosine(peak, warmup, total, final))
    tfn = schedules.warmup_cosine(peak, warmup, total, final)
    steps = np.arange(0, total + 40, dtype=np.int32)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(steps)))
    got = np.array([tfn(torch.tensor(s, dtype=torch.int32)).item() for s in steps],
                   dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    out = tfn(torch.tensor(3, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.shape == ()


def test_constant_schedule():
    out = schedules.constant(3e-4)(torch.tensor(9, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.item() == \
        float(np.asarray(jsched.constant(3e-4)(jnp.asarray(9))))


@pytest.mark.parametrize("shape", [(333, 17), (256,), (1,), (2, 3, 5)])
def test_compress_decompress_int8_bit_for_bit(shape):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * np.exp(rng.normal() * 3)).astype(np.float32)
    jc, js = jax.jit(jcomp.compress_int8)(_j(x))
    tc, ts = compression.compress_int8(_t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(compression.decompress_int8(tc, ts, shape).numpy(),
                                  np.asarray(jax.jit(jcomp.decompress_int8,
                                                     static_argnums=2)(jc, js, shape)))


def _moment_like(seed, shape=(1000, 256)):
    """Values spanning many orders of magnitude per block, and a zero
    block and a negative-only block, like Adam moments."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * np.exp(rng.normal(size=shape[:1] + (1,)) * 4)
    x = x.astype(np.float32).reshape(-1)[:shape[0] * shape[1] - 77]
    x[:256] = 0.0
    x[256:512] = -np.abs(x[256:512])
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_q8_quantizers_bit_for_bit_with_and_without_draws(seed):
    x = _moment_like(seed)
    v = x * x
    key = jax.random.fold_in(jax.random.PRNGKey(17), 3 + seed)
    tkey = prng.fold_in(prng.PRNGKey(17), 3 + seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jax.random.key_data(key)))
    deq = jax.jit(jq8.dequantize, static_argnums=1)
    deq_v = jax.jit(jq8.dequantize_v, static_argnums=1)
    for k, tk in ((None, None), (key, tkey)):
        jm, tm = jax.jit(jq8.quantize)(_j(x), k), q8adam.quantize(_t(x), tk)
        jv, tv = jax.jit(jq8.quantize_v)(_j(v), k), q8adam.quantize_v(_t(v), tk)
        for got, want in ((tm, jm), (tv, jv)):
            assert got.codes.dtype == torch.int8
            np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
            np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
        np.testing.assert_array_equal(q8adam.dequantize(tm, x.shape).numpy(),
                                      np.asarray(deq(jm, x.shape)))
        np.testing.assert_array_equal(q8adam.dequantize_v(tv, v.shape).numpy(),
                                      np.asarray(deq_v(jv, v.shape)))


def test_dequantize_v_every_code_bit_for_bit():
    codes = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    scales = np.array([[3.7e-3]], np.float32)
    want = jax.jit(jq8.dequantize_v, static_argnums=1)(jq8.QTensor(_j(codes), _j(scales)),
                                                      (256,))
    got = q8adam.dequantize_v(q8adam.QTensor(_t(codes), _t(scales)), (256,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 16)).astype(np.float32),
            "stack_norm": (1 + 0.1 * rng.normal(size=(3, 16))).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "groups": [(rng.normal(size=(2, 5, 3)).astype(np.float32),)]}


def _grads(seed, like):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 0.3).astype(np.float32), like)


def test_global_norm_and_clip_match_jax():
    t = _grads(1, _tree(0))
    jt, tt = jax.tree_util.tree_map(_j, t), tree.tree_map(_t, t)
    assert abs(float(adamw.global_norm(tt)) - float(jadamw.global_norm(jt))) <= \
        1e-6 * float(jadamw.global_norm(jt))
    jc, jn = jadamw.clip_by_global_norm(jt, 1.0)
    tc, tn = adamw.clip_by_global_norm(tt, 1.0)
    for got, want in zip(tree.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _trajectory(opt, params, grads_by_step, to):
    """``opt`` over the steps' gradients; the JAX optimizer compiled."""
    state = opt.init(params)
    update = jax.jit(opt.update) if to is _j else opt.update
    for g in grads_by_step:
        params, state, stats = update(jax.tree_util.tree_map(to, g) if to is _j
                                      else tree.tree_map(to, g), state, params)
    return params, state, stats


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_three_steps_match_jax_and_decay_stacked_leaves(wd):
    p0 = _tree(2)
    grads = [_grads(10 + i, p0) for i in range(3)]
    sched = (jsched.warmup_cosine(1e-2, 2, 10), schedules.warmup_cosine(1e-2, 2, 10))
    jopt = jadamw.make_adamw(sched[0], weight_decay=wd)
    topt = adamw.make_adamw(sched[1], weight_decay=wd)
    jp, js, jstats = _trajectory(jopt, jax.tree_util.tree_map(_j, p0), grads, _j)
    tp, ts, tstats = _trajectory(topt, tree.tree_map(_t, p0), grads, _t)
    assert int(ts.step) == int(js.step) == 3
    assert float(tstats["lr"]) == float(jstats["lr"])
    for got, want in zip(tree.tree_leaves((tp, ts.m, ts.v)),
                         jax.tree_util.tree_leaves((jp, js.m, js.v))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * max(np.abs(want).max(), 1e-30))
    if wd:
        # the stacked (3, 16) norm is decayed (ndim > 1), the (7,) bias not:
        # rerun with zero gradients from the carried state and compare
        g0 = jax.tree_util.tree_map(np.zeros_like, p0)
        jp2, _, _ = jax.jit(jopt.update)(jax.tree_util.tree_map(_j, g0), js, jp)
        before = {k: v.clone() for k, v in tp.items() if k != "groups"}
        tp2, _, _ = topt.update(tree.tree_map(_t, g0), ts, tp)
        assert not torch.equal(tp2["stack_norm"], before["stack_norm"])
        np.testing.assert_allclose(tp2["stack_norm"].numpy(), np.asarray(jp2["stack_norm"]),
                                   rtol=0, atol=TOL)


def test_adamw_updates_in_place_and_chunks_equal_whole(monkeypatch):
    """The update writes into the given tensors; slicing the elementwise
    update (CHUNK) changes no bit."""
    p0 = _tree(3)
    g = _grads(4, p0)
    results = []
    for chunk in (adamw.CHUNK, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        params = tree.tree_map(_t, p0)
        opt = adamw.make_adamw(schedules.constant(1e-2))
        state = opt.init(params)
        w = params["w"]
        params, state, _ = opt.update(tree.tree_map(_t, g), state, params)
        assert params["w"] is w
        results.append(tree.tree_leaves((params, state)))
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_q8adam_three_step_trajectory_codes_agree_with_jax(capsys):
    p0 = _tree(6)
    grads = [_grads(20 + i, p0) for i in range(3)]
    jopt = jq8.make_q8adam(jsched.constant(1e-2), weight_decay=0.1)
    topt = q8adam.make_q8adam(schedules.constant(1e-2), weight_decay=0.1)
    jp, js, _ = _trajectory(jopt, jax.tree_util.tree_map(_j, p0), grads, _j)
    tp, ts, _ = _trajectory(topt, tree.tree_map(_t, p0), grads, _t)
    for got, want in zip(tree.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    same = total = 0
    for moment in ("m", "v"):
        for got, want in zip(tree.tree_leaves(getattr(ts, moment)),
                             jax.tree_util.tree_leaves(getattr(js, moment))):
            got, want = got.numpy(), np.asarray(want)
            if got.dtype == np.int8:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1
                same += int((diff == 0).sum())
                total += diff.size
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    share = same / total
    with capsys.disabled():
        print(f"\nQ8Adam codes equal to JAX's after 3 steps: {same}/{total} = {share:.6f}")
    assert share >= 0.999


# -- the reference's own checks (tests/test_optim.py) through the port --------

def _quadratic_problem(dim=64, seed=0):
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(rng.normal(size=(dim, dim)).astype(np.float32))
    params = {"w": torch.zeros((dim, dim)), "b": torch.zeros((dim,))}

    def loss_fn(p):
        return torch.mean((p["w"] - target) ** 2) + torch.mean(p["b"] ** 2)
    return params, loss_fn


def _run(optimizer, params, loss_fn, steps):
    state = optimizer.init(params)
    losses = []
    leaves = tree.tree_leaves(params)
    for _ in range(steps):
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        params, state, _ = optimizer.update(tree.tree_structure(params).unflatten(grads),
                                            state, params)
        losses.append(float(loss.detach()))
    return params, losses


def test_adamw_converges_quadratic():
    params, loss_fn = _quadratic_problem()
    _, losses = _run(adamw.make_adamw(schedules.constant(0.05), weight_decay=0.0), params,
                     loss_fn, 200)
    assert losses[-1] < 0.01 * losses[0], losses[-1]


def test_q8adam_tracks_adamw():
    params, loss_fn = _quadratic_problem()
    _, l32 = _run(adamw.make_adamw(schedules.constant(0.05), weight_decay=0.0), params,
                  loss_fn, 150)
    params, loss_fn = _quadratic_problem()
    _, l8 = _run(q8adam.make_q8adam(schedules.constant(0.05), weight_decay=0.0), params,
                 loss_fn, 150)
    assert l8[-1] < 0.05 * l8[0]
    assert abs(l8[-1] - l32[-1]) < 0.1 * (l32[0] - l32[-1])


def test_quantizer_zero_is_exact_and_rounding_is_unbiased():
    qt = q8adam.quantize(torch.zeros(1000))
    assert float(q8adam.dequantize(qt, (1000,)).abs().max()) == 0.0
    x = torch.full((4096,), 0.3 * 0.011)
    x[0] = 1.4
    samples = [float(q8adam.dequantize(q8adam.quantize(x, prng.PRNGKey(i)), x.shape)[1])
               for i in range(400)]
    assert abs(np.mean(samples) - 0.0033) < 1e-3


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(6)
    g_true = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32))
    err = torch.zeros_like(g_true)
    acc_fb = torch.zeros_like(g_true)
    acc_nofb = torch.zeros_like(g_true)
    for _ in range(100):
        codes, scales = compression.compress_int8(g_true + err)
        sent = compression.decompress_int8(codes, scales, g_true.shape)
        err = (g_true + err) - sent
        acc_fb += sent
        c2, s2 = compression.compress_int8(g_true)
        acc_nofb += compression.decompress_int8(c2, s2, g_true.shape)
    bias_fb = float((acc_fb / 100 - g_true).abs().max())
    assert bias_fb <= float((acc_nofb / 100 - g_true).abs().max()) + 1e-6
    assert bias_fb < 0.005
