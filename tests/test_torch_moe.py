"""The port's MoE FFN against the JAX package's on the CPU: the dispatch
and combine tensors, the routed output and the aux losses, drop-free and
at a capacity factor of 1.25 with drops, with and without shared experts,
and the all-ties router (zero router weights), where the lower expert
index must win as ``jax.lax.top_k`` has it.  Also the checks of
``tests/test_moe_dispatch.py`` through the port (all but the gradient
check, which belongs to training)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import split_tree  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5


def _probs(g, s, e, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(g, s, e)).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _params(d, ff, e, shared, seed=0, zero_router=False):
    """The JAX package's init_moe, as numpy, and the same on the port."""
    jp = split_tree(jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, e, shared))[0]
    jp = jax.tree_util.tree_map(np.asarray, jp)
    if zero_router:
        jp["router"] = np.zeros_like(jp["router"])
    return jp, convert.model_params_from_numpy(jp, device="cpu")


def _jax_moe_ffn(jp, x, **kw):
    """The JAX package's moe_ffn, compiled (one program per case)."""
    fn = jax.jit(lambda p, v: jmoe.moe_ffn(p, v, **kw))
    return fn(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# dispatch tensors against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,s,e,k,cap", [
    (1, 32, 4, 2, 64),     # drop-free
    (2, 16, 8, 2, 3),      # drops
    (2, 16, 8, 3, 4),      # drops, three choices
    (3, 24, 6, 1, 5),      # top-1
])
def test_dispatch_tensors_equal_jax(g, s, e, k, cap):
    probs = _probs(g, s, e, seed=g * 100 + e)
    want = jmoe._dispatch_tensors(jnp.asarray(probs), k, cap)
    got = tmoe._dispatch_tensors(torch.from_numpy(probs), k, cap)
    for name, a, b in zip(("dispatch", "combine", "gates", "idx"), got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)
    assert got[3].dtype == torch.int64


@pytest.mark.parametrize("k", [1, 2, 6])
def test_all_ties_router_picks_the_lowest_experts(k):
    """Uniform probabilities (zero router weights): every expert ties, and
    the choices are experts 0..k-1 in order, as JAX's top_k gives them."""
    e = 8
    probs = np.full((2, 8, e), 1.0 / e, np.float32)
    want = jmoe._dispatch_tensors(jnp.asarray(probs), k, 16)
    got = tmoe._dispatch_tensors(torch.from_numpy(probs), k, 16)
    np.testing.assert_array_equal(got[3].numpy(), np.broadcast_to(np.arange(k), (2, 8, k)))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_ranked_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    values, idx = tmoe.ranked_top_k(x, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("group,k,cf,e", [(1024, 6, 1.25, 64), (4, 6, 1.25, 64),
                                          (192, 2, 8.0, 8), (128, 2, 0.25, 4)])
def test_capacity_formula(group, k, cf, e):
    assert tmoe.moe_capacity(group, k, cf, e) == max(int(np.ceil(group * k * cf / e)), k)


# ---------------------------------------------------------------------------
# moe_ffn and its aux losses against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(b=2, s=24, d=32, ff=48, e=8, shared=1, k=2, cf=8.0),       # drop-free
    dict(b=2, s=64, d=32, ff=48, e=8, shared=0, k=2, cf=1.25),      # drops
    dict(b=1, s=96, d=16, ff=32, e=6, shared=2, k=3, cf=1.25),      # drops, shared
    dict(b=4, s=1, d=32, ff=48, e=8, shared=1, k=2, cf=1.25),       # a decode step's group
])
def test_moe_ffn_and_aux_equal_jax(case):
    jp, tp = _params(case["d"], case["ff"], case["e"], case["shared"])
    x = _x(case["b"], case["s"], case["d"])
    kw = dict(num_experts=case["e"], top_k=case["k"], capacity_factor=case["cf"])
    jout, jaux = _jax_moe_ffn(jp, x, **kw)
    tout, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    for name in ("moe_lb_loss", "moe_z_loss"):
        assert taux[name].dtype == torch.float32 and taux[name].shape == ()
        np.testing.assert_allclose(taux[name].numpy(), np.asarray(jaux[name]), rtol=1e-6)


def test_moe_ffn_all_ties_router_equals_jax():
    jp, tp = _params(32, 48, 8, 1, zero_router=True)
    x = _x(2, 32, 32, seed=4)
    kw = dict(num_experts=8, top_k=2, capacity_factor=1.25)
    jout, jaux = _jax_moe_ffn(jp, x, **kw)
    tout, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(taux[name].numpy(), np.asarray(jaux[name]), rtol=1e-6)
    # every token chose experts 0 and 1: the balance loss is E * (1/E) * 1
    assert float(taux["moe_lb_loss"]) == pytest.approx(1.0, rel=1e-6)


def test_tokens_must_split_into_groups():
    _, tp = _params(16, 32, 4, 0)
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_ffn(tp, torch.zeros((3, 500, 16)), num_experts=4, top_k=2,
                     capacity_factor=1.25)


# ---------------------------------------------------------------------------
# tests/test_moe_dispatch.py through the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,e,k", [(0, 2, 1), (3, 4, 2), (17, 8, 3), (42, 5, 2),
                                      (77, 8, 1), (99, 3, 3)])
def test_capacity_never_exceeded(seed, e, k):
    k = min(k, e)
    probs = torch.from_numpy(_probs(2, 16, e, seed))
    cap = 4
    dispatch, _, _, _ = tmoe._dispatch_tensors(probs, k, cap)
    slot_load = dispatch.sum(dim=1)                      # (G, E, C): at most one token
    assert bool((slot_load <= 1.0 + 1e-6).all())
    load = dispatch.sum(dim=(1, 3))                      # (G, E): at most the capacity
    assert bool((load <= cap + 1e-6).all())


def test_no_drops_with_big_capacity():
    probs = torch.from_numpy(_probs(1, 32, 4, 3))
    dispatch, combine, _, _ = tmoe._dispatch_tensors(probs, 2, 64)
    np.testing.assert_allclose(dispatch.sum(dim=(2, 3)).numpy(), 2.0, rtol=1e-6)
    np.testing.assert_allclose(combine.sum(dim=(2, 3)).numpy(), 1.0, rtol=1e-5)


def test_earlier_choices_win_capacity():
    """With capacity 1 and all tokens preferring expert 0, only the first
    token per group gets its first choice."""
    probs = torch.full((1, 8, 4), 0.01)
    probs[:, :, 0] = 0.97
    dispatch, _, _, _ = tmoe._dispatch_tensors(probs, 1, 1)
    d = dispatch[0]                                      # (S, E, C)
    assert float(d[0, 0, 0]) == 1.0
    assert float(d[1:, 0, :].sum()) == 0.0               # dropped


def test_forward_and_shapes():
    d, ff, e = 32, 64, 8
    _, tp = _params(d, ff, e, 1)
    x = torch.from_numpy(_x(2, 64, d, seed=5))
    out, aux = tmoe.moe_ffn(tp, x, num_experts=e, top_k=2, capacity_factor=2.0)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(aux["moe_lb_loss"]) > 0.5              # ~1 for balanced routing
    assert np.isfinite(float(aux["moe_z_loss"]))


def test_capacity_factor_controls_drops():
    """Tiny capacity -> tokens lose their routed output (drops); huge ->
    none."""
    d, ff, e = 16, 32, 4
    _, tp = _params(d, ff, e, 0)
    x = torch.from_numpy(_x(1, 128, d, seed=2))
    small, _ = tmoe.moe_ffn(tp, x, num_experts=e, top_k=2, capacity_factor=0.25)
    big, _ = tmoe.moe_ffn(tp, x, num_experts=e, top_k=2, capacity_factor=float(e))
    diff = (small - big).abs().sum(dim=-1)
    assert bool((diff[0] > 1e-6).any())
