"""The port's dense serving path against the JAX package on the CPU, at the
reduced qwen2.5-3b configuration: the config, the parameter carry-over,
prefill logits and caches, decode steps, greedy generation, the chunked
(flash) branch of prefill, recordize and the SJPC stream monitor."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import recordize as jrec  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro.sketchstream import monitor as jmon  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import recordize as trec  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402
from repro_torch.sketchstream import monitor as tmon  # noqa: E402

ARCH = "qwen2.5-3b"
B, PROMPT, GEN = 8, 24, 8
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    """(jax cfg, dims, params), (port cfg, dims, params): the JAX package's
    init_params(PRNGKey(0)) carried into the port."""
    jcfg = jconfigs.reduced(ARCH)
    jdims = jcompute_dims(jcfg, tp=1)
    jparams = jM.strip_p(jM.init_params(jax.random.PRNGKey(0), jcfg, jdims))
    tcfg = tconfigs.reduced(ARCH)
    tdims = tcompute_dims(tcfg, tp=1)
    tparams = convert.model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu")
    return (jcfg, jdims, jparams), (tcfg, tdims, tparams)


def _prompts(seed=5, batch=B, length=PROMPT, vocab=256):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, size=(batch, length), dtype=np.int32)
    prompts[3] = prompts[0]            # duplicate requests, as examples/serve_decode.py
    prompts[5] = prompts[0]
    return prompts


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_reduced_config_equals_jax():
    for name in (ARCH,):
        assert dataclasses.asdict(tconfigs.reduced(name)) == \
            dataclasses.asdict(jconfigs.reduced(name))
        assert dataclasses.asdict(tconfigs.get(name)) == dataclasses.asdict(jconfigs.get(name))
    assert list(tconfigs.REGISTRY) == list(jconfigs.REGISTRY)
    full = tconfigs.get(ARCH)
    assert tcompute_dims(full) == tcompute_dims(full, tp=1)
    assert full.param_count() == jconfigs.get(ARCH).param_count()


def test_params_carry_over_with_the_jax_layout(model):
    (_, _, jparams), (tcfg, tdims, tparams) = model
    jleaves, jdef = jax.tree_util.tree_flatten(jparams)
    tleaves = [x for x in _leaves(tparams)]
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    layer = tparams["groups"][0][0]
    assert layer["attn"]["wq"].shape == (tcfg.num_layers, tcfg.d_model, tdims.heads,
                                         tcfg.head_dim)
    # the port's own init has the same tree, shapes and dtypes
    own = tM.init_params(torch.Generator().manual_seed(0), tcfg, tdims, device="cpu")
    assert [tuple(x.shape) for x in _leaves(own)] == [tuple(x.shape) for x in tleaves]
    assert float(own["embed"].abs().max()) <= 2.0


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):              # jax flattens dicts in key order
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _prefill_and_decode(model, prompts, steps, **prefill_kw):
    """Prefill then ``steps`` decode steps in f32 through both packages;
    compares the logits and the caches at every step."""
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = model
    jlg, jcache = jM.prefill(jparams, jcfg, jdims, jnp.asarray(prompts),
                             compute_dtype=jnp.float32, **prefill_kw)
    tlg, tcache = tM.prefill(tparams, tcfg, tdims, torch.from_numpy(prompts),
                             compute_dtype=torch.float32, **prefill_kw)
    assert tlg.shape == jlg.shape and tlg.dtype == torch.float32
    _close(tlg, jlg)
    for jg, tg in zip(jcache.groups, tcache.groups):
        for name in ("k", "v"):
            _close(tg[0][name], jg[0][name])
    np.testing.assert_array_equal(tcache.lens.numpy(), np.asarray(jcache.lens))

    b, s = prompts.shape
    max_len = s + steps
    jc = jserve._rebase_cache(jM.init_cache(jcfg, jdims, b, max_len, dtype=jnp.float32),
                              jcache, s)
    tc = tserve._rebase_cache(tM.init_cache(tcfg, tdims, b, max_len, dtype=torch.float32,
                                            device="cpu"), tcache, s)
    tok = np.argmax(np.asarray(jlg[:, -1]), axis=-1)[:, None].astype(np.int32)
    for _ in range(steps):
        jlg, jc = jM.decode_step(jparams, jcfg, jdims, jnp.asarray(tok), jc,
                                 compute_dtype=jnp.float32)
        tlg, tc = tM.decode_step(tparams, tcfg, tdims, torch.from_numpy(tok), tc,
                                 compute_dtype=torch.float32)
        _close(tlg, jlg)
        tok = np.argmax(np.asarray(jlg[:, -1]), axis=-1)[:, None].astype(np.int32)
    for jg, tg in zip(jc.groups, tc.groups):
        for name in ("k", "v"):
            _close(tg[0][name], jg[0][name])
    np.testing.assert_array_equal(tc.lens.numpy(), np.asarray(jc.lens))


def test_prefill_and_three_decode_steps_match_jax(model):
    _prefill_and_decode(model, _prompts(), 3)


def test_chunked_prefill_branch_matches_jax(model, monkeypatch):
    """Above CHUNKED_THRESHOLD prefill takes the chunked (flash) branch in
    both packages: the threshold is patched to 16 in both attention modules
    for this test, with 16-token chunks over 64-token prompts."""
    monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 16)
    calls = []
    real = tattn.ops.flash_attention

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(tattn.ops, "flash_attention", spy)
    prompts = _prompts(seed=9, length=64)
    _prefill_and_decode(model, prompts, 2, attn_chunk=16)
    (_, _, _), (tcfg, _, _) = model
    assert len(calls) == tcfg.num_layers
    assert all(kw["block_q"] == kw["block_k"] == 16 and kw["causal"] for kw in calls)


def test_greedy_generate_tokens_equal_jax(model):
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = model
    prompts = _prompts()
    want = np.asarray(jserve.greedy_generate(jparams, jcfg, jdims, jnp.asarray(prompts), GEN))
    got = tserve.greedy_generate(tparams, tcfg, tdims, torch.from_numpy(prompts), GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(want[0], want[3]) and np.array_equal(want[0], want[5])


def test_make_prefill_and_decode_step_are_the_model_calls(model):
    _, (tcfg, tdims, tparams) = model
    prompts = torch.from_numpy(_prompts())
    lg, cache = tserve.make_prefill(tcfg, tdims, compute_dtype=torch.float32)(tparams, prompts)
    want, _ = tM.prefill(tparams, tcfg, tdims, prompts, compute_dtype=torch.float32)
    assert torch.equal(lg, want)
    step = tserve.make_decode_step(tcfg, tdims, compute_dtype=torch.float32)
    cache = tserve._rebase_cache(tM.init_cache(tcfg, tdims, B, PROMPT + 1, dtype=torch.float32,
                                               device="cpu"), cache, PROMPT)
    lg2, cache = step(tparams, torch.argmax(lg[:, -1], dim=-1)[:, None], cache)
    assert lg2.shape == (B, 1, tdims.vocab) and bool((cache.lens == PROMPT + 1).all())


def test_layers_match_jax():
    """rmsnorm, rope, the MLP and the padded-vocabulary mask on the same
    inputs as the JAX package's layers."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) * 997, (2, 5))
    np.testing.assert_array_equal(tl.rope_frequencies(16, 1e6), np.asarray(
        jl.rope_frequencies(16, 1e6)))
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e6),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-6)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(scale), torch.from_numpy(h)),
           jl.rmsnorm(jnp.asarray(scale), jnp.asarray(h)), 1e-6)
    w = {k: rng.normal(size=shape).astype(np.float32) * 0.1
         for k, shape in (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    _close(tl.mlp({k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(h)),
           jl.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(h)))
    lg = rng.normal(size=(2, 1, 256)).astype(np.float32)
    for true_vocab in (256, 250):
        np.testing.assert_array_equal(
            tl.mask_padded_vocab(torch.from_numpy(lg), true_vocab).numpy(),
            np.asarray(jl.mask_padded_vocab(jnp.asarray(lg), true_vocab)))


@pytest.mark.parametrize("d,length", [(4, 24), (6, 40), (3, 7)])
def test_records_from_tokens_bit_exact(d, length):
    tokens = _prompts(seed=d, length=length, vocab=151936)
    want = np.asarray(jrec.records_from_tokens(jnp.asarray(tokens), d))
    got = trec.records_from_tokens(torch.from_numpy(tokens), d)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(trec.np_records_from_tokens(tokens, d), want)


def _monitor_states(pkg, cfg, params, state, shards_tokens):
    """Each shard's tokens through monitor_update_local, stacked on the
    shard axis."""
    counters, ns = [], []
    for i, tokens in enumerate(shards_tokens):
        if pkg is jmon:
            c, n = pkg.monitor_update_local(cfg, params, state.counters[i], state.n[i],
                                            jnp.asarray(tokens), state.step)
        else:
            c, n = pkg.monitor_update_local(cfg, params, state.counters[i], state.n[i],
                                            torch.from_numpy(tokens), state.step)
        counters.append(c)
        ns.append(n)
    if pkg is jmon:
        return jmon.MonitorState(jnp.stack(counters), jnp.stack(ns), state.step)
    return tmon.MonitorState(torch.stack(counters), torch.stack(ns), state.step)


def test_monitor_matches_jax():
    """Counters, n and both queries of a two-shard monitor equal the JAX
    package's; the per-level pair estimates agree to 1e-6."""
    kw = dict(d=4, s=2, ratio=0.5, width=256, depth=3, shards=2)
    jcfg, tcfg = jmon.SketchMonitorConfig(**kw), tmon.SketchMonitorConfig(**kw)
    train = [_prompts(seed=11, batch=16, length=32), _prompts(seed=12, batch=16, length=32)]
    evals = [_prompts(seed=13, batch=16, length=32), train[0].copy()]
    evals[0][:4] = train[1][:4]
    est = {}
    for name, pkg, cfg in (("jax", jmon, jcfg), ("torch", tmon, tcfg)):
        if pkg is jmon:
            params, state = pkg.init_monitor(cfg)
        else:
            params, state = pkg.init_monitor(cfg, device="cpu")
        a = _monitor_states(pkg, cfg, params, state, train)
        b = _monitor_states(pkg, cfg, params, state, evals)
        est[name] = (a, b, pkg.monitor_estimate(cfg, a), pkg.contamination_estimate(cfg, a, b))
    (ja, jb, jest, jcon), (ta, tb, test_, tcon) = est["jax"], est["torch"]
    for j, t in ((ja, ta), (jb, tb)):
        np.testing.assert_array_equal(t.counters.numpy(), np.asarray(j.counters))
        np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
        assert t.counters.dtype == torch.int32
    merged = tmon.merge_monitor(ta)
    assert merged.counters.dtype == torch.int32 and float(merged.n) == 32.0
    assert test_["n"] == jest["n"] and test_["g"].keys() == jest["g"].keys()
    np.testing.assert_allclose(test_["per_level_pairs"], jest["per_level_pairs"],
                               rtol=1e-6, atol=1e-6)
    for k in jest["g"]:
        np.testing.assert_allclose(test_["g"][k], jest["g"][k], rtol=1e-6)
    np.testing.assert_allclose(tcon["per_level_pairs"], jcon["per_level_pairs"],
                               rtol=1e-6, atol=1e-6)
    for k in jcon["join"]:
        np.testing.assert_allclose(tcon["join"][k], jcon["join"][k], rtol=1e-6, atol=1e-6)
