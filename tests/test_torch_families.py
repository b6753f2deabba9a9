"""Every architecture of the LM stack through the port against the JAX
package on the CPU, at the reduced configs: the registry and the shape
pool, the parameter tree, prefill logits and every cache leaf (K/V, mamba
conv and SSM states, cross-attention memories), three decode steps,
greedy tokens, and the flash branch of the encoder and the
cross-attention.  The JAX package's ``init_params(PRNGKey(0))`` is carried
into the port; the encoder-decoder gets the same frontend frames."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402

ARCHS = list(jconfigs.ARCH_NAMES)
B, PROMPT, SRC, GEN, STEPS = 4, 16, 12, 4, 3
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jax cfg, dims, params), (port cfg, dims, params) of ``arch``."""
    jcfg = jconfigs.reduced(arch)
    jdims = jcompute_dims(jcfg, tp=1)
    jparams = jM.strip_p(jM.init_params(jax.random.PRNGKey(0), jcfg, jdims))
    tcfg = tconfigs.reduced(arch)
    tdims = tcompute_dims(tcfg, tp=1)
    tparams = convert.model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu")
    return (jcfg, jdims, jparams), (tcfg, tdims, tparams)


@functools.lru_cache(maxsize=None)
def _jax_steps(arch):
    """The JAX package's prefill and decode step, compiled once per arch."""
    jcfg = jconfigs.reduced(arch)
    jdims = jcompute_dims(jcfg, tp=1)
    prefill = jax.jit(functools.partial(jM.prefill, cfg=jcfg, dims=jdims,
                                        compute_dtype=jnp.float32),
                      static_argnames=("attn_chunk",))
    decode = jax.jit(functools.partial(jM.decode_step, cfg=jcfg, dims=jdims,
                                       compute_dtype=jnp.float32))
    return prefill, decode


def _prompts(seed=5, length=PROMPT, vocab=256):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, size=(B, length), dtype=np.int32)
    prompts[2] = prompts[0]
    return prompts


def _frames(cfg, seed=6, length=SRC):
    """Frontend frames (B, S_src, d) for an encoder-decoder, else None;
    row 2 repeats row 0, as the prompts do."""
    if not cfg.is_encdec:
        return None
    frames = np.random.default_rng(seed).normal(size=(B, length, cfg.d_model))
    frames[2] = frames[0]
    return frames.astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _walk(t, j, path=()):
    """Pairs (path, port leaf, jax leaf) of two trees of equal structure;
    dicts by key."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and sorted(t) == sorted(j), (path, sorted(t), sorted(j))
        for k in sorted(j):
            yield from _walk(t[k], j[k], path + (k,))
    elif isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            yield from _walk(a, b, path + (i,))
    else:
        yield path, t, j


def _close_tree(t, j, what):
    n = 0
    for path, a, b in _walk(t, j):
        assert tuple(a.shape) == tuple(b.shape), (what, path)
        np.testing.assert_allclose(a.to(torch.float32).numpy(), np.asarray(b, np.float32),
                                   rtol=TOL, atol=TOL, err_msg=f"{what} {path}")
        n += 1
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_config_registry_and_cells_equal_jax(arch):
    assert tconfigs.ARCH_NAMES == list(jconfigs.ARCH_NAMES)
    for get in ("get", "reduced"):
        assert dataclasses.asdict(getattr(tconfigs, get)(arch)) == \
            dataclasses.asdict(getattr(jconfigs, get)(arch))
    cfg = tconfigs.get(arch)
    assert cfg.param_count() == jconfigs.get(arch).param_count()
    assert tcompute_dims(cfg) == tcompute_dims(cfg, tp=1)
    assert tconfigs.cells([arch]) == jconfigs.cells([arch])
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for shape in tconfigs.SHAPES:
        assert tconfigs.applicable(cfg, shape) == jconfigs.applicable(jconfigs.get(arch), shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_carried_params_have_the_port_init_tree(arch):
    (_, _, jparams), (tcfg, tdims, tparams) = _model(arch)
    own = tM.init_params(torch.Generator().manual_seed(0), tcfg, tdims, device="cpu")
    leaves = list(_walk(own, tparams))
    assert leaves
    for path, mine, carried in leaves:
        assert tuple(mine.shape) == tuple(carried.shape), path
        assert mine.dtype == carried.dtype == torch.float32, path
        assert mine.device.type == "cpu", path
    for path, carried, j in _walk(tparams, jparams):
        np.testing.assert_array_equal(carried.numpy(), np.asarray(j), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_three_decode_steps_match_jax(arch):
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = _model(arch)
    jprefill, jdecode = _jax_steps(arch)
    prompts, frames = _prompts(), _frames(jcfg)
    jlg, jcache = jprefill(jparams, tokens=jnp.asarray(prompts),
                           enc_feats=None if frames is None else jnp.asarray(frames))
    tlg, tcache = tM.prefill(tparams, tcfg, tdims, torch.from_numpy(prompts),
                             enc_feats=None if frames is None else torch.from_numpy(frames),
                             compute_dtype=torch.float32)
    assert tlg.shape == jlg.shape and tlg.dtype == torch.float32
    _close(tlg, jlg)
    assert _close_tree(tcache.groups, jcache.groups, "prefill cache") > 0
    np.testing.assert_array_equal(tcache.lens.numpy(), np.asarray(jcache.lens))

    src = 0 if frames is None else SRC
    max_len = PROMPT + STEPS
    jc = jserve._rebase_cache(jM.init_cache(jcfg, jdims, B, max_len, src_len=src,
                                            dtype=jnp.float32), jcache, PROMPT)
    tc = tserve._rebase_cache(tM.init_cache(tcfg, tdims, B, max_len, src, dtype=torch.float32,
                                            device="cpu"), tcache, PROMPT)
    _close_tree(tc.groups, jc.groups, "rebased cache")
    tok = np.argmax(np.asarray(jlg[:, -1]), axis=-1)[:, None].astype(np.int32)
    for step in range(STEPS):
        jlg, jc = jdecode(jparams, token=jnp.asarray(tok), cache=jc)
        tlg, tc = tM.decode_step(tparams, tcfg, tdims, torch.from_numpy(tok), tc,
                                 compute_dtype=torch.float32)
        _close(tlg, jlg)
        _close_tree(tc.groups, jc.groups, f"decode step {step} cache")
        tok = np.argmax(np.asarray(jlg[:, -1]), axis=-1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(tc.lens.numpy(), np.asarray(jc.lens))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_equal_jax(arch):
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = _model(arch)
    prompts, frames = _prompts(seed=8), _frames(jcfg, seed=9)
    want = np.asarray(jserve.greedy_generate(
        jparams, jcfg, jdims, jnp.asarray(prompts), GEN,
        enc_feats=None if frames is None else jnp.asarray(frames)))
    got = tserve.greedy_generate(tparams, tcfg, tdims, torch.from_numpy(prompts), GEN,
                                 enc_feats=None if frames is None else torch.from_numpy(frames))
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(want[0], want[2])


def test_encoder_and_cross_attention_flash_branch_matches_jax(monkeypatch):
    """Above CHUNKED_THRESHOLD (patched to 16 in both packages) the
    encoder's self-attention (non-causal, Sq = Skv = 32), the decoder's
    (causal, 16-token chunks of 48) and the cross-attention (non-causal,
    48 queries against 32 memory rows) take the flash branch; prefill and
    two decode steps equal JAX's."""
    arch = "seamless-m4t-large-v2"
    monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 16)
    calls = []
    real = tattn.ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"], kw["block_q"], kw["block_k"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn.ops, "flash_attention", spy)
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = _model(arch)
    prompts, frames = _prompts(seed=10, length=48), _frames(jcfg, seed=11, length=32)
    jlg, jcache = jM.prefill(jparams, jcfg, jdims, jnp.asarray(prompts),
                             enc_feats=jnp.asarray(frames), compute_dtype=jnp.float32,
                             attn_chunk=16)
    tlg, tcache = tM.prefill(tparams, tcfg, tdims, torch.from_numpy(prompts),
                             enc_feats=torch.from_numpy(frames), compute_dtype=torch.float32,
                             attn_chunk=16)
    _close(tlg, jlg)
    _close_tree(tcache.groups, jcache.groups, "prefill cache")
    enc, dec = tcfg.encoder_layers, tcfg.num_layers
    assert calls == ([(32, 32, False, 2048, 2048)] * enc
                     + [(48, 48, True, 16, 16), (48, 32, False, 16, 16)] * dec)
    jc = jserve._rebase_cache(jM.init_cache(jcfg, jdims, B, 50, src_len=32, dtype=jnp.float32),
                              jcache, 48)
    tc = tserve._rebase_cache(tM.init_cache(tcfg, tdims, B, 50, 32, dtype=torch.float32,
                                            device="cpu"), tcache, 48)
    tok = np.argmax(np.asarray(jlg[:, -1]), axis=-1)[:, None].astype(np.int32)
    for _ in range(2):
        jlg, jc = jM.decode_step(jparams, jcfg, jdims, jnp.asarray(tok), jc,
                                 compute_dtype=jnp.float32)
        tlg, tc = tM.decode_step(tparams, tcfg, tdims, torch.from_numpy(tok), tc,
                                 compute_dtype=torch.float32)
        _close(tlg, jlg)
        tok = np.argmax(np.asarray(jlg[:, -1]), axis=-1)[:, None].astype(np.int32)
    _close_tree(tc.groups, jc.groups, "decode cache")


def test_encoder_decoder_prefill_needs_frames():
    _, (tcfg, tdims, tparams) = _model("seamless-m4t-large-v2")
    with pytest.raises(ValueError, match="enc_feats"):
        tM.prefill(tparams, tcfg, tdims, torch.from_numpy(_prompts()))


def test_make_prefill_passes_frames_and_chunk():
    (jcfg, _, _), (tcfg, tdims, tparams) = _model("seamless-m4t-large-v2")
    prompts, frames = torch.from_numpy(_prompts()), torch.from_numpy(_frames(jcfg))
    lg, _ = tserve.make_prefill(tcfg, tdims, compute_dtype=torch.float32)(tparams, prompts,
                                                                         frames)
    want, _ = tM.prefill(tparams, tcfg, tdims, prompts, enc_feats=frames,
                         compute_dtype=torch.float32)
    assert torch.equal(lg, want)


def test_no_port_module_imports_jax_or_the_reference():
    """A fresh interpreter imports every module of ``repro_torch`` and the
    port's plugin package: no ``jax`` and no ``repro`` module loads."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, examples.plugins_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'repro_torch.models.moe' in names and 'repro_torch.models.ssm' in names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": f"{root / 'src'}:{root}", "PATH": "/usr/bin:/bin"}
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
