"""The port's training path against the JAX package's on the CPU:
``forward`` and ``lm_loss`` for every reduced architecture (the
encoder-decoder with frontend frames, the MoE aux losses), the gradients
of one train step at every leaf, three AdamW steps of the integration
test's tiny LM with the SJPC monitor, the remat modes, ``token_batches``,
one step above ``CHUNKED_THRESHOLD`` (the flash op and its backward) on the
dense, MoE and encoder-decoder configs, and a fresh interpreter that
imports the training modules without jax.  Parameters and states are carried
across with ``convert``."""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.loader import token_batches as jtoken_batches  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro.optim import make_adamw as jmake_adamw  # noqa: E402
from repro.optim.schedules import constant as jconstant  # noqa: E402
from repro.sketchstream.monitor import SketchMonitorConfig as JMonitorConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.data.loader import to_device, token_batches  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tM  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402
from repro_torch.optim import make_adamw  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.sketchstream.monitor import SketchMonitorConfig, init_monitor  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(jconfigs.ARCH_NAMES)
B, S, SRC = 2, 16, 12
TOL = 1e-5
# tests/test_integration_train.py's tiny LM and monitor
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=1, d_ff=64, vocab_size=128, head_dim=16)
MONITOR = dict(d=4, s=3, width=256, depth=2, shards=1)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jax cfg, dims, params), (port cfg, dims, params) of a reduced arch."""
    jcfg = jconfigs.reduced(arch)
    jdims = jcompute_dims(jcfg, tp=1)
    jparams = jM.strip_p(jM.init_params(jax.random.PRNGKey(0), jcfg, jdims))
    tcfg = tconfigs.reduced(arch)
    tdims = tcompute_dims(tcfg, tp=1)
    tparams = convert.model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu")
    return (jcfg, jdims, jparams), (tcfg, tdims, tparams)


def _batch(cfg, seed=3, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.is_encdec:
        out["enc_feats"] = rng.normal(size=(batch, SRC, cfg.d_model)).astype(np.float32)
    return out


def _jax_loss_fn(cfg, dims, batch):
    def fn(params):
        lg, aux = jM.forward(params, cfg, dims, jnp.asarray(batch["tokens"]),
                             enc_feats=(jnp.asarray(batch["enc_feats"])
                                        if "enc_feats" in batch else None),
                             compute_dtype=jnp.float32, remat="none", ssm_chunk=8)
        loss = jM.lm_loss(lg, jnp.asarray(batch["labels"]), cfg.vocab_size)
        return loss, (lg, aux)
    return fn


def _port_forward(tparams, tcfg, tdims, batch, **kw):
    kw.setdefault("remat", "none")
    lg, aux = tM.forward(tparams, tcfg, tdims, torch.from_numpy(batch["tokens"]),
                         enc_feats=(torch.from_numpy(batch["enc_feats"])
                                    if "enc_feats" in batch else None),
                         compute_dtype=torch.float32, ssm_chunk=8, **kw)
    return lg, aux, tM.lm_loss(lg, torch.from_numpy(batch["labels"]), tcfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_loss_and_aux_match_jax(arch):
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = _model(arch)
    batch = _batch(jcfg)
    jloss, (jlg, jaux) = jax.jit(_jax_loss_fn(jcfg, jdims, batch))(jparams)
    with torch.no_grad():
        lg, aux, loss = _port_forward(tparams, tcfg, tdims, batch)
    assert lg.dtype == torch.float32 and tuple(lg.shape) == tuple(jlg.shape)
    assert _rel(lg, jlg) <= TOL
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert sorted(aux) == sorted(jaux) == ["moe_lb_loss", "moe_z_loss"]
    for k in aux:
        assert abs(float(aux[k]) - float(jaux[k])) <= TOL * max(abs(float(jaux[k])), 1e-30), k
    if jcfg.num_experts:
        assert float(jaux["moe_lb_loss"]) > 0


def test_lm_loss_masks_and_padded_vocab_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 33, size=(3, 5)).astype(np.int32)
    labels[0, 0] = -1                      # outside the vocabulary: a zero one-hot
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jM.lm_loss(jnp.asarray(logits), jnp.asarray(labels), 33,
                          mask=None if m is None else jnp.asarray(m))
        got = tM.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels), 33,
                         mask=None if m is None else torch.from_numpy(m))
        assert abs(float(got) - float(want)) <= TOL * max(abs(float(want)), 1.0)


def _tiny_configs(kind):
    if kind == "dense":
        return JArch(**TINY), TArch(**TINY)
    return jconfigs.reduced("deepseek-moe-16b"), tconfigs.reduced("deepseek-moe-16b")


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_train_step_gradients_match_jax_at_every_leaf(kind):
    """One step's gradients of the total loss (the MoE aux losses
    weighted in), float32, at every leaf in JAX's leaf order."""
    jcfg, tcfg = _tiny_configs(kind)
    jdims, tdims = jcompute_dims(jcfg, tp=1), tcompute_dims(tcfg, tp=1)
    jparams = jM.strip_p(jM.init_params(jax.random.PRNGKey(1), jcfg, jdims))
    batch = _batch(jcfg, seed=5, batch=4)

    def jtotal(params):
        loss, (_, aux) = _jax_loss_fn(jcfg, jdims, batch)(params)
        if jcfg.num_experts:
            loss = (loss + jtrain.MOE_LB_WEIGHT * aux["moe_lb_loss"]
                    + jtrain.MOE_Z_WEIGHT * aux["moe_z_loss"])
        return loss

    jgrads = jax.tree_util.tree_leaves(jax.jit(jax.grad(jtotal))(jparams))
    tparams = convert.model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu")
    leaves = tree.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    lg, aux, loss = _port_forward(tparams, tcfg, tdims, batch)
    if tcfg.num_experts:
        loss = (loss + ttrain.MOE_LB_WEIGHT * aux["moe_lb_loss"]
                + ttrain.MOE_Z_WEIGHT * aux["moe_z_loss"])
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(jgrads)
    worst = 0.0
    for g, jg in zip(grads, jgrads):
        assert tuple(g.shape) == tuple(jg.shape)
        worst = max(worst, _rel(g, jg))
    assert worst <= TOL, worst


def _tiny_states():
    """The integration test's tiny LM, AdamW at a constant 5e-3 without
    decay and the monitor: the JAX state and step, and the port's carried
    from the same state."""
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jdims, tdims = jcompute_dims(jcfg, tp=1), tcompute_dims(tcfg, tp=1)
    jm, tm = JMonitorConfig(**MONITOR), SketchMonitorConfig(**MONITOR)
    jopt = jmake_adamw(jconstant(5e-3), weight_decay=0.0)
    jstate, jmp, _ = jtrain.make_train_state(jax.random.PRNGKey(0), jcfg, jdims, jopt,
                                             monitor_cfg=jm)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jdims, jopt, None, monitor_cfg=jm,
                                           monitor_params=jmp, remat="none", ssm_chunk=8,
                                           compute_dtype=jnp.float32))
    tstate = convert.train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                            device="cpu")
    tmp, _ = init_monitor(tm, device="cpu")
    topt = make_adamw(constant(5e-3), weight_decay=0.0)
    tstep = ttrain.make_train_step(tcfg, tdims, topt, monitor_cfg=tm, monitor_params=tmp,
                                   remat="none", ssm_chunk=8, compute_dtype=torch.float32)
    return (jstate, jstep), (tstate, tstep)


def integration_batch(step):
    """tests/test_integration_train.py's batch of ``step``."""
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, TINY["vocab_size"], size=(4, 33), dtype=np.int32)
    toks[1] = toks[0]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_three_adamw_steps_with_the_monitor_match_jax():
    (jstate, jstep), (tstate, tstep) = _tiny_states()
    for step in range(3):
        batch = integration_batch(step)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= TOL * abs(float(jmet[k])), k
    assert int(tstate.step) == int(jstate.step) == 3
    for got, want in zip(tree.tree_leaves(tstate.params),
                         jax.tree_util.tree_leaves(jstate.params)):
        assert _rel(got, want) <= TOL
    for got, want in zip(tree.tree_leaves(tstate.opt), jax.tree_util.tree_leaves(jstate.opt)):
        if got.dtype == torch.float32:
            assert _rel(got, want) <= TOL
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tstate.monitor, jstate.monitor):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(np.abs(tstate.monitor.counters.numpy()).sum()) > 0


def test_train_step_monitor_dispatches_the_kernel_ops():
    """The step's monitor goes through the sampling, fingerprint and
    sketch_update ops (their plain tier on the CPU): once, and once per
    level of d=4, s=3."""
    from repro_torch.obs import metrics
    (_, _), (tstate, tstep) = _tiny_states()
    reg = metrics.MetricsRegistry()
    prev = metrics.set_default_registry(reg)
    try:
        tstep(tstate, integration_batch(0))
    finally:
        metrics.set_default_registry(prev)
    counts = {dict(k)["kernel"]: v for k, v in reg.series("kernel_dispatch_total").items()}
    assert counts == {"sample_weights": 1, "fingerprint": 2, "sketch_update": 2}


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("threshold", [None, 8])
def test_remat_modes_give_equal_loss_and_gradients(kind, threshold, monkeypatch):
    """remat none, full and dots bit for bit; with the threshold at 8
    every attention is the flash op, whose forward the checkpoint
    recomputes through its autograd.Function."""
    if threshold is not None:
        monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", threshold)
    _, tcfg = _tiny_configs(kind)
    tdims = tcompute_dims(tcfg, tp=1)
    params = tM.init_params(torch.Generator().manual_seed(2), tcfg, tdims, device="cpu")
    batch = _batch(tcfg, seed=6, batch=4)
    leaves = tree.tree_leaves(params)
    results = {}
    for remat in tM.REMAT_MODES:
        for p in leaves:
            p.requires_grad_(True)
        _, aux, loss = _port_forward(params, tcfg, tdims, batch, remat=remat, attn_chunk=8)
        total = loss + aux["moe_lb_loss"] + aux["moe_z_loss"]
        results[remat] = (total.detach(), torch.autograd.grad(total, leaves))
        for p in leaves:
            p.requires_grad_(False)
    want_loss, want = results["none"]
    for remat in ("full", "dots"):
        loss, grads = results[remat]
        assert torch.equal(loss, want_loss), remat
        for g, w in zip(grads, want):
            assert torch.equal(g, w), remat


def test_unknown_remat_and_mesh_raise():
    _, tcfg = _tiny_configs("dense")
    tdims = tcompute_dims(tcfg, tp=1)
    params = tM.init_params(torch.Generator().manual_seed(0), tcfg, tdims, device="cpu")
    with pytest.raises(ValueError):
        tM.forward(params, tcfg, tdims, torch.zeros((1, 4), dtype=torch.int32),
                   remat="offload")
    # a mesh's model axis needs the Dims of its tp; seq_parallel needs a mesh
    with pytest.raises(ValueError, match="Dims built for tp=1 on a model axis of 2"):
        ttrain.make_train_step(tcfg, tdims, make_adamw(constant(1e-3)),
                               mesh=AbstractMesh((1, 2), ("data", "model")))
    with pytest.raises(ValueError, match="seq_parallel"):
        ttrain.make_train_step(tcfg, tdims, make_adamw(constant(1e-3)), seq_parallel=True)


# The train step above CHUNKED_THRESHOLD (patched to 8 in both packages):
# (model, probs_dtype, attention chunk).  The dense tiny LM and the reduced
# MoE over two 8-token tiles; the encoder-decoder's encoder (12 frames,
# non-causal) and its cross-attention (16 queries over 12 frames, the
# flash op with Sq != Skv) in 4-token tiles; bf16 probabilities on the
# dense LM, where the two packages round P, dP and dV at places a tile's
# rescale factor apart (a few bf16 ulps, 2^-8 each, of a leaf's max).
ABOVE_THRESHOLD = [("dense", "float32", 8), ("moe", "float32", 8),
                   ("seamless-m4t-large-v2", "float32", 4), ("dense", "bfloat16", 8)]
PROBS = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PROBS_BF16_TOL = 2e-2


def _above_threshold_configs(kind):
    if kind in ("dense", "moe"):
        return _tiny_configs(kind)
    return jconfigs.reduced(kind), tconfigs.reduced(kind)


@pytest.mark.parametrize("kind,probs,chunk", ABOVE_THRESHOLD)
def test_train_step_above_the_threshold_matches_jax(kind, probs, chunk, monkeypatch):
    """One step's total loss and its gradient at every leaf, float32,
    with every attention above the (patched) threshold: the port's flash
    op and its backward (plain tier) against ``jax.value_and_grad``
    through ``chunked_attention``."""
    monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", 8)
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 8)
    jcfg, tcfg = _above_threshold_configs(kind)
    jdims, tdims = jcompute_dims(jcfg, tp=1), tcompute_dims(tcfg, tp=1)
    jparams = jM.strip_p(jM.init_params(jax.random.PRNGKey(2), jcfg, jdims))
    batch = _batch(jcfg, seed=9)
    jprobs, tprobs = PROBS[probs]

    def jtotal(params):
        lg, aux = jM.forward(params, jcfg, jdims, jnp.asarray(batch["tokens"]),
                             enc_feats=(jnp.asarray(batch["enc_feats"])
                                        if "enc_feats" in batch else None),
                             compute_dtype=jnp.float32, remat="none", attn_chunk=chunk,
                             probs_dtype=jprobs)
        loss = jM.lm_loss(lg, jnp.asarray(batch["labels"]), jcfg.vocab_size)
        if jcfg.num_experts:
            loss = (loss + jtrain.MOE_LB_WEIGHT * aux["moe_lb_loss"]
                    + jtrain.MOE_Z_WEIGHT * aux["moe_z_loss"])
        return loss

    jloss, jgrads = jax.jit(jax.value_and_grad(jtotal))(jparams)
    jgrads = jax.tree_util.tree_leaves(jgrads)
    tparams = convert.model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu")
    leaves = tree.tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    from repro_torch.obs import metrics
    reg = metrics.MetricsRegistry()
    prev = metrics.set_default_registry(reg)
    try:
        _, aux, loss = _port_forward(tparams, tcfg, tdims, batch, attn_chunk=chunk,
                                     probs_dtype=tprobs)
        if tcfg.num_experts:
            loss = (loss + ttrain.MOE_LB_WEIGHT * aux["moe_lb_loss"]
                    + ttrain.MOE_Z_WEIGHT * aux["moe_z_loss"])
        grads = torch.autograd.grad(loss, leaves)
    finally:
        metrics.set_default_registry(prev)
    counts = {dict(key)["kernel"]: n for key, n in reg.series("kernel_dispatch_total").items()}
    attention_layers = tcfg.num_layers + (tcfg.encoder_layers + tcfg.num_layers
                                          if tcfg.is_encdec else 0)
    assert counts == {"flash_attention": attention_layers,
                      "flash_attention_bwd": attention_layers}, counts
    tol = TOL if probs == "float32" else PROBS_BF16_TOL
    assert abs(float(loss.detach()) - float(jloss)) <= tol * abs(float(jloss))
    assert len(grads) == len(jgrads)
    worst = 0.0
    for g, jg in zip(grads, jgrads):
        assert tuple(g.shape) == tuple(jg.shape)
        worst = max(worst, _rel(g, jg))
    assert worst <= tol, worst


def test_forward_above_the_threshold_without_grad_matches_jax(monkeypatch):
    """Without grad the flash op is the forward alone, bf16 probabilities
    included (which raised before the op had a backward)."""
    monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", 8)
    monkeypatch.setattr(tattn, "CHUNKED_THRESHOLD", 8)
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = _model("qwen2.5-3b")
    batch = _batch(jcfg)
    for jprobs, tprobs in PROBS.values():
        jlg, _ = jax.jit(lambda p: jM.forward(p, jcfg, jdims, jnp.asarray(batch["tokens"]),
                                              compute_dtype=jnp.float32, remat="none",
                                              attn_chunk=8, probs_dtype=jprobs))(jparams)
        with torch.no_grad():
            lg, _ = tM.forward(tparams, tcfg, tdims, torch.from_numpy(batch["tokens"]),
                               compute_dtype=torch.float32, remat="none", attn_chunk=8,
                               probs_dtype=tprobs)
        assert lg.grad_fn is None
        assert _rel(lg, jlg) <= (TOL if tprobs == torch.float32 else PROBS_BF16_TOL)


def test_probs_dtype_bf16_forward_matches_jax():
    (jcfg, jdims, jparams), (tcfg, tdims, tparams) = _model("qwen2.5-3b")
    batch = _batch(jcfg)
    jlg, _ = jax.jit(lambda p: jM.forward(p, jcfg, jdims, jnp.asarray(batch["tokens"]),
                                          compute_dtype=jnp.float32, remat="none",
                                          probs_dtype=jnp.bfloat16))(jparams)
    with torch.no_grad():
        lg, _ = tM.forward(tparams, tcfg, tdims, torch.from_numpy(batch["tokens"]),
                           compute_dtype=torch.float32, remat="none",
                           probs_dtype=torch.bfloat16)
    assert _rel(lg, jlg) <= TOL


@pytest.mark.parametrize("seed,batch,seq,vocab,dup", [(7, 8, 128, 512, 0.2),
                                                      (0, 3, 31, 151_936, 0.05)])
def test_token_batches_equal_jax(seed, batch, seq, vocab, dup):
    got = token_batches(batch, seq, vocab, seed=seed, dup_fraction=dup)
    want = jtoken_batches(batch, seq, vocab, seed=seed, dup_fraction=dup)
    for _ in range(3):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    on = to_device(a, device="cpu")
    assert on["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(on["labels"].numpy(), a["labels"])


def test_make_train_state_shapes_and_monitor():
    _, tcfg = _tiny_configs("dense")
    tdims = tcompute_dims(tcfg, tp=1)
    mcfg = SketchMonitorConfig(**MONITOR)
    state, mp = ttrain.make_train_state(torch.Generator().manual_seed(0), tcfg, tdims,
                                        make_adamw(constant(1e-3)), monitor_cfg=mcfg,
                                        device="cpu")
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    assert tuple(state.monitor.counters.shape) == (1, 2, 2, 256)
    assert [tuple(x.shape) for x in tree.tree_leaves(state.opt.m)] == \
        [tuple(x.shape) for x in tree.tree_leaves(state.params)]
    assert dataclasses.fields(mcfg)[-2].name == "merge_every_step"


def test_tree_order_is_jax_order():
    from collections import namedtuple
    NT = namedtuple("NT", ["b", "a"])
    t = {"z": [1, (2, None)], "a": NT(3, {"y": 4, "x": 5}), "m": None}
    leaves, treedef = tree.tree_flatten(t)
    assert leaves == jax.tree_util.tree_leaves(t) == [3, 5, 4, 1, 2]
    back = treedef.unflatten(leaves)
    assert back == t and list(back) == ["a", "m", "z"]
    assert treedef.flatten_up_to({"z": [10, ([1], None)], "a": NT(3, {"y": 4, "x": [5]}),
                                  "m": None}) == [3, [5], 4, 10, [1]]


def test_training_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.optim, repro_torch.runtime\n"
            "import repro_torch.checkpoint, repro_torch.data.loader, repro_torch.tree\n"
            "import repro_torch.optim.q8adam, repro_torch.optim.compression\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_example_trains_on_the_cpu(tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import train_lm_sketch_torch as example
    finally:
        sys.path.pop(0)
    example.main(["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
                  "--ckpt", str(tmp_path), "--inject-failure", "2"])
    out = capsys.readouterr().out
    assert "lm-smoke" in out and "SJPC stream monitor" in out and "restore" in out
