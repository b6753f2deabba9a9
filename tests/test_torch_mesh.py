"""Training across ranks on the CPU: the port's mesh, shardings, sharded
Q8Adam, elastic restore and data-parallel train step.

* Spec trees against the JAX package's, on mesh shapes without devices
  (``launch.mesh.AbstractMesh`` and ``jax.sharding.AbstractMesh``; the
  spec functions read only axis names and sizes): the logical axes and
  ``param_pspecs`` of four reduced configs on (data=2, model=1) and on
  the multi-pod (pod=2, data=16, model=16) rules, ``cache_pspecs`` of
  reduced jamba in both regimes, ``state_shardings``, and the activation,
  logits and batch specs.
* ``make_q8adam_sharded`` at one rank against JAX's on a 1 x 1 mesh
  (jitted, as ``tests/test_q8_sharded.py`` runs it), 60 steps, to
  ``tests/test_torch_optim.py``'s Q8Adam tolerance.
* Two gloo ranks (one spawn for the file, ``torch_rank_cases.mesh_rank``):
  the mesh train step (f32, AdamW) of reduced qwen2.5-3b and reduced
  deepseek-moe-16b -- MoE routing groups spanning the ranks, and within
  them -- against the port's one-process step on the whole batch (loss
  within 1e-6 relative, every gradient leaf within 1e-5 of its max |g|);
  the deferred monitor against JAX's ``monitor_update_local`` on each
  rank's rows and the merged one on the whole batch, bit for bit; a mesh
  with a model axis of 2 and Dims for tp=1 refused; each rank's Q8 codes
  and scales after three steps against JAX's (data=2, model=1) and
  (data=1, model=2) runs on two host devices (one subprocess); a
  checkpoint restored onto the mesh with target shardings.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import torch_rank_cases as cases  # noqa: E402
from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_debug_mesh as jmake_debug_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro.models.layers import split_tree  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import q8sharded as jq8s  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.sketchstream import monitor as jmon  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import compute_dims  # noqa: E402
from repro_torch.optim import make_adamw  # noqa: E402
from repro_torch.optim.q8sharded import make_q8adam_sharded, state_pspecs  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.sketchstream.monitor import SketchMonitorConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 1e-5              # tests/test_torch_optim.py's Q8Adam parameter tolerance
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5        # of each leaf's max |g|
SPEC_CONFIGS = ["jamba-1.5-large-398b", "dbrx-132b", "seamless-m4t-large-v2", "mamba2-370m"]
MESHES = {"debug": ((2, 1), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(which):
    shape, names = MESHES[which]
    return AbstractMesh(shape, names), JAbstractMesh(shape, names)


def _specs(tree):
    return [tuple(s) for s in tree_leaves(tree, is_leaf=SH.is_pspec)]


def _jspecs(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _sharding_specs(tree):
    return [tuple(s.spec) for s in tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, SH.NamedSharding))]


def _jsharding_specs(tree):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JNamedSharding))]


# -- spec trees ---------------------------------------------------------------

@pytest.mark.parametrize("name", SPEC_CONFIGS)
def test_param_axes_and_pspecs_match_jax(name):
    cfg, jcfg = configs.reduced(name), jconfigs.reduced(name)
    params = M.init_params(torch.Generator(), cfg, compute_dims(cfg, tp=1), device="meta")
    axes = M.param_axes(params)
    jptree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg,
                                                   jcompute_dims(jcfg, tp=1)))
    jparams, jaxes = split_tree(jptree)
    is_axes = lambda x: isinstance(x, tuple) and all(isinstance(a, str) for a in x)  # noqa: E731
    assert tree_leaves(axes, is_leaf=is_axes) == jax.tree_util.tree_leaves(
        jaxes, is_leaf=is_axes)
    assert [tuple(p.shape) for p in tree_leaves(params)] == [
        tuple(p.shape) for p in jax.tree_util.tree_leaves(jparams)]
    for which in MESHES:
        mesh, jmesh = _meshes(which)
        assert _specs(SH.param_pspecs(mesh, axes)) == _jspecs(JSH.param_pspecs(jmesh, jaxes))


@pytest.mark.parametrize("which", list(MESHES))
def test_rules_and_activation_specs_match_jax(which):
    mesh, jmesh = _meshes(which)
    assert SH.logical_rules(mesh) == JSH.logical_rules(jmesh)
    for seq in (False, True):
        assert tuple(SH.activation_pspec(mesh, seq_parallel=seq)) == tuple(
            JSH.activation_pspec(jmesh, seq_parallel=seq))
    assert tuple(SH.logits_pspec(mesh)) == tuple(JSH.logits_pspec(jmesh))
    assert tuple(SH.batch_pspec(mesh)) == tuple(JSH.batch_pspec(jmesh))


@pytest.mark.parametrize("batch", [4, 1])
def test_cache_shardings_match_jax(batch):
    """Reduced jamba: batch >= data shards splits the batch, batch < data
    shards (long context) the sequence; every leaf's spec is JAX's."""
    cfg, jcfg = configs.reduced("jamba-1.5-large-398b"), jconfigs.reduced("jamba-1.5-large-398b")
    mesh, jmesh = _meshes("debug")
    assert serve.seq_sharded_mode(mesh, batch) == jserve.seq_sharded_mode(jmesh, batch)
    abstract, shard = serve.cache_shardings(mesh, cfg, compute_dims(cfg, tp=1), batch, 64)
    jabstract, jshard = jserve.cache_shardings(jmesh, jcfg, jcompute_dims(jcfg, tp=1), batch, 64)
    assert _sharding_specs(shard) == _jsharding_specs(jshard)
    assert [tuple(x.shape) for x in tree_leaves(abstract)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jabstract)]
    assert all(x.device.type == "meta" for x in tree_leaves(abstract))


@pytest.mark.parametrize("shards", [1, 2])
def test_state_shardings_match_jax(shards):
    cfg, jcfg = configs.reduced("qwen2.5-3b"), jconfigs.reduced("qwen2.5-3b")
    mesh, jmesh = _meshes("debug")
    mcfg = SketchMonitorConfig(**cases.MONITOR, shards=shards)
    state, _ = train.make_train_state(torch.Generator().manual_seed(0), cfg,
                                      compute_dims(cfg, tp=1), make_adamw(constant(1e-3)),
                                      monitor_cfg=mcfg, device="cpu")
    jdims, key = jcompute_dims(jcfg, tp=1), jax.random.PRNGKey(0)
    jstate = jax.eval_shape(lambda: jtrain.make_train_state(
        key, jcfg, jdims, jadamw.make_adamw(jsched.constant(1e-3)),
        monitor_cfg=jmon.SketchMonitorConfig(**cases.MONITOR, shards=shards))[0])
    jaxes = split_tree(jax.eval_shape(lambda: JM.init_params(key, jcfg, jdims)))[1]
    got = train.state_shardings(mesh, state, M.param_axes(state.params))
    want = jtrain.state_shardings(jmesh, jstate, jaxes)
    assert _sharding_specs(got) == _jsharding_specs(want)
    assert all(isinstance(s.placements[0], (SH.Shard, SH.Replicate))
               for s in tree_leaves(got, is_leaf=lambda x: isinstance(x, SH.NamedSharding)))


def test_q8_state_pspecs_match_jax():
    mesh, jmesh = _meshes("multi_pod")
    specs = {"w": SH.PartitionSpec("data", None), "b": SH.PartitionSpec(None)}
    jspecs = {"w": JP("data", None), "b": JP(None)}
    assert _specs(state_pspecs(mesh, specs)) == _jspecs(jq8s.state_pspecs(jmesh, jspecs))


# -- Q8Adam at one rank against JAX's on a 1 x 1 mesh --------------------------

def test_q8_sharded_one_rank_matches_jax():
    """60 steps of ``tests/test_q8_sharded.py``'s problem.  Each step of
    the port starts from JAX's parameters and state of the step before
    (the trajectories otherwise part where a stochastic-rounding code
    lands one step apart, which the tolerance allows once in 1,000), and
    its parameters, codes and scales are held to JAX's after it; the
    port's last step meets the reference's convergence check."""
    p0, target = cases.q8_case()
    jmesh = jmake_debug_mesh(1, 1)
    jspecs = {"w": JP(None, None), "b": JP(None)}
    jopt = jq8s.make_q8adam_sharded(jmesh, jsched.constant(0.05), jspecs, weight_decay=0.0)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    specs = {"w": SH.PartitionSpec(None, None), "b": SH.PartitionSpec(None)}
    opt = make_q8adam_sharded(mesh, constant(0.05), specs, weight_decay=0.0)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    ts = opt.init({k: t(v) for k, v in p0.items()})
    with compat.set_mesh(jmesh):
        js = jax.jit(jopt.init)(jp)
        update = jax.jit(jopt.update)
        for _ in range(60):
            forced = {k: t(v) for k, v in jp.items()}
            fstate = type(ts)(t(js.step), *({k: type(q)(*map(t, q)) for k, q in moment.items()}
                                            for moment in (js.m, js.v)))
            got_p, got_s, _ = opt.update(cases.q8_grads(forced, t(target)), fstate, forced)
            jp, js, _ = update(cases.q8_grads(jp, jnp.asarray(target)), js, jp)
            for k in jp:
                np.testing.assert_allclose(got_p[k].numpy(), np.asarray(jp[k]), rtol=0, atol=TOL)
            _codes_agree([(got_s.m[k], js.m[k]) for k in jp] +
                         [(got_s.v[k], js.v[k]) for k in jp])
    err_q = float(np.abs(got_p["w"].numpy() - target).mean())
    err_j = float(np.abs(np.asarray(jp["w"]) - target).mean())
    assert err_q < 0.25 and abs(err_q - err_j) < 0.15, (err_q, err_j)


def _codes_agree(pairs):
    """Q8 codes within one step and >= 99.9 % equal, scales within 1e-5
    relative (``tests/test_torch_optim.py``'s Q8Adam tolerance)."""
    same = total = 0
    for got, want in pairs:
        codes, jcodes = np.asarray(got[0]).astype(np.int32), np.asarray(want[0]).astype(np.int32)
        assert np.abs(codes - jcodes).max() <= 1
        same += int((codes == jcodes).sum())
        total += codes.size
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-5, atol=0)
    assert same / total >= 0.999, same / total


# -- two gloo ranks -------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The two ranks and JAX's two-device Q8Adam run (a subprocess),
    started before the file's first test, so that they run beside its
    one-process tests."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(ckpt), 4, {k: jnp.asarray(v) for k, v in cases.restore_tree().items()},
                    chunks=8)
    q8_path = tmp_path_factory.mktemp("q8") / "q8.npz"
    jax_run = cases.start_jax_q8_two_devices(q8_path)
    try:
        handle = cases.start(cases.mesh_rank, tmp_path_factory.mktemp("mesh"), str(ckpt))
        yield handle, jax_run, q8_path
        cases.stop(handle)
    finally:
        jax_run.kill()


@pytest.fixture(scope="module")
def ranks(started):
    """The ranks' results, and JAX's two-device run."""
    handle, jax_run, q8_path = started
    out = cases.join(handle)
    assert jax_run.wait(timeout=300) == 0
    return out, dict(np.load(q8_path))


def _assemble(parts, spec):
    """The whole tensor from the ranks' blocks of a (data=2) spec."""
    dims = [d for d, entry in enumerate(spec) if entry == "data"]
    if not dims:
        assert torch.equal(parts[0], parts[1])
        return parts[0]
    return torch.cat(parts, dims[0])


@pytest.mark.parametrize("case", cases.TRAIN_CASES, ids=lambda c: f"{c[0]}-shards{c[1]}"
                         f"-group{c[2]}-rows{c[3]}")
def test_mesh_train_step_matches_one_process(ranks, case):
    ranks, _ = ranks
    state, metrics, grads = cases.train_case(*case)
    specs = _specs(SH.param_pspecs(_meshes("debug")[0], M.param_axes(state.params)))
    for key, want in metrics.items():
        got = ranks[0][case]["metrics"][key]
        assert got == ranks[1][case]["metrics"][key]
        assert abs(got - want) <= LOSS_RTOL * abs(want), (key, got, want)
    assert len(grads) == len(specs) == len(ranks[0][case]["grads"])
    for i, (want, spec) in enumerate(zip(grads, specs)):
        got = _assemble([r[case]["grads"][i] for r in ranks], spec)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= GRAD_RTOL * scale, (i, spec)


@functools.lru_cache(maxsize=None)
def _jax_monitor_fn():
    """JAX's monitor update from an empty state at step 0, jitted once
    for the file."""
    jcfg = jmon.SketchMonitorConfig(**cases.MONITOR)
    jparams, jstate = jmon.init_monitor(jcfg)
    fn = jax.jit(lambda t: jmon.monitor_update_local(jcfg, jparams, jstate.counters[0],
                                                     jstate.n[0], t, jnp.int32(0)))
    return fn


def _jax_monitor(tokens):
    c, n = _jax_monitor_fn()(jnp.asarray(tokens))
    return np.asarray(c), float(n)


def test_deferred_monitor_matches_jax_per_rank(ranks):
    """One shard per rank: rank r's block holds its own rows only."""
    ranks, _ = ranks
    case = cases.TRAIN_CASES[1]
    tokens = cases.train_batch(case[0], case[3])["tokens"]
    rows = case[3] // cases.WORLD
    for r, res in enumerate(ranks):
        counters, n = res[case]["monitor"]
        want_c, want_n = _jax_monitor(tokens[r * rows:(r + 1) * rows])
        assert counters.shape[0] == 1
        np.testing.assert_array_equal(counters[0].numpy(), want_c)
        assert float(n[0]) == want_n == rows


def test_merged_monitor_matches_jax_on_the_whole_batch(ranks):
    ranks, _ = ranks
    case = cases.TRAIN_CASES[0]
    want_c, want_n = _jax_monitor(cases.train_batch(case[0], case[3])["tokens"])
    for res in ranks:
        counters, n = res[case]["monitor"]
        np.testing.assert_array_equal(counters[0].numpy(), want_c)
        assert float(n[0]) == want_n == case[3]


def test_model_axis_needs_its_dims(ranks):
    """A (data=1, model=2) mesh with Dims built for tp=1 is refused."""
    ranks, _ = ranks
    for res in ranks:
        assert "Dims built for tp=1 on a model axis of 2" in res["dims_refused"]


@pytest.mark.parametrize("key,placement,axis", [
    ("q8", (SH.Shard(0), SH.Replicate()), 0),
    ("q8_tp", (SH.Replicate(), SH.Shard(1)), 1)], ids=["data2", "model2"])
def test_q8_sharded_two_ranks_match_jax(ranks, key, placement, axis):
    """Each rank's Q8 codes and scales after Q8_STEPS steps against JAX's
    two-device run: w split over data (rows) or over model (columns); the
    rank's rows of the codes are its quantized local block either way."""
    ranks, want = ranks
    prefix = "" if key == "q8" else "tp_"
    for r, res in enumerate(ranks):
        q8 = res[key]
        assert q8["placements"]["w"] == placement
        for k, p in q8["params"].items():
            whole = want[f"{prefix}p_{k}"]
            block = np.split(whole, cases.WORLD, axis=axis)[r] if k == "w" else whole
            np.testing.assert_allclose(p.numpy(), block, rtol=0, atol=TOL)
        pairs = []
        for moment in ("m", "v"):
            for k, (codes, scales) in q8[moment].items():
                jc = np.split(want[f"{prefix}{moment}_{k}_codes"], cases.WORLD)[r]
                js = np.split(want[f"{prefix}{moment}_{k}_scales"], cases.WORLD)[r]
                pairs.append(((codes, scales), (jc, js)))
        _codes_agree(pairs)


def test_restore_with_target_shardings(ranks):
    """The reference's elastic restore (``tests/test_q8_sharded.py``): a
    checkpoint of 8 chunks restored onto the mesh, each rank with its own
    block and the target placements."""
    ranks, _ = ranks
    tree = cases.restore_tree()
    for r, res in enumerate(ranks):
        out = res["restore"]
        assert out["step"] == 4
        np.testing.assert_array_equal(out["local"]["w"].numpy(),
                                      np.split(tree["w"], cases.WORLD)[r])
        np.testing.assert_array_equal(out["local"]["b"].numpy(), tree["b"])
        for k in tree:
            got, want = out["placements"][k]
            assert got == want
            np.testing.assert_array_equal(out["full"][k].numpy(), tree[k])
