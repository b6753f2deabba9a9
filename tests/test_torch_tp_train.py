"""Tensor-parallel training under a mesh, on gloo ranks on the CPU, against
the port's one-process train step at the same ``Dims``
(``compute_dims(cfg, tp=2)``) -- the function GSPMD's sharded program
computes -- and, for reduced qwen2.5-3b, against ``jax.value_and_grad`` of
the JAX package's meshless loss.

* (data=1, model=2), two ranks: the five reduced families (dense, MoE,
  SSM with one group, hybrid with eight, encoder-decoder), one f32 step
  with AdamW and the merged monitor each; reduced qwen2.5-3b again with
  ``seq_parallel=True``.  Loss and aux within ``LOSS_RTOL`` and the same
  bits on every rank; every gradient leaf, assembled from the ranks'
  blocks, within ``GRAD_RTOL`` of its max |g| (replicas equal bit for
  bit); the parameters after the step within ``PARAM_ATOL`` where the
  gradient sets AdamW's direction, within 2 lr elsewhere; the monitor
  equal; every layer's output and the gradient reaching
  it held equal across the model group.
* (data=2, model=2), four ranks: reduced qwen2.5-3b (merged monitor) and
  deepseek-moe-16b (deferred monitor; MoE groups spanning the data ranks):
  FSDP gathers and TP together, under the same gates.
* The fault-tolerant driver on (1, 2): a failure injected and restored
  through ``shardings=``; the end state equal to the uninterrupted run's
  bit for bit, the checkpoint's arrays equal to the full tensors, the
  monitor handed to the telemetry whole.
* The MoE router's backward on a toy: with the probabilities' *f* the
  ranks' router and input gradients are the one-process ones; without it
  they are not.
* Pure functions: the gradient-sum rule (``train.grad_sums``) for every
  leaf of the five configs at (2, 2), with and without ``seq_parallel``.

The ranks start once, before the file's first test, and run beside the
file's one-process and JAX work.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_rank_cases as cases  # noqa: E402
import torch_tp_cases as tpc  # noqa: E402
import torch_tp_train_cases as ttc  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import compute_dims  # noqa: E402
from repro_torch.optim import make_adamw  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.sketchstream import monitor as mon  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5        # of each leaf's max |g|
PARAM_ATOL = 1e-5
SIGNAL = 10             # see _close_params
ROUTER_RTOL = 1e-6      # the toy, of each gradient's max


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    handles = {world: cases.start(ttc.tp_rank, tmp_path_factory.mktemp(f"world{world}"),
                                  world, str(ckpt), world=world)
               for world in ttc.CASES}
    yield handles
    for handle in handles.values():
        cases.stop(handle)


@pytest.fixture(scope="module")
def ranks(started):
    return {world: cases.join(handle) for world, handle in started.items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The port's one-process step on the whole batch at tp=2's Dims, on
    one thread as the ranks run (the CPU's BLAS sums in another order on
    more).  Reduced jamba is the tightest case: its f32 gradients lie
    about 1.3e-5 of a leaf's max |g| from a float64 run, so two f32 runs
    that sum in other orders part by nearly GRAD_RTOL
    (``tools/tp_grad_noise.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = ttc.train_case(name, 1)
    finally:
        torch.set_num_threads(threads)
    return {"metrics": res["metrics"], "grads": res["grads"],
            "params": tree_leaves(res["state"].params),
            "monitor": (res["state"].monitor.counters, res["state"].monitor.n)}


def _specs(name, shape):
    cfg = configs.reduced(name)
    abstract = M.init_params(torch.Generator(), cfg, compute_dims(cfg, tp=ttc.TP),
                             device="meta")
    return tree_leaves(SH.param_pspecs(AbstractMesh(shape, tpc.NAMES), M.param_axes(abstract)),
                       is_leaf=SH.is_pspec)


def _close(got, want, rtol, what):
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= rtol * scale, (what, gap, scale)


def _close_params(got, want, grad, got_grad, what):
    """The parameters after the step within PARAM_ATOL, where the
    gradient sets the update's direction.  AdamW's first step moves an
    element by about lr * g / (|g| + eps), so where the reference's |g|
    is within SIGNAL times the largest gap between the two gradients of
    the leaf, rounding may choose the sign (K's bias has a gradient that
    is zero but for rounding: a softmax ignores a shift every key
    shares); those elements are not held, but stay within 2 lr (the most
    two updates of opposite sign can part).  Returns (held, elements)."""
    sure = grad.abs() > SIGNAL * float((got_grad - grad).abs().max())
    gap = (got - want).abs()
    held = float(gap[sure].max()) if bool(sure.any()) else 0.0
    assert held <= PARAM_ATOL, (what, held, int(sure.sum()))
    free = float(gap[~sure].max()) if not bool(sure.all()) else 0.0
    assert free <= 2 * ttc.LR, (what, free)
    return int(sure.sum()), sure.numel()


def _check_step(results, name, shape, seq):
    """The ranks' step of ``name`` on a mesh of ``shape`` against the
    one-process step at the same Dims."""
    want = _reference(name)
    got = [r[shape, name, seq] for r in results]
    for key, value in want["metrics"].items():
        assert all(g["metrics"][key] == got[0]["metrics"][key] for g in got), key
        assert abs(got[0]["metrics"][key] - value) <= LOSS_RTOL * abs(value), (
            key, got[0]["metrics"][key], value)
    specs = _specs(name, shape)
    assert len(specs) == len(want["grads"]) == len(got[0]["grads"]) > 0
    held = total = 0
    for i, spec in enumerate(specs):
        grad = tpc.assemble([g["grads"][i] for g in got], spec, shape)
        _close(grad, want["grads"][i], GRAD_RTOL, f"{name} gradient leaf {i} {spec}")
        counts = _close_params(tpc.assemble([g["params"][i] for g in got], spec, shape),
                               want["params"][i], want["grads"][i], grad,
                               f"{name} parameter leaf {i} {spec}")
        held, total = held + counts[0], total + counts[1]
    assert 2 * held > total, (held, total)     # the mask leaves most elements held
    for g in got:
        assert (g["checks"] > 0) == (not seq), g["checks"]
    return got


@pytest.mark.parametrize("name", ttc.ARCHS)
def test_model_axis_of_two_matches_one_process(ranks, name):
    got = _check_step(ranks[2], name, (1, 2), False)
    want = _reference(name)["monitor"]
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g["monitor"], want))


def test_sequence_parallel_matches_one_process(ranks):
    got = _check_step(ranks[2], "qwen2.5-3b", (1, 2), True)
    want = _reference("qwen2.5-3b")["monitor"]
    assert all(torch.equal(a, b) for g in got for a, b in zip(g["monitor"], want))


def _monitor_of(rows):
    """The port's monitor update of ``rows`` from an empty shard."""
    mcfg = mon.SketchMonitorConfig(**cases.MONITOR)
    mparams, state = mon.init_monitor(mcfg, device="cpu")
    c, n = mon.monitor_update_local(mcfg, mparams, state.counters[0], state.n[0],
                                    torch.from_numpy(rows), state.step)
    return c, n


@pytest.mark.parametrize("name", [archs[0] for shape, archs, _, _ in ttc.CASES[4]])
def test_two_by_two_mesh_matches_one_process(ranks, name):
    """FSDP and TP together; deepseek-moe-16b's deferred monitor holds each
    data rank's rows, the same block on both ranks of a model group."""
    got = _check_step(ranks[4], name, (2, 2), False)
    shards = dict((archs[0], sh) for _, archs, sh, _ in ttc.CASES[4])[name]
    tokens = ttc.train_batch(name)["tokens"]
    for rank, g in enumerate(got):
        counters, n = g["monitor"]
        if shards == 1:
            want = _reference(name)["monitor"]
            assert torch.equal(counters, want[0]) and torch.equal(n, want[1])
        else:
            data = rank // ttc.TP
            rows = ttc.ROWS // 2
            c, count = _monitor_of(tokens[data * rows:(data + 1) * rows])
            assert counters.shape[0] == 1
            assert torch.equal(counters[0], c) and float(n[0]) == float(count) == rows


def _jax_total(jcfg, jdims, batch):
    def fn(params):
        lg, aux = jM.forward(params, jcfg, jdims, jnp.asarray(batch["tokens"]),
                             compute_dtype=jnp.float32, remat="none", ssm_chunk=8)
        return jM.lm_loss(lg, jnp.asarray(batch["labels"]), jcfg.vocab_size)
    return fn


def test_model_axis_of_two_matches_jax_value_and_grad(ranks):
    """Reduced qwen2.5-3b's loss and gradients on (1, 2) against
    ``jax.value_and_grad`` of the JAX package's meshless loss at the same
    Dims, on the port's initial parameters carried across by
    ``convert.train_state_to_numpy``."""
    name = "qwen2.5-3b"
    cfg, jcfg = configs.reduced(name), jconfigs.reduced(name)
    dims = compute_dims(cfg, tp=ttc.TP)
    state, _ = train.make_train_state(torch.Generator().manual_seed(0), cfg, dims,
                                      make_adamw(constant(ttc.LR)), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, convert.train_state_to_numpy(state).params)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_total(
        jcfg, jcompute_dims(jcfg, tp=ttc.TP), ttc.train_batch(name))))(params)
    jgrads = [torch.from_numpy(np.asarray(g)) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [r[(1, 2), name, False] for r in ranks[2]]
    loss = got[0]["metrics"]["loss"]
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (loss, float(jloss))
    specs = _specs(name, (1, 2))
    assert len(specs) == len(jgrads) == len(got[0]["grads"])
    for i, spec in enumerate(specs):
        _close(tpc.assemble([g["grads"][i] for g in got], spec, (1, 2)), jgrads[i], GRAD_RTOL,
               f"gradient leaf {i} {spec} against JAX")


def test_driver_restores_two_dimensional_blocks(ranks):
    """A failure at step DRIVER_FAILURE_AT, the restore through
    ``shardings=``, and the end state bit for bit the uninterrupted run's;
    the last checkpoint holds the full tensors; the telemetry gets the
    whole monitor, as plain tensors."""
    for r, res in enumerate(ranks[2]):
        failing, whole = res["driver"]["failing"], res["driver"]["whole"]
        assert "restore" in failing["events"] and "failure" in failing["events"]
        assert "restore" not in whole["events"]
        assert failing["saved_step"] == whole["saved_step"] == ttc.DRIVER_STEPS
        assert failing["saved_equal"] and whole["saved_equal"]
        assert len(failing["leaves"]) == len(whole["leaves"]) > 0
        assert all(torch.equal(a, b) for a, b in zip(failing["leaves"], whole["leaves"]))
        assert failing["placements"] == whole["placements"]
        assert any(isinstance(p[1], SH.Shard) for p in failing["placements"])
        assert failing["losses"][-1] == whole["losses"][-1]
        kinds = [kind for kind, _ in failing["client"]]
        assert "resync" in kinds and "publish" in kinds
        for _, leaves in failing["client"] + whole["client"]:
            (c_type, c_shape), (n_type, n_shape), _ = leaves
            assert c_type == n_type == "Tensor" and c_shape[0] == n_shape[0] == 1
    same = ranks[2][0]["driver"]["whole"]["leaves"], ranks[2][1]["driver"]["whole"]["leaves"]
    assert any(not torch.equal(a, b) for a, b in zip(*same)), "the ranks hold other blocks"


def test_router_backward_sums_the_ranks_partials(ranks):
    want = ttc.router_toy_grads()
    for fixed in (True, False):
        got = [r["router"]["fixed" if fixed else "unfixed"] for r in ranks[2]]
        router = torch.cat([g["router"] for g in got], dim=1)
        x_ok = all(torch.allclose(g["x"], want["x"], rtol=0,
                                  atol=ROUTER_RTOL * float(want["x"].abs().max())) for g in got)
        router_gap = float((router - want["router"]).abs().max())
        if fixed:
            assert x_ok
            assert router_gap <= ROUTER_RTOL * float(want["router"].abs().max()), router_gap
            experts = torch.cat([g["w_gate"] for g in got])
            _close(experts, want["w_gate"], ROUTER_RTOL, "w_gate")
        else:
            assert router_gap > 1e-3 * float(want["router"].abs().max()), router_gap


# -- pure functions -----------------------------------------------------------

def _expected_sums(path, axes, seq_parallel):
    """The rule by the leaves' names: FSDP leaves (an "embed" dim) come
    back summed over the batch; over the model group only mamba's B/C
    projections and conv, and the norms under seq_parallel."""
    name, module = path[-1], [p for p in path if isinstance(p, str)][-2:-1]
    over_batch = not ({"embed", "embed_out"} & set(axes))
    norm = name in ("final_norm", "mixer_norm", "cross_norm", "mlp_norm") or (
        name == "norm" and module != ["mamba"])
    over_model = name in ("wB", "wC", "conv_bc") or (seq_parallel and norm)
    return over_batch, over_model


def _paths(tree, path=()):
    """(path, logical axes) of every leaf of an axes tree."""
    if isinstance(tree, tuple) and all(isinstance(a, str) for a in tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("name", ttc.ARCHS)
def test_grad_sum_rule_at_two_by_two(name, seq_parallel):
    cfg = configs.reduced(name)
    abstract = M.init_params(torch.Generator(), cfg, compute_dims(cfg, tp=ttc.TP),
                             device="meta")
    mesh = AbstractMesh((2, 2), tpc.NAMES)
    axes = M.param_axes(abstract)
    specs = SH.param_pspecs(mesh, axes)
    leaves = list(_paths(axes))
    assert len(leaves) == len(tree_leaves(abstract))
    seen = set()
    for path, ax in leaves:
        spec = specs
        for key in path:
            spec = spec[key]
        got = train.grad_sums(spec, ax, ("data",), seq_parallel=seq_parallel)
        assert got == _expected_sums(path, ax, seq_parallel), (path, ax, spec, got)
        if "model" in spec:
            assert not got[1], path
        seen.add(got)
    assert (False, False) in seen
    if seq_parallel or "M" in cfg.pattern:
        assert any(over_model for _, over_model in seen)
