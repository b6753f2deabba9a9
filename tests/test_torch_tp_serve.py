"""Tensor-parallel serving under a mesh, on gloo ranks on the CPU, against
the JAX package's meshless ``prefill`` and ``decode_step`` at the same
``Dims`` (``compute_dims(cfg, tp=<model axis size>)``) -- the function
GSPMD's sharded program computes.

* (data=1, model=2), two ranks: the five reduced families (dense, MoE,
  SSM, hybrid, encoder-decoder) -- prefill and ``STEPS`` greedy decode
  steps through ``make_prefill(mesh=)`` / ``make_decode_step(mesh=)``;
  the logits of every step and the caches assembled from the ranks'
  blocks (K/V, SSM and conv states, cross memories, after the re-base
  and after the last step) within ``TOL`` of JAX's, the tokens equal,
  the logits the same bits on every rank, every layer's output held
  equal across the model group.
* (data=2, model=2), four ranks: reduced qwen2.5-3b and deepseek-moe-16b
  (FSDP gathers over the data ranks, TP, MoE decode groups spanning the
  data ranks).
* (data=2, model=1), batch 1: reduced qwen2.5-3b with the cache split by
  sequence (the ``long_500k`` regime), and a max_len the data shards do
  not divide refused.
* (1, 1), one rank: every family equal to the port's meshless serving,
  bit for bit.
* Pure functions: the mesh's group rank lists, the bitwise check of
  replicated activations, a rank's block of a tensor from its spec.

The ranks start once, before the file's first test (they wait for the
JAX parameters, ``torch_tp_cases.wait_for``), and run beside the file's
JAX work.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_rank_cases as cases  # noqa: E402
import torch_tp_cases as tpc  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, coordinate, group_ranks  # noqa: E402
from repro_torch.launch.tensor_parallel import same_on_every_rank  # noqa: E402
from repro_torch.models.config import compute_dims  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 1e-5              # tests/test_torch_families.py's tolerance
NAMES = ("data", "model")


@functools.lru_cache(maxsize=None)
def _jax_params(name, tp):
    jcfg = jconfigs.reduced(name)
    return jM.strip_p(jM.init_params(jax.random.PRNGKey(0), jcfg, jcompute_dims(jcfg, tp=tp)))


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The ranks of every world, started first; then the JAX parameters
    they wait for, written once."""
    params_file = tmp_path_factory.mktemp("params") / "params.pt"
    handles = {world: cases.start(tpc.tp_rank, tmp_path_factory.mktemp(f"world{world}"),
                                  str(params_file), world, world=world)
               for world in tpc.CASES}
    handles[1] = cases.start(tpc.one_rank, tmp_path_factory.mktemp("world1"), world=1)
    try:
        wanted = {(name, tpc.tp_of(shape)) for cases_ in tpc.CASES.values()
                  for shape, archs, _ in cases_ for name in archs}
        carried = {key: jax.tree_util.tree_map(np.asarray, _jax_params(*key)) for key in wanted}
        partial = params_file.with_suffix(".part")
        torch.save(carried, partial)
        partial.rename(params_file)
        yield handles
    finally:
        for handle in handles.values():
            cases.stop(handle)


@pytest.fixture(scope="module")
def ranks(started):
    return {world: cases.join(handle) for world, handle in started.items()}


@functools.lru_cache(maxsize=None)
def _jax_run(name, tp, batch):
    """The JAX package's meshless prefill, re-base and STEPS greedy decode
    steps at ``compute_dims(cfg, tp=tp)``, jitted."""
    jcfg = jconfigs.reduced(name)
    jdims = jcompute_dims(jcfg, tp=tp)
    params = _jax_params(name, tp)
    prefill = jax.jit(functools.partial(jM.prefill, cfg=jcfg, dims=jdims,
                                        compute_dtype=jnp.float32))
    decode = jax.jit(functools.partial(jM.decode_step, cfg=jcfg, dims=jdims,
                                       compute_dtype=jnp.float32))
    feats = tpc.frames(jcfg, batch)
    lg, pcache = prefill(params, tokens=jnp.asarray(tpc.prompts(batch)),
                         enc_feats=None if feats is None else jnp.asarray(feats))
    src = 0 if feats is None else tpc.SRC
    cache = jserve._rebase_cache(jM.init_cache(jcfg, jdims, batch, tpc.MAX_LEN, src_len=src,
                                               dtype=jnp.float32), pcache, tpc.PROMPT)
    out = {"logits": [np.asarray(lg)],
           "rebased": [np.asarray(x) for x in jax.tree_util.tree_leaves(cache.groups)]}
    tok = np.argmax(np.asarray(lg[:, -1]), axis=-1)[:, None].astype(np.int32)
    toks = [tok]
    for _ in range(tpc.STEPS):
        lg, cache = decode(params, token=jnp.asarray(tok), cache=cache)
        out["logits"].append(np.asarray(lg))
        tok = np.argmax(np.asarray(lg[:, -1]), axis=-1)[:, None].astype(np.int32)
        toks.append(tok)
    out["tokens"] = np.concatenate(toks, axis=1)
    out["final"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(cache.groups)]
    out["lens"] = np.asarray(cache.lens)
    return out


def _check_serving(results, name, shape, batch):
    """The ranks' serving of ``name`` on a mesh of ``shape`` against the
    JAX package's meshless run at the same Dims."""
    want = _jax_run(name, tpc.tp_of(shape), batch)
    got = [r[shape, name] for r in results]
    for step, jlg in enumerate(want["logits"]):
        for r in got[1:]:
            assert same_on_every_rank([got[0]["logits"][step], r["logits"][step]]), step
        assert tuple(got[0]["logits"][step].shape) == jlg.shape
        np.testing.assert_allclose(got[0]["logits"][step].numpy(), jlg, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} step {step} logits")
    for r in got:
        np.testing.assert_array_equal(r["tokens"].numpy(), want["tokens"])
        assert (r["checks"] > 0) == (tpc.tp_of(shape) > 1)
    cfg = configs.reduced(name)
    src = tpc.SRC if cfg.is_encdec else 0
    _, shard = serve.cache_shardings(AbstractMesh(shape, NAMES), cfg,
                                     compute_dims(cfg, tp=tpc.tp_of(shape)), batch, tpc.MAX_LEN,
                                     src, dtype=torch.float32)
    specs = [s.spec for s in tree_leaves(shard.groups,
                                         is_leaf=lambda x: isinstance(x, SH.NamedSharding))]
    for which in ("rebased", "final"):
        parts = [tree_leaves(r[which]) for r in got]
        assert len(specs) == len(parts[0]) == len(want[which]) > 0
        for i, (spec, jleaf) in enumerate(zip(specs, want[which])):
            whole = tpc.assemble([p[i] for p in parts], spec, shape)
            assert tuple(whole.shape) == jleaf.shape, (which, i)
            np.testing.assert_allclose(whole.to(torch.float32).numpy(),
                                       jleaf.astype(np.float32), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {which} cache leaf {i} {spec}")
    lens = tpc.assemble([r["lens"] for r in got], SH.PartitionSpec(
        None if batch < shape[0] else "data"), shape)
    np.testing.assert_array_equal(lens.numpy(), want["lens"])


# -- pure functions ---------------------------------------------------------

@pytest.mark.parametrize("shape,names,want", [
    ((2, 2), ("data", "model"), {"model": [[0, 1], [2, 3]], "batch": [[0, 2], [1, 3]]}),
    ((2, 2, 2), ("pod", "data", "model"),
     {"model": [[0, 1], [2, 3], [4, 5], [6, 7]], "batch": [[0, 2, 4, 6], [1, 3, 5, 7]]}),
])
def test_mesh_group_rank_lists_are_row_major(shape, names, want):
    """Model groups are the mesh's rows; a batch group flattens (pod,
    data) in mesh order, its ranks in that order."""
    mesh = AbstractMesh(shape, names)
    assert group_ranks(shape, names, ("model",)) == want["model"]
    assert group_ranks(shape, names, tuple(a for a in names if a != "model")) == want["batch"]
    for rank in range(math.prod(shape)):
        where = coordinate(mesh, rank)
        assert rank == sum(where[a] * math.prod(shape[i + 1:]) for i, a in enumerate(names))


def test_replicated_check_is_bitwise():
    x = torch.linspace(-1, 1, 12).reshape(3, 4)
    assert same_on_every_rank([x, x.clone(), x.clone()])
    y = x.clone()
    y[1, 2] = torch.nextafter(y[1, 2], torch.tensor(2.0))
    assert not same_on_every_rank([x, y])
    z = torch.zeros(3)
    assert torch.equal(z, -z) and not same_on_every_rank([z, -z])


def test_local_block_follows_the_spec():
    """A rank's block of an (embed, heads) leaf on (data=2, model=2):
    rows by its data coordinate, columns by its model coordinate; on
    (pod, data, model) a dim over ("pod", "data") takes pod as the major
    index; a dim the shards do not divide is refused."""
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    mesh = AbstractMesh((2, 2), NAMES)
    shard = SH.NamedSharding(mesh, SH.PartitionSpec("data", "model"))
    for rank in range(4):
        d, m = divmod(rank, 2)
        assert torch.equal(SH.local_block(x, shard, rank), x[4 * d:4 * d + 4, 3 * m:3 * m + 3])
    pod = AbstractMesh((2, 2, 1), ("pod", "data", "model"))
    shard = SH.NamedSharding(pod, SH.PartitionSpec(("pod", "data"), None))
    assert [SH.local_block(x, shard, r)[0, 0].item() for r in range(4)] == [0, 12, 24, 36]
    with pytest.raises(ValueError, match="does not split"):
        SH.local_block(x[:7], SH.NamedSharding(mesh, SH.PartitionSpec("data", None)), 0)


# -- ranks ------------------------------------------------------------------

@pytest.mark.parametrize("name", tpc.ARCHS)
def test_model_axis_of_two_matches_jax(ranks, name):
    _check_serving(ranks[2], name, (1, 2), tpc.B)


@pytest.mark.parametrize("name", tpc.CASES[4][0][1])
def test_two_by_two_mesh_matches_jax(ranks, name):
    _check_serving(ranks[4], name, (2, 2), tpc.B)


def test_sequence_sharded_decode_matches_jax(ranks):
    """Batch 1 on two data shards: each rank holds 8 of the 16 positions,
    the prompt in rank 0's block and the decoded tokens in rank 1's."""
    _check_serving(ranks[2], "qwen2.5-3b", (2, 1), 1)
    for r in ranks[2]:
        assert "max_len 15 does not split over 2 shards" in r[(2, 1), "max_len"]


def test_one_rank_mesh_equals_meshless_serving(ranks):
    (res,) = ranks[1]
    assert sorted(res) == sorted(tpc.ONE_RANK)
    for name, out in res.items():
        assert out["equal"] and out["leaves"] > 0, name
