"""The port's sharded SJPC ingest on the CPU: ``sjpc.ShardedIngest``,
``sjpc.all_reduce`` and ``compression.compressed_mean`` against the JAX
package.

* The three checks of ``tests/test_fused_ingest.py::TestShardedIngestExecutor``
  through the port (per-shard replay, merge-deferral counts, ratio-one
  invariance), and the port's merged counters, ``n``, ``step`` and shard
  keys against the JAX executor's (its ``vmap`` path on one device), bit
  for bit.
* Two gloo ranks (one spawn for the file, ``torch_rank_cases.sharded_rank``):
  ``all_reduce`` and ``compressed_mean`` against JAX's under
  ``jax.vmap(..., axis_name=)`` (compiled), and the mapped executor -- each
  rank one shard, one ``all_reduce`` on merge -- against the JAX executor,
  bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_rank_cases as cases  # noqa: E402
from repro.core import sjpc as jsjpc  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.core import sjpc  # noqa: E402
from repro_torch.core.sjpc import SJPCConfig  # noqa: E402


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(777)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(got, want):
    np.testing.assert_array_equal(_np(got.counters), np.asarray(want.counters))
    assert float(got.n) == float(want.n)
    assert int(got.step) == int(want.step)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The two ranks, started before the file's first test."""
    inputs = cases.sharded_inputs()
    handle = cases.start(cases.sharded_rank, tmp_path_factory.mktemp("sharded"), inputs)
    yield inputs, handle
    cases.stop(handle)


@pytest.fixture(scope="module")
def jax_executor():
    """JAX's two-shard executor (its ``vmap`` path on one device) after
    the shared micro-batches, compiled once for the file."""
    jcfg = jsjpc.SJPCConfig(**cases.SHARDED_CFG)
    jparams, _ = jsjpc.init(jcfg)
    sh = jsjpc.ShardedIngest(jcfg, jparams, num_shards=cases.WORLD, devices=jax.devices()[:1])
    for b in cases.sharded_inputs()["batches"]:
        sh.ingest(b)
    return sh


def _replay(cfg, params, base, sh, batches, masks, shards):
    """Per-shard updates with the executor's own keys, merged once."""
    acc = [sjpc.init(cfg, device="cpu")[1] for _ in range(shards)]
    for m, (b, mask) in enumerate(zip(batches, masks)):
        pad = (-b.shape[0]) % shards
        vals = np.pad(b, ((0, pad), (0, 0)))
        mask = np.pad(mask, (0, pad))
        per = vals.shape[0] // shards
        for j in range(shards):
            acc[j] = sjpc.update(cfg, params, acc[j], vals[j * per:(j + 1) * per],
                                 key=sh.shard_key(m, j), row_mask=mask[j * per:(j + 1) * per])
    want = base
    for st in acc:
        want = sjpc.merge(want, st)
    return want, acc


class TestShardedIngestExecutor:
    def test_sharded_equals_per_shard_replay(self, jax_executor):
        """The executor's deferred merge == per-shard updates with the
        executor's own fold-in keys, merged once; and == JAX's executor,
        shard keys included."""
        cfg = SJPCConfig(**cases.SHARDED_CFG)
        params, base = sjpc.init(cfg, device="cpu")
        sh = sjpc.ShardedIngest(cfg, params, num_shards=2, device="cpu")
        batches = cases.sharded_inputs()["batches"]
        for b in batches:
            sh.ingest(b)
        merged = sh.merged()
        assert not sh.mapped
        want, _ = _replay(cfg, params, base, sh, batches,
                          [np.ones(len(b), np.int32) for b in batches], 2)
        assert torch.equal(merged.counters, want.counters)
        rows = sum(len(b) for b in batches)
        assert float(merged.n) == float(want.n) == rows
        assert int(merged.step) == int(want.step) == 6

        _same_state(merged, jax_executor.merged())
        for m in range(len(batches)):
            for j in range(2):
                np.testing.assert_array_equal(
                    sh.shard_key(m, j).numpy(),
                    np.asarray(jax.random.key_data(jax_executor.shard_key(m, j))).astype(
                        np.int64))

    def test_merge_deferral_counts(self, rng):
        cfg = SJPCConfig(d=4, s=2, ratio=1.0, width=256, depth=2, seed=12)
        params, _ = sjpc.init(cfg, device="cpu")
        sh = sjpc.ShardedIngest(cfg, params, num_shards=4, device="cpu")
        for _ in range(5):
            sh.ingest(rng.integers(0, 6, size=(16, cfg.d)).astype(np.uint32))
        assert sh.micro_batches == 5 and sh.merges == 0
        merged = sh.merged()
        assert sh.merges == 1
        assert float(merged.n) == 80.0
        sh.reset()
        assert sh.micro_batches == 0 and int(sh.deltas.counters.abs().sum()) == 0

    def test_ratio_one_sharding_invariant(self, rng):
        """ratio=1 has no sampling randomness, so any shard count yields the
        same counters as one unsharded update of the whole batch."""
        cfg = SJPCConfig(d=4, s=2, ratio=1.0, width=256, depth=2, seed=13)
        params, s0 = sjpc.init(cfg, device="cpu")
        batch = rng.integers(0, 6, size=(48, cfg.d)).astype(np.uint32)
        plain = sjpc.update(cfg, params, s0, batch)
        for shards in (2, 4):
            sh = sjpc.ShardedIngest(cfg, params, num_shards=shards, device="cpu")
            sh.ingest(batch)
            assert torch.equal(sh.merged().counters, plain.counters)


@pytest.mark.parametrize("use_fused", [True, False])
def test_executor_replays_with_a_base_and_masks(rng, use_fused):
    """Four shards over a non-empty base, masked rows and a ragged batch:
    every shard's delta and the merged state equal the per-shard replay,
    through the fused and the per-level update."""
    cfg = SJPCConfig(d=6, s=3, ratio=0.5, width=256, depth=3, seed=5)
    params, base = sjpc.init(cfg, device="cpu")
    base = sjpc.update(cfg, params, base, rng.integers(0, 7, size=(20, cfg.d)))
    batches = [rng.integers(0, 7, size=(rows, cfg.d)).astype(np.uint32) for rows in (30, 64)]
    masks = [(rng.random(len(b)) < 0.7).astype(np.int32) for b in batches]
    sh = sjpc.ShardedIngest(cfg, params, base, num_shards=4, use_fused=use_fused, device="cpu")
    for b, m in zip(batches, masks):
        sh.ingest(b, row_mask=m)
    want, acc = _replay(cfg, params, base, sh, batches, masks, 4)
    for j, st in enumerate(acc):
        assert torch.equal(sh.deltas.counters[j], st.counters)
        assert sh.deltas.n[j] == st.n and sh.deltas.step[j] == st.step
    merged = sh.merged()
    assert torch.equal(merged.counters, want.counters)
    assert merged.n == want.n and merged.step == want.step


# -- two gloo ranks ----------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(started):
    inputs, handle = started
    return inputs, cases.join(handle)


def test_all_reduce_matches_psum(ranks):
    inputs, out = ranks
    step = jnp.int32(inputs["step"])

    def one(c, n):
        st = jsjpc.all_reduce(jsjpc.SJPCState(c, n, step), "r")
        return st.counters, st.n, st.step
    jc, jn, jstep = jax.jit(jax.vmap(one, axis_name="r"))(jnp.asarray(inputs["counters"]),
                                                          jnp.asarray(inputs["n"]))
    for r, res in enumerate(out):
        got = res["all_reduce"]
        np.testing.assert_array_equal(got.counters.numpy(), np.asarray(jc[r]))
        assert got.n.item() == float(jn[r]) and got.step.item() == int(jstep[r])
        assert res["input_unchanged"]


def test_compressed_mean_matches_jax(ranks):
    inputs, out = ranks
    want = jax.jit(jax.vmap(lambda x: jcomp.compressed_mean(x, "r"), axis_name="r"))(
        jnp.asarray(inputs["x"]))
    for r, res in enumerate(out):
        np.testing.assert_array_equal(res["compressed_mean"].numpy(), np.asarray(want[r]))


def test_mapped_executor_matches_jax(ranks, jax_executor):
    """Each rank updates its own shard; ``merged()`` (one all_reduce)
    equals JAX's two-shard executor on every rank."""
    _, out = ranks
    jsh = jax_executor
    for r, res in enumerate(out):
        assert res["mapped"] and res["num_shards"] == cases.WORLD
        np.testing.assert_array_equal(res["delta"].counters.numpy(),
                                      np.asarray(jsh.deltas.counters)[r:r + 1])
        np.testing.assert_array_equal(res["delta"].step.numpy(),
                                      np.asarray(jsh.deltas.step)[r:r + 1])
    want = jsh.merged()
    for res in out:
        _same_state(res["merged"], want)
