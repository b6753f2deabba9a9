"""The port's checkpoints and fault-tolerant driver on the CPU: the on-disk
format shared with the JAX package (a checkpoint of either restores in the
other, leaf for leaf: a TrainState with AdamW or Q8 moments and the SJPC
monitor), elastic re-chunking, atomic commit and ``keep``; the driver's
recovery bit for bit against an uninterrupted run, its losses against the
JAX driver's over 20 steps, and the reference's own driver checks
(``tests/test_checkpoint_runtime.py``) through the port."""
import os
import time
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro.models.config import compute_dims as jcompute_dims  # noqa: E402
from repro.optim import make_adamw as jmake_adamw  # noqa: E402
from repro.optim import make_q8adam as jmake_q8adam  # noqa: E402
from repro.optim.schedules import constant as jconstant  # noqa: E402
from repro.runtime import DriverConfig as JDriverConfig  # noqa: E402
from repro.runtime import TrainDriver as JTrainDriver  # noqa: E402
from repro.sketchstream.monitor import SketchMonitorConfig as JMonitorConfig  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from repro_torch.models.config import compute_dims as tcompute_dims  # noqa: E402
from repro_torch.optim import make_adamw  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.runtime import DriverConfig, SimulatedFailure, TrainDriver  # noqa: E402
from repro_torch.sketchstream.monitor import SketchMonitorConfig, init_monitor  # noqa: E402

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=1, d_ff=64, vocab_size=128, head_dim=16)
MONITOR = dict(d=4, s=3, width=256, depth=2, shards=1)


def _jax_state(opt_kind="adamw", monitor=True):
    cfg = JArch(**TINY)
    dims = jcompute_dims(cfg, tp=1)
    opt = (jmake_adamw(jconstant(5e-3), weight_decay=0.0) if opt_kind == "adamw"
           else jmake_q8adam(jconstant(5e-3)))
    mcfg = JMonitorConfig(**MONITOR) if monitor else None
    state, _, _ = jtrain.make_train_state(jax.random.PRNGKey(0), cfg, dims, opt,
                                          monitor_cfg=mcfg)
    # non-trivial moments, counters and step, in every dtype the state has
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape).astype(np.float32) if x.dtype == jnp.float32
                   else rng.integers(-100, 100, size=x.shape).astype(np.dtype(x.dtype))),
        state)


def _leaves_equal(got_tree, want_tree):
    got = tree.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("opt_kind", ["adamw", "q8"])
def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path, opt_kind):
    jstate = _jax_state(opt_kind)
    template = convert.train_state_from_numpy(jstate, device="cpu")
    _leaves_equal(template, jstate)

    jckpt.save_checkpoint(str(tmp_path / "jax"), 7, jstate, chunks=3)
    got, man = restore_checkpoint(str(tmp_path / "jax"), template)
    assert man.step == 7 and type(got) is ttrain.TrainState
    _leaves_equal(got, jstate)
    assert all(x.device.type == "cpu" for x in tree.tree_leaves(got))

    save_checkpoint(str(tmp_path / "port"), 9, got, chunks=5)
    back, jman = jckpt.restore_checkpoint(str(tmp_path / "port"), jstate)
    assert jman.step == 9
    _leaves_equal(got, back)
    names = sorted(os.listdir(tmp_path / "port" / "step_00000009"))
    assert names[-1] == "manifest.json" and names[0] == "leaf00000.c0.npy"
    as_numpy = convert.train_state_to_numpy(got)
    assert type(as_numpy) is ttrain.TrainState
    _leaves_equal(as_numpy, jstate)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)),
                       "step": torch.tensor(3, dtype=torch.int32)},
            "tuple": (torch.ones((5, 2)), torch.zeros((3,)))}


class TestCheckpoint:
    def test_round_trip(self, tmp_path):
        t = _tree()
        save_checkpoint(str(tmp_path), 10, t, chunks=4)
        restored, man = restore_checkpoint(str(tmp_path), t)
        assert man.step == 10
        for a, b in zip(tree.tree_leaves(t), tree.tree_leaves(restored)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("chunks", [1, 8, 64, 100])
    def test_elastic_rechunk(self, tmp_path, chunks):
        """Any chunk count on disk restores (and the JAX package restores
        it too): the count is a storage detail, not a topology contract."""
        t = _tree(1)
        save_checkpoint(str(tmp_path), 5, t, chunks=chunks)
        with open(tmp_path / "step_00000005" / "manifest.json") as f:
            assert f"\"chunks\": {min(chunks, 64)}" in f.read()
        restored, _ = restore_checkpoint(str(tmp_path), t)
        assert torch.equal(t["w"], restored["w"])
        jt = jax.tree_util.tree_map(lambda x: x.numpy(), t)
        back, _ = jckpt.restore_checkpoint(str(tmp_path), jt)
        np.testing.assert_array_equal(np.asarray(back["w"]), t["w"].numpy())

    def test_atomic_no_partial_reads(self, tmp_path):
        t = _tree(2)
        save_checkpoint(str(tmp_path), 1, t)
        stale = tmp_path / "step_00000002.tmp-dead"
        stale.mkdir()
        (stale / "garbage.npy").write_bytes(b"xx")
        assert latest_step(str(tmp_path)) == 1
        save_checkpoint(str(tmp_path), 3, t)
        assert latest_step(str(tmp_path)) == 3
        assert not any(".tmp-" in d for d in os.listdir(tmp_path))

    def test_keep_gc(self, tmp_path):
        t = _tree(3)
        for s in range(6):
            save_checkpoint(str(tmp_path), s, t, keep=2)
        steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
        assert steps == ["step_00000004", "step_00000005"]
        assert latest_step(str(tmp_path)) == 5

    def test_bfloat16_leaf_raises_and_device_is_honoured(self, tmp_path):
        with pytest.raises(TypeError, match="bfloat16"):
            save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(3, dtype=torch.bfloat16)})
        t = {"x": np.arange(6, dtype=np.int8).reshape(2, 3)}
        save_checkpoint(str(tmp_path), 1, t)
        got, _ = restore_checkpoint(str(tmp_path), t, device="cpu")
        assert got["x"].dtype == torch.int8 and got["x"].device.type == "cpu"
        with pytest.raises(ValueError, match="template has"):
            restore_checkpoint(str(tmp_path), {"x": t["x"], "y": t["x"]})
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(str(tmp_path / "none"), t)


# ---------------------------------------------------------------------------
# The driver on the tiny LM with the monitor, against the JAX driver
# ---------------------------------------------------------------------------

def _batch(step):
    """tests/test_integration_train.py's batch of ``step``."""
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, TINY["vocab_size"], size=(4, 33), dtype=np.int32)
    toks[1] = toks[0]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port_driver(ckpt_dir, start_from):
    cfg = TArch(**TINY)
    dims = tcompute_dims(cfg, tp=1)
    mcfg = SketchMonitorConfig(**MONITOR)
    mparams, _ = init_monitor(mcfg, device="cpu")
    opt = make_adamw(constant(5e-3), weight_decay=0.0)
    step_fn = ttrain.make_train_step(cfg, dims, opt, monitor_cfg=mcfg, monitor_params=mparams,
                                     remat="none", ssm_chunk=8, compute_dtype=torch.float32)
    state = convert.train_state_from_numpy(start_from, device="cpu")
    return TrainDriver(step_fn, state, lambda s: {k: torch.from_numpy(v.copy())
                                                  for k, v in _batch(s).items()},
                       DriverConfig(ckpt_dir=str(ckpt_dir), ckpt_every=8, log_every=1,
                                    sketch_log_every=5),
                       monitor_cfg=mcfg)


def _jax_start():
    cfg = JArch(**TINY)
    dims = jcompute_dims(cfg, tp=1)
    mcfg = JMonitorConfig(**MONITOR)
    opt = jmake_adamw(jconstant(5e-3), weight_decay=0.0)
    state, mparams, _ = jtrain.make_train_state(jax.random.PRNGKey(0), cfg, dims, opt,
                                                monitor_cfg=mcfg)
    step_fn = jax.jit(jtrain.make_train_step(cfg, dims, opt, None, monitor_cfg=mcfg,
                                             monitor_params=mparams, remat="none",
                                             ssm_chunk=8, compute_dtype=jnp.float32))
    return state, step_fn, mcfg


def test_driver_recovery_bit_exact_and_losses_match_the_jax_driver(tmp_path):
    jstate, jstep, jmcfg = _jax_start()
    start = jax.tree_util.tree_map(np.asarray, jstate)
    jdriver = JTrainDriver(jstep, jstate,
                           lambda s: {k: jnp.asarray(v) for k, v in _batch(s).items()},
                           JDriverConfig(ckpt_dir=str(tmp_path / "jax"), ckpt_every=8,
                                         log_every=1, sketch_log_every=5),
                           monitor_cfg=jmcfg)
    jdriver.run(20)

    ref = _port_driver(tmp_path / "ref", start)
    ref.run(20)
    assert [m["step"] for m in ref.metrics_log] == list(range(20))
    for got, want in zip(ref.metrics_log, jdriver.metrics_log):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), got["step"]
    assert [r["step"] for r in ref.sketch_log] == [r["step"] for r in jdriver.sketch_log]
    for got, want in zip(ref.sketch_log, jdriver.sketch_log):
        assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_array_equal(ref.state.monitor.counters.numpy(),
                                  np.asarray(jdriver.state.monitor.counters))

    failed = _port_driver(tmp_path / "fail", start)
    failed.inject_failure_at = {11: SimulatedFailure("pod lost"),
                                17: SimulatedFailure("pod lost again")}
    failed.run(20)
    assert failed.restarts == 2 and failed.step == 20
    assert [e["step"] for e in failed.events if e["kind"] == "restore"] == [9, 17]
    for a, b in zip(tree.tree_leaves(ref.state), tree.tree_leaves(failed.state)):
        assert torch.equal(a, b)
    assert float(failed.state.monitor.n.sum()) == 80.0


class _S(NamedTuple):
    params: torch.Tensor
    opt: torch.Tensor
    monitor: type(None)
    step: torch.Tensor


def _quad_driver(tmp_path, ckpt_every=5):
    """tests/test_checkpoint_runtime.py's quadratic 'training'."""
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(16,)).astype(np.float32))

    def step_fn(state, batch):
        g = 2 * (state.params - target) + 0.01 * batch
        loss = torch.mean((state.params - target) ** 2)
        return _S(state.params - 0.1 * g, state.opt, None, state.step + 1), {"loss": loss}

    def make_batch(step):
        return torch.from_numpy(np.random.default_rng(1000 + step).normal(size=(16,))
                                .astype(np.float32))

    init = _S(torch.zeros(16), torch.zeros(()), None, torch.zeros((), dtype=torch.int32))
    return TrainDriver(step_fn, init, make_batch,
                       DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                                    log_every=1))


class TestDriver:
    def test_runs_and_checkpoints(self, tmp_path):
        driver = _quad_driver(tmp_path)
        driver.run(12)
        assert driver.step == 12
        assert latest_step(str(tmp_path)) == 12
        assert any(e["kind"] == "checkpoint" for e in driver.events)

    def test_too_many_failures_raises(self, tmp_path):
        driver = _quad_driver(tmp_path)
        driver.cfg.max_restarts = 1
        driver.inject_failure_at = {3: SimulatedFailure("a"), 4: SimulatedFailure("b")}
        with pytest.raises(SimulatedFailure):
            driver.run(10)

    def test_straggler_detection(self, tmp_path):
        driver = _quad_driver(tmp_path)

        def slow_hook(step):
            if step in (8, 9, 10):
                time.sleep(0.25)

        driver.run(14, slow_step_hook=slow_hook)
        kinds = [e["kind"] for e in driver.events]
        assert "straggler" in kinds and "straggler_mitigation" in kinds
