"""The port's sketch-delta wire format (``repro_torch.distributed.wire``):
the checks of ``tests/test_wire.py`` run through the port, and the two
packages' frames held against each other.

* Bit-exact round-trip of every kind's state, merge transparency, version
  safety, heartbeats, bundles, field order, the state-type registry.
* Cross-package: the same state encodes to the same bytes in both
  packages, and each package decodes the other's frames into its own
  state class -- every kind, a backing-epoch sample window among them.
* uint32 data: the port's int64 record leaves go on the wire as ``<u4``;
  values near 2^32 - 1 survive both directions, and a value outside
  [0, 2^32) raises on encode.
"""
from __future__ import annotations

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax  # noqa: E402

from repro import estimators as JE  # noqa: E402
from repro.core.sjpc import SJPCConfig as JConfig  # noqa: E402
from repro.distributed import wire as jwire  # noqa: E402
from repro.service.window import WindowedSketch as JWindow  # noqa: E402
from repro_torch import estimators as TE  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.sjpc import SJPCConfig as TConfig  # noqa: E402
from repro_torch.distributed import wire  # noqa: E402
from repro_torch.estimators import base as tbase  # noqa: E402
from repro_torch.service.window import WindowedSketch as TWindow  # noqa: E402

KW = dict(d=5, s=3, ratio=0.5, width=64, depth=2, seed=7)
KINDS = ("sjpc", "reservoir", "lsh_ss")
ESTS = {kind: TE.make(kind, TConfig(**KW), device="cpu") for kind in KINDS}
JESTS = {kind: JE.make(kind, JConfig(**KW)) for kind in KINDS}
# the dtype of every leaf in the JAX package's frames
U32_LEAVES = {"reservoir": ("items",), "lsh_ss": ("rec_items",)}


def _records(seed, rows=32, vocab=50):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(1, 1, rows, KW["d"]), dtype=np.uint32)


def _ingest_round(est, state, seed, rows=32):
    """One ingest round of one stream through the port's protocol path."""
    keys = prng.fold_in(prng.PRNGKey(est.ingest_seed), seed)[None, None]
    new = est.ingest_rounds(TE.stack_states([state]), _records(seed, rows),
                            np.ones((1, 1, rows), np.int32), keys)
    return TE.index_state(new, 0)


def _jax_ingest_round(est, state, seed, rows=32):
    keys = jax.random.fold_in(jax.random.PRNGKey(est.ingest_seed), seed)[None, None]
    new = est.ingest_rounds(JE.stack_states([state]), _records(seed, rows),
                            np.ones((1, 1, rows), np.int32), keys)
    return JE.index_state(new, 0)


def _ingested_state(kind, seed, rows=32):
    return _ingest_round(ESTS[kind], ESTS[kind].init(sid=0), seed, rows)


def _assert_leaves_bitexact(a, b):
    for name, la, lb in zip(a._fields, a, b):
        la, lb = la.numpy(), lb.numpy()
        assert la.dtype == lb.dtype, name
        assert la.shape == lb.shape, name
        assert np.array_equal(la, lb, equal_nan=True), name


def _frame(module, kind, state, **kw):
    kw = {"stream": "t", "epoch": 3, "window_version": 5, "mode": module.MODE_REPLACE, **kw}
    return module.encode_delta(module.DeltaMessage(kind=kind, state=state, **kw))


# ---------------------------------------------------------------------------
# the checks of tests/test_wire.py, through the port
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.sampled_from(KINDS), st.integers(min_value=0, max_value=1000))
def test_roundtrip_bitexact(kind, seed):
    state = _ingested_state(kind, seed)
    msg = wire.DeltaMessage(kind=kind, stream=f"t-{seed}", epoch=seed % 7,
                            window_version=seed, mode=wire.MODE_REPLACE, state=state)
    back = wire.decode_message(wire.encode_delta(msg))
    assert back.kind == kind and back.stream == f"t-{seed}"
    assert back.epoch == seed % 7 and back.window_version == seed
    assert type(back.state) is type(state)
    _assert_leaves_bitexact(state, back.state)


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=500), st.integers(min_value=0, max_value=500))
def test_merge_of_deserialized_equals_merge_of_live(sa, sb):
    """Serialization is invisible to the merge algebra (every kind)."""
    for kind in KINDS:
        est = ESTS[kind]
        a = _ingested_state(kind, sa)
        b = _ingested_state(kind, 1000 + sb)

        def rt(s):
            return wire.decode_message(wire.encode_delta(wire.DeltaMessage(
                kind=kind, stream="x", epoch=0, window_version=0, mode=wire.MODE_MERGE,
                state=s))).state

        _assert_leaves_bitexact(est.merge(a, b), est.merge(rt(a), rt(b)))


def _backing_window_export(est, init, ingest, window_cls):
    """A 3-epoch reservoir window with two backing epochs: two closed
    epochs, then the open epoch's export."""
    w = window_cls(est, init, 3, backing_epochs=2)
    for seed in range(2):
        w.absorb_delta(ingest(est, w.ingest_base(), seed))
        w.advance_epoch()
    w.absorb_delta(ingest(est, w.ingest_base(), 99))
    return w, w.export_delta()


def test_roundtrip_backing_epoch_sample_window():
    """The open slot of a backing-epoch sample window round-trips bit-exact
    and installs on a mirror window."""
    est = ESTS["reservoir"]
    w, (mode, state) = _backing_window_export(est, est.init(sid=0), _ingest_round, TWindow)
    assert mode == "replace"
    back = wire.decode_message(_frame(wire, "reservoir", state, epoch=w.epoch,
                                      window_version=w.version))
    _assert_leaves_bitexact(state, back.state)
    mirror = TWindow(est, est.init(sid=0), 3, backing_epochs=2)
    mirror.absorb_delta(back.state)
    _assert_leaves_bitexact(mirror.ingest_base(), state)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=65535))
def test_version_mismatch_rejected(version):
    """Any wire version but ours is refused with both versions named."""
    payload = _frame(wire, "sjpc", _ingested_state("sjpc", 0), mode=wire.MODE_MERGE)
    forged = payload[:4] + struct.pack("<H", version) + payload[6:]
    if version == wire.WIRE_VERSION:
        wire.decode_message(forged)
        return
    with pytest.raises(wire.WireVersionError) as ei:
        wire.decode_message(forged)
    assert str(version) in str(ei.value)
    assert str(wire.WIRE_VERSION) in str(ei.value)


def test_heartbeat_is_zero_bytes_and_versionless():
    assert wire.encode_heartbeat() == b""
    assert wire.decode_message(b"") is wire.HEARTBEAT
    assert wire.decode_bundle(b"") is wire.HEARTBEAT


def test_bundle_roundtrip_and_truncation():
    msgs = [_frame(wire, "sjpc", _ingested_state("sjpc", i), stream=f"t{i}", epoch=i,
                   window_version=i, mode=wire.MODE_MERGE) for i in range(3)]
    bundle = wire.encode_bundle(msgs)
    assert [m.stream for m in wire.decode_bundle(bundle)] == ["t0", "t1", "t2"]
    with pytest.raises(wire.WireFormatError):
        wire.decode_bundle(bundle[:-3])
    with pytest.raises(wire.WireFormatError):
        wire.decode_message(b"XXXX" + bundle[4:40])


def test_field_order_and_count_are_checked():
    payload = _frame(wire, "sjpc", _ingested_state("sjpc", 0), mode=wire.MODE_MERGE)
    idx = payload.index(b"counters")
    bad = payload[:idx] + b"cowriter" + payload[idx + 8:]
    with pytest.raises(wire.WireFormatError):
        wire.decode_message(bad)


@pytest.fixture
def private_registry(monkeypatch):
    """The port's kind registry as a copy, so kinds a test registers do not
    outlive it (other files in the same process enumerate the kinds)."""
    monkeypatch.setattr(tbase, "_REGISTRY", dict(tbase._REGISTRY))


def test_register_state_type_conflicts(private_registry):
    class Fake:
        _fields = ("x",)
    wire.register_state_type("_torch_test_kind", Fake)
    wire.register_state_type("_torch_test_kind", Fake)        # idempotent

    class Other:
        _fields = ("x",)
    with pytest.raises(ValueError):
        wire.register_state_type("_torch_test_kind", Other)
    assert wire.state_type("_torch_test_kind") is Fake
    assert "_torch_test_kind" not in TE.available()            # no factory
    with pytest.raises(KeyError):
        wire.state_type("_no_such_kind")


def test_state_type_only_spec_merges_with_factory(private_registry):
    """A state-class-only registration (the wire's channel) and a factory
    registration of the same kind complete each other in either order."""
    class State:
        _fields = ("x",)

    def factory(*a, **k):                                      # pragma: no cover
        raise NotImplementedError

    TE.register_state_type("_torch_merge_a", State)
    merged = TE.register("_torch_merge_a", factory, linear=True)
    assert merged.state_cls is State and merged.factory is factory
    TE.register("_torch_merge_b", factory, linear=False)
    TE.register_state_type("_torch_merge_b", State)
    assert TE.state_type("_torch_merge_b") is State
    assert TE.spec("_torch_merge_b").linear is False
    with pytest.raises(ValueError, match="conflicting"):
        TE.register("_torch_merge_b", factory, linear=True)


# ---------------------------------------------------------------------------
# the two packages' frames
# ---------------------------------------------------------------------------

def _jax_state(kind, seed):
    est = JESTS[kind]
    return _jax_ingest_round(est, est.init(sid=0), seed)


def _assert_same_as_jax(jstate, tstate, kind):
    assert tuple(jstate._fields) == tuple(tstate._fields)
    for name in jstate._fields:
        a, b = np.asarray(getattr(jstate, name)), getattr(tstate, name).numpy()
        want = np.int64 if name in U32_LEAVES.get(kind, ()) else a.dtype
        assert b.dtype == want, (kind, name, b.dtype)
        assert a.shape == b.shape, (kind, name)
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=f"{kind} {name}")


def _leaf_dtypes(payload):
    """{leaf name: dtype string} of one frame, read by the JAX package's
    decoder."""
    msg = jwire.decode_message(payload)
    return {name: np.asarray(leaf).dtype.str for name, leaf in zip(msg.state._fields,
                                                                     msg.state)}


@pytest.mark.parametrize("kind", KINDS)
def test_frames_equal_jax_and_decode_across(kind):
    """The same state gives the same bytes in both packages; each package
    decodes the other's frame into its own state class."""
    for seed in (0, 1, 17):
        jstate, tstate = _jax_state(kind, seed), _ingested_state(kind, seed)
        _assert_same_as_jax(jstate, tstate, kind)
        jframe, tframe = _frame(jwire, kind, jstate), _frame(wire, kind, tstate)
        assert jframe == tframe, (kind, seed)
        back_j = jwire.decode_message(tframe)
        assert type(back_j.state) is JE.state_type(kind)
        for name in jstate._fields:
            a, b = np.asarray(getattr(jstate, name)), getattr(back_j.state, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (kind, name)
        back_t = wire.decode_message(jframe)
        assert type(back_t.state) is TE.state_type(kind)
        _assert_leaves_bitexact(tstate, back_t.state)
    dtypes = _leaf_dtypes(tframe)
    for name, dt in dtypes.items():
        assert dt == ("<u4" if name in U32_LEAVES.get(kind, ()) else
                      np.asarray(getattr(jstate, name)).dtype.str), (kind, name, dt)


def test_backing_epoch_window_frames_decode_across():
    """A backing-epoch reservoir window's open slot: the same export in
    both packages, the same bytes, and each decodes the other's."""
    jest, test = JESTS["reservoir"], ESTS["reservoir"]
    jw, (jmode, jslot) = _backing_window_export(jest, jest.init(sid=0), _jax_ingest_round,
                                                JWindow)
    tw, (tmode, tslot) = _backing_window_export(test, test.init(sid=0), _ingest_round,
                                                TWindow)
    assert jmode == tmode == "replace"
    _assert_same_as_jax(jslot, tslot, "reservoir")
    jframe = _frame(jwire, "reservoir", jslot, epoch=jw.epoch, window_version=jw.version)
    tframe = _frame(wire, "reservoir", tslot, epoch=tw.epoch, window_version=tw.version)
    assert jframe == tframe
    mirror = TWindow(test, test.init(sid=0), 3, backing_epochs=2)
    mirror.absorb_delta(wire.decode_message(jframe).state)
    _assert_leaves_bitexact(mirror.ingest_base(), tslot)
    jmirror = JWindow(jest, jest.init(sid=0), 3, backing_epochs=2)
    jmirror.absorb_delta(jwire.decode_message(tframe).state)
    for name, leaf in zip(jslot._fields, jmirror.ingest_base()):
        assert np.array_equal(np.asarray(leaf), np.asarray(getattr(jslot, name))), name


@pytest.mark.parametrize("kind", ["reservoir", "lsh_ss"])
def test_uint32_items_near_limit_survive_both_directions(kind):
    field = U32_LEAVES[kind][0]
    tstate = _ingested_state(kind, 3)
    items = getattr(tstate, field).clone()
    items[0, 0] = 2**32 - 1
    items[1, -1] = 2**32 - 2
    items[2, 1] = 2**31
    tstate = tstate._replace(**{field: items})
    jstate = JE.state_type(kind)(*(
        np.asarray(leaf.numpy().astype(np.uint32) if name == field else leaf.numpy())
        for name, leaf in zip(tstate._fields, tstate)))
    tframe = _frame(wire, kind, tstate)
    assert tframe == _frame(jwire, kind, jstate)
    back_j = getattr(jwire.decode_message(tframe).state, field)
    assert back_j.dtype == np.uint32 and back_j[0, 0] == 2**32 - 1
    np.testing.assert_array_equal(back_j.astype(np.int64), items.numpy())
    back_t = getattr(wire.decode_message(_frame(jwire, kind, jstate)).state, field)
    assert back_t.dtype == torch.int64 and int(back_t[0, 0]) == 2**32 - 1
    assert torch.equal(back_t, items)


@pytest.mark.parametrize("kind", ["reservoir", "lsh_ss"])
@pytest.mark.parametrize("bad", [-1, 2**32])
def test_uint32_items_out_of_range_raise_on_encode(kind, bad):
    field = U32_LEAVES[kind][0]
    tstate = _ingested_state(kind, 4)
    items = getattr(tstate, field).clone()
    items[0, 0] = bad
    with pytest.raises(wire.WireFormatError, match=field):
        _frame(wire, kind, tstate._replace(**{field: items}))
