"""Sketch-delta wire format: versioned, deterministic state serialization,
ported from the JAX package's ``distributed/wire.py``.  The frames are the
same bytes as that package's, so a worker of either package can feed a
coordinator of the other.

The multi-host service ships estimator state between worker processes and
the coordinator.  Every estimator state is a NamedTuple of dense tensors
(``SJPCState``, ``ReservoirState``, ``LSHSSState``), so one generic layout
covers all kinds: leaves are serialized **in NamedTuple field order** as
(field name, dtype, shape, little-endian C-order raw bytes).  That makes the
encoding a pure function of the state -- byte-identical across processes
and runs -- and the round-trip ``decode(encode(x))`` bit-exact, which the
window merge algebra requires.

**uint32 data on the wire.**  The port carries uint32 record data as int64
tensors (PyTorch has no uint32 arithmetic on the CPU); the JAX package
stores it as uint32.  So every int64 leaf goes on the wire as ``<u4`` --
after a check that each value lies in [0, 2^32) -- and every ``<u4`` leaf
comes back as int64.  Today those leaves are ``ReservoirState.items`` and
``LSHSSState.rec_items``.  A frame that carried ``<i8`` would decode on a
JAX coordinator without error into a state that is silently wrong, so the
encoder never writes one.

Two delta **modes** mirror the two window strategies of
``service/window.py``:

  ``MODE_MERGE``    linear kinds (SJPC): the payload is the leaf-wise
                    difference of the open epoch since the last export,
                    applied on the replica through the estimator's
                    ``merge`` (counter addition).
  ``MODE_REPLACE``  sample kinds (reservoir, lsh_ss): a uniform sample
                    cannot be shipped as arithmetic deltas, so the open
                    epoch's full state replaces the replica's open slot.

Decoding rebuilds the **registered** state class (``estimators.state_type``)
with CPU tensors as leaves; whoever applies a decoded state moves it to the
receiving service's device.  Plugin kinds register theirs with
:func:`register_state_type`.

The **zero-byte heartbeat**: a worker with nothing new since its last
export ships an empty frame instead of a delta bundle.
:func:`decode_message` maps the empty payload to :data:`HEARTBEAT` without
touching the version machinery.

Framing (length prefixes, the stdin/stdout loop) lives in transport.py;
this module is pure bytes <-> state.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from .. import estimators

MAGIC = b"RSJD"                  # delta-message preamble
WIRE_VERSION = 1                 # bump on any layout change

MODE_MERGE = 1                   # linear delta: apply via estimator.merge
MODE_REPLACE = 2                 # sample state: replace the open slot

_U32_LIMIT = 1 << 32


class WireVersionError(ValueError):
    """Peer speaks a different wire version; merging would corrupt state."""


class WireFormatError(ValueError):
    """Payload does not parse as a delta message, or a state cannot be
    written in the wire's format."""


# -- kind -> state class registry -------------------------------------------

def register_state_type(kind: str, cls: type) -> None:
    """Register an estimator kind's state NamedTuple class so
    :func:`decode_message` can rebuild it.  The same class again is a
    no-op; another class raises.  Delegates to the port's estimator spec
    registry: kinds registered through ``estimators.register`` with a
    ``state_cls`` need no separate call."""
    estimators.register_state_type(kind, cls)


def state_type(kind: str) -> type:
    return estimators.state_type(kind)


def mode_code(mode: str) -> int:
    """Wire byte of a window export mode ("merge" / "replace" --
    ``EstimatorSpec.wire_mode``)."""
    try:
        return {"merge": MODE_MERGE, "replace": MODE_REPLACE}[mode]
    except KeyError:
        raise WireFormatError(f"unknown delta mode {mode!r}") from None


def mode_name(code: int) -> str:
    """Inverse of :func:`mode_code`."""
    try:
        return {MODE_MERGE: "merge", MODE_REPLACE: "replace"}[code]
    except KeyError:
        raise WireFormatError(f"unknown delta mode {code}") from None


# -- messages ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaMessage:
    """One stream's epoch-aligned export."""
    kind: str                    # estimator kind ("sjpc", ...)
    stream: str                  # stream (tenant) name
    epoch: int                   # the open epoch this delta belongs to
    window_version: int          # worker window version at export time
    mode: int                    # MODE_MERGE | MODE_REPLACE
    state: object                # the kind's state NamedTuple (decoded:
                                 # CPU tensors)


class _Heartbeat:
    """Singleton marker for the zero-byte idle export."""

    def __repr__(self) -> str:   # pragma: no cover - repr cosmetics
        return "HEARTBEAT"


HEARTBEAT = _Heartbeat()


# -- encoding ---------------------------------------------------------------

def _pack_str(s: str, width: str = "H") -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<" + width, len(raw)) + raw


def _leaf_array(leaf, name: str) -> np.ndarray:
    """One leaf on the host in the wire's dtype: int64 leaves (uint32 data
    carried wide) narrowed to uint32 after a range check."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    a = np.asarray(leaf)
    if a.dtype == np.int64:
        if a.size and (a.min() < 0 or a.max() >= _U32_LIMIT):
            raise WireFormatError(
                f"leaf {name!r} holds values outside [0, 2^32) "
                f"({int(a.min())}..{int(a.max())}); the wire carries it as uint32")
        a = a.astype(np.uint32)
    return a


def _leaf_bytes(arr, name: str) -> tuple[str, tuple, bytes]:
    """(dtype-str, shape, raw) of one state leaf, normalized to
    little-endian C order so the encoding is platform-independent."""
    a = _leaf_array(arr, name)
    if not a.flags["C_CONTIGUOUS"]:
        # NB: not ascontiguousarray -- that promotes 0-d leaves to (1,)
        a = np.ascontiguousarray(a)
    le = a.dtype.newbyteorder("<")
    if a.dtype != le:
        a = a.astype(le)
    return le.str, tuple(a.shape), a.tobytes(order="C")


def encode_delta(msg: DeltaMessage) -> bytes:
    """Serialize one delta message (deterministic: NamedTuple field
    order, fixed-width little-endian header fields)."""
    fields = getattr(msg.state, "_fields", None)
    if fields is None:
        raise WireFormatError(
            f"state of kind {msg.kind!r} is not a NamedTuple "
            f"({type(msg.state).__name__})")
    out = [MAGIC, struct.pack("<HB", WIRE_VERSION, msg.mode),
           _pack_str(msg.kind, "B"), _pack_str(msg.stream),
           struct.pack("<qq", msg.epoch, msg.window_version),
           struct.pack("<B", len(fields))]
    for name in fields:
        dt, shape, raw = _leaf_bytes(getattr(msg.state, name), name)
        out.append(_pack_str(name, "B"))
        out.append(_pack_str(dt, "B"))
        out.append(struct.pack("<B", len(shape)))
        out.append(struct.pack(f"<{len(shape)}I", *shape) if shape else b"")
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)


def encode_heartbeat() -> bytes:
    """The idle-worker fast path: zero bytes.  No version field -- there
    is nothing to mismatch -- and nothing for the coordinator to merge."""
    return b""


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise WireFormatError(
                f"truncated delta message: wanted {n} bytes at offset "
                f"{self.pos}, have {len(self.buf) - self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        vals = struct.unpack("<" + fmt, self.take(struct.calcsize("<" + fmt)))
        return vals[0] if len(vals) == 1 else vals

    def take_str(self, width: str = "H") -> str:
        return self.take(self.unpack(width)).decode("utf-8")


def decode_message(payload: bytes):
    """Decode one export payload: :data:`HEARTBEAT` for the empty frame,
    a :class:`DeltaMessage` of CPU tensors otherwise.  Raises
    :class:`WireVersionError` (naming both versions) on a wire-version
    mismatch BEFORE touching any state bytes."""
    if not payload:
        return HEARTBEAT
    r = _Reader(payload)
    magic = r.take(len(MAGIC))
    if magic != MAGIC:
        raise WireFormatError(f"bad delta magic {magic!r} (expected {MAGIC!r})")
    version, mode = r.unpack("HB")
    if version != WIRE_VERSION:
        raise WireVersionError(
            f"wire version mismatch: peer sent version {version}, this "
            f"process speaks version {WIRE_VERSION}; refusing to merge")
    if mode not in (MODE_MERGE, MODE_REPLACE):
        raise WireFormatError(f"unknown delta mode {mode}")
    kind = r.take_str("B")
    stream = r.take_str()
    epoch, window_version = r.unpack("qq")
    n_fields = r.unpack("B")
    cls = state_type(kind)
    if n_fields != len(cls._fields):
        raise WireFormatError(
            f"kind {kind!r} delta carries {n_fields} leaves, state type "
            f"{cls.__name__} has {len(cls._fields)}")
    leaves = {}
    for i in range(n_fields):
        name = r.take_str("B")
        if name != cls._fields[i]:
            raise WireFormatError(
                f"kind {kind!r} leaf {i} is {name!r}, expected "
                f"{cls._fields[i]!r} (field order is part of the format)")
        dt = np.dtype(r.take_str("B"))
        ndim = r.unpack("B")
        if ndim:
            dims = r.unpack(f"{ndim}I")
            shape = (dims,) if ndim == 1 else tuple(dims)
        else:
            shape = ()
        nbytes = r.unpack("Q")
        raw = r.take(nbytes)
        # copy out of the frame buffer: leaves must be writable, C-order
        # arrays (they feed straight into the window merge algebra)
        a = np.frombuffer(raw, dtype=dt).reshape(shape).copy()
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        leaves[name] = torch.from_numpy(a)
    if r.pos != len(payload):
        raise WireFormatError(
            f"{len(payload) - r.pos} trailing bytes after delta message")
    return DeltaMessage(kind=kind, stream=stream, epoch=epoch,
                        window_version=window_version, mode=mode,
                        state=cls(**leaves))


def encode_bundle(messages: list[bytes]) -> bytes:
    """Concatenate encoded delta messages into one export payload:
    uint32 count, then (uint32 length, bytes) per message.  An empty
    message list is NOT a bundle -- idle workers ship
    :func:`encode_heartbeat` (zero bytes) instead."""
    out = [struct.pack("<I", len(messages))]
    for m in messages:
        out.append(struct.pack("<I", len(m)))
        out.append(m)
    return b"".join(out)


def decode_bundle(payload: bytes):
    """Inverse of :func:`encode_bundle`; the empty payload decodes to
    :data:`HEARTBEAT` (no messages, no version check, no merge work)."""
    if not payload:
        return HEARTBEAT
    r = _Reader(payload)
    count = r.unpack("I")
    msgs = []
    for _ in range(count):
        msgs.append(decode_message(r.take(r.unpack("I"))))
    if r.pos != len(payload):
        raise WireFormatError(
            f"{len(payload) - r.pos} trailing bytes after delta bundle")
    return msgs


def state_to(state, device):
    """A decoded state with its leaves on ``device``."""
    return type(state)(*(leaf.to(device) for leaf in state))
