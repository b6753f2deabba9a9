"""Length-prefixed framing over byte streams (pipes, sockets, files), a
copy of the JAX package's ``distributed/transport.py``: the frames and
opcodes are the same bytes, so workers and coordinators of either package
speak to each other.

The worker protocol is strictly request -> (optional) response over one
pair of unidirectional streams, so plain 4-byte big-endian length prefixes
are enough -- no interleaving, no reassembly.  A zero-length frame is
legal payload (the idle-worker heartbeat, wire.py) and distinct from EOF:
:func:`read_frame` returns ``b""`` for the former and ``None`` for the
latter.

Requests carry a 1-byte opcode before the body; :func:`pack_op` /
:func:`unpack_op` keep that convention in one place.
"""
from __future__ import annotations

import struct

_LEN = struct.Struct(">I")

MAX_FRAME = 1 << 30              # sanity bound: a corrupt length prefix
#   must fail loudly, not allocate gigabytes

# worker protocol opcodes (requests; see distributed/worker.py)
OP_CONFIG = 0x01                 # JSON topology -> JSON ack
OP_INGEST = 0x02                 # stream name + raw records; NO response
OP_FLUSH = 0x03                  # drain ingest buffers -> JSON ack
OP_EXPORT = 0x04                 # -> delta bundle | zero-byte heartbeat
OP_ADVANCE = 0x05                # close the open epoch -> JSON ack
OP_METRICS = 0x06                # -> JSON metrics collect() snapshot
OP_SHUTDOWN = 0x07               # -> JSON ack, then the worker exits


def write_frame(fp, payload: bytes) -> None:
    fp.write(_LEN.pack(len(payload)))
    if payload:
        fp.write(payload)
    fp.flush()


def _read_exact(fp, n: int) -> bytes | None:
    """Read exactly ``n`` bytes; None on clean EOF at a frame boundary.
    EOF *inside* a frame is a protocol error (a peer died mid-write)."""
    chunks = []
    got = 0
    while got < n:
        chunk = fp.read(n - got)
        if not chunk:
            if got == 0:
                return None
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes read)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(fp) -> bytes | None:
    """One frame's payload; ``b""`` for a zero-length frame (heartbeat),
    ``None`` on EOF before any header byte."""
    hdr = _read_exact(fp, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise ConnectionError(f"frame length {n} exceeds bound {MAX_FRAME}")
    if n == 0:
        return b""
    return _read_exact(fp, n)


def pack_op(op: int, body: bytes = b"") -> bytes:
    return bytes((op,)) + body


def unpack_op(frame: bytes) -> tuple[int, bytes]:
    if not frame:
        raise ConnectionError("empty request frame (no opcode)")
    return frame[0], frame[1:]
