"""Worker runtime: one `EstimationService` shard for a subset of tenants,
ported from the JAX package's ``distributed/worker.py``.

A worker owns the tenants the coordinator hashed onto it: it buffers and
flushes their records exactly like a single-process service -- same cohort
batching, same kernels -- and, on request, exports epoch-aligned window
deltas in the wire format.  Two invariants make a worker's sketches
interchangeable with a single-process run:

* **Pinned uids**: every stream registers with its *global* tenant uid,
  so the per-(stream, round) ingest PRNG grid (``ingest.ingest_key``)
  matches the single-process oracle bit for bit.
* **Export-before-advance**: the coordinator exports every worker's
  deltas before broadcasting ``advance``, so ring slots are fully
  mirrored on the replicas when they close.

The OP_CONFIG JSON is part of the protocol.  A JAX coordinator names the
service's backend as ``"platform"``; the port's ``ServiceConfig`` has
``device``.  :func:`service_kwargs` reads both: ``"platform": "cpu"``
means ``device="cpu"``, any other platform the CUDA card.

The subprocess entry (``python -m repro_torch.distributed.worker``) speaks
the framed opcode protocol of transport.py over stdin/stdout.  The protocol
stream is dup'd off fd 0/1 at startup and fd 1 is re-pointed at stderr, so
a stray ``print`` (or a library warning) can never corrupt a frame.
:func:`handle_request` is the single opcode dispatcher -- the in-process
``LocalWorker`` handle (coordinator.py) routes through the same function
with the same encoded bytes.
"""
from __future__ import annotations

import json
import struct
import sys

import numpy as np

from . import transport, wire
from .transport import (OP_ADVANCE, OP_CONFIG, OP_EXPORT, OP_FLUSH,
                        OP_INGEST, OP_METRICS, OP_SHUTDOWN)


def service_kwargs(service: dict) -> dict:
    """``ServiceConfig`` keywords from an OP_CONFIG's ``"service"`` object.
    The JAX package's ``"platform"`` key becomes ``device``: ``"cpu"`` is
    the CPU, any other value the CUDA card (``device=None``).  An explicit
    ``device`` wins; no other key is translated."""
    kw = dict(service)
    platform = kw.pop("platform", None)
    if platform is not None and "device" not in kw:
        kw["device"] = "cpu" if platform == "cpu" else None
    return kw


class WorkerRuntime:
    """The service shard behind one worker: built from the coordinator's
    JSON topology spec, queried through plain methods (the protocol layer
    below is a thin codec around these)."""

    def __init__(self, spec: dict, *, obs=None):
        from ..core.sjpc import SJPCConfig
        from ..obs import MetricsRegistry, Observability, Tracer
        from ..service import EstimationService, ServiceConfig

        self.worker = int(spec.get("worker", 0))
        if obs is None:
            # a private registry: in-process workers (tests) must not
            # interleave their series with the coordinator's
            metrics = MetricsRegistry()
            obs = Observability(metrics=metrics, tracer=Tracer(registry=metrics))
        self.service = EstimationService(
            ServiceConfig(**service_kwargs(spec.get("service", {}))), obs=obs)
        for g in spec.get("groups", []):
            self.service.create_group(g["group_id"], SJPCConfig(**g["cfg"]))
        for s in spec.get("streams", []):
            kwargs = {k: s[k] for k in
                      ("window_epochs", "estimator", "backing_epochs", "uid")
                      if k in s}
            self.service.create_stream(s["name"], s["group"], **kwargs)

    def ingest(self, name: str, records) -> int:
        return self.service.ingest(name, records)

    def flush(self) -> None:
        self.service.flush()

    def export(self) -> bytes:
        """The export payload: a delta bundle for every stream with new
        rounds since the last export, or the zero-byte heartbeat when the
        whole shard is idle."""
        deltas = self.service.export_deltas()
        m = self.service.obs.metrics
        if not deltas:
            m.inc("worker_heartbeats_total")
            return wire.encode_heartbeat()
        msgs = [wire.encode_delta(wire.DeltaMessage(
            kind=kind, stream=name, epoch=epoch, window_version=version,
            mode=wire.mode_code(mode), state=state))
            for name, kind, epoch, version, mode, state in deltas]
        m.inc("worker_delta_messages_total", value=float(len(msgs)))
        return wire.encode_bundle(msgs)

    def advance(self) -> None:
        self.service.advance_epoch()

    def metrics(self) -> dict:
        """The shard's metric snapshot + service stats (the coordinator
        absorbs this under a ``worker=<idx>`` label)."""
        self.service.refresh_gauges()
        return {"worker": self.worker,
                "stats": dict(self.service.stats),
                "metrics": self.service.obs.metrics.collect()}


# -- protocol codec ---------------------------------------------------------

_INGEST_HDR = struct.Struct("<HII")      # name length, rows, dims


def encode_ingest(name: str, records) -> bytes:
    arr = np.ascontiguousarray(np.asarray(records, dtype=np.uint32))
    raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
    nm = name.encode("utf-8")
    return _INGEST_HDR.pack(len(nm), arr.shape[0], arr.shape[1]) + nm + raw


def decode_ingest(body: bytes) -> tuple[str, np.ndarray]:
    nlen, rows, dims = _INGEST_HDR.unpack_from(body)
    name = body[_INGEST_HDR.size:_INGEST_HDR.size + nlen].decode("utf-8")
    arr = np.frombuffer(body, dtype="<u4",
                        offset=_INGEST_HDR.size + nlen).reshape(rows, dims)
    return name, arr


def _ack(**kw) -> bytes:
    return json.dumps({"ok": True, **kw}).encode("utf-8")


def handle_request(runtime: WorkerRuntime | None, op: int, body: bytes):
    """Dispatch one request; returns ``(runtime, response_bytes | None)``.
    ``None`` responses (ingest) send nothing -- the one-directional
    opcode, so the coordinator can stream records without round-trips.
    Shared verbatim by the subprocess loop and the in-process handle."""
    if op == OP_CONFIG:
        runtime = WorkerRuntime(json.loads(body.decode("utf-8")))
        return runtime, _ack(worker=runtime.worker)
    if runtime is None:
        raise ConnectionError(f"opcode {op:#x} before OP_CONFIG")
    if op == OP_INGEST:
        runtime.ingest(*decode_ingest(body))
        return runtime, None
    if op == OP_FLUSH:
        runtime.flush()
        return runtime, _ack(flushes=runtime.service.stats["ingested_records"])
    if op == OP_EXPORT:
        return runtime, runtime.export()
    if op == OP_ADVANCE:
        runtime.advance()
        return runtime, _ack(epochs=runtime.service.stats["epochs"])
    if op == OP_METRICS:
        return runtime, json.dumps(runtime.metrics()).encode("utf-8")
    if op == OP_SHUTDOWN:
        return runtime, _ack(shutdown=True)
    raise ConnectionError(f"unknown opcode {op:#x}")


def main() -> int:
    """Subprocess entry: framed request loop over the original fd 0/1.
    fd 1 is re-pointed at stderr immediately so library chatter cannot
    corrupt protocol frames."""
    import os
    proto_in = os.fdopen(os.dup(0), "rb")
    proto_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    runtime = None
    while True:
        frame = transport.read_frame(proto_in)
        if frame is None:
            return 0                     # coordinator closed the pipe
        op, body = transport.unpack_op(frame)
        runtime, resp = handle_request(runtime, op, body)
        if resp is not None:
            transport.write_frame(proto_out, resp)
        if op == OP_SHUTDOWN:
            return 0


if __name__ == "__main__":
    sys.exit(main())
