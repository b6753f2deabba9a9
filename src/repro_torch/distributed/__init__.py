"""repro_torch.distributed -- the multi-host service, ported from the JAX
package's ``distributed/``: sharded workers, a compact sketch-delta wire
protocol whose frames are byte-compatible with the JAX package's, and a
coordinator that merges every worker's epoch-aligned deltas into query
replicas.

  wire.py         versioned delta serialization (bit-exact round-trips,
                  zero-byte idle heartbeats)
  transport.py    length-prefixed frames + the worker opcode set
  worker.py       one EstimationService shard per worker; subprocess entry
  coordinator.py  tenant-hash routing, delta merging, stale-on-failure
  harness.py      1/2/4-worker scale-out benchmark + oracle smoke run
"""
from .coordinator import (ClusterSpec, Coordinator, LocalWorker,
                          SubprocessWorker, shard_of)
from .wire import (HEARTBEAT, MODE_MERGE, MODE_REPLACE, WIRE_VERSION,
                   DeltaMessage, WireFormatError, WireVersionError,
                   decode_bundle, decode_message, encode_bundle,
                   encode_delta, encode_heartbeat, register_state_type,
                   state_type)
from .worker import WorkerRuntime, handle_request

__all__ = [
    "HEARTBEAT", "MODE_MERGE", "MODE_REPLACE", "WIRE_VERSION",
    "ClusterSpec", "Coordinator", "DeltaMessage", "LocalWorker",
    "SubprocessWorker", "WireFormatError", "WireVersionError",
    "WorkerRuntime", "decode_bundle", "decode_message", "encode_bundle",
    "encode_delta", "encode_heartbeat", "handle_request",
    "register_state_type", "shard_of", "state_type",
]
