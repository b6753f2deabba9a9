"""Three-term roofline of one rank's step, from a count of the eager ops it
runs (no compile, no card needed: the ops may run on ``meta`` tensors).

    compute term    = sum over dtypes of FLOPs / that dtype's peak rate
    memory term     = HBM bytes / HBM bandwidth
    collective term = wire bytes / the NVLink rate

The JAX package's ``launch/roofline.py`` parses XLA's partitioned HLO
(``hlo_cost``, ``parse_collectives``, ``analyze_compiled``).  Eager
PyTorch has no HLO; its counterpart here is :func:`count_cost`, a
``TorchDispatchMode`` that sees every aten op the step runs -- forward,
backward and recompute under remat -- and every c10d collective:

  * FLOPs: ``torch.utils.flop_counter``'s formulas for every matmul,
    ``bmm``, ``addmm``, ``baddbmm`` and attention op (``einsum`` reaches
    them as products), 2 * output elements * contraction, as XLA's ``dot``
    count; kept by the first input's dtype, since the card's rates differ
    by more than 10x between bf16 (tensor cores) and f32 without TF32
    (CUDA cores).  Elementwise flops are not counted, as in the reference.
  * HBM bytes: each eager op is a kernel whose operands cross HBM, so each
    op's inputs and outputs; an input is charged the bytes of storage it
    can touch (an ``expand``ed GQA K/V once, not once per head), never
    more than its storage.  Ops that move nothing -- views, ``detach``,
    ``empty*`` -- are skipped (the reference's ``_SKIP_TRAFFIC``).
  * Collectives: all-reduce charged twice its result's bytes on the wire
    (a ring's reduce-scatter and all-gather), all-gather and
    reduce-scatter once (the reference's ``_WIRE_FACTOR``).
  * Kernel ops (``kernels.ops``: ``fingerprint``, ``fused_ingest``,
    ``sample_weights``, ``fused_query``, ``sketch_update``,
    ``sketch_moments``, ``fused_pairs``, ``flash_attention``,
    ``flash_attention_bwd``) are costed by the hand-written kernel's own
    formula (``kernels.work``); the aten ops their plain versions issue
    are not counted, so a step counts the same on the CPU, on ``meta`` and
    on the card.
  * Memory: the bytes of live storages (each counted once, however many
    views share it), their peak, and the arguments' share.

Shapes are one rank's, so all numbers are per rank.  The peaks are one
H100 SXM's (``kernels.work``).  The reference's ``xla_flops_raw``,
``legalization_bytes`` and ``memory_s_tpu`` describe XLA's cost analysis
on a CPU backend and a TPU's bf16 legalization; eager ops on the card
have neither, so :class:`Roofline` has no counterpart of them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import work
from ..kernels.work import F32_FLOPS_PER_S, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S

# Rate of each dtype's operations; float64 at half the f32 CUDA-core rate
# (the data sheet's FP64 34 TFLOP/s against FP32's 67).
RATES = {**work.RATES, "float64": F32_FLOPS_PER_S / 2}
INT_KINDS = ("int32",)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")
_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "broadcast": 1.0}
# c10d op names (``torch.ops.c10d`` and ``torch.ops._c10d_functional``) by kind
_COLLECTIVE_NAMES = (("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
                     ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
                     ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
                     ("all_to_all", "all-to-all"), ("broadcast", "broadcast"))

_aten = torch.ops.aten
# ops that move no bytes of their own besides the views (``OpOverload.is_view``)
_SKIP_TRAFFIC = {_aten.detach, _aten.empty, _aten.empty_like, _aten.empty_strided,
                 _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh, _aten._unsafe_view,
                 _aten.set_, _aten.resize_, _aten._local_scalar_dense}
_COPIES = {_aten._to_copy, _aten.copy_, _aten.copy}


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _local_tensors(tree) -> list:
    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tree)]


def touched_bytes(t: torch.Tensor) -> int:
    """The bytes of storage ``t`` can read: its distinct elements (a
    stride-0 dim counts once) or the span its strides cover, whichever is
    less, and never more than its storage."""
    if t.numel() == 0:
        return 0
    distinct, span = 1, 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            distinct *= size
        span += (size - 1) * abs(stride)
    return min(min(distinct, span) * t.element_size(), t.untyped_storage().nbytes())


def _collective_kind(func) -> str | None:
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._opname
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


@dataclasses.dataclass
class Cost:
    """One rank's counted work (:func:`count_cost`)."""
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    hbm_bytes: int = 0
    collectives: dict = dataclasses.field(default_factory=lambda: {
        k: {"count": 0, "bytes": 0, "wire_bytes": 0} for k in COLLECTIVE_OPS})
    kernel_ops: dict = dataclasses.field(default_factory=dict)
    hbm_by_op: dict = dataclasses.field(default_factory=dict)   # aten op -> bytes
    argument_bytes: int = 0
    output_bytes: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0

    @property
    def flops(self) -> int:
        """Floating-point operations of every dtype (not the int32 ones)."""
        return sum(n for k, n in self.flops_by_dtype.items() if k not in INT_KINDS)

    @property
    def total_wire_bytes(self) -> int:
        return sum(v["wire_bytes"] for v in self.collectives.values())

    def memory(self) -> dict:
        return {"argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
                "peak_bytes": self.peak_bytes,
                "temp_bytes": self.peak_bytes - self.argument_bytes}

    def as_dict(self) -> dict:
        return {"flops": self.flops, "flops_by_dtype": dict(self.flops_by_dtype),
                "hbm_bytes": self.hbm_bytes, "collectives": parse_collectives(self),
                "total_wire_bytes": self.total_wire_bytes,
                "kernel_ops": {op: dict(v) for op, v in self.kernel_ops.items()},
                "memory": self.memory()}


class _CostMode(TorchDispatchMode):
    """The dispatch mode behind :func:`count_cost`."""

    def __init__(self, cost: Cost, memory_device: str | None):
        super().__init__()
        self.cost = cost
        self.memory_device = memory_device
        self.paused = 0
        self._live: dict = {}

    # -- memory -------------------------------------------------------------
    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it is freed; its bytes if it
        was not live already, else 0."""
        if self.memory_device is not None and t.device.type != self.memory_device:
            return 0
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return 0
        nbytes = storage.nbytes()
        self._live[key] = nbytes
        weakref.finalize(storage, self._release, key)
        self.cost.live_bytes += nbytes
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.cost.live_bytes)
        return nbytes

    def _release(self, key) -> None:
        self.cost.live_bytes -= self._live.pop(key, 0)

    # -- ops ----------------------------------------------------------------
    def _add_flops(self, dtype: str, n: int) -> None:
        if n:
            by = self.cost.flops_by_dtype
            by[dtype] = by.get(dtype, 0) + int(n)

    def kernel_call(self, op: str, fn, args, kwargs):
        """One kernel op's call: run it uncounted, cost it by its formula."""
        if self.paused:
            return fn(*args, **kwargs)
        self.paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.paused -= 1
        w = work.op_work(op, args, kwargs, out)
        entry = self.cost.kernel_ops.setdefault(op, {"calls": 0, "bytes": 0, "ops": {}})
        entry["calls"] += 1
        entry["bytes"] += w.nbytes
        for kind, n in w.ops.items():
            entry["ops"][kind] = entry["ops"].get(kind, 0) + n
            self._add_flops(kind, n)
        self.cost.hbm_bytes += w.nbytes
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and t is not torch.nn.Parameter for t in types):
            return NotImplemented   # a subclass (DTensor): counted as its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self.track(t)
        if self.paused:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            first = next(iter(_tensors(args)), None)
            dtype = str(first.dtype).removeprefix("torch.") if first is not None else "float32"
            self._add_flops(dtype, flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or packet in _SKIP_TRAFFIC:
            return out
        if packet in _COPIES and len({t.device for t in _tensors((args, kwargs, out))}) > 1:
            return out      # host <-> card: over PCIe, not HBM traffic
        kind = _collective_kind(func)
        if kind is not None:
            result = _tensors(args[0] if func.namespace == "c10d" else out)
            nbytes = sum(t.numel() * t.element_size() for t in result)
            entry = self.cost.collectives[kind]
            entry["count"] += 1
            entry["bytes"] += nbytes
            entry["wire_bytes"] += int(nbytes * _WIRE_FACTOR[kind])
        nbytes = (sum(touched_bytes(t) for t in _tensors((args, kwargs)))
                  + sum(touched_bytes(t) for t in _tensors(out)))
        self.cost.hbm_bytes += nbytes
        by = self.cost.hbm_by_op
        by[func.name()] = by.get(func.name(), 0) + nbytes
        return out


class CostCounter:
    """What :func:`count_cost` yields: the :class:`Cost` so far, and the
    means to name the step's arguments and outputs."""

    def __init__(self, mode: _CostMode):
        self._mode = mode
        self.cost = mode.cost

    def arguments(self, *trees) -> int:
        """Count the storages of ``trees`` (the step's state and batch;
        a DTensor's local block) as live arguments; returns their bytes."""
        storages = self._storages(trees, self._mode.memory_device)
        for t in storages.values():
            self._mode.track(t)
        n = sum(t.untyped_storage().nbytes() for t in storages.values())
        self.cost.argument_bytes += n
        return n

    def outputs(self, *trees) -> int:
        """Record the bytes of the distinct storages of ``trees`` (the
        step's results) as its output bytes."""
        storages = self._storages(trees, self._mode.memory_device)
        self.cost.output_bytes = sum(t.untyped_storage().nbytes() for t in storages.values())
        return self.cost.output_bytes

    @staticmethod
    def _storages(trees, device_type) -> dict:
        """One tensor of each distinct storage of ``trees`` on ``device_type``."""
        out = {}
        for t in _local_tensors(trees):
            if device_type is None or t.device.type == device_type:
                out.setdefault(t.untyped_storage()._cdata, t)
        return out


@contextlib.contextmanager
def count_cost(memory_device: str | None = None):
    """Count the work of the ops run inside: ``with count_cost() as c:
    c.arguments(state, batch); out = step(state, batch)``, then
    ``c.cost.as_dict()`` (``flops``, ``flops_by_dtype``, ``hbm_bytes``,
    ``collectives`` by kind with ``count``, ``bytes``, ``wire_bytes``,
    ``total_wire_bytes``, ``kernel_ops`` and ``memory``).  Only storages on
    ``memory_device`` (a device type; None: every device) count towards
    the memory figures."""
    mode = _CostMode(Cost(), memory_device)
    work._OBSERVERS.append(mode)
    try:
        with mode:
            yield CostCounter(mode)
    finally:
        work._OBSERVERS.remove(mode)


def parse_collectives(cost: Cost) -> dict:
    """The collective summary: by kind, and ``total_wire_bytes``."""
    out = {k: dict(v) for k, v in cost.collectives.items()}
    out["total_wire_bytes"] = cost.total_wire_bytes
    return out


@dataclasses.dataclass
class Roofline:
    flops: float              # per rank, every float dtype
    hbm_bytes: float          # per rank, eager op boundaries
    wire_bytes: float         # per rank
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0  # 6*N_active*D (train) / 2*N_active*D (serve), per rank
    useful_ratio: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, flops, hbm_bytes, wire_bytes, model_flops=0.0):
        """``flops`` by dtype (a dict, int32 operations under ``"int32"``)
        or one number of bf16 tensor-core flops."""
        by = dict(flops) if isinstance(flops, dict) else {"bfloat16": flops}
        total = sum(n for k, n in by.items() if k not in INT_KINDS)
        c = sum(n / RATES[k] for k, n in by.items())
        m = hbm_bytes / HBM_BYTES_PER_S
        n = wire_bytes / NVLINK_BYTES_PER_S
        dom = max((("compute", c), ("memory", m), ("collective", n)), key=lambda kv: kv[1])[0]
        return cls(flops=total, hbm_bytes=hbm_bytes, wire_bytes=wire_bytes, compute_s=c,
                   memory_s=m, collective_s=n, dominant=dom, model_flops=model_flops,
                   useful_ratio=(model_flops / total) if total else 0.0, flops_by_dtype=by)

    @property
    def bound_s(self) -> float:
        """The least time of the step on one card: its larger term of
        compute and memory (the collective term is a separate floor)."""
        return max(self.compute_s, self.memory_s)

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze_cost(cost: Cost, *, model_flops_per_device: float = 0.0) -> Roofline:
    """The :class:`Roofline` of a counted step (``analyze_compiled``)."""
    return Roofline.build(cost.flops_by_dtype, cost.hbm_bytes, cost.total_wire_bytes,
                          model_flops_per_device)


def model_flops(cfg, n_tokens: int, *, train: bool) -> float:
    """6*N_active*D for training, 2*N_active*D for inference (global)."""
    n = cfg.active_param_count()
    return (6.0 if train else 2.0) * n * n_tokens
