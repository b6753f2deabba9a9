"""The Estimator protocol: every similarity-join size estimator -- the
paper's SJPC and its competitors -- behind one streaming interface, ported
from the JAX package's ``estimators/base.py``.

An :class:`Estimator` is the per-hash-group engine of one estimator kind:
it owns the static configuration (d, s, byte budget, seeds) and works on
per-stream **states**, NamedTuples of tensors that stack on a leading
stream axis:

  init(sid)                  a fresh per-stream state
  ingest_rounds(...)         every round of a flush for every stream of a
                             cohort: stacked states (S, ...), records
                             (R, S, B, d), masks (R, S, B), keys (R, S, 2)
  merge / subtract           the window algebra (exact counter arithmetic
                             for linear kinds; weighted union and
                             provenance-tag removal for sample kinds)
  memory_bytes()             the per-stream state footprint, the paper's
                             equal-space axis (Fig. 8)
  estimate_batch(states)     every (stream, threshold) estimate of a stack
  estimate_ref(state)        the per-stream host-numpy oracle

The registry maps kind names ("sjpc", "reservoir", "lsh_ss") to factories
that take the group's ``SJPCConfig``, so every competitor derives its
space budget from the sketch it is compared with.

States live on one device (the CUDA card unless a caller asks for the
CPU).  The JAX package's ``lax.scan`` over rounds is a Python loop
(:func:`scan_rounds`), and its ``vmap`` over streams is a leading stream
axis written out in each kind's update.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.prng import mul_u32

_MASK32 = 0xFFFFFFFF


class EstimateTable(NamedTuple):
    """Estimates for N same-config streams at every threshold k = s..d
    (column i answers k = s + i).  ``stderr_kind`` names the method behind
    the stderr columns: "analytic" (Theorems 1/2), "bootstrap",
    "bootstrap_stratified", or "none" (columns are zero)."""
    x: np.ndarray              # (N, L) per-level k-similar pair estimates
    g: np.ndarray              # (N, L) g_k per threshold
    y: np.ndarray              # (N, L) raw level diagnostics (per kind)
    n: np.ndarray              # (N,) records in each stream
    stderr: np.ndarray         # (N, L) absolute 1-sigma bound (0 = unknown)
    stderr_offline: np.ndarray  # (N, L) sampling-only bound (0 = unknown)
    stderr_kind: str = "none"


class Estimator:
    """Abstract base; subclasses set ``kind``, the capability flags, and
    ``d``, ``s``, ``seed``."""

    kind: str = "abstract"
    linear: bool = False         # exact merge/subtract by state arithmetic
    supports_join: bool = False  # two-stream joins (paper §6)

    @property
    def num_levels(self) -> int:
        return self.d - self.s + 1

    @property
    def thresholds(self) -> range:
        return range(self.s, self.d + 1)

    @property
    def ingest_seed(self) -> int:
        """Seed of the per-(stream, round) ingest key grid
        (``service.ingest.ingest_key_grid``)."""
        return self.seed ^ 0x5E41CE

    def init(self, sid: int = 0):
        raise NotImplementedError

    def ingest_rounds(self, states, values, row_mask, keys):
        """states stacked on a leading S axis; values (R, S, B, d) uint32
        data; row_mask (R, S, B); keys (R, S, 2).  Returns the updated
        stacked states."""
        raise NotImplementedError

    def merge(self, a, b):
        raise NotImplementedError

    def subtract(self, a, b):
        raise NotImplementedError

    def memory_bytes(self) -> int:
        raise NotImplementedError

    def estimate_batch(self, states, *, clamp: bool = True,
                       impl: str | None = None) -> EstimateTable:
        """Stacked states (leading N axis) -> the (N, L) table.  ``impl``
        names the kernel implementation (None: the estimator's own, or
        resolved from the device)."""
        raise NotImplementedError

    def estimate_ref(self, state, *, clamp: bool = True) -> EstimateTable:
        """Single-state host-numpy oracle (an N=1 table); by default the
        batched path on a singleton stack."""
        return self.estimate_batch(stack_states([state]), clamp=clamp)

    def state_n(self, state) -> float:
        return float(state.n.cpu())


# ---------------------------------------------------------------------------
# State stacking
# ---------------------------------------------------------------------------

def stack_states(states):
    """Stack same-shape states along a new leading axis, on their device."""
    first = states[0]
    return type(first)(*(torch.stack(leaves) for leaves in zip(*states)))


def index_state(stacked, i: int):
    """The i-th state of a stack."""
    return type(stacked)(*(leaf[i] for leaf in stacked))


def zeros_like_stack(state, count: int):
    """A (count, ...) stack of zeros shaped like ``state``."""
    return type(state)(*(torch.zeros((count,) + tuple(leaf.shape), dtype=leaf.dtype,
                                     device=leaf.device) for leaf in state))


def scan_rounds(ingest_one: Callable, states, values, row_mask, keys):
    """The (R rounds x S streams) ingest: a loop over the round axis of
    values (R, S, B, d), row_mask (R, S, B) and keys (R, S, 2), where
    ``ingest_one(states, values, mask, keys)`` updates all S streams of
    one round at once."""
    for r in range(values.shape[0]):
        states = ingest_one(states, values[r], row_mask[r], keys[r])
    return states


# ---------------------------------------------------------------------------
# Sample merge: deterministic weighted union of two uniform samples
# ---------------------------------------------------------------------------

def priority_merge_keys(items, tags, weight, salt: int):
    """Selection keys for merging uniform samples (A-ES weighted draw).

    items (..., M, c) uint32 data as int64; tags (..., M) int32 (-1 marks
    an empty slot); weight (...) float32, the population each item stands
    for.  The key is log(u) / weight, u a hash of (slot index, item, tag,
    salt) in (0, 1] -- not a PRNG draw, so the merge is deterministic and
    symmetric.  The hash is the JAX package's uint32 arithmetic, carried in
    int64 with 32-bit masks; the log and the division are float32.  Empty
    slots get -inf.
    """
    M = items.shape[-2]
    slot = torch.arange(M, dtype=torch.int64, device=items.device)
    h = torch.bitwise_and(torch.bitwise_xor(torch.bitwise_and(tags.to(torch.int64), _MASK32),
                                            salt & _MASK32)
                          + mul_u32(slot, 0x9E3779B9), _MASK32)
    for c in range(items.shape[-1]):
        h = torch.bitwise_xor(mul_u32(h, 0x9E3779B1), items[..., c].to(torch.int64))
    h = mul_u32(h, 0x85EBCA77)
    h = torch.bitwise_xor(h, h >> 15)
    u = (h.to(torch.float32) + 1.0) / 4294967296.0                  # (0, 1]
    weight = torch.as_tensor(weight, dtype=torch.float32, device=items.device)
    key = torch.log(u) / torch.clamp_min(weight, 1e-9)[..., None]
    return torch.where(tags >= 0, key, torch.full_like(key, -torch.inf))


def merge_tagged_samples(items_a, tags_a, n_a, items_b, tags_b, n_b, capacity: int,
                         salt: int):
    """Merge two tagged fixed-capacity uniform samples into ``capacity``
    slots: pool both and keep the ``capacity`` largest priority keys
    (:func:`priority_merge_keys`, each side weighted by n / m).  Leading
    dims are streams.  Returns (items, tags), empty slots tagged -1, short
    pools padded with empty slots.

    ``jax.lax.top_k`` puts the lower index first among equal keys (the -inf
    of empty slots included); a stable descending sort does the same here.
    """
    m_a = (tags_a >= 0).sum(dim=-1).to(torch.float32)
    m_b = (tags_b >= 0).sum(dim=-1).to(torch.float32)
    w_a = torch.as_tensor(n_a).to(torch.float32) / torch.clamp_min(m_a, 1.0)
    w_b = torch.as_tensor(n_b).to(torch.float32) / torch.clamp_min(m_b, 1.0)
    items = torch.cat([items_a, items_b], dim=-2)
    tags = torch.cat([tags_a, tags_b], dim=-1)
    keys = torch.cat([priority_merge_keys(items_a, tags_a, w_a, salt),
                      priority_merge_keys(items_b, tags_b, w_b, salt)], dim=-1)
    k = min(capacity, items.shape[-2])
    top = torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]
    sel_tags = torch.gather(tags, -1, top)
    out_tags = torch.where(sel_tags >= 0, sel_tags, torch.full_like(sel_tags, -1))
    out_items = torch.gather(items, -2, top[..., None].expand(top.shape + items.shape[-1:]))
    if k < capacity:
        pad = capacity - k
        out_items = torch.cat([out_items, out_items.new_zeros(
            out_items.shape[:-2] + (pad, out_items.shape[-1]))], dim=-2)
        out_tags = torch.cat([out_tags, out_tags.new_full(out_tags.shape[:-1] + (pad,), -1)],
                             dim=-1)
    return out_items, out_tags


# ---------------------------------------------------------------------------
# Spec registry: one declarative record per estimator kind
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    """What every layer needs to know about an estimator kind.

    Capability fields left ``None`` resolve from the instance attribute
    (``est.linear`` / ``est.supports_join``); :func:`spec_of` performs that
    resolution.

      factory(sjpc_cfg, *, params=None, estimator_cfg=None, opts=None,
              device=None) -> Estimator
      fusion(est) -> hashable        the planner's fusion-signature config part
      exact_oracle(query_kind, records) -> (s -> float)  exact g replay
    """
    kind: str
    factory: Callable | None = None
    state_cls: type | None = None
    linear: bool | None = None
    join_capable: bool | None = None
    stderr_kind: str | None = None
    fusion: Callable | None = None
    exact_oracle: Callable | None = None
    registrant: str = "?"

    @property
    def wire_mode(self) -> str:
        """The delta mode this kind exports: linear kinds ship per-epoch
        counter increments (``"merge"``), sample kinds replace their open
        slot (``"replace"``)."""
        return "merge" if self.linear else "replace"


_REGISTRY: dict[str, EstimatorSpec] = {}


def _callable_id(fn):
    """A callable's identity across module re-import: (module, qualname).
    The same source definition executed again (``importlib.reload``)
    makes a new function object with the same identity."""
    if fn is None:
        return None
    return (getattr(fn, "__module__", None), getattr(fn, "__qualname__", repr(fn)))


def _cls_id(cls):
    """A state class's identity: (module, qualname, NamedTuple fields)."""
    if cls is None:
        return None
    return (getattr(cls, "__module__", None), getattr(cls, "__qualname__", cls.__name__),
            tuple(getattr(cls, "_fields", ())))


def _spec_signature(sp: EstimatorSpec):
    """The comparison key of a re-registration: equal signatures are a
    no-op, anything else merges or conflicts."""
    return (sp.kind, _callable_id(sp.factory), _cls_id(sp.state_cls), sp.linear,
            sp.join_capable, sp.stderr_kind, _callable_id(sp.fusion),
            _callable_id(sp.exact_oracle))


def register_spec(spec: EstimatorSpec) -> EstimatorSpec:
    """Register (or register again) a kind's spec.

    The same definitions again (a module imported twice or reloaded) are a
    no-op that adopts the newcomer's objects, so that decoding by kind
    hands back the class live states carry.  A spec may complete a partial
    one: a state-class-only spec (the wire codec's channel) merges with a
    factory registration of the same kind, in either order.  A
    conflicting registration raises, naming both registrants.
    """
    prev = _REGISTRY.get(spec.kind)
    if prev is None or _spec_signature(prev) == _spec_signature(spec):
        _REGISTRY[spec.kind] = spec
        return spec
    merged = _merge_specs(prev, spec)
    if merged is None:
        raise ValueError(f"estimator kind {spec.kind!r} already registered by {prev.registrant} "
                         f"with a conflicting spec; refused re-registration from "
                         f"{spec.registrant}")
    _REGISTRY[spec.kind] = merged
    return merged


def _merge_specs(prev: EstimatorSpec, new: EstimatorSpec):
    """``prev`` with its ``None`` fields filled from ``new``; ``None`` if a
    field set on both sides disagrees."""
    updates = {}
    for f in ("factory", "state_cls", "linear", "join_capable", "stderr_kind", "fusion",
              "exact_oracle"):
        a, b = getattr(prev, f), getattr(new, f)
        if a is None and b is not None:
            updates[f] = b
        elif a is not None and b is not None:
            ident = _cls_id if f == "state_cls" else (
                _callable_id if callable(a) else (lambda x: x))
            if ident(a) != ident(b):
                return None
    return dataclasses.replace(prev, **updates) if updates else prev


def register(kind: str, factory: Callable, *, state_cls: type | None = None,
             linear: bool | None = None, join_capable: bool | None = None,
             stderr_kind: str | None = None, fusion: Callable | None = None,
             exact_oracle: Callable | None = None) -> EstimatorSpec:
    """Register an estimator kind through :func:`register_spec`.  The same
    definitions again are a no-op; a conflicting registration raises,
    naming both registrants."""
    return register_spec(EstimatorSpec(
        kind=kind, factory=factory, state_cls=state_cls, linear=linear,
        join_capable=join_capable, stderr_kind=stderr_kind, fusion=fusion,
        exact_oracle=exact_oracle, registrant=getattr(factory, "__module__", "?")))


def register_state_type(kind: str, cls: type) -> None:
    """Register the state NamedTuple class of ``kind`` (the wire codec's
    decode channel), merged into the kind's spec: the same class again is
    a no-op, another class raises, naming both registrants."""
    prev = _REGISTRY.get(kind)
    if prev is not None and prev.state_cls is not None \
            and _cls_id(prev.state_cls) != _cls_id(cls):
        raise ValueError(f"state type for kind {kind!r} already registered as "
                         f"{prev.state_cls.__name__} (by {prev.registrant}), not "
                         f"{cls.__name__} (from {getattr(cls, '__module__', '?')})")
    register_spec(EstimatorSpec(kind=kind, state_cls=cls,
                                registrant=getattr(cls, "__module__", "?")))


def state_type(kind: str) -> type:
    """The registered state NamedTuple class of ``kind`` (KeyError if
    none is registered)."""
    sp = _REGISTRY.get(kind)
    if sp is None or sp.state_cls is None:
        raise KeyError(f"no state type registered for estimator kind {kind!r}; "
                       f"register_state_type() it (a plugin: import its module on the "
                       f"decoding side too)")
    return sp.state_cls


def spec(kind: str) -> EstimatorSpec:
    """The registered spec of ``kind`` (KeyError if unknown)."""
    if kind not in _REGISTRY:
        raise KeyError(f"unknown estimator kind {kind!r}; available: {available()}")
    return _REGISTRY[kind]


def spec_of(est: Estimator) -> EstimatorSpec:
    """The resolved spec of an estimator instance: registered fields win,
    ``None`` capability fields fall back to the instance's attributes.  An
    instance of an unregistered kind gets a spec made from the instance
    alone."""
    kind = getattr(est, "kind", "abstract")
    sp = _REGISTRY.get(kind)
    if sp is None:
        sp = EstimatorSpec(kind=kind, registrant=type(est).__module__)
    updates = {}
    if sp.linear is None:
        updates["linear"] = bool(getattr(est, "linear", False))
    if sp.join_capable is None:
        updates["join_capable"] = bool(getattr(est, "supports_join", False))
    return dataclasses.replace(sp, **updates) if updates else sp


def available() -> list[str]:
    """The kinds that can be made (a state-type-only registration, the
    wire's decode channel without a factory, is left out)."""
    return sorted(k for k, sp in _REGISTRY.items() if sp.factory is not None)


def make(kind: str, sjpc_cfg, *, params=None, estimator_cfg=None, opts=None,
         device=None) -> Estimator:
    """An estimator of ``kind`` for a hash group.

    ``sjpc_cfg`` is the group's ``SJPCConfig``: it fixes (d, s, seed) for
    every kind and the byte budget the competitors match.  ``params`` is
    the group's shared hash randomness (SJPC only); ``estimator_cfg``
    overrides the derived per-kind config; ``opts`` carries construction
    keywords (``impl``, ``use_fused``, bootstrap sizes).  States live on
    ``device`` (default: the CUDA card).
    """
    sp = _REGISTRY.get(kind)
    if sp is None or sp.factory is None:
        raise KeyError(f"unknown estimator kind {kind!r}; available: {available()}")
    return sp.factory(sjpc_cfg, params=params, estimator_cfg=estimator_cfg, opts=opts,
                      device=device)


def load_plugins(modules=None) -> list[str]:
    """Import plugin modules for their registration side effect.

    ``modules`` is an iterable of module names; by default the
    ``REPRO_PLUGINS`` environment variable (comma-separated), so that a
    service picks up plugin kinds without code changes.  The names are the
    port's plugin modules (``examples.plugins_torch``).  Importing a module
    already imported is a no-op, and so is registering an identical spec
    again, so this is safe to call repeatedly.  Returns the names loaded.
    """
    import importlib
    import os
    if modules is None:
        raw = os.environ.get("REPRO_PLUGINS", "")
        modules = [m for m in (p.strip() for p in raw.split(",")) if m]
    loaded = []
    for name in modules:
        importlib.import_module(name)
        loaded.append(name)
    return loaded


def pairwise_exact_oracle(query_kind: str, records):
    """The exact g replay shared by the kinds that estimate the paper's
    pairwise-similarity counts: given the record batches of a query's
    streams (one (n, d) array for a self-join, two for a join), return
    ``g(s)``, the exact number of pairs at threshold ``s``."""
    from ..core import exact
    if query_kind == "join":
        a, b = records
        counts = np.asarray(exact.brute_force_join_counts(a, b))
        return lambda s: float(counts[s:].sum())
    recs = records[0]
    x = np.asarray(exact.exact_pair_counts(recs))
    n = recs.shape[0]
    return lambda s: float(x[s:].sum() + n)
