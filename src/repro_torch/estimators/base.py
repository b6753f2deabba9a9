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

      factory(sjpc_cfg, *, params=None, estimator_cfg=None, opts=None,
              device=None) -> Estimator
      exact_oracle(query_kind, records) -> (s -> float)  exact g replay
    """
    kind: str
    factory: Callable
    state_cls: type | None = None
    linear: bool | None = None
    join_capable: bool | None = None
    stderr_kind: str | None = None
    exact_oracle: Callable | None = None
    registrant: str = "?"


_REGISTRY: dict[str, EstimatorSpec] = {}


def _identity(fn):
    """A callable's identity across module re-import: (module, qualname)."""
    if fn is None:
        return None
    return (getattr(fn, "__module__", None), getattr(fn, "__qualname__", repr(fn)))


def _signature(sp: EstimatorSpec):
    return (sp.kind, _identity(sp.factory), _identity(sp.state_cls), sp.linear,
            sp.join_capable, sp.stderr_kind, _identity(sp.exact_oracle))


def register(kind: str, factory: Callable, *, state_cls: type | None = None,
             linear: bool | None = None, join_capable: bool | None = None,
             stderr_kind: str | None = None,
             exact_oracle: Callable | None = None) -> EstimatorSpec:
    """Register an estimator kind.  Registering the same definitions again
    (a module imported twice or reloaded) is a no-op; a conflicting
    registration raises, naming both registrants."""
    new = EstimatorSpec(kind=kind, factory=factory, state_cls=state_cls, linear=linear,
                        join_capable=join_capable, stderr_kind=stderr_kind,
                        exact_oracle=exact_oracle,
                        registrant=getattr(factory, "__module__", "?"))
    prev = _REGISTRY.get(kind)
    if prev is not None and _signature(prev) != _signature(new):
        raise ValueError(f"estimator kind {kind!r} already registered by {prev.registrant} "
                         f"with a conflicting spec; refused re-registration from "
                         f"{new.registrant}")
    _REGISTRY[kind] = new
    return new


def spec(kind: str) -> EstimatorSpec:
    """The registered spec of ``kind`` (KeyError if unknown)."""
    if kind not in _REGISTRY:
        raise KeyError(f"unknown estimator kind {kind!r}; available: {available()}")
    return _REGISTRY[kind]


def available() -> list[str]:
    """The registered kinds."""
    return sorted(_REGISTRY)


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
    return spec(kind).factory(sjpc_cfg, params=params, estimator_cfg=estimator_cfg,
                              opts=opts, device=device)


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
