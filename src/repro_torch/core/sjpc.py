"""SJPC -- Similarity Self-Join Pair Count (the paper's Algorithm 1).

One-pass, sublinear-space estimation of g_s = #{record pairs at least
s-similar} for a stream of d-column records:

  Step 1  per record, per level k in [s, d]: sample ~r*C(d,k) column
          combinations, fingerprint each projected sub-value, insert into
          the level's Fast-AGMS sketch.
  Step 2  Y_k = sketch F2 estimate of the level-k sub-value stream.
  Step 3  invert the lattice system (Eq. 4):
              X_k = (Y_k - r*C(d,k)*n) / r^2  -  sum_{j>k} C(j,k) X_j
          and return sum_k X_k (+ n for self-pairs -> g_s).

The state is int32 counters (levels, t, w): linear, so sketches of
disjoint sub-streams merge by addition.  The similarity *join* estimator
(paper §6, Eq. 7) works on two streams sketched with the same hash
parameters; Y_k is then the sketch inner product and the inversion drops
the self-pair term.

On CUDA, both update functions draw their sampling weights with the
``sample_weights`` kernel; :func:`update_fused` runs the ``fused_ingest``
kernel, the per-level :func:`update` the ``fingerprint`` kernel (and,
through its ``update_fn`` hook, the ``sketch_update`` kernel), and the
batched queries the ``fused_query`` kernel; on the CPU the same functions
run the kernels' plain versions.  Under the default keys the counters
equal the JAX package's bit for bit: the parameters come from the same
numpy draws and the sampling replays ``jax.random`` (:mod:`.prng`).

:func:`update_fused`, :func:`estimate_batch` and :func:`estimate_join_batch`
open spans of :func:`~repro_torch.obs.trace.path_tracer`, live only while a
``torch.profiler`` records or an operator switches it on:
``sjpc.update_fused`` (attribute ``rows``) with the stages ``prepare``,
``draws`` and ``ingest``; each estimate with ``wait``, ``query``,
``to_host``, ``recursion`` and ``bounds``.  ``wait`` blocks, while live,
on the counters' stream, which the estimate's one copy to the host would
block on anyway: the time the estimate waits for the card's queued work
is then apart from the host's own.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import platform
from ..kernels import ops
from ..obs.trace import NULL_SPAN, path_tracer
from . import prng
from . import projections as proj
from . import sketch as sk
from .fingerprint import make_fingerprint_bases
from .hashing import as_field_tensor
from .sketch import median_depth, np_median_depth


@dataclasses.dataclass(frozen=True)
class SJPCConfig:
    """Static configuration (hashable)."""
    d: int                  # record dimensionality (number of columns)
    s: int                  # similarity threshold (count of equal columns)
    ratio: float = 0.5      # projection sampling ratio r
    width: int = 1024       # sketch width w (counters per row, pow2)
    depth: int = 3          # sketch depth t (median of t estimates)
    seed: int = 0x5A5A

    def __post_init__(self):
        assert 1 <= self.s <= self.d, "need 1 <= s <= d"
        assert 0 < self.ratio <= 1.0
        assert self.width & (self.width - 1) == 0

    @property
    def num_levels(self) -> int:
        return self.d - self.s + 1

    def level_k(self, idx: int) -> int:
        return self.s + idx

    @property
    def counters_bytes(self) -> int:
        return self.num_levels * self.depth * self.width * 4


class SJPCParams(NamedTuple):
    """Hash/fingerprint randomness, int64 field elements."""
    bucket_coeffs: torch.Tensor   # (levels, t, 2, 4)
    sign_coeffs: torch.Tensor     # (levels, t, 2, 4)
    fp_bases: torch.Tensor        # (2,)


class SJPCState(NamedTuple):
    """Linear sketch state.  counters: (levels, t, w) int32; n: records seen."""
    counters: torch.Tensor
    n: torch.Tensor               # float32 scalar, as in the JAX package
    step: torch.Tensor            # int32 scalar: rounds that carried data


def init(cfg: SJPCConfig, device=None) -> tuple[SJPCParams, SJPCState]:
    """Parameters from ``np.random.default_rng(cfg.seed)`` (the JAX
    package's draws, in its order) and an empty state, on ``device``
    (default: the CUDA card)."""
    device = platform.resolve(device)
    rng = np.random.default_rng(cfg.seed)
    params = sk.make_sketch_params(rng, cfg.depth, stack=(cfg.num_levels,), device=device)
    fp_bases = torch.from_numpy(make_fingerprint_bases(rng).astype(np.int64)).to(device)
    state = SJPCState(
        counters=sk.empty_counters(cfg.depth, cfg.width, stack=(cfg.num_levels,),
                                   device=device),
        n=torch.zeros((), dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )
    return SJPCParams(params.bucket_coeffs, params.sign_coeffs, fp_bases), state


def default_key(cfg: SJPCConfig, step) -> torch.Tensor:
    """The sampling key of round ``step``:
    ``fold_in(PRNGKey(seed ^ 0xC0FFEE), step)``.  The update functions
    derive it where the draws run, from ``state.step`` (see
    ``kernels.ops.sample_weights``); this host version is for callers that
    want the key itself."""
    return prng.fold_in(prng.PRNGKey(cfg.seed ^ 0xC0FFEE), int(step))


@functools.lru_cache(maxsize=None)
def _lattice_tensors(d: int, s: int, device: torch.device):
    """Per-level (masks, ids) and the padded (masks, ids), int64 on device."""
    levels = [(torch.from_numpy(lv.masks.astype(np.int64)).to(device),
               torch.from_numpy(lv.ids.astype(np.int64)).to(device))
              for lv in proj.lattice(d, s)]
    pad = proj.padded_lattice(d, s)
    padded = (torch.from_numpy(pad.masks.astype(np.int64)).to(device),
              torch.from_numpy(pad.ids.astype(np.int64)).to(device))
    return levels, padded


@functools.lru_cache(maxsize=None)
def _base_key(seed: int, device: torch.device) -> torch.Tensor:
    """``PRNGKey(seed ^ 0xC0FFEE)`` on ``device``, uploaded once."""
    return prng.PRNGKey(seed ^ 0xC0FFEE).to(device)


def _prepare(cfg: SJPCConfig, state: SJPCState, values, key, row_mask):
    """(values, B, key, step, row_mask) of one round on the counters'
    device.  Without a ``key``, the round's key is the base key folded with
    ``state.step`` where the draws run (``step`` is then that tensor), so
    nothing is read back to the host."""
    device = state.counters.device
    values = as_field_tensor(values, device)
    B = values.shape[0]
    step = None
    if key is None:
        key, step = _base_key(cfg.seed, device), state.step
    elif not (isinstance(key, torch.Tensor) and key.dtype == torch.int64
              and key.device == device):
        key = as_field_tensor(key, device)
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask).to(device=device, dtype=torch.int32).reshape(B)
    return values, B, key, step, row_mask


def advance(state: SJPCState, counters: torch.Tensor, B: int,
            row_mask: torch.Tensor | None) -> SJPCState:
    """The state after a round of ``B`` rows (``row_mask`` marks the valid
    ones) that produced ``counters``."""
    # step counts rounds that CARRIED data: a fully masked round is a
    # content no-op and consumes no randomness, so it must not advance the
    # replay coordinate either
    if row_mask is None:
        return SJPCState(counters=counters, n=state.n + float(B), step=state.step + 1)
    n_new = row_mask.sum().to(torch.float32)
    step_inc = (n_new > 0).to(torch.int32)
    return SJPCState(counters=counters, n=state.n + n_new, step=state.step + step_inc)


def update(cfg: SJPCConfig, params: SJPCParams, state: SJPCState, values,
           key: torch.Tensor | None = None, *, update_fn=None,
           row_mask=None, impl: str | None = None) -> SJPCState:
    """Absorb a batch of records level by level.  values: (B, d) uint32
    data (numpy or tensor).

    ``key`` is key data ((2,) int64, as ``jax.random.key_data`` gives it);
    by default it is :func:`default_key` of ``state.step``.  ``row_mask``
    ((B,), optional) marks valid rows; rows with mask 0 contribute nothing
    to the counters or to ``n``.  The weights come from the
    ``sample_weights`` op and the fingerprints of each level from
    ``kernels.ops.fingerprint`` (``impl`` names the implementation of both;
    None resolves from the device).  ``update_fn(counters, fp1, fp2,
    level_params, weights) -> counters`` does the scatter: by default the
    plain ``sketch.sketch_update``, as in the JAX package;
    ``kernels.ops.make_sjpc_update_fn()`` runs the ``sketch_update`` op.
    """
    values, B, key, step, row_mask = _prepare(cfg, state, values, key, row_mask)
    device = state.counters.device
    update_fn = update_fn or sk.sketch_update
    levels, _ = _lattice_tensors(cfg.d, cfg.s, device)
    weights = ops.sample_weights(key, B, cfg.d, cfg.s, cfg.ratio, step=step, row_mask=row_mask,
                                 impl=impl)
    new_counters = []
    for idx, (masks, ids) in enumerate(levels):
        fp1, fp2 = ops.fingerprint(values, masks, ids, params.fp_bases, impl=impl)
        level_params = sk.SketchParams(params.bucket_coeffs[idx], params.sign_coeffs[idx])
        new_counters.append(update_fn(state.counters[idx], fp1, fp2, level_params,
                                      weights[:, idx, :ids.shape[0]]))
    return advance(state, torch.stack(new_counters), B, row_mask)


def fused_ingest_args(cfg: SJPCConfig, params: SJPCParams, state: SJPCState, values,
                      key: torch.Tensor | None = None, row_mask=None,
                      impl: str | None = None, *, span=NULL_SPAN):
    """The ``fused_ingest`` arguments of one round over the padded lattice,
    with the batch size and the row mask: ``(args, B, row_mask)``.  The
    weights come from the ``sample_weights`` op (``impl`` names its
    implementation).  ``span`` is the caller's path span, whose ``prepare``
    and ``draws`` stages run here."""
    span.stage("prepare")
    values, B, key, step, row_mask = _prepare(cfg, state, values, key, row_mask)
    _, (masks, ids) = _lattice_tensors(cfg.d, cfg.s, state.counters.device)
    span.set(rows=B)
    span.stage("draws")
    wpad = ops.sample_weights(key, B, cfg.d, cfg.s, cfg.ratio, step=step, row_mask=row_mask,
                              impl=impl)
    args = (state.counters, values, masks, ids, params.fp_bases, params.bucket_coeffs,
            params.sign_coeffs, wpad)
    return args, B, row_mask


def update_fused(cfg: SJPCConfig, params: SJPCParams, state: SJPCState, values,
                 key: torch.Tensor | None = None, *,
                 row_mask=None, impl: str | None = None) -> SJPCState:
    """:func:`update` as one fused ingest launch over the padded lattice;
    bit-identical counters under the same key.  ``impl`` names the
    implementation of the ``sample_weights`` and ``fused_ingest`` ops (None
    resolves from the device).  With the default key and the records on
    the card, nothing is read back to the host."""
    with path_tracer().span("sjpc.update_fused") as span:
        args, B, row_mask = fused_ingest_args(cfg, params, state, values, key, row_mask, impl,
                                              span=span)
        span.stage("ingest")
        return advance(state, ops.fused_ingest(*args, impl=impl), B, row_mask)


def merge(a: SJPCState, b: SJPCState) -> SJPCState:
    """Linearity: sketches of disjoint sub-streams add.  ``step`` is the
    sum, so post-merge updates never replay a key either side folded in."""
    return SJPCState(a.counters + b.counters, a.n + b.n, a.step + b.step)


def subtract(a: SJPCState, b: SJPCState) -> SJPCState:
    """Remove the sub-stream ``b`` sketched into ``a``.  ``step`` keeps
    ``a.step``: expiry removes data, not PRNG history."""
    return SJPCState(a.counters - b.counters, a.n - b.n, a.step)


def all_reduce(state: SJPCState, group=None) -> SJPCState:
    """Merge the ranks' sketches: ``counters`` and ``n`` summed over the
    ``torch.distributed`` process ``group`` (None: the default group),
    ``step`` kept, as the JAX package's ``psum`` over mesh axes.  Returns
    new tensors; the input state is left as it was."""
    counters, n = state.counters.clone(), state.n.clone()
    dist.all_reduce(counters, group=group)
    dist.all_reduce(n, group=group)
    return SJPCState(counters, n, state.step)


_SHARD_SALT = 0x5A4D


class ShardedIngest:
    """Sharded ingest with deferred merges.

    Sketches are linear, so each record micro-batch is split across
    ``num_shards`` shards, every shard folds its slice into a shard-local
    *delta* sketch, and nothing crosses shards on the ingest path.
    ``merged()`` pays the one cross-shard reduction for however many
    micro-batches were absorbed.

    Without a ``group`` the deltas are stacked (num_shards, L, t, w) on
    ``device`` (None: the CUDA card) and each shard's update is one
    :func:`update_fused` (or :func:`update`) call with its shard key: the
    JAX package's ``vmap`` over the shard axis.  With a process ``group``
    of ``num_shards`` ranks (``mapped``), every rank receives the whole
    micro-batch and updates only its own shard's (1, L, t, w) delta, on its
    own ``device``; ``merged()`` then runs :func:`all_reduce` over the
    group.  Per-shard keys are ``fold_in(fold_in(PRNGKey(seed ^ 0x5A4D),
    micro_batch), shard)``, so replaying a shard's slices with
    :meth:`shard_key` through :func:`update` rebuilds it bit for bit.
    ``impl`` names the kernel implementation (None: by device).
    """

    def __init__(self, cfg: SJPCConfig, params: SJPCParams, state: SJPCState | None = None, *,
                 num_shards: int | None = None, use_fused: bool = True,
                 impl: str | None = None, group=None, device=None):
        if num_shards is None:
            num_shards = dist.get_world_size(group) if group is not None else 1
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be at least 1, got {num_shards}")
        if group is not None and dist.get_world_size(group) != self.num_shards:
            raise ValueError(f"a group of {dist.get_world_size(group)} ranks cannot hold "
                             f"{self.num_shards} shards")
        self.device = platform.resolve(device)
        self.cfg, self.params = cfg, params
        self.base = state if state is not None else init(cfg, device=self.device)[1]
        self.use_fused = use_fused
        self.impl = impl
        self.group = group
        self.micro_batches = 0
        self.merges = 0
        self.deltas = self._zero_deltas()

    @property
    def mapped(self) -> bool:
        """True when each shard is a rank of a process group (False: the
        shards are stacked on one device, with identical numbers)."""
        return self.group is not None

    def _own_shards(self) -> range:
        """The shards this process updates: its rank's, or all of them."""
        if self.mapped:
            rank = dist.get_rank(self.group)
            return range(rank, rank + 1)
        return range(self.num_shards)

    def _zero_deltas(self) -> SJPCState:
        k = len(self._own_shards())
        return SJPCState(
            counters=torch.zeros((k,) + tuple(self.base.counters.shape), dtype=torch.int32,
                                 device=self.device),
            n=torch.zeros((k,), dtype=torch.float32, device=self.device),
            step=torch.zeros((k,), dtype=torch.int32, device=self.device))

    def reset(self, base: SJPCState | None = None) -> None:
        """Drop the accumulated deltas (and optionally rebase)."""
        if base is not None:
            self.base = base
        self.deltas = self._zero_deltas()
        self.micro_batches = 0

    def ingest(self, values, key: torch.Tensor | None = None, row_mask=None) -> None:
        """Absorb one micro-batch: values (B, d) uint32 data (numpy or
        tensor), split across shards; rows pad to a shard multiple with
        mask 0.  ``key`` (key data) replaces the micro-batch key."""
        values = as_field_tensor(values, self.device)
        B = values.shape[0]
        if key is None:
            key = self._batch_key(self.micro_batches)
        mask = (torch.ones((B,), dtype=torch.int32, device=self.device) if row_mask is None
                else torch.as_tensor(row_mask).to(device=self.device,
                                                  dtype=torch.int32).reshape(B))
        pad = (-B) % self.num_shards
        if pad:
            values = torch.nn.functional.pad(values, (0, 0, 0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        per = values.shape[0] // self.num_shards
        shards = self._own_shards()
        keys = prng.fold_in(key.cpu(), torch.tensor(list(shards))).to(self.device)
        one = update_fused if self.use_fused else update
        d = self.deltas
        out = [one(self.cfg, self.params, SJPCState(d.counters[i], d.n[i], d.step[i]),
                   values[j * per:(j + 1) * per], key=keys[i],
                   row_mask=mask[j * per:(j + 1) * per], impl=self.impl)
               for i, j in enumerate(shards)]
        self.deltas = SJPCState(*(torch.stack(leaf) for leaf in zip(*out)))
        self.micro_batches += 1

    def merged(self) -> SJPCState:
        """The deferred cross-shard reduction: base + the sum of the
        deltas.  ``step`` is summed as :func:`merge` sums it, so later
        updates never replay a shard's keys."""
        self.merges += 1
        d = self.deltas
        delta = SJPCState(d.counters.sum(dim=0, dtype=torch.int32), d.n.sum(),
                          d.step.sum(dtype=torch.int32))
        if self.mapped:
            step = delta.step.clone()
            dist.all_reduce(step, group=self.group)
            delta = all_reduce(delta, self.group)._replace(step=step)
        return merge(self.base, delta)

    def _batch_key(self, micro_batch: int) -> torch.Tensor:
        return prng.fold_in(prng.PRNGKey(self.cfg.seed ^ _SHARD_SALT), micro_batch)

    def shard_key(self, micro_batch: int, shard: int) -> torch.Tensor:
        """The sampling key shard ``shard`` folded in for micro-batch
        ``micro_batch`` (the offline-replay coordinate), as key data."""
        return prng.fold_in(self._batch_key(micro_batch), shard)


# ---------------------------------------------------------------------------
# Step 2+3: estimation (host-side numpy; exact in float64)
# ---------------------------------------------------------------------------

def level_f2(state: SJPCState) -> np.ndarray:
    """Y_k for k = s..d, int64-exact median-of-rows F2."""
    return sk.np_estimate_f2_exact(state.counters.cpu().numpy()).astype(np.float64)


def f2_to_pair_count(d: int, s: int, n: float, r: float, y: Sequence[float],
                     *, clamp: bool = True) -> np.ndarray:
    """Procedure f2toPairCnt of Algorithm 1 (Eq. 4 inversion), with the
    paper's erratum corrected as in the JAX package: the r^2-scaled
    recursion subtracts C(j,k) X_scaled[j].  Returns X[s..d] (ordered
    pairs exactly k-similar)."""
    X = np.zeros(d + 1, dtype=np.float64)     # r^2-scaled accumulators
    for k in range(d, s - 1, -1):
        acc = float(y[k - s]) - math.comb(d, k) * r * n
        for j in range(k + 1, d + 1):
            acc -= math.comb(j, k) * X[j]
        if clamp:
            acc = max(acc, 0.0)
        X[k] = acc
    X = X / (r * r)
    return X[s:]


class SJPCEstimate(NamedTuple):
    x: np.ndarray          # X[s..d]: per-level k-similar pair estimates
    pairs: float           # sum_k X_k (similar pairs, ordered, excl. self)
    g_s: float             # pairs + n (the paper's g_s, Eq. 2)
    y: np.ndarray          # raw level F2 estimates (diagnostics)
    n: float


def estimate(cfg: SJPCConfig, state: SJPCState, *, clamp: bool = True) -> SJPCEstimate:
    y = level_f2(state)
    n = float(state.n)
    x = f2_to_pair_count(cfg.d, cfg.s, n, cfg.ratio, y, clamp=clamp)
    pairs = float(x.sum())
    return SJPCEstimate(x=x, pairs=pairs, g_s=pairs + n, y=y, n=n)


def join_level_inner(state_a: SJPCState, state_b: SJPCState) -> np.ndarray:
    ca = state_a.counters.cpu().numpy()
    cb = state_b.counters.cpu().numpy()
    return sk.np_estimate_inner_exact(ca, cb).astype(np.float64)


def inner_to_join_count(d: int, s: int, r: float, y: Sequence[float],
                        *, clamp: bool = True) -> np.ndarray:
    """Eq. 7: X_k = Y_k / r^2 - sum_{j>k} C(j,k) X_j (no self-pair term)."""
    X = np.zeros(d + 1, dtype=np.float64)
    for k in range(d, s - 1, -1):
        acc = float(y[k - s]) / (r * r)
        for j in range(k + 1, d + 1):
            acc -= math.comb(j, k) * X[j]
        if clamp:
            acc = max(acc, 0.0)
        X[k] = acc
    return X[s:]


def estimate_join(cfg: SJPCConfig, state_a: SJPCState, state_b: SJPCState,
                  *, clamp: bool = True) -> SJPCEstimate:
    """Similarity join size of two streams sketched with identical params."""
    y = join_level_inner(state_a, state_b)
    x = inner_to_join_count(cfg.d, cfg.s, cfg.ratio, y, clamp=clamp)
    pairs = float(x.sum())
    return SJPCEstimate(x=x, pairs=pairs, g_s=pairs, y=y, n=float(state_a.n))


# ---------------------------------------------------------------------------
# Batched estimation: every (stream, threshold) cell at once
# ---------------------------------------------------------------------------

class SJPCBatchEstimate(NamedTuple):
    """Estimates for N same-config sketches at EVERY threshold k = s..d.

    Column i answers threshold k = s + i; ``g[:, i]`` is the suffix sum
    ``x[:, i:].sum(axis=1)`` (+ n for self-joins).
    """
    x: np.ndarray              # (N, L) per-level k-similar pair estimates
    g: np.ndarray              # (N, L) g_k per threshold (join: join size)
    y: np.ndarray              # (N, L) raw level F2 / inner estimates
    n: np.ndarray              # (N,) records; joins: (N, 2) per side
    stderr: np.ndarray         # (N, L) absolute 1-sigma bound (Theorem 2)
    stderr_offline: np.ndarray  # (N, L) sampling-only bound (Theorem 1)


def estimate_from_moments(cfg: SJPCConfig, moments, n, *, clamp: bool, join: bool):
    """(N, L, t) float32 row moments and (N,) records -> (y, x, g), each
    (N, L) float32, on the host: the median over depth, then the Eq. 4
    (self) or Eq. 7 (join) recursion in float32 in the JAX package's op
    order, one IEEE operation at a time with each constant rounded once to
    float32, then suffix sums.  The suffix sums accumulate in float64 from
    +0.0 and round each entry to float32, as torch's CPU ``cumsum`` does.
    Tensors are read back to the host, once each."""
    d, s, r = cfg.d, cfg.s, cfg.ratio
    f32 = np.float32
    y = np_median_depth(_host_f32(moments))
    n = _host_f32(n)
    X: dict[int, np.ndarray] = {}
    for k in range(d, s - 1, -1):
        if join:
            acc = y[:, k - s] / f32(r * r)
        else:
            acc = y[:, k - s] - f32(math.comb(d, k) * r) * n
        for j in range(k + 1, d + 1):
            acc = acc - f32(math.comb(j, k)) * X[j]
        if clamp:
            # torch.clamp_min's semantics: NaN and -0.0 pass unchanged
            acc = np.where(acc < 0, f32(0), acc)
        X[k] = acc
    x = np.stack([X[k] for k in range(s, d + 1)], axis=1)
    if not join:
        x = x / f32(r * r)
    g = (0.0 + np.cumsum(x[:, ::-1], axis=1, dtype=np.float64))[:, ::-1].astype(np.float32)
    if not join:
        g = g + n[:, None]
    return y, x, g


def _batch_bounds(cfg: SJPCConfig, n: np.ndarray,
                  g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized Theorem 1/2 plug-in bounds, float64, the same op order as
    the scalar bounds.  n (N,), g (N, L) -> (online, offline) (N, L)."""
    d, r, w = cfg.d, cfg.ratio, cfg.width
    lead = np.array([math.comb(d, k) ** 2 / r * math.comb(2 * (d - k), d - k)
                     for k in range(cfg.s, d + 1)], dtype=np.float64)
    g = np.asarray(g, np.float64)
    n = np.asarray(n, np.float64).reshape(-1, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        off = np.sqrt(lead[None, :] / g) * g
        on = np.sqrt(lead[None, :] * ((1 + 2 / w) / g
                                      + (2 / w) * (1 + n / (r * g)) ** 2)) * g
    pos = g > 0
    return np.where(pos, on, 0.0), np.where(pos, off, 0.0)


def _stack_counters(counters, device) -> torch.Tensor:
    if not isinstance(counters, torch.Tensor):
        counters = torch.as_tensor(np.asarray(counters), device=platform.resolve(device))
    if counters.ndim != 4:
        raise ValueError(f"expected stacked (N, levels, t, w) counters; "
                         f"got {tuple(counters.shape)}")
    return counters


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _read_back(moments: torch.Tensor, *ns) -> list[np.ndarray]:
    """``moments`` (N, L, t) and each records count of ``ns`` (N values) as
    float32 host arrays, in one device-to-host copy: counts on a device
    travel packed beside the moments, counts on the host stay there."""
    N = moments.shape[0]
    on_device = [isinstance(v, torch.Tensor) and v.device.type != "cpu" for v in ns]
    parts = [moments.flatten(1)] + [v.to(moments.device, torch.float32).reshape(N, 1)
                                    for v, dev in zip(ns, on_device) if dev]
    packed = _host_f32(torch.cat(parts, dim=1) if len(parts) > 1 else parts[0])
    width = packed.shape[1] - sum(on_device)
    columns = iter(packed[:, width:].T)
    return [packed[:, :width].reshape(moments.shape)] + [
        next(columns) if dev else _host_f32(v).reshape(N) for v, dev in zip(ns, on_device)]


def estimate_batch(cfg: SJPCConfig, counters, n, *, clamp: bool = True,
                   device=None, impl: str | None = None) -> SJPCBatchEstimate:
    """Self-join estimates for N stacked sketches, all thresholds at once.

    counters: (N, levels, t, w) int32 (stacked ``SJPCState.counters`` of
    streams sharing one params draw); n: (N,) records per stream, on the
    host or a device.  Tensor counters stay on their device; numpy counters
    go to ``device`` (default: the CUDA card).  ``impl`` names the
    ``fused_query`` implementation (None resolves from the device).  The
    card runs the query alone; one copy brings its moments (and a device
    ``n``) to the host, where :func:`estimate_from_moments` runs.
    """
    with path_tracer().span("sjpc.estimate_batch") as span:
        counters = _stack_counters(counters, device)
        span.stage("wait")
        span.wait(counters)
        span.stage("query")
        moments = ops.fused_query(counters, impl=impl)
        span.stage("to_host")
        moments, n = _read_back(moments, n)
        span.stage("recursion")
        y, x, g = estimate_from_moments(cfg, moments, n, clamp=clamp, join=False)
        span.stage("bounds")
        y, x, g, n = (a.astype(np.float64) for a in (y, x, g, n))
        on, off = _batch_bounds(cfg, n, g)
    return SJPCBatchEstimate(x=x, g=g, y=y, n=n, stderr=on, stderr_offline=off)


def estimate_join_batch(cfg: SJPCConfig, counters_a, counters_b, n_a, n_b, *,
                        clamp: bool = True, device=None,
                        impl: str | None = None) -> SJPCBatchEstimate:
    """Join sizes for N stacked sketch PAIRS (identical hash params per
    pair), all thresholds at once, read back as :func:`estimate_batch`
    reads.  Error bars: the self-join bound at n = max(n_a, n_b) with
    max(estimate, 1) plugged in."""
    with path_tracer().span("sjpc.estimate_join_batch") as span:
        counters_a = _stack_counters(counters_a, device)
        counters_b = _stack_counters(counters_b, counters_a.device)
        span.stage("wait")
        span.wait(counters_a, counters_b)
        span.stage("query")
        moments = ops.fused_query(counters_a, counters_b, impl=impl)
        span.stage("to_host")
        moments, n_a, n_b = _read_back(moments, n_a, n_b)
        span.stage("recursion")
        y, x, g = estimate_from_moments(cfg, moments, n_a, clamp=clamp, join=True)
        span.stage("bounds")
        y, x, g, n_a, n_b = (a.astype(np.float64) for a in (y, x, g, n_a, n_b))
        on, off = _batch_bounds(cfg, np.maximum(n_a, n_b), np.maximum(g, 1.0))
    return SJPCBatchEstimate(x=x, g=g, y=y, n=np.stack([n_a, n_b], axis=1),
                             stderr=on, stderr_offline=off)


# ---------------------------------------------------------------------------
# Analytical bounds (Theorems 1-2)
# ---------------------------------------------------------------------------

def offline_variance_bound(d: int, s: int, r: float, g_s: float) -> float:
    """Theorem 1: var(G_s / g_s) <= C(d,s)^2 (1/r) C(2(d-s), d-s) / g_s."""
    return math.comb(d, s) ** 2 / r * math.comb(2 * (d - s), d - s) / g_s


def online_variance_bound(d: int, s: int, r: float, w: int, n: float, g_s: float) -> float:
    """Theorem 2 (depth-1 sketch)."""
    lead = math.comb(d, s) ** 2 / r * math.comb(2 * (d - s), d - s)
    return lead * ((1 + 2 / w) / g_s + (2 / w) * (1 + n / (r * g_s)) ** 2)
