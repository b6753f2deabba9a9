"""The projection lattice and per-record combination sampling (paper §3.2).

Level k of the lattice is the set of C(d, k) column combinations.  Each
record emits, per level, a uniform random subset of its combinations of
expected size r * C(d, k) (Algorithm 1 lines 8-12): the non-integer sample
size is rounded stochastically and the selection is uniform without
replacement, by ranking i.i.d. uniforms -- the top-l_i ranks form a uniform
random l_i-subset.  The result is a dense (batch, M) {0,1} weight matrix.

The lattice tables are numpy (copied from the JAX package); the sampling
replays ``jax.random`` (:mod:`.prng`) so the weights equal the reference's
under the same key.  :func:`padded_level_weights` is the plain version of
the ``sample_weights`` kernel (``kernels/csrc/sample_weights.cu``), which
draws every level's weights on the card.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import prng


def comb(n: int, k: int) -> int:
    return math.comb(n, k)


class LevelCombos(NamedTuple):
    """Static combination table for one lattice level."""
    k: int
    masks: np.ndarray      # (M, d) uint32 in {0,1}
    ids: np.ndarray        # (M,) uint32 -- the column bitmask (globally unique)

    @property
    def num(self) -> int:
        return self.masks.shape[0]


def level_combinations(d: int, k: int) -> LevelCombos:
    masks = np.zeros((comb(d, k), d), dtype=np.uint32)
    ids = np.zeros((comb(d, k),), dtype=np.uint32)
    for i, cols in enumerate(itertools.combinations(range(d), k)):
        masks[i, list(cols)] = 1
        ids[i] = sum(1 << c for c in cols)
    return LevelCombos(k=k, masks=masks, ids=ids)


def lattice(d: int, s: int) -> list[LevelCombos]:
    """Levels s..d (the ones SJPC needs for threshold s)."""
    return [level_combinations(d, k) for k in range(s, d + 1)]


class PaddedLattice(NamedTuple):
    """All levels s..d stacked into one rectangular table.

    Every level is padded to ``m_max = max_k C(d, k)`` combinations so the
    whole lattice becomes dense (L, m_max, ...) arrays -- the layout the
    fused ingest kernel (one launch for every level) consumes.  Padded
    combination slots carry ``valid == 0``; the sampling step multiplies
    weights by ``valid`` so padded slots can never contribute to a sketch.
    """
    d: int
    s: int
    masks: np.ndarray      # (L, m_max, d) uint32 in {0,1}
    ids: np.ndarray        # (L, m_max) uint32 (0 in padded slots)
    valid: np.ndarray      # (L, m_max) uint32 in {0,1}
    nums: tuple            # true C(d, k) per level

    @property
    def num_levels(self) -> int:
        return self.masks.shape[0]

    @property
    def m_max(self) -> int:
        return self.masks.shape[1]


class ConcatLattice(NamedTuple):
    """All levels s..d concatenated along the combination axis (no padding).

    The flat layout: one masked-Horner fingerprint pass over all
    ``m_total = sum_k C(d, k)`` combinations can feed one flat scatter into
    the (L, t, w) counter block, with per-combination hash coefficients
    gathered via ``level_of``.
    """
    d: int
    s: int
    masks: np.ndarray      # (m_total, d) uint32 in {0,1}
    ids: np.ndarray        # (m_total,) uint32
    level_of: np.ndarray   # (m_total,) int32 level index (0 = level s)
    nums: tuple            # C(d, k) per level; offsets are cumulative

    @property
    def m_total(self) -> int:
        return self.masks.shape[0]


@functools.lru_cache(maxsize=None)
def concat_lattice(d: int, s: int) -> ConcatLattice:
    levels = lattice(d, s)
    masks = np.concatenate([lv.masks for lv in levels], axis=0)
    ids = np.concatenate([lv.ids for lv in levels], axis=0)
    level_of = np.concatenate(
        [np.full((lv.num,), i, dtype=np.int32) for i, lv in enumerate(levels)])
    return ConcatLattice(d=d, s=s, masks=masks, ids=ids, level_of=level_of,
                         nums=tuple(lv.num for lv in levels))


@functools.lru_cache(maxsize=None)
def padded_lattice(d: int, s: int) -> PaddedLattice:
    levels = lattice(d, s)
    m_max = max(lv.num for lv in levels)
    L = len(levels)
    masks = np.zeros((L, m_max, d), dtype=np.uint32)
    ids = np.zeros((L, m_max), dtype=np.uint32)
    valid = np.zeros((L, m_max), dtype=np.uint32)
    for i, lv in enumerate(levels):
        masks[i, :lv.num] = lv.masks
        ids[i, :lv.num] = lv.ids
        valid[i, :lv.num] = 1
    return PaddedLattice(d=d, s=s, masks=masks, ids=ids, valid=valid,
                         nums=tuple(lv.num for lv in levels))


def sample_size_parts(num_combos: int, ratio: float) -> tuple[int, float]:
    """(floor, frac) of the stochastically rounded sample size r*M."""
    target = num_combos * ratio
    lo = int(math.floor(target + 1e-9))
    frac = target - lo
    if frac < 1e-9:
        frac = 0.0
    lo = min(lo, num_combos)
    return lo, frac


# Below this combination count, descending ranks are computed by pairwise
# comparison counting instead of a double argsort.  Both give the same
# ranks (ties broken by index, as a stable argsort does), as in the JAX
# package, whose threshold this keeps.
_RANK_BY_COMPARISON_MAX_M = 64


def descending_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank (0 = largest) of each entry along the last axis, ties by index.

    rank_j = #{k : s_k > s_j} + #{k < j : s_k == s_j}, int32.
    """
    m = scores.shape[-1]
    if m > _RANK_BY_COMPARISON_MAX_M:
        order = torch.argsort(-scores, dim=-1, stable=True)
        return torch.argsort(order, dim=-1, stable=True).to(torch.int32)
    sk_ = scores[..., None, :]                  # k runs along the last axis
    sj = scores[..., :, None]
    earlier = torch.tril(torch.ones((m, m), dtype=torch.int32, device=scores.device),
                         diagonal=-1)           # [k < j]
    gt = (sk_ > sj).to(torch.int32)
    eq = (sk_ == sj).to(torch.int32)
    return torch.sum(gt + eq * earlier, dim=-1, dtype=torch.int32)


def sample_combo_weights(key: torch.Tensor, batch: int, num_combos: int, ratio: float,
                         device=None) -> torch.Tensor:
    """(batch, M) {0,1} int32 weights: per-record uniform l_i-subset, on
    ``device`` (None: the key's device).

    l_i = floor(r*M) + Bernoulli(frac(r*M)) per record (Alg. 1 lines 9-11).
    ratio == 1 short-circuits to all-ones.
    """
    lo, frac = sample_size_parts(num_combos, ratio)
    device = key.device if device is None else torch.device(device)
    if lo >= num_combos and frac == 0.0:
        return torch.ones((batch, num_combos), dtype=torch.int32, device=device)
    k_sel, k_round = prng.split(key)
    scores = prng.uniform(k_sel, (batch, num_combos), device)
    ranks = descending_ranks(scores)
    l_i = torch.full((batch, 1), lo, dtype=torch.int32, device=device)
    if frac > 0.0:
        u = prng.uniform(k_round, (batch, 1), device)
        l_i = l_i + (u < torch.tensor(frac, dtype=torch.float32)).to(torch.int32)
    return (ranks < l_i).to(torch.int32)


@functools.lru_cache(maxsize=None)
def level_sample_parts(d: int, s: int, ratio: float) -> tuple:
    """Per level s..d: (M, lo, frac), M = C(d, k) and the parts of its
    stochastically rounded sample size."""
    return tuple((lv.num,) + sample_size_parts(lv.num, ratio) for lv in lattice(d, s))


def padded_level_weights(key: torch.Tensor, batch: int, d: int, s: int, ratio: float,
                         row_mask: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """(B, L, m_max) int32 weights of levels s..d over the padded lattice,
    as the JAX package's ``sjpc._sample_level_weights`` draws them (level
    idx with ``fold_in(key, idx)``, rows multiplied by ``row_mask``) and
    ``jnp.pad`` pads them before ``fused_ingest_pallas``: 0 in the padded
    slots."""
    levels = lattice(d, s)
    m_max = max(lv.num for lv in levels)
    weights = []
    for idx, level in enumerate(levels):
        w = sample_combo_weights(prng.fold_in(key, idx), batch, level.num, ratio, device)
        if row_mask is not None:
            w = w * row_mask[:, None]
        weights.append(torch.nn.functional.pad(w, (0, m_max - level.num)))
    return torch.stack(weights, dim=1).contiguous()
