"""The least work of each kernel op the cells drive, and the card's peaks:
the benchmark's own frozen copy of the formulas, so that no change to the
program can move its yardstick.

Bytes count each input read once and each output written once, field data
(records, tables, coefficients) at its uint32 width; operations count only
what the inputs need (sampled weights of 0 are skipped, a pair sample's
valid slots only).  A call's bound is the larger of its bytes over the HBM
bandwidth and its int32 operations over the CUDA cores' rate.
"""
from __future__ import annotations

import math

# One H100 SXM5 80 GB: HBM3 at 3.35 TB/s (NVIDIA H100 data sheet); 132 SMs
# x 64 INT32 lanes x 1.98 GHz boost (the H100 architecture white paper).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FIELD_BYTES = 4
THREEFRY_OPS = 72       # int32 operations of one threefry2x32 block


def bound_ms(nbytes: float, ops: float) -> float:
    """The least milliseconds of a call that moves ``nbytes`` and does
    ``ops`` int32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


def level_parts(d: int, s: int, ratio: float) -> list[tuple[int, int, float]]:
    """Per level k = s..d: (C(d, k), floor(r C), frac(r C))."""
    out = []
    for k in range(s, d + 1):
        m = math.comb(d, k)
        target = m * ratio
        lo = int(math.floor(target + 1e-9))
        frac = target - lo
        out.append((m, min(lo, m), 0.0 if frac < 1e-9 else frac))
    return out


def sample_weights(d: int, s: int, ratio: float, batch: int, partial: list[int]) -> tuple:
    """(bytes, ops) of one round's draws: the (B, L, m_max) int32 weights
    written, 12 bytes of key and step; 72 operations per threefry block:
    1 + 3L for the keys and, per level, B Bernoulli draws when r C(d, k)
    has a fraction and C(d, k) scores for each record that keeps some but
    not all of the level's combinations (``partial[level]``)."""
    parts = level_parts(d, s, ratio)
    m_max = max(m for m, _, _ in parts)
    blocks = 1 + 3 * len(parts)
    for (m, lo, frac), p in zip(parts, partial):
        if lo >= m and frac == 0.0:
            continue
        blocks += batch * (frac > 0.0) + m * p
    return batch * len(parts) * m_max * 4 + 12, THREEFRY_OPS * blocks


def fused_ingest(d: int, s: int, depth: int, width: int, batch: int,
                 kept: list[int]) -> tuple:
    """(bytes, ops) of one round's fused ingest: the records, each level's
    live combination tables and weights, the coefficients, the counters read
    and written; per kept sub-value at level k, 2k fingerprint and 12 t
    hash operations (``kept[level]`` sub-values kept)."""
    L = d - s + 1
    live = sum(math.comb(d, k) for k in range(s, d + 1))
    nbytes = ((batch * d + live * (d + 1) + 2 + 2 * L * depth * 2 * 4) * FIELD_BYTES
              + batch * live * 4 + 2 * L * depth * width * 4)
    ops = sum(n * (2 * (s + i) + 12 * depth) for i, n in enumerate(kept))
    return nbytes, ops


def fused_pairs(samples: int, slots: int, d: int, valid: int) -> tuple:
    """(bytes, ops) of one pair-histogram call over ``samples`` samples of
    ``slots`` slots, ``valid`` of them valid in each: items at uint32
    width, valid flags and histograms; d compares per unordered pair of
    valid slots."""
    nbytes = samples * slots * d * FIELD_BYTES + samples * slots * 4 + samples * (d + 1) * 4
    return nbytes, d * samples * valid * (valid - 1) // 2
