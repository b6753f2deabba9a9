"""The plain reference of an SJPC scan job: Algorithm 1 of Rafiei & Deng
written out in plain PyTorch, independent of the program under test.

From a configuration (d, s, r, w, t, seed) and the records alone it
derives what any correct implementation must produce:

* the hash and fingerprint parameters: ``np.random.default_rng(seed)``
  draws bucket coefficients (L, t, 2, 4), then sign coefficients, then two
  fingerprint bases, each uniform in [0, 2^31 - 1) (bases moved to [2, p));
* the sampling: round ``j`` of a stream draws with key
  ``fold_in(PRNGKey(seed ^ 0xC0FFEE), j)``; level ``i`` (k = s + i) folds
  in ``i``, splits into a selection and a rounding key, scores every
  (record, combination) with a uniform, keeps the ``floor(r M) +
  Bernoulli(frac(r M))`` highest scores (ties by index);
* each kept sub-value's two masked-Horner fingerprints mod p = 2^31 - 1,
  seeded by the combination's column bitmask + 1;
* per depth row, the degree-3 Carter-Wegman bucket and sign hashes of the
  fingerprint pair, and the counter adds (int64 here, so a wrap would show);
* the estimate tables in float64 from exact int64 moments: the median
  over depth rows, Eq. 4 (self-join) or Eq. 7 (join) inverted with the
  clamp at 0, and the suffix sums g_k.

Rows go through in blocks, so the reference fits beside nothing else on
the card.  ``dtype`` of :func:`tables` lowers the precision of the
inversion: the control of the benchmark's comparison.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from . import prng

P = 0x7FFFFFFF
BLOCK_ROWS = 1 << 18


def sample_parts(m: int, ratio: float) -> tuple[int, float]:
    """(floor, fraction) of the stochastically rounded sample size r M."""
    target = m * ratio
    lo = int(math.floor(target + 1e-9))
    frac = target - lo
    if frac < 1e-9:
        frac = 0.0
    return min(lo, m), frac


class Sketcher:
    """Parameters and lattice of one configuration, on ``device``."""

    def __init__(self, d: int, s: int, ratio: float, width: int, depth: int, seed: int,
                 device):
        self.d, self.s, self.ratio, self.width, self.depth = d, s, ratio, width, depth
        self.device = torch.device(device)
        self.L = d - s + 1
        rng = np.random.default_rng(seed)
        shape = (self.L, depth, 2, 4)
        self.bucket = torch.from_numpy(rng.integers(0, P, size=shape, dtype=np.uint32)
                                       .astype(np.int64)).to(self.device)
        self.sign = torch.from_numpy(rng.integers(0, P, size=shape, dtype=np.uint32)
                                     .astype(np.int64)).to(self.device)
        bases = rng.integers(0, P, size=(2,), dtype=np.uint32) % np.uint32(P - 2) + np.uint32(2)
        self.bases = torch.from_numpy(bases.astype(np.int64)).to(self.device)
        self.base_key = prng.key(seed ^ 0xC0FFEE, self.device)
        self.levels = []
        for k in range(s, d + 1):
            combos = list(itertools.combinations(range(d), k))
            mask = torch.zeros((len(combos), d), dtype=torch.bool)
            for i, cols in enumerate(combos):
                mask[i, list(cols)] = True
            ids = torch.tensor([sum(1 << c for c in cols) for cols in combos], dtype=torch.int64)
            self.levels.append((k, mask.to(self.device), ids.to(self.device),
                                sample_parts(len(combos), ratio)))
        # [j, k]: k < j, the ties a score loses to
        self.earlier = [torch.ones((lv[1].shape[0],) * 2, dtype=torch.bool,
                                   device=self.device).tril(-1) for lv in self.levels]

    def weights(self, step: int, level: int, row0: int, rows: int) -> torch.Tensor:
        """(rows, M) bool: which combinations rows ``row0 .. row0 + rows`` of
        round ``step`` keep at level index ``level``."""
        _, mask, _, (lo, frac) = self.levels[level]
        m = mask.shape[0]
        if lo >= m and frac == 0.0:
            return torch.ones((rows, m), dtype=torch.bool, device=self.device)
        k = prng.fold_in(prng.fold_in(self.base_key, step), level)
        k_sel, k_round = prng.split2(k)
        score = prng.unit_float(prng.bits(k_sel, row0 * m, rows * m)).reshape(rows, m)
        later = score[:, None, :] > score[:, :, None]          # [j, k]: s_k > s_j
        tie = (score[:, None, :] == score[:, :, None]) & self.earlier[level]
        rank = (later | tie).sum(dim=2)
        keep = torch.full((rows, 1), lo, dtype=torch.int64, device=self.device)
        if frac > 0.0:
            u = prng.unit_float(prng.bits(k_round, row0, rows)).reshape(rows, 1)
            keep = keep + (u < torch.tensor(frac, dtype=torch.float32)).to(torch.int64)
        return rank < keep

    def fingerprints(self, values: torch.Tensor, level: int) -> torch.Tensor:
        """(2, rows, M) masked-Horner fingerprints of rows ``values`` (rows, d)
        int64 in [0, 2^32) at level index ``level``."""
        _, mask, ids, _ = self.levels[level]
        v = (values % P + 1) % P
        base = self.bases[:, None, None]
        fp = ((ids % P + 1) % P)[None, None, :].expand(2, values.shape[0], ids.shape[0])
        for c in range(self.d):
            step = (fp * base % P + v[None, :, c:c + 1]) % P
            fp = torch.where(mask[None, None, :, c], step, fp)
        return fp

    @staticmethod
    def _hash(x, y, coeffs):
        """Pair hash: cw(x, coeffs[:, 0]) + cw(y, coeffs[:, 1]) mod p for
        coefficients (t, 2, 4) and keys (K,) -> (t, K)."""
        out = []
        for key, c in ((x, coeffs[:, 0]), (y, coeffs[:, 1])):
            h = c[:, 3:4].expand(-1, key.shape[0])
            for i in (2, 1, 0):
                h = (h * key[None, :] % P + c[:, i:i + 1]) % P
            out.append(h)
        return (out[0] + out[1]) % P

    def add(self, counters: torch.Tensor, values: torch.Tensor, step: int, row0: int,
            kept: list | None = None) -> None:
        """Add rows ``row0 ..`` of round ``step`` (``values`` (rows, d)) to
        int64 ``counters`` (L, t, w) in place.  ``kept`` (a list of per-level
        [records keeping some but not all, kept sub-values]) gathers what the
        work formulas read."""
        t, w = self.depth, self.width
        rows = torch.arange(t, device=self.device)[:, None] * w
        for li in range(self.L):
            keep = self.weights(step, li, row0, values.shape[0])
            if kept is not None:
                per = keep.sum(dim=1)
                kept[li][0] += int(((per > 0) & (per < keep.shape[1])).sum())
                kept[li][1] += int(per.sum())
            fp = self.fingerprints(values, li)
            fp1, fp2 = fp[0][keep], fp[1][keep]
            if fp1.numel() == 0:
                continue
            bucket = self._hash(fp1, fp2, self.bucket[li]) & (w - 1)
            sign = 1 - 2 * (self._hash(fp1, fp2, self.sign[li]) & 1)
            counters[li].view(-1).index_add_(0, (bucket + rows).reshape(-1), sign.reshape(-1))

    def scan(self, table: torch.Tensor, call_rows: int, first_step: int = 0,
             kept: list | None = None) -> torch.Tensor:
        """The int64 counters (L, t, w) of ``table`` (N, d) ingested in rounds
        of ``call_rows`` rows, round ``i`` drawing with step ``first_step +
        i``.  ``kept``, when given, is a list with one list per round, each
        filled as :meth:`add` fills it."""
        counters = torch.zeros((self.L, self.depth, self.width), dtype=torch.int64,
                               device=self.device)
        for i, start in enumerate(range(0, table.shape[0], call_rows)):
            call = table[start:start + call_rows]
            stats = None
            if kept is not None:
                stats = [[0, 0] for _ in range(self.L)]
                kept.append(stats)
            for r0 in range(0, call.shape[0], BLOCK_ROWS):
                block = call[r0:r0 + BLOCK_ROWS].to(torch.int64) & prng.M32
                self.add(counters, block, first_step + i, r0, stats)
        return counters


def _median_rows(moments: np.ndarray) -> np.ndarray:
    """Median over the last axis: the middle value, or the mean of the two
    middle values for an even count."""
    ordered = np.sort(moments, axis=-1)
    t = ordered.shape[-1]
    return (ordered[..., (t - 1) // 2] + ordered[..., t // 2]) / 2


def tables(d: int, s: int, ratio: float, counters_a: torch.Tensor, n_a: float,
           counters_b: torch.Tensor | None = None, dtype=torch.float64) -> dict:
    """{'x', 'g', 'y'} (L,) numpy float64 of one sketch's self-join
    (``counters_b`` None) or of the join of two: exact int64 row moments,
    then the median and the inversion computed in ``dtype``."""
    a = counters_a.to(torch.int64).cpu()
    b = a if counters_b is None else counters_b.to(torch.int64).cpu()
    moments = (a * b).sum(dim=-1).numpy()                     # (L, t) exact
    y_exact = _median_rows(moments.astype(np.float64))

    def q(v):
        return torch.tensor(v, dtype=torch.float64).to(dtype)

    y = q(y_exact)
    n = q(n_a)
    X = {}
    for k in range(d, s - 1, -1):
        if counters_b is None:
            acc = y[k - s] - q(math.comb(d, k) * ratio) * n
        else:
            acc = y[k - s] / q(ratio * ratio)
        for j in range(k + 1, d + 1):
            acc = acc - q(math.comb(j, k)) * X[j]
        X[k] = torch.clamp_min(acc, 0)
    x = torch.stack([X[k] for k in range(s, d + 1)])
    if counters_b is None:
        x = x / q(ratio * ratio)
    g = torch.flip(torch.cumsum(torch.flip(x, [0]), 0), [0])
    if counters_b is None:
        g = g + n
    return {"x": x.double().numpy(), "g": g.double().numpy(), "y": y.double().numpy()}


def table_gap(port: dict, ref: dict, ratio: float) -> float:
    """The largest absolute difference of any x, g or y entry between two
    tables, over the largest magnitude that enters the inversion (|x|, |g|
    and |y| / r^2, at least 1)."""
    scale = max(1.0, float(np.abs(ref["x"]).max()), float(np.abs(ref["g"]).max()),
                float(np.abs(ref["y"]).max()) / ratio ** 2)
    gap = max(float(np.abs(np.asarray(port[k], np.float64).reshape(-1) - ref[k]).max())
              for k in ("x", "g", "y"))
    return gap / scale
