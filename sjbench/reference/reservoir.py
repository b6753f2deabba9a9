"""The plain reference of batched reservoir-sample queries: Vitter's
Algorithm R over many streams at once, the all-pairs similarity histogram
of each sample, the bootstrap error bars and the scaled table, written out
in plain PyTorch and NumPy, independent of the program under test.

The draws are specified as ``jax.random``'s (:mod:`.prng`):

* a round of stream ``i`` with key ``k_i``: ``ku, ks = split(k_i)``; the
  candidate with arrival index ``g`` (the stream's count before the round
  plus its position among the round's valid rows) is kept when
  ``g < R`` (into slot ``g``) or when ``randint(ku)[row] in [0, g]`` falls
  below ``R`` (into slot ``randint(ks)[row] in [0, R)``); per slot the last
  kept candidate wins;
* bootstrap keys ``fold_in(fold_in(PRNGKey(seed ^ 0xB0075), n_i),
  step_i)``; replicate ``b`` draws ``min(256, R)`` of the valid slots
  (in slot order) with replacement, ``randint`` over the valid count.

A table: x_k = hist_k n (n - 1) / (m (m - 1)) for k = s..d, g the suffix
sums plus n, stderr the replicates' std (ddof 1) of their suffix sums,
scaled by sqrt(min(b, m) / m) and Serfling's sqrt(1 - (m - 1) / n).
``dtype`` of :func:`table` lowers the precision of that arithmetic: the
control of the benchmark's comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng

BOOT_SALT = 0xB0075
PAIR_CHUNK = 1 << 27          # (sample, slot, slot) int8 match cells at a time


def equal_space_capacity(d: int, s: int, width: int, depth: int) -> int:
    """The paper's Fig. 8 budget: the records (d words and a tag each)
    that fit in the bytes of the group's SJPC counters, (d - s + 1) t w
    int32 words."""
    return max(1, (d - s + 1) * depth * width // (d + 1))


def ingest_round(items, tags, n, sid, step, values, mask, keys, capacity: int):
    """One round of S streams: items (S, R, d) int64, tags (S, R), n (S,)
    int64, sid (S,), step (S,); values (S, B, d), mask (S, B), keys (S, 2).
    Returns the new (items, tags, n, step)."""
    S, B = mask.shape
    dev = values.device
    valid = mask != 0
    pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    g = n.to(torch.int64)[:, None] + pos
    ku, ks = prng.split2(keys.to(dev))
    rank = prng.randint(ku, B, 0, torch.clamp_min(g + 1, 1))
    slot_draw = prng.randint(ks, B, 0, capacity)
    kept = valid & ((g < capacity) | (rank < capacity))
    slot = torch.where(g < capacity, g.clamp(0, capacity - 1), slot_draw)
    # per slot, the kept candidate with the largest position
    order = torch.where(kept, pos, torch.full_like(pos, -1))
    last = torch.full((S, capacity), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(1, torch.where(kept, slot, 0), order, "amax", include_self=True)
    won = last >= 0
    # position among the valid rows -> row of the batch
    row_of = torch.zeros((S, B + 1), dtype=torch.int64, device=dev)
    row_of.scatter_(1, torch.where(valid, pos, B), torch.arange(B, device=dev).expand(S, B))
    row = torch.gather(row_of, 1, last.clamp(0, B))
    new_items = torch.where(won[..., None],
                            torch.gather(values.to(torch.int64) & prng.M32, 1,
                                         row[..., None].expand(-1, -1, values.shape[-1])),
                            items)
    new_tags = torch.where(won, sid[:, None].to(tags.dtype), tags)
    carried = valid.any(dim=1).to(step.dtype)
    return new_items, new_tags, n + valid.sum(dim=1), step + carried


def pair_hist(items: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """items (N, R, d), valid (N, R) -> (N, d + 1) int64: ordered pairs of
    distinct valid slots of each sample that agree on exactly k columns."""
    N, R, d = items.shape
    out = torch.zeros((N, d + 1), dtype=torch.int64, device=items.device)
    off = ~torch.eye(R, dtype=torch.bool, device=items.device)
    step = max(1, PAIR_CHUNK // max(R * R, 1))
    for lo in range(0, N, step):
        it = items[lo:lo + step]
        same = torch.zeros((it.shape[0], R, R), dtype=torch.int8, device=items.device)
        for c in range(d):
            same += (it[:, :, None, c] == it[:, None, :, c]).to(torch.int8)
        va = valid[lo:lo + step] != 0
        ok = va[:, :, None] & va[:, None, :] & off
        same = torch.where(ok, same, torch.full_like(same, -1))
        for k in range(d + 1):
            out[lo:lo + step, k] = (same == k).sum(dim=(1, 2))
    return out


def bootstrap_reps(items, valid, n, step, seed: int, replicates: int, item_cap: int):
    """(N, B, d + 1) replicate histograms and the replicate sizes (N,)."""
    N, R, _ = items.shape
    dev = items.device
    base = prng.key((seed ^ BOOT_SALT) & prng.M32, dev).expand(N, 2)
    keys = prng.fold_in(prng.fold_in(base, n.to(torch.int64)), step.to(torch.int64))
    is_valid = valid != 0
    m = is_valid.sum(dim=1)
    b = min(item_cap, R)
    order = torch.argsort((~is_valid).to(torch.int8), dim=1, stable=True)
    r = prng.randint(keys, replicates * b, 0, torch.clamp_min(m, 1)[:, None])
    idx = torch.gather(order, 1, r).reshape(N, replicates, b)
    rep_items = items[torch.arange(N, device=dev)[:, None, None], idx]
    sizes = torch.clamp_max(m, b)
    cols = torch.arange(b, device=dev)
    rep_valid = ((cols[None, None, :] < sizes[:, None, None]) & (m[:, None, None] >= 2)) \
        .expand(N, replicates, b)
    hists = pair_hist(rep_items.reshape(N * replicates, b, -1),
                      rep_valid.reshape(N * replicates, b))
    return hists.reshape(N, replicates, -1), sizes


def table(hist, n, m, rep_hists, rep_sizes, s: int, dtype=torch.float64) -> dict:
    """{'x', 'g', 'y', 'stderr'} (N, L) numpy float64 of N samples: hist
    (N, d + 1), n and m (N,), rep_hists (N, B, d + 1), rep_sizes (N,),
    computed in ``dtype``."""
    def q(v):
        return torch.as_tensor(np.asarray(v, np.float64)).to(dtype)

    def scale(nn, mm):
        return torch.where(mm >= 2, nn * (nn - 1) / torch.clamp_min(mm * (mm - 1), 1),
                           torch.zeros_like(nn))

    hist, n, m = q(hist.cpu()), q(n.cpu()), q(m.cpu())
    x = hist[:, s:] * scale(n, m)[:, None]
    g = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1]) + n[:, None]
    reps = q(rep_hists.cpu())[:, :, s:] * scale(n, q(rep_sizes.cpu()))[:, None, None]
    g_reps = torch.flip(torch.cumsum(torch.flip(reps, [2]), 2), [2])
    sd = g_reps.std(dim=1, correction=1)
    b = q(rep_sizes.cpu())
    cap = torch.where(m >= 2, torch.sqrt(torch.minimum(b, m) / torch.clamp_min(m, 1)),
                      torch.zeros_like(m))
    serf = torch.where(n > 0, 1 - (m - 1) / torch.clamp_min(n, 1), torch.ones_like(n))
    serf = torch.sqrt(torch.clamp(serf, 0, 1))
    stderr = sd * (cap * serf)[:, None]
    return {k: v.double().numpy() for k, v in
            (("x", x), ("g", g), ("y", hist[:, s:]), ("stderr", stderr))}


def query(items, tags, n, step, s: int, seed: int, replicates: int, item_cap: int,
          dtype=torch.float64) -> dict:
    """The table of stacked reservoir states (items (N, R, d), tags, n,
    step) with bootstrap error bars."""
    valid = tags >= 0
    hist = pair_hist(items, valid)
    reps, sizes = bootstrap_reps(items, valid, n, step, seed, replicates, item_cap)
    return table(hist, n, valid.sum(dim=1), reps, sizes, s, dtype)


def table_gap(port: dict, ref: dict) -> float:
    """The largest relative difference of any x, g, y or stderr column:
    each quantity's largest absolute difference over its largest reference
    magnitude (at least 1)."""
    return max(float(np.abs(np.asarray(port[k], np.float64) - ref[k]).max())
               / max(1.0, float(np.abs(ref[k]).max())) for k in ("x", "g", "y", "stderr"))
