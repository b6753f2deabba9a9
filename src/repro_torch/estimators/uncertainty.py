"""Error bars for the sample-kind estimators, ported from the JAX
package's ``estimators/uncertainty.py``.

* **Bootstrap over the retained sample** (reservoir): resample each
  stream's valid sample B times with replacement, recompute the scaled
  pair-count table per replicate, and report the replicate standard
  deviation.  Every replicate histogram of every stream goes through ONE
  ``fused_pairs`` launch over the stacked (N, B) leading dims.
* **m-out-of-m cap**: a replicate draws at most ``item_cap`` items, and its
  std is rescaled by sqrt(b / m) (the leading variance term of a degree-2
  U-statistic is O(1/m)).
* **Serfling's correction**: the sample is drawn without replacement from
  the n-record stream, so every stderr is scaled by
  sqrt(max(1 - (m-1)/n, 0)).
* **Stratified bootstrap** (LSH-SS): each stratum's pair reservoir is
  resampled independently (a Dirichlet/Jeffreys Bayesian bootstrap, host
  numpy), scaled by the stratum's pair mass and Serfling factor, and the
  strata are combined.

Every path is deterministic given the estimator seed and each state's
(n, step): an unchanged window reports the same bars.  The reservoir's
resampling keys replay ``jax.random`` (:mod:`..core.prng`), so its bars
equal the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import prng
from ..obs.metrics import default_registry

DEFAULT_REPLICATES = 32     # bootstrap resamples B
DEFAULT_ITEM_CAP = 256      # m-out-of-m cap b per replicate

_BOOT_SALT = 0xB0075  # PRNG domain separator vs ingest / merge salts


def serfling_factor(n, m):
    """Serfling's without-replacement variance factor, as a std multiplier:
    sqrt(1 - (m-1)/n), clamped to [0, 1] (1 where n <= 0)."""
    n = np.asarray(n, np.float64)
    m = np.asarray(m, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(n > 0, 1.0 - (m - 1.0) / np.maximum(n, 1.0), 1.0)
    return np.sqrt(np.clip(f, 0.0, 1.0))


def bootstrap_key(seed: int, n, step) -> torch.Tensor:
    """Per-stream keys for bootstrap resampling, deterministic in the seed
    and each state's (n, step): n (N,), step (N,) -> (N, 2) keys, each
    ``fold_in(fold_in(PRNGKey(seed ^ salt), n_i), step_i)``."""
    n = torch.as_tensor(n).to(torch.int64).reshape(-1)
    step = torch.as_tensor(step).to(n.device, torch.int64).reshape(-1)
    base = prng.PRNGKey((seed ^ _BOOT_SALT) & 0xFFFFFFFF).to(n.device)
    return prng.fold_in(prng.fold_in(base.expand(n.shape[0], 2), n), step)


def resample_valid_slots(keys, valid, replicates: int, item_cap: int):
    """Bootstrap slot indices over the valid entries of fixed-shape samples.

    keys (N, 2); valid (N, R) -> (idx (N, B, b) int64, rep_valid (N, B, b)
    int32, b_sizes (N,)) with b = min(item_cap, R): ``idx`` draws uniformly
    with replacement from each stream's valid slots; columns past
    b_i = min(m_i, item_cap), and whole streams with m < 2, are masked out.
    """
    valid = torch.as_tensor(valid) != 0
    N, R = valid.shape
    device = valid.device
    b = min(item_cap, R)
    m = valid.sum(dim=1)                                               # (N,)
    # valid slot ids first, in slot order (jnp.argsort is stable)
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)  # (N, R)
    r = prng.randint(keys, (replicates, b), 0, torch.clamp_min(m, 1)[:, None, None],
                     device)                                           # (N, B, b)
    idx = torch.gather(order[:, None, :].expand(N, replicates, R), 2, r.to(torch.int64))
    b_sizes = torch.clamp_max(m, b)
    col = torch.arange(b, device=device)
    rep_valid = ((col[None, None, :] < b_sizes[:, None, None])
                 & (m[:, None, None] >= 2)).expand(N, replicates, b).to(torch.int32)
    return idx, rep_valid, b_sizes


def pair_scale(n, m):
    """n(n-1) / (m(m-1)) with the m < 2 guard -> the zero table."""
    n = np.asarray(n, np.float64)
    m = np.asarray(m, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(m >= 2, n * (n - 1.0) / np.maximum(m * (m - 1.0), 1.0), 0.0)


def suffix_stderr_from_reps(x_reps: np.ndarray) -> np.ndarray:
    """Replicate per-level tables (N, B, L) -> stderr of the suffix-sum g
    table (N, L): std (ddof=1) of the per-replicate suffix sums."""
    g_reps = np.cumsum(x_reps[:, :, ::-1], axis=2)[:, :, ::-1]
    return g_reps.std(axis=1, ddof=1)


def bootstrap_pair_stderr(items, valid, n, *, keys, s: int,
                          replicates: int = DEFAULT_REPLICATES,
                          item_cap: int = DEFAULT_ITEM_CAP, impl: str | None = None,
                          pair_fn=None) -> np.ndarray:
    """Bootstrap stderr of a scaled all-pairs suffix table (reservoir).

    items (N, R, d) stored samples, valid (N, R), n (N,) float stream
    counts, keys (N, 2); returns (N, L) absolute stderr for g_k, k = s..d,
    rescaled by the m-out-of-m cap and the Serfling factor.
    ``pair_fn(items, valid)`` computes stacked pair histograms: by default
    the ``fused_pairs`` op (``impl`` names its implementation).
    """
    if pair_fn is None:
        from ..kernels.ops import fused_pairs

        def pair_fn(it, va):
            return fused_pairs(it, va, impl=impl)

    items = torch.as_tensor(items)
    valid = torch.as_tensor(valid, device=items.device)
    N, R, d = items.shape
    L = d - s + 1
    m = (valid != 0).sum(dim=1).cpu().numpy().astype(np.float64)
    if replicates < 2 or R < 2:
        return np.zeros((N, L))
    metrics = default_registry()
    if metrics.enabled:
        metrics.inc("bootstrap_replicates_total", N * replicates, method="bootstrap")
    idx, rep_valid, b_sizes = resample_valid_slots(keys, valid, replicates, item_cap)
    # gather the replicate items on the device; ONE pair-histogram call over
    # the stacked (N, B) leading dims
    rep_items = items[torch.arange(N, device=items.device)[:, None, None], idx]
    hists = np.asarray(torch.as_tensor(pair_fn(rep_items, rep_valid)).cpu().numpy(),
                       np.float64)                                     # (N, B, d+1)

    n = np.asarray(n, np.float64)
    b_sizes = b_sizes.cpu().numpy().astype(np.float64)
    scale_b = pair_scale(n, b_sizes)                                   # (N,)
    x_reps = hists[:, :, s:] * scale_b[:, None, None]                  # (N, B, L)
    stderr = suffix_stderr_from_reps(x_reps)
    with np.errstate(divide="ignore", invalid="ignore"):
        cap_scale = np.where(m >= 2, np.sqrt(np.minimum(b_sizes, m) / np.maximum(m, 1.0)),
                             0.0)
    return stderr * (cap_scale * serfling_factor(n, m))[:, None]


def _resample_fracs(sim, valid, levels, rng, replicates: int):
    """Bayesian-bootstrap level-fraction replicates of ONE stream's
    stratum reservoir: sim (M,) match counts, valid (M,) -> ((B, d+1)
    replicate fractions, m).  Replicates draw f* ~ Dirichlet(hits + 1/2),
    the Jeffreys prior, so a level the reservoir never saw keeps a
    half-hit of spread.  m == 0 gives all-zero fractions."""
    vals = np.asarray(sim)[np.asarray(valid) != 0]
    m = vals.shape[0]
    if m == 0:
        return np.zeros((replicates, levels.shape[0])), 0.0
    hits = (vals[:, None] == levels).sum(axis=0)
    return rng.dirichlet(hits + 0.5, size=replicates), float(m)


def stratified_bootstrap_stderr(same_sim, same_valid, same_seen,
                                cross_sim, cross_valid, cross_seen,
                                same_pairs, cross_pairs, *, d: int, s: int,
                                seed: int, n, step,
                                replicates: int = DEFAULT_REPLICATES) -> np.ndarray:
    """Stratified bootstrap stderr of the LSH-SS g table (N, L), host
    numpy: each stratum's pair reservoir is resampled independently, its
    centered replicate fraction deviations scaled by the stratum's pair
    mass and Serfling factor (population = candidates seen), and combined
    per replicate."""
    same_pairs = np.asarray(same_pairs, np.float64)
    cross_pairs = np.asarray(cross_pairs, np.float64)
    if replicates < 2:
        raise ValueError("stratified bootstrap needs >= 2 replicates")
    levels = np.arange(d + 1)
    N = same_pairs.shape[0]
    metrics = default_registry()
    if metrics.enabled:
        metrics.inc("bootstrap_replicates_total", N * replicates,
                    method="bootstrap_stratified")
    n_i = np.asarray(n, np.int64).reshape(N)
    step_i = np.asarray(step, np.int64).reshape(N)
    seen_s = np.asarray(same_seen, np.float64).reshape(N)
    seen_c = np.asarray(cross_seen, np.float64).reshape(N)
    x_dev = np.zeros((N, replicates, d + 1))
    for i in range(N):
        # per-stream rng keyed on (seed, n, step): a stream's bars do not
        # depend on its position in a stack (batch == ref)
        rng = np.random.default_rng(np.random.SeedSequence(
            [int(np.uint32(seed) ^ np.uint32(_BOOT_SALT)),
             int(n_i[i]) & 0xFFFFFFFF, int(step_i[i]) & 0xFFFFFFFF]))
        for sim, valid, seen, pairs in (
                (np.asarray(same_sim)[i], np.asarray(same_valid)[i], seen_s[i], same_pairs[i]),
                (np.asarray(cross_sim)[i], np.asarray(cross_valid)[i], seen_c[i],
                 cross_pairs[i])):
            f, m = _resample_fracs(sim, valid, levels, rng, replicates)
            dev = f - f.mean(axis=0, keepdims=True)                    # (B, d+1)
            x_dev[i] += dev * (pairs * serfling_factor(seen, m))
    return suffix_stderr_from_reps(x_dev[:, :, s:])
