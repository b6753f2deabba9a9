"""Tables of records made on the card from the run's seed.

Vectorised torch rewrites of the two generators the SJPC evaluation uses
(the statistics of ``data/synthetic.py``'s ``shingle_records`` and
``yfcc_like``, not their numbers): every column made by a few large calls
of one ``torch.Generator`` on the device, so the same seed gives the same
table.  Records are (n, d) int32 words holding uint32 column values.
"""
from __future__ import annotations

import torch


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one named stream of a run's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & ((1 << 63) - 1))
    return g


def shingles(n: int, d: int, dup_profile, group: int, gen: torch.Generator,
             device) -> torch.Tensor:
    """Documents as d super-shingle fingerprints in [0, 2^30) with planted
    near-duplicate groups: for each (k, frac) of ``dup_profile``, frac * n
    rows form groups of ``group`` rows, each group ``group - 1`` rows of
    the second half copying k random columns of one source row of the
    first half (so every pair in a group agrees on at least k columns).
    Groups fill the table from its last row down."""
    recs = torch.randint(0, 1 << 30, (n, d), generator=gen, device=device, dtype=torch.int64)
    per = group - 1
    counts = [max(int(n * frac) // max(per, 1), 1) for _, frac in dup_profile]
    total = sum(counts)
    if total * per > n - n // 2 - 1:
        raise ValueError(f"the duplicate profile {dup_profile} needs {total * per} rows of "
                         f"the second half of {n}")
    ks = torch.cat([torch.full((c,), k, dtype=torch.int64, device=device)
                    for (k, _), c in zip(dup_profile, counts)])
    src = torch.randint(0, n // 2, (total,), generator=gen, device=device)
    # a uniform k-subset of the columns per group: the k smallest of d uniforms
    order = torch.argsort(torch.rand((total, d), generator=gen, device=device), dim=1)
    cols = torch.zeros((total, d), dtype=torch.bool, device=device)
    cols.scatter_(1, order, torch.arange(d, device=device).expand(total, d) < ks[:, None])
    dst = (n - 1 - torch.arange(total * per, device=device)).reshape(total, per)
    copy = torch.where(cols[:, None, :], recs[src][:, None, :], recs[dst])
    recs[dst.reshape(-1)] = copy.reshape(-1, d)
    return recs.to(torch.int32)


def zipf(a: float, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n draws of the Zipf law P(k) ~ k^-a, k >= 1 (numpy's ``zipf``: the
    rejection method of Devroye, draws above 2^62 rejected), int64."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        u = 1.0 - torch.rand(todo.numel(), generator=gen, device=device, dtype=torch.float64)
        v = torch.rand(todo.numel(), generator=gen, device=device, dtype=torch.float64)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x < 2.0 ** 62) & (x >= 1) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok].to(torch.int64)
        todo = todo[~ok]
    return out


def yfcc(n: int, gen: torch.Generator, device, user_zipf: float = 1.5,
         device_zipf: float = 1.3, users: int | None = None, devices: int = 5000,
         days: int = 4000, lat_cells: int = 180_000, lon_cells: int = 360_000) -> torch.Tensor:
    """(n, 5) photo records shaped like YFCC100M's (userid, date, device,
    lat, lon): Zipf user ids over n / 50 users, uniform days, Zipf devices,
    uniform coordinates at 0.001 degree."""
    users = users or max(n // 50, 2)
    cols = [zipf(user_zipf, n, gen, device) % users,
            torch.randint(0, days, (n,), generator=gen, device=device),
            zipf(device_zipf, n, gen, device) % devices,
            torch.randint(0, lat_cells, (n,), generator=gen, device=device),
            torch.randint(0, lon_cells, (n,), generator=gen, device=device)]
    return torch.stack(cols, dim=1).to(torch.int32)


def table(config: dict, seed: int, device) -> torch.Tensor:
    """The configuration's table of ``config['rows']`` records."""
    gen = generator(seed, device)
    kind = config["data"]
    if kind == "shingles":
        return shingles(config["rows"], config["d"], config["dup_profile"], config["group"],
                        gen, device)
    if kind == "yfcc":
        return yfcc(config["rows"], gen, device, **config.get("data_args", {}))
    raise ValueError(f"unknown data kind {kind!r}")
