"""The query planner on the PyTorch port: cross-group fusion, plan caching
and admission.  The port's counterpart of
``examples/planner_admission.py``, with ``--device`` and size flags.

    PYTHONPATH=src python examples/planner_admission_torch.py                # on the card
    PYTHONPATH=src python examples/planner_admission_torch.py --device cpu   # on the CPU

Four hash groups share one derived config, each serving four tenant
streams with standing self-join queries.  The planner (on by default)
fuses all four group cohorts into one ``estimate_batch`` launch per poll,
caches the fusion plan across polls, and -- when a tenant is given a
query budget -- throttles that tenant to its last fresh result, marked
``stale=True``, instead of dropping it.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import platform  # noqa: E402
from repro_torch.core import sjpc  # noqa: E402
from repro_torch.service import ContinuousQuery, EstimationService, ServiceConfig  # noqa: E402

GROUPS, PER_GROUP, D = 4, 4, 6


def main(argv=None) -> dict:
    """Prints the planner's counters and the budgeted polls; returns the
    counters and each budgeted poll's ``stale`` flag."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--records", type=int, default=2048)
    args = ap.parse_args(argv)
    device = platform.resolve(args.device)
    print(f"device: {device}")
    cfg = sjpc.SJPCConfig(d=D, s=4, ratio=0.5, width=1024, depth=3)

    svc = EstimationService(ServiceConfig(device=device, batch_rows=512, window_epochs=None))
    rng = np.random.default_rng(0)
    names = []
    for g in range(GROUPS):
        svc.create_group(f"region-{g}", cfg)        # distinct hash params...
        for t in range(PER_GROUP):
            nm = f"region-{g}/tenant-{t}"
            svc.create_stream(nm, f"region-{g}")    # ...same derived geometry
            svc.ingest(nm, rng.integers(0, 2000, size=(args.records, D), dtype=np.uint32))
            names.append(nm)
    svc.flush()

    # standing queries: tenant-0 of region-0 is latency-critical (priority 0)
    for i, nm in enumerate(names):
        svc.register_continuous(ContinuousQuery(f"q/{nm}", "self_join", (nm,),
                                                priority=0 if i == 0 else 1))

    # -- cross-group fusion + the plan cache -------------------------------
    met = svc.obs.metrics
    names_ = ("planner_fused_launches_total", "planner_fused_cohorts_total",
              "planner_plans_built_total", "planner_plan_reuse_total",
              "admission_rejections_total")
    # the counters since here (the registry is the process's, shared by
    # any earlier service)
    base = {name: met.counter_total(name) for name in names_}

    def since(name):
        return met.counter_total(name) - base[name]
    for _ in range(3):
        out = svc.poll()
    launches, cohorts, built, reused = (since(name) for name in names_[:4])
    print(f"{GROUPS} groups x {PER_GROUP} streams, {len(names)} standing queries:")
    print(f"  fused launches: {launches:.0f} (covering {cohorts:.0f} group "
          f"cohorts -- one device call answered every group)")
    print(f"  plans built: {built:.0f}, reused: {reused:.0f} "
          f"(topology unchanged -> no replanning)")
    print(f"  {names[0]} g_4 = {out['q/' + names[0]].estimate:.1f} "
          f"+/- {out['q/' + names[0]].stderr:.1f}")

    # -- admission control: budget one tenant to 1 query per 2 polls ------
    noisy = names[-1]
    svc.set_tenant_budget(noisy, 0.5, burst=1.0)
    print(f"\nbudgeting {noisy} to 0.5 queries/poll (burst 1):")
    stale = []
    for i in range(4):
        svc.ingest(noisy, rng.integers(0, 2000, size=(256, D), dtype=np.uint32))
        svc.flush()                              # the window really does change
        r = svc.poll()[f"q/{noisy}"]
        stale.append(bool(r.stale))
        print(f"  poll {i}: g_4 = {r.estimate:>10.1f}  "
              f"{'STALE (over budget, last fresh answer)' if r.stale else 'fresh'}")
    rej = since("admission_rejections_total")
    print(f"admission_rejections_total = {rej:.0f}; every other tenant stayed fresh")
    return {"launches": launches, "cohorts": cohorts, "built": built, "reused": reused,
            "stale": stale, "rejections": rej}


if __name__ == "__main__":
    main()
