"""The port's query planner against the JAX package's on the CPU, and
against the port's own planner-off path: every scenario runs the same
records and standing queries through a JAX service and a port service
(``device="cpu"``) with private metrics registries, and holds the served
results within 1e-6 and the ``planner_*``, ``admission_*`` and
``query_cache_*`` counters equal.

Scenarios: planner on == off for every kind (fused and per-stream query
paths), cross-group fusion into one launch, the plan cache and its
invalidation, per-tenant admission with throttled ``stale`` results,
launch coalescing, LRU eviction of the shared cache, join buckets by
estimator instance, and a stream's replay coordinate independent of its
cohort-mates' backlogs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_service_cases import (JCFG, TCFG, assert_result_close, assert_same_results,  # noqa: E402
                                 assert_same_state, bundles, records)

from repro import estimators as jest_mod  # noqa: E402
from repro import service as jsvc  # noqa: E402
from repro.estimators import base as jest_base  # noqa: E402
from repro.estimators.sjpc_backend import SJPCEstimator as JSJPC  # noqa: E402
from repro_torch import estimators as test_mod  # noqa: E402
from repro_torch import service as tsvc  # noqa: E402
from repro_torch.estimators import base as test_base  # noqa: E402
from repro_torch.estimators.sjpc_backend import SJPCEstimator as TSJPC  # noqa: E402

KINDS = ("sjpc", "reservoir", "lsh_ss")
PKGS = ((jsvc, JCFG), (tsvc, TCFG))
COUNTED = ("planner_", "admission_", "query_cache_", "query_prefetch_")


def _service(pkg, obs, **kw):
    kw = {"batch_rows": 32, "window_epochs": 4, **kw}
    if pkg is tsvc:
        kw["device"] = "cpu"
    return pkg.EstimationService(pkg.ServiceConfig(**kw), obs=obs)


def _twins(**kw):
    """(JAX service, port service), each with its own metrics."""
    jo, to = bundles()
    return _service(jsvc, jo, **kw), _service(tsvc, to, **kw)


def _counters(svc):
    return {name: fam for name, fam in svc.obs.metrics.collect().items()
            if name.startswith(COUNTED) and not name.endswith("_ratio")}


def _assert_same_counters(j, t):
    assert _counters(j) == _counters(t)


def _populate(svc, cfg, pkg, *, groups=2, seed=0):
    """Per group one stream of each kind plus a second SJPC stream (the
    join partner), standing queries over all of it."""
    rng = np.random.default_rng(seed)
    for g in range(groups):
        gid = f"g{g}"
        svc.create_group(gid, cfg)
        for kind in KINDS:
            svc.create_stream(f"{gid}-{kind}", gid, estimator=kind)
        svc.create_stream(f"{gid}-sjpc2", gid)
        for name in [f"{gid}-{k}" for k in KINDS] + [f"{gid}-sjpc2"]:
            svc.ingest(name, records(rng, 40))
        for kind in KINDS:
            svc.register_continuous(pkg.ContinuousQuery(f"q-{gid}-{kind}", "self_join",
                                                         (f"{gid}-{kind}",)))
        svc.register_continuous(pkg.ContinuousQuery(f"qa-{gid}", "all_thresholds",
                                                     (f"{gid}-sjpc2",)))
        svc.register_continuous(pkg.ContinuousQuery(f"qj-{gid}", "join",
                                                     (f"{gid}-sjpc", f"{gid}-sjpc2")))
    return rng


@pytest.mark.parametrize("fused", [True, False])
def test_planner_on_equals_off_and_jax(fused):
    """Two polls with fresh ingest between them: the port's planner-on
    results equal its planner-off results and the JAX planner's within
    1e-6, and the counters equal the JAX service's."""
    outs, svcs = {}, {}
    for pkg, cfg in PKGS:
        for on in (True, False):
            jo, to = bundles()
            svc = _service(pkg, jo if pkg is jsvc else to, use_planner=on,
                           use_fused_query=fused)
            rng = _populate(svc, cfg, pkg)
            polls = []
            for _ in range(2):
                polls.append(svc.poll())
                for g in range(2):
                    svc.ingest(f"g{g}-sjpc", records(rng, 40))
            outs[pkg, on], svcs[pkg, on] = polls, svc
    for i in range(2):
        assert_same_results(outs[tsvc, False][i], outs[tsvc, True][i])
        assert_same_results(outs[jsvc, True][i], outs[tsvc, True][i])
        assert_same_results(outs[jsvc, False][i], outs[tsvc, False][i])
    for on in (True, False):
        _assert_same_counters(svcs[jsvc, on], svcs[tsvc, on])


def test_cross_group_fusion_one_launch():
    """Four same-config groups' SJPC cohorts share one estimate_batch
    launch; each group's rows equal a solo snapshot's."""
    outs = []
    for svc, (pkg, cfg) in zip(_twins(), PKGS):
        rng = np.random.default_rng(3)
        for g in range(4):
            svc.create_group(f"g{g}", cfg)
            svc.create_stream(f"s{g}", f"g{g}")
            svc.ingest(f"s{g}", records(rng, 40))
            svc.register_continuous(pkg.ContinuousQuery(f"q{g}", "self_join", (f"s{g}",)))
        outs.append((svc, svc.poll()))
    (j, out_j), (t, out_t) = outs
    assert_same_results(out_j, out_t)
    m = t.obs.metrics
    assert m.counter("planner_fused_launches_total", op="self") == 1.0
    assert m.counter("planner_fused_cohorts_total", op="self") == 4.0
    for g in range(4):
        solo = tsvc.QueryEngine(t.registry).snapshot([f"s{g}"]).self_join(f"s{g}")
        assert_result_close(out_t[f"q{g}"], solo)
    _assert_same_counters(j, t)


def test_plan_cached_and_invalidated_by_create_stream():
    """The plan is built once and reused; a mid-life create_stream
    rebuilds it."""
    j, t = _twins()
    outs = []
    for svc, (pkg, cfg) in zip((j, t), PKGS):
        rng = np.random.default_rng(4)
        svc.create_group("g", cfg)
        svc.create_stream("s0", "g")
        svc.ingest("s0", records(rng, 40))
        svc.register_continuous(pkg.ContinuousQuery("q0", "self_join", ("s0",)))
        svc.poll()
        svc.poll()
        m = svc.obs.metrics
        assert m.counter("planner_plans_built_total") == 1.0
        assert m.counter("planner_plan_reuse_total") == 1.0
        svc.create_stream("s1", "g")
        svc.ingest("s1", records(rng, 40))
        svc.register_continuous(pkg.ContinuousQuery("q1", "self_join", ("s1",)))
        outs.append(svc.poll())
        assert m.counter("planner_plans_built_total") == 2.0
    assert_same_results(*outs)
    _assert_same_counters(j, t)


def _admission_twins():
    j, t = _twins()
    rngs = []
    for svc, (pkg, cfg) in zip((j, t), PKGS):
        rng = np.random.default_rng(5)
        svc.create_group("g", cfg)
        for s in ("a", "b"):
            svc.create_stream(s, "g")
            svc.ingest(s, records(rng, 40))
        rngs.append(rng)
    return (j, t), rngs


def test_throttled_tenant_served_stale_last_fresh():
    (j, t), rngs = _admission_twins()
    polls = []
    for svc, rng, (pkg, _) in zip((j, t), rngs, PKGS):
        svc.register_continuous(pkg.ContinuousQuery("qa", "self_join", ("a",)))
        svc.register_continuous(pkg.ContinuousQuery("qb", "self_join", ("b",)))
        svc.register_continuous(pkg.ContinuousQuery("qt", "all_thresholds", ("a",)))
        first = svc.poll()
        svc.set_tenant_budget("a", 0)
        svc.ingest("a", records(rng, 40))
        svc.ingest("b", records(rng, 40))
        second = svc.poll()
        assert second["qa"].stale and not second["qb"].stale
        assert second["qa"].estimate == first["qa"].estimate
        assert second["qb"].estimate != first["qb"].estimate
        assert all(r.stale for r in second["qt"].values())
        svc.set_tenant_budget("a", 10)
        third = svc.poll()
        assert not third["qa"].stale and third["qa"].estimate != first["qa"].estimate
        assert svc.obs.metrics.counter("admission_rejections_total", tenant="a") == 2.0
        polls.append((first, second, third))
    for pj, pt in zip(*polls):
        assert_same_results(pj, pt)
    _assert_same_counters(j, t)


def test_priority_orders_throttling_within_tenant():
    (j, t), _ = _admission_twins()
    polls = []
    for svc, (pkg, _) in zip((j, t), PKGS):
        svc.register_continuous(pkg.ContinuousQuery("low", "self_join", ("a",), priority=2,
                                                    tenant="t"))
        svc.register_continuous(pkg.ContinuousQuery("high", "self_join", ("b",), priority=0,
                                                     tenant="t"))
        first = svc.poll()
        assert not first["low"].stale and not first["high"].stale
        svc.set_tenant_budget("t", 1)
        second = svc.poll()
        assert not second["high"].stale and second["low"].stale
        polls.append((first, second))
    for pj, pt in zip(*polls):
        assert_same_results(pj, pt)
    _assert_same_counters(j, t)


# -- launch coalescing ---------------------------------------------------

def _coalescing_service(pkg, cfg, obs, window):
    svc = _service(pkg, obs, planner=pkg.PlannerConfig(coalesce_window=window))
    svc.create_group("g", cfg)
    svc.create_stream("a", "g")
    svc.create_stream("b", "g")
    svc.register_continuous(pkg.ContinuousQuery("qa", "self_join", ("a",)))
    svc.register_continuous(pkg.ContinuousQuery("qj", "join", ("a", "b")))
    clock = [0.0]
    svc.planner._now = lambda: clock[0]
    return svc, clock


@pytest.mark.parametrize("window", [0.5, 0.0, 10.0])
def test_launch_coalescing(window):
    """In-window polls reuse the last launch (fresh, not stale); a zero
    window always recomputes; a poll with no new data is a cache hit, not
    a coalesced launch."""
    runs = []
    for (pkg, cfg), obs in zip(PKGS, bundles()):
        svc, clock = _coalescing_service(pkg, cfg, obs, window)
        rng = np.random.default_rng(0)
        out = []
        for now, fresh in ((0.0, True), (0.2, True), (0.3, False), (1.0, True)):
            clock[0] = now
            if fresh:
                for name in ("a", "b"):
                    svc.ingest(name, records(rng, 40))
            out.append(svc.poll())
        runs.append((svc, out))
    (j, out_j), (t, out_t) = runs
    for a, b in zip(out_j, out_t):
        assert_same_results(a, b)
    m = t.obs.metrics
    coalesced = m.counter_total("planner_coalesced_launches_total")
    assert coalesced == {0.5: 2.0, 0.0: 0.0, 10.0: 4.0}[window]
    if window == 0.5:
        assert out_t[1]["qa"].estimate == out_t[0]["qa"].estimate
        assert not out_t[1]["qa"].stale
        assert out_t[3]["qa"].estimate != out_t[0]["qa"].estimate
    if window == 0.0:
        assert out_t[1]["qa"].estimate != out_t[0]["qa"].estimate
    assert out_t[2]["qa"].estimate == out_t[1]["qa"].estimate
    _assert_same_counters(j, t)


def test_lru_eviction_keeps_the_hot_entry(monkeypatch):
    import repro.service.query as jq
    import repro_torch.service.query as tq
    monkeypatch.setattr(jq, "_CACHE_MAX_ENTRIES", 4)
    monkeypatch.setattr(tq, "_CACHE_MAX_ENTRIES", 4)
    iters = 10
    results = []
    for svc, (pkg, cfg) in zip(_twins(), PKGS):
        rng = np.random.default_rng(7)
        svc.create_group("hot", cfg)
        svc.create_stream("hot-s", "hot")
        svc.ingest("hot-s", records(rng, 40))
        svc.create_group("churn", cfg)
        svc.create_stream("churn-s", "churn")
        out = []
        for _ in range(iters):
            svc.ingest("churn-s", records(rng, 40))
            svc.flush()
            snap = svc.engine.snapshot()
            out.append((snap.self_join("hot-s"), snap.self_join("churn-s")))
        m = svc.obs.metrics
        assert m.counter("query_cache_misses_total", group="hot", kind="sjpc", op="self") == 1.0
        assert len(svc.engine._cache) <= 4 + 1
        assert m.counter_total("query_cache_evictions_total") == float(iters - 4)
        results.append((svc, out))
    (j, out_j), (t, out_t) = results
    for a, b in zip(out_j, out_t):
        for x, y in zip(a, b):
            assert_result_close(x, y)
    _assert_same_counters(j, t)


# -- join buckets by estimator instance ------------------------------------

class _TScaled(TSJPC):
    """A join-capable kind whose estimator_cfg changes the numbers: pairs of
    different instances must not share one batched join launch."""
    kind = "sjpc_scaled"

    def __init__(self, cfg, params=None, *, scale=1.0, **kw):
        super().__init__(cfg, params, **kw)
        self.scale = float(scale)

    def estimate_join_batch(self, states_a, states_b, **kw):
        table = super().estimate_join_batch(states_a, states_b, **kw)
        return table._replace(g=np.asarray(table.g) * self.scale)

    def estimate_join_ref(self, state_a, state_b, **kw):
        table = super().estimate_join_ref(state_a, state_b, **kw)
        return table._replace(g=np.asarray(table.g) * self.scale)


class _JScaled(JSJPC):
    kind = "sjpc_scaled"

    def __init__(self, cfg, params=None, *, scale=1.0, **kw):
        super().__init__(cfg, params, **kw)
        self.scale = float(scale)

    def estimate_join_batch(self, states_a, states_b, **kw):
        table = super().estimate_join_batch(states_a, states_b, **kw)
        return table._replace(g=np.asarray(table.g) * self.scale)

    def estimate_join_ref(self, state_a, state_b, **kw):
        table = super().estimate_join_ref(state_a, state_b, **kw)
        return table._replace(g=np.asarray(table.g) * self.scale)


def _t_scaled(sjpc_cfg, *, params=None, estimator_cfg=None, opts=None, device=None):
    return _TScaled(sjpc_cfg, params, device=device,
                    **{**(dict(opts) if opts else {}),
                       **(dict(estimator_cfg) if estimator_cfg else {})})


def _j_scaled(sjpc_cfg, *, params=None, estimator_cfg=None, opts=None):
    return _JScaled(sjpc_cfg, params, **{**(dict(opts) if opts else {}),
                                          **(dict(estimator_cfg) if estimator_cfg else {})})


@pytest.fixture
def scaled_kind():
    """The probe kind in both packages for one test, unregistered after."""
    test_mod.register("sjpc_scaled", _t_scaled)
    jest_mod.register("sjpc_scaled", _j_scaled)
    yield "sjpc_scaled"
    test_base._REGISTRY.pop("sjpc_scaled", None)
    jest_base._REGISTRY.pop("sjpc_scaled", None)


@pytest.mark.parametrize("use_planner", [True, False])
def test_mixed_instance_join_pairs_use_their_own_estimator(use_planner, scaled_kind):
    outs = []
    for svc, (pkg, cfg) in zip(_twins(use_planner=use_planner), PKGS):
        svc.create_group("g", cfg)
        rng = np.random.default_rng(6)
        for name in ("a1", "b1"):
            svc.create_stream(name, "g", estimator=scaled_kind)
        for name in ("a2", "b2"):
            svc.create_stream(name, "g", estimator=scaled_kind,
                              estimator_cfg={"scale": 100.0})
        for name in ("a1", "b1", "a2", "b2"):
            svc.ingest(name, records(rng, 40, card=3))
        svc.register_continuous(pkg.ContinuousQuery("j1", "join", ("a1", "b1")))
        svc.register_continuous(pkg.ContinuousQuery("j2", "join", ("a2", "b2")))
        out = svc.poll()
        for qname, pair in (("j1", ("a1", "b1")), ("j2", ("a2", "b2"))):
            solo = pkg.QueryEngine(svc.registry).snapshot().join(*pair)
            assert solo.estimate > 0
            assert out[qname].estimate == pytest.approx(solo.estimate, rel=1e-9)
        outs.append(out)
    assert_same_results(*outs)


@pytest.mark.parametrize("kind", ["sjpc", "reservoir"])
def test_replay_coordinate_independent_of_cohort_backlog(kind):
    """A stream's window and its ``flushes`` coordinate are the same with
    or without a busier cohort-mate sharing its flushes."""
    def run(with_busy):
        svc = _service(tsvc, None)
        svc.create_group("g", TCFG)
        svc.create_stream("solo", "g", estimator=kind)
        if with_busy:
            svc.create_stream("busy", "g", estimator=kind)
        rng, busy_rng = np.random.default_rng(8), np.random.default_rng(99)
        for _ in range(2):
            svc.ingest("solo", records(rng, 40))           # 2 rounds of 32
            if with_busy:
                svc.ingest("busy", records(busy_rng, 300))  # 10 rounds
            svc.flush()
        return svc.registry.stream("solo")

    alone, crowded = run(False), run(True)
    assert alone.flushes == crowded.flushes == 4
    assert_same_state(alone.window.total, crowded.window.total)
