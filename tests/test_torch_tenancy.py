"""Multi-tenant admission (``deeplearning4j_tpu_torch/serving/tenancy.py``
and the batcher's lanes) held against the reference's classes: the same
scripted clock and calls give the same decisions, errors and snapshots
from the port's copy and from ``deeplearning4j_tpu/serving/tenancy.py``,
and the batchers drain the same tenants in the same order.  Then the
reference's race and fair-share scenarios on the port's batcher and
engine.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.serving import DynamicBatcher as JBatcher
from deeplearning4j_tpu.serving import TenantConfig as JConfig
from deeplearning4j_tpu.serving import TenantTable as JTable
from deeplearning4j_tpu_torch.serving import (DynamicBatcher, Engine, OverloadedError,
                                              ServingMetrics, TenantConfig,
                                              TenantOverloadedError, TenantTable)

ROWS = [{"tenant": "gold", "weight": 3.0, "quota_concurrent": 4, "slo_ms": 250},
        {"tenant": "bronze", "weight": 1.0, "quota_qps": 2.0, "burst": 3},
        {"tenant": "gold", "model": "m2", "weight": 3.0, "quota_concurrent": 1},
        {"tenant": "blocky", "quota_concurrent": 1, "admission": "block"}]


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(rows=ROWS, **kw):
    jc, tc = _Clock(), _Clock()
    return (JTable.from_specs(rows, clock=jc, **kw), jc,
            TenantTable.from_specs(rows, clock=tc, **kw), tc)


# -- the table against the reference's ------------------------------------------------------


def test_config_validation_and_dict_round_trip_are_the_references():
    bad = [dict(tenant=""), dict(tenant="a", weight=0), dict(tenant="a", slo_ms=0),
           dict(tenant="a", quota_qps=-1), dict(tenant="a", quota_concurrent=0),
           dict(tenant="a", admission="maybe"), dict(tenant="a", qps=5), dict(weight=2.0)]
    for row in bad:
        with pytest.raises(ValueError) as jerr:
            JConfig.from_dict(row)
        with pytest.raises(ValueError) as terr:
            TenantConfig.from_dict(row)
        assert str(terr.value) == str(jerr.value)
    for row in ROWS + [{"tenant": "q", "quota_qps": 0.25}]:
        assert TenantConfig.from_dict(row).to_dict() == JConfig.from_dict(row).to_dict()
        assert TenantConfig.from_dict(row).burst == JConfig.from_dict(row).burst


def test_scripted_admissions_match_the_reference_call_for_call():
    """One script of admits, releases, sheds and clock moves through both
    tables: every decision, error and snapshot is the reference's."""
    jt, jc, tt, tc = _both(default=None)
    script = []
    rng = np.random.default_rng(0)
    for step in range(300):
        t = ["gold", "bronze", "blocky", "stranger", ""][rng.integers(0, 5)]
        model = [None, "m2"][rng.integers(0, 2)]
        op = ["admit", "admit", "release", "shed", "tick"][rng.integers(0, 5)]
        script.append((step, t, model, op, float(rng.uniform(0, 0.4))))
    for step, t, model, op, dt in script:
        if op == "admit":
            assert tt.try_admit(t, model) == jt.try_admit(t, model), step
        elif op == "release":
            tt.release(t)
            jt.release(t)
        elif op == "shed" and t:
            te, je = tt.shed(t, model, reason="quota_qps"), jt.shed(t, model, reason="quota_qps")
            assert isinstance(te, TenantOverloadedError) and isinstance(te, OverloadedError)
            assert (str(te), te.tenant, te.shed_count, te.reason) == \
                (str(je), je.tenant, je.shed_count, je.reason)
        else:
            tc.t += dt
            jc.t += dt
        assert tt.snapshot() == jt.snapshot(), step
    for t in ("gold", "bronze", "blocky", "stranger", ""):
        assert tt.concurrent(t) == jt.concurrent(t)
        assert tt.shed_count(t) == jt.shed_count(t)
        assert tt.weight(t) == jt.weight(t)
        assert tt.admission_for(t) == jt.admission_for(t)
        assert tt.slo_ms_for(t, "m2") == jt.slo_ms_for(t, "m2")
    assert tt.tenants() == jt.tenants()


def test_resolve_precedence_is_the_references():
    rows = [{"tenant": "a", "weight": 1.0}, {"tenant": "a", "model": "m2", "weight": 3.0}]
    dflt = {"tenant": "anyone", "weight": 7.0}
    tt = TenantTable.from_specs(rows, default=TenantConfig.from_dict(dflt))
    jt = JTable.from_specs(rows, default=JConfig.from_dict(dflt))
    for t, m in (("a", "m2"), ("a", "m1"), ("a", None), ("stranger", "m1")):
        assert tt.resolve(t, m).to_dict() == jt.resolve(t, m).to_dict()
    assert TenantTable.from_specs(rows[:1]).resolve("stranger") is None


# -- the batcher's lanes against the reference's --------------------------------------------


def _drain_order(batcher_cls, table, subs, max_batch):
    b = batcher_cls(max_batch=max_batch, slo_ms=10_000, max_queue=10_000, max_wait_ms=0.0,
                    tenants=table)
    x = np.zeros((1, 4), np.float32)
    for tenant, rows, model in subs:
        b.submit(np.zeros((rows, 4), np.float32) if rows > 1 else x, tenant=tenant,
                 model=model)
    order = []
    while b.qsize():
        order.append([(r.tenant, r.rows, r.model) for r in b.next_batch()])
    b.close(fail_pending=True)
    return order


@pytest.mark.parametrize("max_batch", [1, 2, 4])
def test_weighted_fair_drain_order_is_the_references(max_batch):
    rows = [{"tenant": "heavy", "weight": 2.0}, {"tenant": "light", "weight": 1.0},
            {"tenant": "tiny", "weight": 0.5}]
    rng = np.random.default_rng(max_batch)
    subs = [(["heavy", "light", "tiny", ""][rng.integers(0, 4)], int(rng.integers(1, 3)),
             [None, "m2"][rng.integers(0, 2)]) for _ in range(60)]
    want = _drain_order(JBatcher, JTable.from_specs(rows), subs, max_batch)
    got = _drain_order(DynamicBatcher, TenantTable.from_specs(rows), subs, max_batch)
    assert got == want
    # a batch never mixes models
    assert all(len({m for _, _, m in batch}) == 1 for batch in got)


def test_weighted_fair_drain_is_proportional():
    t = TenantTable.from_specs([{"tenant": "heavy", "weight": 2.0},
                                {"tenant": "light", "weight": 1.0}])
    b = DynamicBatcher(max_batch=1, slo_ms=10_000, max_queue=10_000, max_wait_ms=0.0,
                       tenants=t)
    x = np.zeros((1, 4), np.float32)
    for _ in range(30):
        b.submit(x, tenant="heavy")
        b.submit(x, tenant="light")
    order = [r.tenant for _ in range(30) for r in b.next_batch()]
    assert 1.5 <= order.count("heavy") / max(order.count("light"), 1) <= 2.5
    assert b.tenant_qsize("heavy") + b.tenant_qsize("light") == 30
    b.close(fail_pending=True)


def test_burst_backlog_does_not_delay_victim():
    t = TenantTable.from_specs([{"tenant": "burst"}, {"tenant": "victim"}])
    b = DynamicBatcher(max_batch=2, slo_ms=10_000, max_queue=10_000, max_wait_ms=0.0,
                       tenants=t)
    x = np.zeros((1, 4), np.float32)
    for _ in range(100):
        b.submit(x, tenant="burst")
    b.submit(x, tenant="victim")
    served = []
    while len(served) < 6:
        served.extend(r.tenant for r in b.next_batch())
    assert "victim" in served[:4]
    b.close(fail_pending=True)


def test_shed_counts_land_on_the_tenant_slice():
    m = ServingMetrics()
    t = TenantTable.from_specs([{"tenant": "a", "quota_concurrent": 1}])
    b = DynamicBatcher(max_batch=4, slo_ms=10_000, tenants=t, metrics=m)
    x = np.zeros((1, 4), np.float32)
    b.submit(x, tenant="a")
    with pytest.raises(TenantOverloadedError) as e:
        b.submit(x, tenant="a")
    assert e.value.tenant == "a" and e.value.reason == "quota"
    assert m.counter_value("shed") == 1 and m.counter_value("shed", tenant="a") == 1
    assert t.shed_count("a") == 1
    b.close(fail_pending=True)


# -- races ----------------------------------------------------------------------------------


def test_16_threads_racing_submit_admit_exactly_the_caps():
    caps = {"t0": 5, "t1": 3, "t2": 7}
    t = TenantTable.from_specs([{"tenant": k, "quota_concurrent": v} for k, v in caps.items()])
    b = DynamicBatcher(max_batch=4, slo_ms=10_000, max_queue=10_000, tenants=t)
    x = np.zeros((1, 4), np.float32)
    n_threads, per_thread = 16, 9
    start = threading.Barrier(n_threads)
    admitted, shed, lock = [], [], threading.Lock()

    def pump(tid):
        tenant = f"t{tid % 3}"
        start.wait()
        for _ in range(per_thread):
            try:
                fut = b.submit(x, tenant=tenant)
            except TenantOverloadedError as e:
                with lock:
                    shed.append((tenant, e))
            else:
                with lock:
                    admitted.append((tenant, fut))

    threads = [threading.Thread(target=pump, args=(i,)) for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    for k, cap in caps.items():
        assert sum(1 for tt, _ in admitted if tt == k) == cap
        assert t.concurrent(k) == cap
        assert t.shed_count(k) == sum(1 for tt, _ in shed if tt == k)
    assert len(admitted) + len(shed) == n_threads * per_thread
    assert all(e.tenant == tenant for tenant, e in shed)
    b.close(fail_pending=True)
    assert all(f.done() for _, f in admitted)
    assert all(t.concurrent(k) == 0 for k in caps)


def test_drained_tenants_queued_futures_resolve_typed():
    t = TenantTable.from_specs([{"tenant": "a", "quota_concurrent": 8}])
    b = DynamicBatcher(max_batch=4, slo_ms=10_000, max_queue=100, tenants=t)
    x = np.zeros((1, 4), np.float32)
    futs = [b.submit(x, tenant="a") for _ in range(6)]
    b.begin_drain()
    with pytest.raises(OverloadedError):
        b.submit(x, tenant="a")
    b.close(fail_pending=True)
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=1)
    assert t.concurrent("a") == 0


def test_block_admission_waits_for_a_released_slot():
    t = TenantTable.from_specs([{"tenant": "a", "quota_concurrent": 1, "admission": "block"}])
    b = DynamicBatcher(max_batch=4, slo_ms=10_000, tenants=t)
    x = np.zeros((1, 4), np.float32)
    f1 = b.submit(x, tenant="a")
    got = []
    th = threading.Thread(target=lambda: got.append(b.submit(x, tenant="a")), daemon=True)
    th.start()
    th.join(timeout=0.2)
    assert not got                         # blocked on the tenant's cap
    batch = b.next_batch()
    batch[0].future.set_result(np.zeros((1, 1)))
    th.join(timeout=5)
    assert got and f1.done() and t.concurrent("a") == 1
    b.close(fail_pending=True)


# -- on the engine ----------------------------------------------------------------------------


class _Conf:
    class input_type:                                   # noqa: N801
        @staticmethod
        def batch_shape(n):
            return (n, 3)


class _Const:
    conf = _Conf()

    def __init__(self, val):
        self.val = float(val)

    def output(self, x):
        return np.full((x.shape[0], 1), self.val, np.float32)


class _Gated(_Const):
    """Holds every forward until ``gate`` is set."""

    def __init__(self, val):
        super().__init__(val)
        self.gate = threading.Event()

    def output(self, x):
        self.gate.wait(30)
        return super().output(x)


def test_engine_tenant_quota_sheds_typed_and_counts_per_tenant():
    t = TenantTable.from_specs([{"tenant": "gold", "weight": 3.0},
                                {"tenant": "free", "quota_concurrent": 2}])
    model = _Gated(1.0)
    eng = Engine(model, max_batch=4, slo_ms=60_000, device="cpu", tenants=t)
    model.gate.set()
    eng.load()
    model.gate.clear()
    try:
        x = np.zeros((1, 3), np.float32)
        held = [eng.output_async(x, tenant="free") for _ in range(2)]
        with pytest.raises(TenantOverloadedError) as e:
            eng.output_async(x, tenant="free")
        assert e.value.tenant == "free" and e.value.reason == "quota"
        assert e.value.shed_count == 1
        gold = eng.output_async(x, tenant="gold")
        model.gate.set()
        assert all(float(f.result(timeout=30)[0, 0]) == 1.0 for f in held + [gold])
        snap = eng.metrics_snapshot()
        assert snap["tenants"]["free"]["shed"] == 1 and snap["tenants"]["gold"]["completed"] == 1
        assert eng.metrics.counter_value("shed", tenant="free") == t.shed_count("free") == 1
    finally:
        model.gate.set()
        eng.shutdown()
    assert t.concurrent("free") == t.concurrent("gold") == 0


def test_engine_burst_tenant_does_not_starve_the_other():
    """One tenant bursts 64 requests at weight 1 beside a weight-3 tenant's
    8: every request completes, and the light tenant's requests are served
    before the burst's tail."""
    t = TenantTable.from_specs([{"tenant": "a", "weight": 3.0}, {"tenant": "b"}])
    eng = Engine(_Const(2.0), max_batch=2, slo_ms=60_000, device="cpu", tenants=t,
                 max_wait_ms=0.0).load()
    try:
        x = np.zeros((1, 3), np.float32)
        burst = [eng.output_async(x, tenant="b") for _ in range(64)]
        victim = [eng.output_async(x, tenant="a") for _ in range(8)]
        for f in burst + victim:
            assert float(f.result(timeout=60)[0, 0]) == 2.0
        ids = {id(f): "a" for f in victim}
        order = [ids.get(i, "b") for e in eng.batch_log for i in e["request_ids"]]
        assert order.index("a") < 40 and len(order) == 72
        assert t.concurrent("a") == t.concurrent("b") == 0
    finally:
        eng.shutdown()
