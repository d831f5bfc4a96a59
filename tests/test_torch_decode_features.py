"""The decode engine's serving features in the port against the JAX
package's: hot swap, named models and the registry, tenant lanes and
quotas, warm bundles and ``compile_cache_size``, the autoscale callback,
and the trace spans of both serving engines.

The same small LM (vocab 48, 2 blocks, d_model 32, 2 heads, max_len 32)
is saved by the JAX package and loaded by the port; a second version is
the same weights scaled by 1.37 and shifted by 0.05, computed once in
numpy and given to both packages.  Tokens after a swap are the reference
plain engine's on the new weights (greedy, exact).  Where the reference
compiles one executable per entry point at load, the port's ``load()``
runs none on the CPU: it prepares only the fused horizon's CUDA graph on
a card, and ``compile_cache_size`` counts that graph (0 here).
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerDecodeAdapter as JAdapter
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
from deeplearning4j_tpu_torch.serving import (DecodeEngine, DecodeMetrics,
                                              ModelNotLoadedError, ModelRegistry,
                                              PoisonInputError, TenantOverloadedError,
                                              TenantTable)
from deeplearning4j_tpu_torch.utils.serializer import load_model

VOCAB, MAXLEN, PAGE = 48, 32, 8
SIZE = dict(vocab_size=VOCAB, n_layers=2, d_model=32, n_heads=2, max_len=MAXLEN)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _bump(a):
    a = np.asarray(a)
    return (a * np.float32(1.37) + np.float32(0.05)).astype(a.dtype)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jn = JLM(**SIZE, seed=5)
    path = str(tmp_path_factory.mktemp("ckpt") / "lm.zip")
    j_save(jn, path)
    net = load_model(path, device="cpu")
    adapter = TransformerDecodeAdapter(net)
    jad = JAdapter(jn)
    v1 = _map(adapter.params, lambda t: torch.from_numpy(_bump(t.numpy())))
    jv1 = _map(jad.params, _bump)
    return dict(jnet=jn, net=net, adapter=adapter, jadapter=jad, v1=v1, jv1=jv1, path=path)


def _engine(models, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("default_max_new", 8)
    return DecodeEngine(models["adapter"], device="cpu", **kw).load()


@pytest.fixture(scope="module")
def engine(models):
    eng = _engine(models)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def ref_v1_tokens(models):
    """The reference plain engine's greedy tokens on the second version."""
    jeng = JEngine(models["jadapter"], max_slots=3, page_size=PAGE).load()
    try:
        jeng.swap_model(models["jv1"], "v1")
        return jeng.generate([10, 11], max_new_tokens=20).tokens
    finally:
        jeng.shutdown()


def _ctr(eng, key):
    return eng.metrics.counter_value(key)


def _wait_prefill(eng, before):
    deadline = time.monotonic() + 30
    while _ctr(eng, "prefills") <= before:
        assert time.monotonic() < deadline, "prefill never landed"
        time.sleep(0.0005)


# -- hot swap -------------------------------------------------------------------------


def test_swap_moves_the_tag_and_never_mixes_versions(models, engine, ref_v1_tokens):
    ref_v0 = engine.generate([10, 11], max_new_tokens=20).tokens
    n0 = engine.compile_cache_size()
    pre = _ctr(engine, "prefills")
    with engine._lock:
        fut_old = engine.generate_async([10, 11], max_new_tokens=20)
    _wait_prefill(engine, pre)
    try:
        engine.swap_model(models["v1"], "v1")
        assert engine.current_tag == "v1"
        fut_new = engine.generate_async([10, 11], max_new_tokens=20)
        r_old, r_new = fut_old.result(timeout=60), fut_new.result(timeout=60)
        assert r_old.model_tag == "v0" and r_old.tokens == ref_v0
        assert r_new.model_tag == "v1" and r_new.tokens == ref_v1_tokens != ref_v0
        assert engine.compile_cache_size() == n0
    finally:
        engine.swap_model(models["adapter"], "v0")
    assert engine.generate([10, 11], max_new_tokens=20).tokens == ref_v0
    assert engine.metrics_snapshot()["versions"] == ["v0"]      # v1 dropped


def test_swap_rejects_a_mismatched_tree(models, engine):
    bad = _map(models["adapter"].params, lambda t: torch.zeros(tuple(t.shape) + (2,)))
    with pytest.raises(ValueError, match="mismatched"):
        engine.swap_model(bad, "vbad")
    with pytest.raises(ValueError, match="different parameter tree"):
        engine.swap_model({"embed": models["adapter"].params["embed"]}, "vbad")
    assert engine.current_tag == "v0"


def test_nan_swap_is_refused_per_request(models, engine):
    ref = engine.generate([12, 13], max_new_tokens=6).tokens
    ref_long = engine.generate([14, 15], max_new_tokens=24).tokens
    nan = _map(models["adapter"].params, lambda t: torch.full_like(t, float("nan")))
    p0 = _ctr(engine, "poison_isolated")
    pre = _ctr(engine, "prefills")
    fut_good = engine.generate_async([14, 15], max_new_tokens=24)
    _wait_prefill(engine, pre)
    try:
        engine.swap_model(nan, "vnan")
        with pytest.raises(PoisonInputError):
            engine.generate([16, 17], max_new_tokens=6)
        assert fut_good.result(timeout=60).tokens == ref_long
    finally:
        engine.swap_model(models["adapter"], "v0")
    assert _ctr(engine, "poison_isolated") > p0
    assert engine.generate([12, 13], max_new_tokens=6).tokens == ref


# -- named models and the registry -------------------------------------------------------


def test_named_models_route_and_unknown_ones_fail_typed(models, engine, ref_v1_tokens):
    engine.add_model("m2", models["v1"], tag="m2:v1")
    try:
        assert engine.has_model("m2") and engine.has_model(None)
        assert engine.placed_models() == {"": "v0", "m2": "m2:v1"}
        r = engine.generate([10, 11], max_new_tokens=20, model="m2")
        assert r.model_tag == "m2:v1" and r.tokens == ref_v1_tokens
        assert engine.model_last_used("m2") is not None
        with pytest.raises(ValueError, match="already placed"):
            engine.add_model("m2", models["v1"])
        with pytest.raises(ModelNotLoadedError):
            engine.generate_async([1], model="nope").result(timeout=10)
    finally:
        assert engine.remove_model("m2") is True
    assert engine.remove_model("m2") is False and not engine.has_model("m2")
    with pytest.raises(ModelNotLoadedError):
        engine.generate_async([1], model="m2").result(timeout=10)
    assert engine.metrics_snapshot()["versions"] == ["v0"]


def test_registry_placement_and_alias_moves(models, tmp_path, ref_v1_tokens):
    from deeplearning4j_tpu_torch.utils.serializer import save_model

    reg = ModelRegistry(device="cpu")
    v_a = reg.load("lm", models["path"])
    bumped = load_model(models["path"], device="cpu")
    bumped.params = _map(models["net"].params, lambda t: torch.from_numpy(_bump(t.numpy())))
    v1_path = str(tmp_path / "v1.zip")
    save_model(bumped, v1_path)
    v_b = reg.load("lm", v1_path)
    reg.set_alias("lm", "prod", v_a)
    eng = _engine(models)
    try:
        eng.attach_registry(reg, "lm", "prod")
        assert eng.current_tag == f"lm:v{v_a}"
        ref_v0 = eng.generate([10, 11], max_new_tokens=20).tokens
        reg.set_alias("lm", "prod", v_b)
        assert eng.current_tag == f"lm:v{v_b}"
        assert eng.generate([10, 11], max_new_tokens=20).tokens == ref_v1_tokens != ref_v0
        eng.add_model_from_registry(reg, "lm", v_a)       # the old version, by name
        assert eng.placed_models() == {"": f"lm:v{v_b}", "lm": f"lm:v{v_a}"}
        assert eng.generate([10, 11], max_new_tokens=20, model="lm").tokens == ref_v0
        assert _ctr(eng, "model_loads") == 1 and _ctr(eng, "swaps") == 2
    finally:
        eng.shutdown()


# -- tenants ------------------------------------------------------------------------------


def test_tenant_quota_sheds_typed_on_decode(models):
    t = TenantTable.from_specs([{"tenant": "free", "quota_concurrent": 1},
                                {"tenant": "gold", "weight": 3.0}])
    eng = _engine(models, tenants=t)
    try:
        with eng._lock:          # the loop cannot finish anything meanwhile
            held = eng.generate_async([1, 2], max_new_tokens=4, tenant="free")
            with pytest.raises(TenantOverloadedError) as e:
                eng.generate_async([1, 2], max_new_tokens=4, tenant="free")
            gold = eng.generate_async([1, 2], max_new_tokens=4, tenant="gold")
        assert e.value.tenant == "free" and e.value.reason == "quota"
        assert held.result(timeout=30).tokens == gold.result(timeout=30).tokens
        snap = eng.metrics_snapshot()
        assert snap["tenants"]["free"]["shed"] == 1
        assert eng.metrics.counter_value("shed", tenant="free") == t.shed_count("free") == 1
    finally:
        eng.shutdown()
    assert t.concurrent("free") == t.concurrent("gold") == 0


def _lane_order(engine, prog_prefills):
    """Completion order of a scripted burst: a blocker holds the one slot,
    then four 'b' and two 'a' requests queue; one slot serves them in
    admission order."""
    order = []
    blocker = engine.generate_async([1], max_new_tokens=24, tenant="c")
    deadline = time.monotonic() + 30
    while prog_prefills() < 1:
        assert time.monotonic() < deadline
        time.sleep(0.001)
    with engine._lock:
        futs = [(t, engine.generate_async([2, 3], max_new_tokens=2, tenant=t))
                for t in "bbbbaa"]
    for t, f in futs:
        f.add_done_callback(lambda _, t=t: order.append(t))
    blocker.result(timeout=60)
    for _, f in futs:
        f.result(timeout=60)
    return order


def test_tenant_lanes_admit_in_the_references_order(models):
    from deeplearning4j_tpu.serving import TenantTable as JTable

    rows = [{"tenant": "a", "weight": 3.0}, {"tenant": "b"}, {"tenant": "c"}]
    eng = _engine(models, max_slots=1, tenants=TenantTable.from_specs(rows))
    jeng = JEngine(models["jadapter"], max_slots=1, page_size=PAGE,
                   tenants=JTable.from_specs(rows)).load()
    try:
        got = _lane_order(eng, lambda: _ctr(eng, "prefills"))
        want = _lane_order(jeng, lambda: jeng.metrics.counter_value("prefills"))
        assert got == want and got.index("a") < 3
    finally:
        eng.shutdown()
        jeng.shutdown()


# -- warm bundles and prepared programs -----------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(role="prefill"), dict(role="decode"),
                                dict(prefix_cache=True), dict(decode_horizon=2),
                                dict(speculate_k=2, draft=True)],
                         ids=["unified", "prefill", "decode", "prefix", "fused", "spec"])
def test_load_runs_no_program_and_prepares_nothing_on_the_cpu(models, kw):
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft_model"] = models["adapter"]
    eng = DecodeEngine(models["adapter"], max_slots=3, page_size=PAGE, default_max_new=4,
                       device="cpu", **kw)
    calls = []

    def recorded(prog, who):
        wrap = lambda name, fn: (lambda *a, **k: (calls.append((who, name)), fn(*a, **k))[1])
        return prog._replace(**{f: wrap(f, getattr(prog, f)) for f in prog._fields
                                if callable(getattr(prog, f))})
    eng.program = recorded(eng.program, "target")
    if eng._draft_program is not None:
        eng._draft_program = recorded(eng._draft_program, "draft")
    eng.load()
    try:
        assert calls == [] and eng._prepared == {} and eng.step_multi_graph is None
        assert eng.compile_cache_size() == 0 == eng.metrics_snapshot()["compile_cache_size"]
        if eng.role != "decode":
            eng.generate_async([1, 2, 3], max_new_tokens=4).result(timeout=60)
            assert ("target", "prefill") in calls
        assert eng.compile_cache_size() == 0
    finally:
        eng.shutdown()


def test_warm_bundle_round_trip_and_flat_cache(models, tmp_path):
    import warnings

    from deeplearning4j_tpu_torch.serving.warmcache import load_bundle

    bundle = str(tmp_path / "lm.zip.warm")
    with pytest.raises(RuntimeError, match="load"):
        DecodeEngine(models["adapter"], max_slots=2, page_size=PAGE,
                     device="cpu").save_warmup_bundle(bundle)
    cold = _engine(models, max_slots=2, decode_horizon=2)
    try:
        ref = cold.generate([1, 2, 3], max_new_tokens=6).tokens
        n = cold.compile_cache_size()
        assert cold.save_warmup_bundle(bundle) == bundle
    finally:
        cold.shutdown()
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # a usable bundle: no refusal warning
        assert load_bundle(bundle, tag="v0", device=torch.device("cpu")) == {}
        warm = DecodeEngine(models["adapter"], max_slots=2, page_size=PAGE,
                            decode_horizon=2, device="cpu").load(warm_bundle=bundle)
    try:
        assert warm.metrics.counter_value("bundle_misses") == 0
        assert warm.metrics.counter_value("bundle_hits") == n == warm.compile_cache_size() == 0
        assert warm.generate([1, 2, 3], max_new_tokens=6).tokens == ref
        for prompt in ([1], [1, 2, 3], list(range(1, 9)), list(range(1, 18))):
            warm.generate(prompt, max_new_tokens=3)
        warm.generate([5, 6], max_new_tokens=4, temperature=0.9, top_k=5, top_p=0.9, seed=3)
        warm.generate([5, 6], max_new_tokens=4, echo_logits=True)
        for f in [warm.generate_async([i + 1], max_new_tokens=4) for i in range(3)]:
            f.result(timeout=60)
        assert warm.compile_cache_size() == n
    finally:
        warm.shutdown()


def test_injected_metrics_and_clock(models):
    m = DecodeMetrics()
    now = [100.0]
    eng = _engine(models, metrics=m, clock=lambda: now[0])
    try:
        assert eng.metrics is m
        r = eng.generate([1, 2], max_new_tokens=3)
        assert r.ttft_ms == 0.0 and m.counter_value("tokens_out") == 3
    finally:
        eng.shutdown()


# -- autoscale ------------------------------------------------------------------------------


class _Scripted:
    def __init__(self, decisions):
        self.decisions = list(decisions)

    def observe(self, queue_depth, inflight, replicas, shed_delta=0):
        return self.decisions.pop(0) if self.decisions else 0


def test_scripted_decisions_drive_the_callback(models):
    calls = []
    eng = _engine(models, max_slots=2)
    try:
        eng.enable_autoscale(lambda d, n: calls.append((d, n)),
                             autoscaler=_Scripted([1, 1, -1]), interval_s=0.0)
        deadline = time.monotonic() + 10.0
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert calls == [(1, 2), (1, 3), (-1, 2)]
        assert _ctr(eng, "scale_ups") == 2 and _ctr(eng, "scale_downs") == 1
        assert len(eng.generate([4, 5], max_new_tokens=3).tokens) == 3
    finally:
        eng.shutdown()


def test_queue_depth_scales_up_then_down_under_a_scripted_clock(models):
    now = [0.0]
    calls = []
    eng = _engine(models, max_slots=1, clock=lambda: now[0])
    try:
        eng.enable_autoscale(lambda d, n: calls.append((d, n)), min_replicas=1,
                             max_replicas=3, up_load=2.0, down_load=0.5, up_ticks=1,
                             down_ticks=1, cooldown_s=0.0, interval_s=1.0)
        with eng._lock:
            futs = [eng.generate_async([1, 2], max_new_tokens=2) for _ in range(6)]
            now[0] += 5.0
            eng._autoscale_tick()          # 6 queued over 1 replica: +1
        for f in futs:
            f.result(timeout=60)
        with eng._lock:
            now[0] += 5.0
            eng._autoscale_tick()          # idle: -1
        assert calls == [(1, 2), (-1, 1)]
    finally:
        eng.shutdown()


# -- trace spans: the reference's names, categories and argument keys -------------------------


def _span_multiset(events):
    return Counter((e["name"], e["cat"], tuple(sorted(e.get("args", {}))))
                   for e in events if e["name"].startswith("serve/"))


def _failing_once(fn):
    state = {"n": 0}

    def call(*a, **kw):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("injected step failure")
        return fn(*a, **kw)
    return call


def _decode_script(eng, v1, swap_back, patch_step):
    eng.generate([1, 2, 3], max_new_tokens=3)
    eng.swap_model(v1, "v1")
    eng.generate([1, 2, 3], max_new_tokens=3)
    eng.swap_model(swap_back, "v0")
    eng.add_model("m2", v1, tag="m2:v1")
    eng.generate([4, 5], max_new_tokens=2, model="m2")
    eng.remove_model("m2")
    patch_step()
    eng.generate([6, 7], max_new_tokens=3)
    eng.begin_drain()


def test_decode_spans_are_the_references(models):
    from deeplearning4j_tpu.obs import trace as jtrace
    from deeplearning4j_tpu_torch.obs import trace as ttrace

    rec = ttrace.enable_tracing()
    try:
        eng = DecodeEngine(models["adapter"], max_slots=2, page_size=PAGE, device="cpu").load()

        def patch():
            eng.program = eng.program._replace(step=_failing_once(eng.program.step))
        try:
            _decode_script(eng, models["v1"], models["adapter"], patch)
        finally:
            eng.shutdown()
        got = _span_multiset(rec.events())
    finally:
        ttrace.disable_tracing()
    jrec = jtrace.enable_tracing()
    try:
        jeng = JEngine(models["jadapter"], max_slots=2, page_size=PAGE).load()

        def jpatch():
            jeng._compiled[("step",)] = _failing_once(jeng._compiled[("step",)])
        try:
            _decode_script(jeng, models["jv1"], models["jadapter"], jpatch)
        finally:
            jeng.shutdown()
        want = _span_multiset(jrec.events())
    finally:
        jtrace.disable_tracing()
    assert got == want
    names = {k[0] for k in got}
    assert {"serve/warmup", "serve/prefill", "serve/decode_step", "serve/request",
            "serve/swap", "serve/model_load", "serve/model_evict", "serve/replica_crash",
            "serve/retry", "serve/drain"} <= names


class _Conf:
    pass


def _const_models():
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    class Const:
        def __init__(self, val, it):
            self.val = float(val)
            self.conf = _Conf()
            self.conf.input_type = it
            self.fail = False

        def output(self, x):
            if self.fail:
                self.fail = False
                raise RuntimeError("injected forward failure")
            return np.full((x.shape[0], 1), self.val, np.float32)

    return [(Const, JInputType.feed_forward(3)), (Const, InputType.feed_forward(3))]


def _predict_script(eng, mk):
    x = np.zeros((1, 3), np.float32)
    eng.output(x)
    eng.swap_model(mk(2.0), "v1")
    eng.output(x)
    eng.add_model("m2", mk(3.0), input_shape=(3,))
    eng.output(x, model="m2")
    eng.remove_model("m2")
    flaky = mk(4.0)
    eng.swap_model(flaky, "v2")
    flaky.fail = True
    eng.output(x)                     # fails once on one replica, retried on the other
    eng.begin_drain()


def test_predict_spans_are_the_references():
    from deeplearning4j_tpu.obs import trace as jtrace
    from deeplearning4j_tpu.serving import Engine as JPredict
    from deeplearning4j_tpu_torch.obs import trace as ttrace
    from deeplearning4j_tpu_torch.serving import Engine

    (JConst, jit), (TConst, tit) = _const_models()
    out = []
    for trace, cls, mk in ((ttrace, lambda m: Engine(m, max_batch=2, slo_ms=60_000,
                                                     replicas=2, device="cpu"),
                            lambda v: TConst(v, tit)),
                           (jtrace, lambda m: JPredict(m, max_batch=2, slo_ms=60_000,
                                                       replicas=2),
                            lambda v: JConst(v, jit))):
        rec = trace.enable_tracing()
        try:
            eng = cls(mk(1.0)).load(input_shape=(3,))
            try:
                _predict_script(eng, mk)
            finally:
                eng.shutdown()
            out.append(_span_multiset(rec.events()))
        finally:
            trace.disable_tracing()
    got, want = out
    assert got == want
    assert {"serve/warmup", "serve/queue_wait", "serve/forward", "serve/request",
            "serve/batch", "serve/batch_form", "serve/swap", "serve/model_load",
            "serve/model_evict", "serve/retry", "serve/drain"} <= {k[0] for k in got}
