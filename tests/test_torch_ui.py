"""The port's training UI (``deeplearning4j_tpu_torch.ui``) against the
reference package's on the CPU: storages that read each other's files,
``StatsListener`` records equal to the reference's on the same parameter
sequences (histogram counts and edges, min and max equal; the other
moments within rtol 1e-6, the mean within 1e-6 x the mean magnitude; update
ratios within rtol 2e-6), identical dashboard and embedding HTML from the
same records, the server's storage routes (``/remote``, ``/trace``,
``/metrics`` sessions, the index, ``/train``), the remote router's drop
accounting, ``profile_trace`` on the CPU, the input pipeline's record and
``train --dashboard`` in both CLIs."""

import json
import os
import re
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ui as jui
import deeplearning4j_tpu_torch.ui as tui
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu_torch.ui import stats as tstats


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ticks(start=1000.0):
    it = iter(float(t) for t in range(int(start), int(start) + 10_000))
    return lambda: next(it)


class _Model:
    """A stand-in network: ``params`` (a list of per-layer dicts, or a dict
    of them as a graph holds) and the layer names in ``conf.layers``."""

    def __init__(self, params, names=()):
        self.params = params
        self.conf = types.SimpleNamespace(
            layers=[types.SimpleNamespace(name=n) for n in names])


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _param_sequence(steps=4, graph=False, seed=0):
    """Parameter trees a short run would pass through: random leaves,
    zeros, a constant leaf, values placed on histogram edges and a leaf
    that does not move (a zero delta)."""
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal((6, 8)).astype(np.float32)
    on_edges = np.concatenate([np.histogram_bin_edges(w0, 20).astype(np.float32),
                               rng.standard_normal(11).astype(np.float32)])
    layers = [{"W": w0, "b": np.zeros(8, np.float32)},
              {"W": rng.standard_normal((8, 3)).astype(np.float32) * 1e-3,
               "gamma": np.ones(3, np.float32), "edges": on_edges},
              {}]
    seq = []
    for t in range(steps):
        step = []
        for i, p in enumerate(layers):
            q = {}
            for k, v in p.items():
                moved = v if k == "gamma" else (
                    v + np.float32(0.01 * t) * rng.standard_normal(v.shape).astype(np.float32))
                q[k] = moved.astype(np.float32)
            step.append(q)
        seq.append(step)
    if graph:
        seq = [{"dense": s[0], "out": s[1], "pool": s[2]} for s in seq]
    return seq


def _close_stats(got, want, where, rtol=1e-6):
    assert got.keys() == want.keys(), where
    if not want:
        return
    assert got["min"] == want["min"] and got["max"] == want["max"], where
    for k in ("std", "mean_magnitude"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=f"{where} {k}")
    assert abs(got["mean"] - want["mean"]) <= rtol * max(want["mean_magnitude"], 1e-30), where
    if "histogram" in want:
        assert got["histogram"] == want["histogram"], where
        assert got["histogram_edges"] == want["histogram_edges"], where


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("iteration", "timestamp", "relative_time", "score", "iterations_per_sec",
                  "epoch_done"):
            assert g.get(k) == w.get(k), k
        for section in ("parameters", "updates"):
            assert list(g.get(section, {})) == list(w.get(section, {}))
            for pid, st in w.get(section, {}).items():
                _close_stats(g[section][pid], st, f"{section} {pid} @ {w['iteration']}")
        for pid, r in w.get("update_ratios", {}).items():
            np.testing.assert_allclose(g["update_ratios"][pid], r, rtol=2e-6, err_msg=pid)


def _listen(pkg, seq, as_tensors, graph=False, **kw):
    storage = pkg.InMemoryStatsStorage()
    lst = pkg.StatsListener(storage, clock=_ticks(), collect_memory=False,
                            collect_input_stats=False, **kw)
    names = [] if graph else ["dense", None, "pool"]
    for i, params in enumerate(seq):
        lst.iteration_done(_Model(_as_tensors(params) if as_tensors else params, names), i,
                           0.5 / (i + 1))
    lst.epoch_done(types.SimpleNamespace(iteration=len(seq)), 1)
    return storage.get_updates(lst.session_id)


@pytest.mark.parametrize("kw", [{}, {"update_frequency": 2}, {"collect_histograms": False},
                                {"histogram_bins": 7}, {"graph": True}, {"chunked": True}],
                         ids=["default", "every_2", "no_histograms", "bins_7", "graph",
                              "small_chunks_and_groups"])
def test_records_are_the_references_on_the_same_parameters(kw, monkeypatch):
    """The last case makes the device route reduce in chunks of 7 elements
    and pass over groups of at most 40, so leaves span many chunks and
    each record many groups."""
    kw = dict(kw)
    graph = kw.pop("graph", False)
    if kw.pop("chunked", False):
        monkeypatch.setattr(tstats, "_CHUNK", 7)
        monkeypatch.setattr(tstats, "_GROUP", 40)
    seq = _param_sequence(graph=graph)
    want = _listen(jui, seq, False, graph=graph, **kw)
    got = _listen(tui, seq, True, graph=graph, **kw)
    _assert_records_equal(got, want)
    assert any("updates" in r for r in got)
    assert "layer_1/edges" in got[0]["parameters"] or "out/edges" in got[0]["parameters"]


def test_mixed_dtypes_and_a_changed_structure_are_the_references():
    """bfloat16 and float64 leaves beside float32 ones (each delta taken in
    the leaf's own dtype, as the reference subtracts its arrays), and a
    parameter tree that gains and loses leaves between records (deltas only
    for the leaves the last record had)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    bf = np.asarray(jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16))
    trees = []
    for t in range(4):
        shift = np.float32(0.03 * t)
        layer = {"W": rng.standard_normal((4, 6)).astype(np.float32) + shift,
                 "h": rng.standard_normal(9) + float(shift),
                 "bf": (bf.astype(np.float32) + shift).astype(bf.dtype)}
        if t == 2:
            layer["extra"] = np.arange(5, dtype=np.float32) * shift
            del layer["h"]
        trees.append([layer])

    def tensor(a):
        if a.dtype == bf.dtype:
            return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    want = _listen(jui, trees, False)
    storage = tui.InMemoryStatsStorage()
    lst = tui.StatsListener(storage, clock=_ticks(), collect_memory=False,
                            collect_input_stats=False)
    for i, tree in enumerate(trees):
        lst.iteration_done(_Model([{k: tensor(v) for k, v in tree[0].items()}], ["dense"]), i,
                           0.5 / (i + 1))
    lst.epoch_done(types.SimpleNamespace(iteration=len(trees)), 1)
    got = storage.get_updates(lst.session_id)
    _assert_records_equal(got, want)
    assert list(got[2]["updates"]) == ["dense/W", "dense/bf"]
    assert list(got[3]["updates"]) == ["dense/W", "dense/bf"]


def test_the_histogram_counts_as_numpy_does():
    """Leaves numpy bins at its edges: constant, all-zero, one-spacing
    ranges, values on every computed edge, huge and tiny magnitudes, a
    length-1 leaf, and float64 / bfloat16 leaves read as float32."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal(4000).astype(np.float32)
    leaves = [base, np.zeros(9, np.float32), np.full(5, -2.5, np.float32),
              np.array([1.0, np.nextafter(np.float32(1), np.float32(2))], np.float32),
              np.concatenate([np.histogram_bin_edges(base, 20).astype(np.float32), base[:50]]),
              (base * 1e15).astype(np.float32), (base * 1e-30).astype(np.float32),
              np.linspace(-1, 1, 101, dtype=np.float32), np.array([3.0], np.float32),
              rng.standard_normal(300) * 7]
    tensors = [torch.from_numpy(np.array(a)) for a in leaves]
    tensors.append(torch.from_numpy(base[:200]).to(torch.bfloat16))
    leaves.append(tensors[-1].float().numpy())
    for bins in (20, 3, 64):
        kept = []
        for t, a in zip(tensors, leaves):
            try:
                kept.append((t, jstats._leaf_stats(a, bins)))
            except ValueError as e:
                # numpy >= 2.1 refuses bins narrower than a float32
                # spacing: so does the port, with numpy's message
                with pytest.raises(ValueError) as got:
                    tstats.leaf_stats([t], bins)
                assert str(got.value) == str(e)
        got = tstats.leaf_stats([t for t, _ in kept], bins)
        assert len(kept) >= len(leaves) - 1
        for i, (_, want) in enumerate(kept):
            _close_stats(got[i], want, f"leaf {i} bins {bins}")


def test_a_non_finite_leaf_is_refused_as_numpy_refuses_it():
    a = np.array([1.0, np.nan], np.float32)
    with pytest.raises(ValueError) as want:
        jstats._leaf_stats(a, 20)
    with pytest.raises(ValueError) as got:
        tstats.leaf_stats([torch.from_numpy(a)], 20)
    assert str(got.value) == str(want.value)
    # without histograms neither package refuses it
    assert np.isnan(tstats.leaf_stats([torch.from_numpy(a)], 20, False)[0]["mean"])


def _nets(updater="sgd"):
    """The reference's MLP and the port's, the port's carrying the
    reference's initial weights."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Adam, Sgd
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerConfiguration,
                                                        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy

    up = Sgd(lr=0.1) if updater == "sgd" else Adam(lr=0.01)
    conf = (NeuralNetConfiguration.builder().seed(3).updater(up)
            .layer(Dense(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    jnet = JNet(conf)
    jnet.init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf.to_dict()), device="cpu")
    net.init()
    net.params = params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                                    for p in jnet.params], device="cpu")
    return jnet, net


def _blobs():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.normal(-2, 1, (64, 6)), rng.normal(2, 1, (64, 6))]).astype(np.float32)
    ys = np.zeros((128, 2), np.float32)
    ys[:64, 0] = 1
    ys[64:, 1] = 1
    return xs, ys


def test_records_after_real_steps_from_carried_weights():
    """Six SGD steps of the same MLP from the same weights: the same record
    stream; scores and parameter moments within 1e-5, update magnitudes
    within 1e-4 (the two packages' steps differ in the last bits), and
    each histogram's counts within one value moved across an edge."""
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet

    jnet, net = _nets()
    xs, ys = _blobs()
    recs = {}
    for pkg, model, ds in ((jui, jnet, JDataSet(xs, ys)), (tui, net, DataSet(xs, ys))):
        storage = pkg.InMemoryStatsStorage()
        model.set_listeners(pkg.StatsListener(storage, session_id="s", clock=_ticks()))
        for _ in range(6):
            model.fit_batch(ds)
        recs[pkg] = storage.get_updates("s")
    want, got = recs[jui], recs[tui]
    assert [r.keys() for r in got] == [r.keys() for r in want]
    for g, w in zip(got, want):
        assert g["iteration"] == w["iteration"] and g["timestamp"] == w["timestamp"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5)
        for section, rtol in (("parameters", 1e-5), ("updates", 1e-4)):
            for pid, st in w.get(section, {}).items():
                mine = g[section][pid]
                for k in ("mean", "std", "min", "max", "mean_magnitude"):
                    np.testing.assert_allclose(mine[k], st[k], rtol=rtol,
                                               atol=rtol * st["mean_magnitude"])
                assert sum(mine["histogram"]) == sum(st["histogram"])
                assert np.abs(np.subtract(mine["histogram"], st["histogram"])).sum() <= 2
        assert "memory" not in g      # no allocator statistics on the CPU


def test_the_listener_s_own_contract():
    """The reference test file's cases: keys, throttle, the injected clock."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    _, net = _nets("adam")
    xs, ys = _blobs()
    storage = tui.InMemoryStatsStorage()
    net.set_listeners(tui.StatsListener(storage, session_id="test_run"))
    for _ in range(12):
        net.fit_batch(DataSet(xs, ys))
    ups = storage.get_updates("test_run")
    assert len(ups) == 12
    st = ups[0]["parameters"]["layer_0/W"]
    assert {"mean", "std", "min", "max", "histogram"} <= set(st)
    assert "updates" in ups[-1] and ups[-1]["update_ratios"]["layer_0/W"] > 0
    assert "iterations_per_sec" in ups[-1]
    assert tui.StatsListener.requires_model_state
    lst = tui.StatsListener(storage, clock=_ticks(), update_frequency=3)
    assert lst.session_id == "session_1000" and lst._start_time == 1001.0
    for i in range(9):
        lst.iteration_done(net, i, 0.5)
    assert len(storage.get_updates("session_1000")) == 3


def test_input_pipeline_rides_the_records():
    """A record made while a ``DevicePrefetchIterator`` is live carries its
    stall statistics, as the reference's does."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.device_prefetch import DevicePrefetchIterator

    _, net = _nets()
    xs, ys = _blobs()
    storage = tui.InMemoryStatsStorage()
    net.set_listeners(tui.StatsListener(storage, session_id="p"))
    it = DevicePrefetchIterator(ListDataSetIterator(DataSet(xs, ys).batch_by(32)), depth=2,
                                device="cpu")
    try:
        while it.has_next():
            net.fit_batch(it.next())
    finally:
        it.close()
    ups = storage.get_updates("p")
    assert len(ups) == 4
    for u in ups:
        snap = u["input_pipeline"]
        assert snap and {"stall_fraction", "depth", "batches"} <= set(snap[-1])
    assert tui.input_pipeline_snapshot() == [p.stall_stats() for p in
                                             __import__("deeplearning4j_tpu_torch.datasets."
                                                        "device_prefetch", fromlist=["x"])
                                             .live_pipelines()]


# -- storages ---------------------------------------------------------------------------


def _storage(pkg, kind, path):
    return (pkg.FileStatsStorage(str(path / "stats")) if kind == "file"
            else pkg.SqliteStatsStorage(str(path / "stats.db")))


@pytest.mark.parametrize("kind", ["file", "sqlite"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_storages_read_each_other_s_files(tmp_path, kind, writer):
    w, r = (jui, tui) if writer == "reference" else (tui, jui)
    recs = _listen(jui, _param_sequence(), False)
    out = _storage(w, kind, tmp_path)
    for rec in recs:
        out.put_update("run/a", rec)
    out.put_update("b", {"iteration": 1, "score": 1.0})
    out.close()
    back = _storage(r, kind, tmp_path)
    assert back.list_session_ids() == _storage(w, kind, tmp_path).list_session_ids()
    sid = [s for s in back.list_session_ids() if s != "b"][0]
    assert back.get_updates(sid) == json.loads(json.dumps(recs))
    back.close()


def test_in_memory_storage_routes_to_its_listeners():
    storage = tui.InMemoryStatsStorage()
    seen = []
    storage.register_listener(lambda sid, rec: seen.append((sid, rec["score"])))
    storage.put_update("x", {"iteration": 1, "score": 0.1})
    assert seen == [("x", 0.1)] and storage.list_session_ids() == ["x"]


# -- rendering --------------------------------------------------------------------------


def test_both_packages_render_the_same_dashboard(tmp_path):
    recs = _listen(jui, _param_sequence(steps=6), False)
    recs[-1]["memory"] = {"bytes_in_use": 3 << 20, "peak_bytes_in_use": 5 << 20}
    pages = []
    for pkg in (jui, tui):
        storage = pkg.InMemoryStatsStorage()
        for rec in recs:
            storage.put_update("test_run", rec)
        path = pkg.render_dashboard(storage, str(tmp_path / f"{pkg.__name__}.html"))
        pages.append(open(path).read())
    assert pages[0] == pages[1]
    assert "Score vs iteration" in pages[1] and "<script" not in pages[1].lower()
    for pkg in (jui, tui):
        with pytest.raises(ValueError, match="sessions"):
            pkg.render_dashboard(pkg.InMemoryStatsStorage(), str(tmp_path / "x.html"))


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_both_packages_render_the_same_embedding_page(form):
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(250, 2))
    labels = rng.integers(0, 12, 250)
    words = [f"w<{i}>" for i in range(250)]
    want = jui.render_embedding_html(coords, labels, words, title="demo & co")
    if form == "tensor":
        coords, labels = torch.from_numpy(coords), torch.from_numpy(labels)
    assert tui.render_embedding_html(coords, labels, words, title="demo & co") == want
    assert tui.render_embedding_html(coords) == jui.render_embedding_html(np.asarray(coords))
    assert tui.render_embedding_html(np.zeros((0, 2))) == jui.render_embedding_html(
        np.zeros((0, 2)))
    for bad in (np.zeros((5, 3)),):
        with pytest.raises(ValueError, match="N,2"):
            tui.render_embedding_html(bad)
    with pytest.raises(ValueError, match="words"):
        tui.render_embedding_html(np.zeros((2, 2)), words=["a"])


# -- the server -------------------------------------------------------------------------


def _http(url, body=None):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_the_server_s_storage_routes_are_the_references():
    """/remote 403 (not enabled), 503 (no storage), 200 (stored); /metrics
    sessions; the index and /train pages byte for byte the reference
    server's; 404 for an unknown path."""
    recs = _listen(jui, _param_sequence(), False)
    item = json.dumps([{"session_id": "remote run", "record": r} for r in recs]).encode()
    answers = {}
    for pkg in (jui, tui):
        bare = pkg.UIServer(port=0).start()
        closed = pkg.UIServer(port=0).attach(pkg.InMemoryStatsStorage()).start()
        storage = pkg.InMemoryStatsStorage()
        storage.put_update("local", {"iteration": 3, "score": 0.25})
        server = pkg.UIServer(port=0).attach(storage).enable_remote_listener().start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            a = {"closed": _http(f"http://127.0.0.1:{closed.port}/remote", item)[0],
                 "no_storage": _http(
                     f"http://127.0.0.1:{bare.enable_remote_listener().port}/remote", item)[0],
                 "stored": _http(f"{base}/remote", item)[0],
                 "malformed": _http(f"{base}/remote", b"{not json")[0],
                 "missing": _http(f"{base}/nope")[0],
                 "index": _http(f"{base}/"), "index_html": _http(f"{base}/index.html"),
                 "page": _http(f"{base}/train/0/remote%20run"),
                 "sessions": json.loads(_http(f"{base}/metrics")[1])["sessions"]}
            assert storage.get_updates("remote run") == json.loads(json.dumps(recs))
            answers[pkg] = a
        finally:
            for s in (bare, closed, server):
                s.stop()
    want, got = answers[jui], answers[tui]
    assert (got["closed"], got["no_storage"], got["stored"], got["malformed"],
            got["missing"]) == (403, 503, 200, 400, 404)
    assert got == want
    assert got["sessions"]["remote run"] == {"updates": len(recs),
                                             "last_iteration": recs[-1]["iteration"],
                                             "last_score": recs[-1].get("score")}
    assert "remote%20run" in got["index"][1] and "Score vs iteration" in got["page"][1]


def test_trace_route_serves_the_ring_buffer():
    from deeplearning4j_tpu_torch.obs import trace as obs_trace

    server = tui.UIServer(port=0).start()
    try:
        url = f"http://127.0.0.1:{server.port}/trace"
        obs_trace.disable_tracing()
        off = json.loads(_http(url)[1])
        assert off["traceEvents"] == [] and "disabled" in off["metadata"]["tracing"]
        obs_trace.enable_tracing()
        with obs_trace.span("ui/test", cat="ui", n=1):
            obs_trace.instant("ui/mark", cat="ui")
        on = json.loads(_http(url)[1])
    finally:
        obs_trace.disable_tracing()
        server.stop()
    assert obs_trace.validate_chrome_trace(on) == []
    names = {e["name"] for e in on["traceEvents"]}
    assert {"ui/test", "ui/mark"} <= names


def test_records_over_http_equal_a_local_storage_s():
    """A StatsListener posting through a RemoteStatsRouter to the port's
    server stores the records a local storage keeps, in both directions
    between the packages."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    for server_pkg, router_pkg in ((tui, tui), (jui, tui), (tui, jui)):
        storage = server_pkg.InMemoryStatsStorage()
        server = server_pkg.UIServer(port=0).attach(storage).enable_remote_listener().start()
        try:
            router = router_pkg.RemoteStatsRouter(f"http://127.0.0.1:{server.port}")
            local = tui.InMemoryStatsStorage()
            _, net = _nets()
            xs, ys = _blobs()
            clocks = (_ticks(), _ticks())
            net.set_listeners(tui.StatsListener(router, session_id="r", clock=clocks[0]),
                              tui.StatsListener(local, session_id="r", clock=clocks[1]))
            for _ in range(3):
                net.fit_batch(DataSet(xs, ys))
            router.close()
        finally:
            server.stop()
        assert storage.get_updates("r") == json.loads(json.dumps(local.get_updates("r")))
        assert router.dropped == 0


def test_the_router_s_drop_accounting_is_the_references(caplog):
    """Posts to a closed port: the buffer keeps the newest ``max_buffer``
    records, drops the oldest into the registry's counter and a
    ``ui/remote_drop`` instant, and warns once — as the reference's."""
    import socket

    from deeplearning4j_tpu.obs.metrics import get_registry as j_registry
    from deeplearning4j_tpu_torch.obs import trace as obs_trace
    from deeplearning4j_tpu_torch.obs.metrics import get_registry

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]      # closed once the block ends
    url = f"http://127.0.0.1:{port}"
    counts = {}
    obs_trace.enable_tracing()
    try:
        for pkg, reg in ((jui, j_registry), (tui, get_registry)):
            before = reg().counter("ui_remote_dropped_records_total").value()
            router = pkg.RemoteStatsRouter(url, max_retries=2, backoff=0.0, timeout=1.0,
                                           max_buffer=3)
            caplog.clear()
            for i in range(7):
                router.put_update("s", {"iteration": i})
            counts[pkg] = (router.dropped, [p["record"]["iteration"] for p in router._pending],
                           reg().counter("ui_remote_dropped_records_total").value() - before,
                           sum("DROPPING" in r.getMessage() for r in caplog.records))
            assert not router.flush()
            with pytest.raises(NotImplementedError):
                router.register_listener(lambda *a: None)
        drops = [e for e in obs_trace.get_recorder().export()["traceEvents"]
                 if e["name"] == "ui/remote_drop"]
    finally:
        obs_trace.disable_tracing()
    assert counts[tui] == counts[jui] == (4, [4, 5, 6], 4, 1)
    assert [e["args"]["dropped"] for e in drops] == [1, 1, 1, 1]


# -- the profiler and the CLI ---------------------------------------------------------------


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from deeplearning4j_tpu_torch.obs import trace as obs_trace

    obs_trace.enable_tracing()
    try:
        with tui.profile_trace(str(tmp_path / "trace")):
            torch.ones(16, 16) @ torch.ones(16, 16)
        spans = [e for e in obs_trace.get_recorder().export()["traceEvents"]
                 if e["name"].startswith("profiler/")]
    finally:
        obs_trace.disable_tracing()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.load(open(tmp_path / "trace" / files[0]))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert [(e["name"], e["args"]["backend_started"]) for e in spans] == [
        ("profiler/trace", True)]


def test_profile_trace_records_an_unavailable_profiler(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.obs import trace as obs_trace

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    obs_trace.enable_tracing()
    try:
        with tui.profile_trace(str(tmp_path / "t")):
            pass
        names = [(e["name"], e.get("args", {}).get("backend_started"))
                 for e in obs_trace.get_recorder().export()["traceEvents"]
                 if e["name"].startswith("profiler/")]
    finally:
        obs_trace.disable_tracing()
    assert names == [("profiler/unavailable", None), ("profiler/trace", False)]


def test_train_dashboard_in_both_clis(tmp_path, capsys):
    """``train --dashboard`` in both CLIs: the page names the ``cli_train``
    session and holds as many updates; the port prints the same line."""
    from deeplearning4j_tpu import cli as jcli
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu_torch import cli

    conf = (NeuralNetConfiguration.builder().seed(1)
            .layer(Dense(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    (tmp_path / "conf.json").write_text(json.dumps(conf.to_dict()))
    pages, lines = {}, {}
    for name, main, extra in (("ref", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.html")
        rc = main(["train", "--config", str(tmp_path / "conf.json"), "--data", "iris",
                   "--epochs", "2", "--batch-size", "32", "--dashboard", out, *extra])
        assert rc in (0, None)
        lines[name] = [l.replace(out, "OUT") for l in capsys.readouterr().out.splitlines()
                       if l.startswith("dashboard:")]
        pages[name] = open(out).read()
    for page in pages.values():
        assert "Training session: cli_train" in page
    n = {k: re.search(r"<p>(\d+) updates", p).group(1) for k, p in pages.items()}
    assert n["port"] == n["ref"] == "10"
    assert lines["port"] == lines["ref"] == ["dashboard: OUT"]
