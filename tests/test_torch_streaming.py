"""The port's tensor pub-sub (``deeplearning4j_tpu_torch/streaming``) and
kNN REST server (``clustering/knn_server.py``) on loopback, against the
JAX package's.

``tests/test_networked.py``'s ``TestTensorPubSub`` and ``TestKnnServer``
cases run on the port; beyond them, the wire is the reference's: a
reference publisher feeds a port subscriber and the other way round
(through either package's broker), bitwise; a reference client queries a
port server and a port client a reference server, with the same answers.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.clustering as jcl
import deeplearning4j_tpu.streaming as jst
from deeplearning4j_tpu_torch.clustering import NearestNeighborsClient, NearestNeighborsServer
from deeplearning4j_tpu_torch.streaming import (
    NDArrayConsumer, NDArrayPublisher, StreamingDataSetIterator, TensorBroker,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the fits run thousands of tiny ops, which
    several test workers sharing the cores would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestTensorPubSub:
    def test_publish_consume_roundtrip(self):
        broker = TensorBroker().start()
        try:
            sub = NDArrayConsumer(broker.address, "t").connect()
            time.sleep(0.05)
            pub = NDArrayPublisher(broker.address, "t").connect()
            rng = np.random.default_rng(0)
            sent = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(5)]
            for a in sent:
                pub.publish(a)
            got = [sub.next(timeout=5) for _ in range(5)]
            for a, b in zip(sent, got):
                np.testing.assert_array_equal(a, b)
            pub.close()
            sub.close()
        finally:
            broker.stop()

    def test_fanout_to_multiple_subscribers(self):
        broker = TensorBroker().start()
        try:
            subs = [NDArrayConsumer(broker.address, "x").connect() for _ in range(3)]
            time.sleep(0.05)
            pub = NDArrayPublisher(broker.address, "x").connect()
            arr = np.arange(6, dtype=np.float32).reshape(2, 3)
            pub.publish(arr)
            for s in subs:
                np.testing.assert_array_equal(s.next(timeout=5), arr)
        finally:
            broker.stop()

    def test_topic_isolation(self):
        broker = TensorBroker().start()
        try:
            sub_a = NDArrayConsumer(broker.address, "a").connect()
            sub_b = NDArrayConsumer(broker.address, "b").connect()
            time.sleep(0.05)
            NDArrayPublisher(broker.address, "a").connect().publish(np.ones((2,), np.float32))
            np.testing.assert_array_equal(sub_a.next(timeout=5), np.ones(2, np.float32))
            with pytest.raises(Exception):  # queue.Empty
                sub_b._q.get(timeout=0.2)
        finally:
            broker.stop()

    def test_a_tensor_is_published_as_its_host_copy(self):
        broker = TensorBroker().start()
        try:
            sub = NDArrayConsumer(broker.address, "t").connect()
            time.sleep(0.05)
            t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
            NDArrayPublisher(broker.address, "t").connect().publish(t)
            got = sub.next(timeout=5)
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, t.numpy())
        finally:
            broker.stop()

    def test_streaming_iterator_trains_a_model(self):
        """Feature/label batches through the broker into the port's
        ``MultiLayerNetwork.fit`` (the reference's Camel-route role)."""
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
        from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
        from deeplearning4j_tpu_torch.nn.multilayer import (
            MultiLayerNetwork, NeuralNetConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.updaters import Adam

        broker = TensorBroker().start()
        try:
            it = StreamingDataSetIterator(broker.address, max_batches=4, timeout=10)
            time.sleep(0.05)
            fpub = NDArrayPublisher(broker.address, "features").connect()
            lpub = NDArrayPublisher(broker.address, "labels").connect()
            rng = np.random.default_rng(0)
            for _ in range(4):
                labels = rng.integers(0, 2, 16)
                x = (labels[:, None] * 2.0 - 1.0
                     + rng.normal(scale=0.3, size=(16, 4))).astype(np.float32)
                fpub.publish(x)
                lpub.publish(np.eye(2, dtype=np.float32)[labels])
            conf = (NeuralNetConfiguration.builder()
                    .updater(Adam(lr=0.05))
                    .layer(Dense(n_out=8, activation="relu"))
                    .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                    .set_input_type(InputType.feed_forward(4)).build())
            net = MultiLayerNetwork(conf, device="cpu")
            net.init()
            losses = net.fit(it)
            assert len(losses) == 4
            assert all(np.isfinite(float(l)) for l in losses)
            it.close()
        finally:
            broker.stop()


@pytest.mark.parametrize("broker_pkg", ["port", "reference"])
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_the_wire_is_the_references(broker_pkg, direction):
    """Frames cross packages both ways, through either package's broker,
    bitwise, dtypes and shapes kept (a streaming iterator of one package
    reads the other's publishers)."""
    import deeplearning4j_tpu_torch.streaming as tst

    broker = (TensorBroker() if broker_pkg == "port" else jst.TensorBroker()).start()
    pub_pkg, sub_pkg = (jst, tst) if direction == "reference_to_port" else (tst, jst)
    try:
        sub = sub_pkg.NDArrayConsumer(broker.address, "t").connect()
        it = sub_pkg.StreamingDataSetIterator(broker.address, max_batches=3, timeout=10)
        time.sleep(0.05)
        pub = pub_pkg.NDArrayPublisher(broker.address, "t").connect()
        fpub = pub_pkg.NDArrayPublisher(broker.address, "features").connect()
        lpub = pub_pkg.NDArrayPublisher(broker.address, "labels").connect()
        rng = np.random.default_rng(1)
        sent = [rng.normal(size=(5, 7)).astype(np.float32),
                rng.integers(0, 100, (3, 2, 4)).astype(np.int32),
                np.asarray(3.5, np.float64), np.zeros((0, 3), np.float16)]
        for a in sent:
            pub.publish(a)
        batches = [(rng.normal(size=(8, 4)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]) for _ in range(3)]
        for x, y in batches:
            fpub.publish(x)
            lpub.publish(y)
        for a in sent:
            b = sub.next(timeout=5)
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(b, a)
        got = list(it)
        assert len(got) == 3
        for ds, (x, y) in zip(got, batches):
            np.testing.assert_array_equal(np.asarray(ds.features), x)
            np.testing.assert_array_equal(np.asarray(ds.labels), y)
        it.close()
    finally:
        broker.stop()


class TestKnnServer:
    @pytest.fixture()
    def server(self):
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(50, 8)).astype(np.float32)
        srv = NearestNeighborsServer(pts, device="cpu").start()
        yield srv, pts
        srv.stop()

    def test_knnnew_matches_local_index(self, server):
        srv, pts = server
        client = NearestNeighborsClient(srv.url)
        q = pts[7] + 0.01
        results = client.knn_new(q, k=3)
        assert len(results) == 3 and results[0]["index"] == 7
        d_local, i_local = srv.index.knn(q[None, :], 3)
        assert [r["index"] for r in results] == [int(x) for x in i_local[0]]
        np.testing.assert_allclose([r["distance"] for r in results], d_local[0], rtol=1e-5)

    def test_knn_by_id_excludes_self(self, server):
        srv, _ = server
        results = NearestNeighborsClient(srv.url).knn(index=3, k=4)
        assert len(results) == 4 and all(r["index"] != 3 for r in results)

    def test_bad_requests_are_400_and_unknown_routes_404(self, server):
        srv, _ = server
        for route, body, code in (("/knn", {"id": 999, "k": 2}, 400),
                                  ("/knn", {"k": 2}, 400),
                                  ("/knnnew", {"vector": "x"}, 400),
                                  ("/other", {}, 404)):
            req = urllib.request.Request(srv.url + route, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == code

    @pytest.mark.parametrize("metric", ["euclidean", "cosine"])
    def test_clients_and_servers_of_both_packages_agree(self, metric):
        """A reference client asks a port server and a port client asks a
        reference server: the same indices, distances within 1e-5."""
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(80, 6)).astype(np.float32)
        port = NearestNeighborsServer(pts, metric=metric, device="cpu").start()
        ref = jcl.NearestNeighborsServer(pts, metric=metric).start()
        try:
            answers = []
            for client in (jcl.NearestNeighborsClient(port.url),
                           NearestNeighborsClient(ref.url),
                           jcl.NearestNeighborsClient(ref.url)):
                answers.append([client.knn(index=5, k=4), client.knn_new(pts[9] + 0.05, k=6)])
            for a in answers[:2]:
                for got, want in zip(a, answers[2]):
                    assert [r["index"] for r in got] == [r["index"] for r in want]
                    np.testing.assert_allclose([r["distance"] for r in got],
                                               [r["distance"] for r in want],
                                               rtol=1e-5, atol=1e-5)
        finally:
            port.stop()
            ref.stop()
