"""The port's clustering, kNN and DeepWalk (``deeplearning4j_tpu_torch/
{clustering,graph}``) against the JAX package's on the CPU.

``tests/test_clustering.py``'s k-means, kNN and DeepWalk cases run on the
port; beyond them: kNN indices equal the reference's on sets with planted
exact ties (the lower index first, as ``jax.lax.top_k``) for every metric
and query tiling, k-means centroids are within 1e-5 of the reference's
and its assignments equal, the walks are the reference's, and DeepWalk
fits (HS and negative sampling) are within rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.clustering as jcl
import deeplearning4j_tpu.graph as jgr
import deeplearning4j_tpu_torch.graph as tgr
from deeplearning4j_tpu_torch.clustering import (
    KMeansClustering, NearestNeighbors, pairwise_distances,
)
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph, RandomWalkIterator


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the fits run thousands of tiny ops, which
    several test workers sharing the cores would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blobs(n_per=100, k=3, d=8, spread=0.5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, (k, d))
    x = np.concatenate([rng.normal(c, spread, (n_per, d)) for c in centers])
    y = np.repeat(np.arange(k), n_per)
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), y[perm], centers


class TestKMeans:
    def test_recovers_blobs(self):
        x, y, _ = blobs()
        km = KMeansClustering.setup(3, max_iterations=100, device="cpu")
        assign = km.apply_to(x)
        for c in range(3):
            true = y[assign == c]
            assert len(true) > 0
            assert np.bincount(true).max() / len(true) > 0.99, f"cluster {c} impure"
        assert km.inertia_ is not None and km.n_iter_ < 100

    def test_predict_matches_training_assignment(self):
        x, _, _ = blobs(50)
        km = KMeansClustering(3, seed=7, device="cpu")
        assign = km.apply_to(x)
        np.testing.assert_array_equal(km.predict(x), assign)

    def test_kpp_finds_near_ideal_solution(self):
        x, _, _ = blobs(60, k=5, spread=1.0, seed=3)
        ideal = x.shape[0] * x.shape[1] * 1.0
        best = min(_inertia(x, s) for s in (1, 2, 3))
        assert best < 1.5 * ideal, f"best inertia {best:.0f} vs ideal {ideal:.0f}"

    def test_validates_input(self):
        with pytest.raises(ValueError, match="k"):
            KMeansClustering(0, device="cpu")
        with pytest.raises(ValueError, match="points"):
            KMeansClustering(5, device="cpu").apply_to(np.zeros((3, 2)))
        with pytest.raises(ValueError, match="apply_to"):
            KMeansClustering(2, device="cpu").predict(np.zeros((3, 2)))

    @pytest.mark.parametrize("init,k,seed", [("kmeans++", 3, 7), ("kmeans++", 5, 1),
                                             ("random", 4, 2), ("kmeans++", 8, 3)])
    def test_fit_is_the_references(self, init, k, seed):
        """Centroids within 1e-5, assignments and iteration count equal; an
        empty cluster (k = 8 on 5 blobs with random seeds) keeps its
        centroid in both."""
        x, _, _ = blobs(60, k=5, spread=1.0, seed=3)
        km = KMeansClustering(k, init=init, seed=seed, device="cpu")
        a = km.apply_to(x)
        ref = jcl.KMeansClustering(k, init=init, seed=seed)
        b = ref.apply_to(x)
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(km.centroids, ref.centroids, rtol=0, atol=1e-5)
        assert km.n_iter_ == ref.n_iter_
        np.testing.assert_allclose(km.inertia_, ref.inertia_, rtol=1e-5)
        np.testing.assert_array_equal(km.predict(x[:17]), np.asarray(ref.predict(x[:17])))

    def test_empty_cluster_keeps_its_centroid(self):
        from deeplearning4j_tpu_torch.clustering.kmeans import _lloyd_step

        x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
        c = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
        new_c, assign, _ = _lloyd_step(x, c)
        np.testing.assert_array_equal(assign.numpy(), [0, 0, 1])
        np.testing.assert_array_equal(new_c[2].numpy(), [100.0, 100.0])


def _inertia(x, seed):
    km = KMeansClustering(5, init="kmeans++", seed=seed, device="cpu")
    km.apply_to(x)
    return km.inertia_


class TestKNN:
    def test_matches_numpy_oracle(self):
        rng = np.random.default_rng(1)
        pts = rng.normal(size=(200, 16)).astype(np.float32)
        q = rng.normal(size=(17, 16)).astype(np.float32)
        d, i = NearestNeighbors(pts, device="cpu").knn(q, k=5)
        od = np.linalg.norm(q[:, None, :] - pts[None, :, :], axis=-1)
        oi = np.argsort(od, axis=1)[:, :5]
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_allclose(d, np.take_along_axis(od, oi, 1), rtol=1e-4, atol=1e-4)

    def test_single_query_and_k_clamp(self):
        pts = np.eye(4, dtype=np.float32)
        d, i = NearestNeighbors(pts, device="cpu").knn(pts[2], k=10)
        assert i.shape == (4,) and i[0] == 2 and d[0] < 1e-6

    def test_query_tiling_consistent(self):
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(64, 8)).astype(np.float32)
        q = rng.normal(size=(40, 8)).astype(np.float32)
        a = NearestNeighbors(pts, query_block=7, device="cpu").knn(q, 3)
        b = NearestNeighbors(pts, query_block=4096, device="cpu").knn(q, 3)
        np.testing.assert_array_equal(a[1], b[1])

    def test_cosine_metric(self):
        pts = np.asarray([[1, 0], [0, 1], [2, 0]], np.float32)
        d, i = NearestNeighbors(pts, metric="cosine", device="cpu").knn(
            np.asarray([3.0, 0.1], np.float32), k=3)
        assert set(i[:2].tolist()) == {0, 2}

    def test_pairwise_distances(self):
        a = np.asarray([[0, 0], [3, 4]], np.float32)
        np.testing.assert_allclose(pairwise_distances(a, device="cpu"), [[0, 5], [5, 0]],
                                   atol=1e-5)

    @pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
    @pytest.mark.parametrize("query_block,col_block", [(4096, 1 << 17), (5, 7)])
    def test_planted_ties_break_as_the_reference(self, metric, query_block, col_block,
                                                 monkeypatch):
        """Integer points with many exact duplicates and equidistant
        shells: every distance is exact in f32 in both packages, so the
        k nearest and their order among ties must be the reference's
        (lower index first), also across column tiles and query tiles."""
        from deeplearning4j_tpu_torch.clustering import knn as tknn

        monkeypatch.setattr(tknn, "COLUMN_BLOCK", col_block)
        rng = np.random.default_rng(0)
        base = rng.integers(-2, 3, (12, 4)).astype(np.float32)
        pts = base[rng.integers(0, 12, 90)]               # 90 points, 12 distinct
        q = np.concatenate([base[:5], rng.integers(-2, 3, (9, 4)).astype(np.float32)])
        for k in (1, 4, 11, 90):
            d, i = NearestNeighbors(pts, metric=metric, query_block=query_block,
                                    device="cpu").knn(q, k)
            jd, ji = jcl.NearestNeighbors(pts, metric=metric).knn(q, k)
            np.testing.assert_array_equal(i, np.asarray(ji))
            np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
    def test_pairwise_distances_are_the_references(self, metric):
        rng = np.random.default_rng(3)
        a = rng.normal(size=(20, 6)).astype(np.float32)
        b = rng.normal(size=(13, 6)).astype(np.float32)
        np.testing.assert_allclose(pairwise_distances(a, b, metric, device="cpu"),
                                   np.asarray(jcl.pairwise_distances(a, b, metric)),
                                   rtol=1e-5, atol=1e-5)

    def test_order_keys_sort_like_the_floats(self):
        from deeplearning4j_tpu_torch.clustering.knn import decode_keys, order_keys

        d = torch.tensor([[3.0, -0.0, 0.0, -1.5, float("inf"), -2.0, 1e-30, -1e-30, 3.0]])
        keys = order_keys(d, 100)
        order = torch.argsort(keys[0]).tolist()
        assert order == [5, 3, 7, 1, 2, 6, 0, 8, 4]
        dist, cols = decode_keys(keys)
        np.testing.assert_array_equal(dist.numpy(), (d + 0.0).numpy())
        np.testing.assert_array_equal(cols.numpy(), [list(range(100, 109))])


def two_community_graph(mod, n_per=16, p_in=0.6, p_out=0.02, seed=0):
    rng = np.random.default_rng(seed)
    n = 2 * n_per
    g = mod.Graph(n, undirected=True)
    for a in range(n):
        for b in range(a + 1, n):
            same = (a < n_per) == (b < n_per)
            if rng.random() < (p_in if same else p_out):
                g.add_edge(a, b)
    for v in range(n):
        if g.degree(v) == 0:
            g.add_edge(v, (v + 1) % n_per + (0 if v < n_per else n_per))
    return g


class TestDeepWalk:
    def test_random_walks_respect_edges(self):
        g = Graph(4)
        g.add_edges([(0, 1), (1, 2), (2, 3)])
        walks = list(RandomWalkIterator(g, walk_length=5, seed=0))
        assert len(walks) == 4
        for w in walks:
            assert len(w) == 5
            for a, b in zip(w, w[1:]):
                assert b in g.neighbors(a) or a == b

    @pytest.mark.parametrize("cls", ["RandomWalkIterator", "WeightedWalkIterator"])
    def test_walks_are_the_references(self, cls):
        g, jg = Graph(6), jgr.Graph(6)
        for a, b, w in [(0, 1, 1.0), (1, 2, 3.0), (2, 3, 0.5), (3, 4, 2.0), (1, 4, 1.5)]:
            g.add_edge(a, b, w)
            jg.add_edge(a, b, w)
        got = list(getattr(tgr, cls)(g, walk_length=7, walks_per_vertex=3, seed=11))
        want = list(getattr(jgr, cls)(jg, walk_length=7, walks_per_vertex=3, seed=11))
        assert got == want

    @pytest.mark.parametrize("hs", [True, False], ids=["hs", "neg"])
    def test_communities_embed_together_and_fit_is_the_references(self, hs):
        kw = dict(vector_size=16, window_size=4, walk_length=20, walks_per_vertex=8,
                  epochs=15, hierarchic_softmax=hs, batch_size=128, seed=2,
                  learning_rate=0.05)
        dw = DeepWalk(device="cpu", **kw)
        dw.fit(two_community_graph(tgr))
        n_per = 16
        within = np.mean([dw.similarity(a, b) for a in range(0, 8) for b in range(8, n_per)])
        across = np.mean([dw.similarity(a, b) for a in range(0, 8)
                          for b in range(n_per, n_per + 8)])
        assert within > across + 0.2, f"within={within:.3f} across={across:.3f}"
        ref = jgr.DeepWalk(**kw)
        ref.fit(two_community_graph(jgr))
        np.testing.assert_allclose(dw.vectors, ref.vectors, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dw.vertex_vector(3), ref.vertex_vector(3),
                                   rtol=1e-4, atol=1e-5)
        assert dw.verticies_nearest(0, 5) == dw.vertices_nearest(0, 5)
