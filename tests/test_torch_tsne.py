"""The port's t-SNE (``deeplearning4j_tpu_torch/plot/tsne.py``) against the
JAX package's ``plot/tsne.py`` on the CPU.

``tests/test_tsne_chunked.py``'s parity and quality cases and
``tests/test_clustering.py``'s t-SNE cases run on the port; beyond them,
the exact and the chunked gradient steps, each started from the
reference's carried state, are within 1e-5 of the reference's step for
10 iterations (norm-relative; the velocity as close to a float64
evaluation as the reference's, see the test); the blocked kNN, the perplexity bisection and the sparse
symmetrization match the reference's on the same inputs.  The
reference's compiled-memory test becomes a card test
(``tests/test_torch_cuda.py``, peak ``max_memory_allocated``); the
500,000-point demo stays opt-in (``TSNE_BIG=1``) as in the reference.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.plot import Tsne
from deeplearning4j_tpu_torch.plot.tsne import (
    _binary_search_p, _chunked_tsne_step, _knn_blocked, _sparse_p_search,
    _symmetrize_sparse, _tsne_step,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the fits run thousands of tiny ops, which
    several test workers sharing the cores would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(rng, n, centers=3, d=10, spread=4.0):
    c = rng.normal(0, spread, (centers, d))
    lab = rng.integers(0, centers, n)
    return (c[lab] + rng.normal(0, 0.5, (n, d))).astype(np.float32), lab


def _t(a):
    return torch.from_numpy(np.array(a))


class TestChunkedParity:
    def test_knn_blocked_matches_numpy_and_the_reference(self):
        import jax.numpy as jnp

        from deeplearning4j_tpu.plot.tsne import _knn_blocked as jknn

        rng = np.random.default_rng(0)
        x = rng.normal(size=(100, 8)).astype(np.float32)
        idx, d2k = _knn_blocked(_t(x), k=7, block=32, row_chunk=30)
        d2 = ((x[:, None] - x[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        np.testing.assert_allclose(np.sort(d2k.numpy(), axis=1), np.sort(d2, axis=1)[:, :7],
                                   rtol=1e-3, atol=1e-4)
        jidx, jd2k = jknn(jnp.asarray(x), k=7, block=32)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(d2k.numpy(), np.asarray(jd2k), rtol=1e-5, atol=1e-5)

    def test_knn_ties_break_as_the_reference(self):
        """Integer points with duplicates: exact ties, lower index first."""
        import jax.numpy as jnp

        from deeplearning4j_tpu.plot.tsne import _knn_blocked as jknn

        rng = np.random.default_rng(1)
        x = rng.integers(-1, 2, (60, 3)).astype(np.float32)
        idx, d2k = _knn_blocked(_t(x), k=9, block=16, row_chunk=25)
        jidx, jd2k = jknn(jnp.asarray(x), k=9, block=16)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(d2k.numpy(), np.asarray(jd2k))

    def test_sparse_p_and_symmetrize_are_the_references(self):
        import jax.numpy as jnp

        from deeplearning4j_tpu.plot import tsne as J

        rng = np.random.default_rng(1)
        x = rng.normal(size=(64, 6)).astype(np.float32)
        idx, d2k = _knn_blocked(_t(x), k=20, block=16)
        p = _sparse_p_search(d2k, perplexity=6.0)
        jp = J._sparse_p_search(jnp.asarray(d2k.numpy()), perplexity=6.0)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
        s = _symmetrize_sparse(idx, p, row_block=16)
        js = J._symmetrize_sparse(jnp.asarray(idx.numpy().astype(np.int32)),
                                  jnp.asarray(p.numpy()), row_block=16)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-7)

    def test_sparse_p_matches_dense_binary_search_at_full_k(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(64, 6)).astype(np.float32)
        n = x.shape[0]
        d2 = np.sum(x * x, 1)[:, None] + np.sum(x * x, 1)[None, :] - 2 * (x @ x.T)
        np.fill_diagonal(d2, 0.0)
        P_dense = _binary_search_p(np.maximum(d2, 0.0), perplexity=10.0)
        P_dense = (P_dense + P_dense.T) / (2.0 * n)
        idx, d2k = _knn_blocked(_t(x), k=n - 1, block=16)
        p_cond = _sparse_p_search(d2k, perplexity=10.0)
        P_sym = _symmetrize_sparse(idx, p_cond, row_block=16).numpy()
        dense_from_sparse = np.zeros((n, n))
        np.put_along_axis(dense_from_sparse, idx.numpy(), P_sym, axis=1)
        np.testing.assert_allclose(dense_from_sparse, P_dense, atol=2e-6)

    def test_step_matches_dense_exactly(self):
        rng = np.random.default_rng(2)
        n, k = 64, 63
        Ynp = rng.normal(0, 1.0, (n, 2)).astype(np.float32)
        idx = _t(np.stack([np.delete(np.arange(n), i) for i in range(n)]))
        Pk = rng.random((n, k)).astype(np.float32)
        Pd_cond = np.zeros((n, n), np.float32)
        np.put_along_axis(Pd_cond, idx.numpy(), Pk, axis=1)
        P_dense = (Pd_cond + Pd_cond.T) / (2.0 * n)
        P_sym = _symmetrize_sparse(idx, _t(Pk), row_block=16)
        y1, _, _, kl1 = _tsne_step(_t(P_dense), _t(Ynp), torch.zeros(n, 2), torch.ones(n, 2),
                                   0.5, 200.0)
        y2, _, _, kl2 = _chunked_tsne_step(idx, _t(Pk), P_sym, _t(Ynp), torch.zeros(n, 2),
                                           torch.ones(n, 2), 0.5, 200.0, 16)
        np.testing.assert_allclose(y2.numpy(), y1.numpy(), atol=2e-4)
        np.testing.assert_allclose(float(kl2), float(kl1), rtol=1e-4)

    def test_asymmetric_inlink_attracts_both_endpoints(self):
        n = 8
        idx = np.tile(np.arange(1, 8), (n, 1))
        for i in range(1, 8):
            idx[i] = np.delete(np.arange(n), [i, 0])[:7].tolist() + [1]
        idx = _t(idx[:, :4])
        P = torch.zeros((n, 4))
        P[0, 3] = 1.0
        tgt = int(idx[0, 3])
        Y = _t(np.eye(n, 2, dtype=np.float32) * 10)
        y2, _, _, _ = _chunked_tsne_step(idx, P, P, Y, torch.zeros(n, 2), torch.ones(n, 2),
                                         0.0, 1000.0, 4)
        moved = np.abs(y2.numpy() - (Y - Y.mean(0, keepdim=True)).numpy())
        assert moved[tgt].max() > 1e-4

    def test_short_run_tracks_exact_at_full_k(self):
        rng = np.random.default_rng(2)
        x, _ = _blobs(rng, 96, d=8)
        kw = dict(perplexity=8.0, max_iter=3, stop_lying_iteration=20,
                  momentum_switch=40, seed=5, device="cpu")
        y_exact = Tsne(method="exact", **kw).fit_transform(x)
        y_chunk = Tsne(method="chunked", knn_k=95, block_size=32, **kw).fit_transform(x)
        np.testing.assert_allclose(y_chunk, y_exact, atol=0.01)

    def test_auto_method_selects_chunked(self, monkeypatch):
        from deeplearning4j_tpu_torch.plot import tsne as T

        seen = []
        real = T._chunked_tsne_step
        monkeypatch.setattr(T, "_chunked_tsne_step",
                            lambda *a: seen.append(1) or real(*a))
        t = Tsne(auto_chunk_threshold=50, max_iter=5, perplexity=5.0, device="cpu")
        x, _ = _blobs(np.random.default_rng(3), 128, d=6)
        y = t.fit_transform(x)
        assert y.shape == (128, 2) and np.isfinite(y).all() and len(seen) == 5


@pytest.mark.parametrize("which", ["exact", "chunked"])
def test_steps_from_carried_state_are_the_references(which):
    """Ten iterations, each port step taken from the reference's state of
    that iteration (the schedule's exaggeration and momentum switch
    included).  Y, the gains and the KL are within 1e-5 of the
    reference's, norm-relative.  The gradient's sum over j of
    p·q·(y_i − y_j) cancels, so f32 rounding in any order moves single
    velocity entries by up to 6.6e-5 relative (measured against the
    reference); every array, velocity included, must therefore be as
    close to the float64 evaluation of the same step (the port's step on
    f64 copies of the inputs) as the reference is: within twice the
    reference's own distance to it, plus 1e-6 of its norm."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.plot import tsne as J

    rng = np.random.default_rng(7)
    n = 80
    x, _ = _blobs(rng, n, d=5)
    Y = (rng.normal(0, 1e-2, (n, 2))).astype(np.float32)
    vel, gains = np.zeros_like(Y), np.ones_like(Y)
    if which == "exact":
        d2 = np.sum(x * x, 1)[:, None] + np.sum(x * x, 1)[None, :] - 2 * (x @ x.T)
        np.fill_diagonal(d2, 0.0)
        P = _binary_search_p(np.maximum(d2, 0.0).astype(np.float64), 10.0)
        P = np.maximum((P + P.T) / (2.0 * n), 1e-12).astype(np.float32)
    else:
        jidx, jd2k = J._knn_blocked(jnp.asarray(x), 30, 32)
        jp = J._sparse_p_search(jd2k, 10.0)
        jsym = jnp.maximum(J._symmetrize_sparse(jidx, jp, row_block=32), 1e-12)
        idx = _t(np.asarray(jidx).astype(np.int64))
        p, sym = np.asarray(jp), np.asarray(jsym)
    norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
    for it in range(10):
        ex = 12.0 if it < 4 else 1.0
        mom = np.float32(0.5 if it < 7 else 0.8)
        if which == "exact":
            want = J._tsne_step(jnp.asarray(P * ex), jnp.asarray(Y), jnp.asarray(vel),
                                jnp.asarray(gains), jnp.asarray(mom), 200.0)
            args = [P * ex, Y, vel, gains]
            step = lambda a, f: _tsne_step(*[_t(v).to(f) for v in a], float(mom), 200.0)
        else:
            want = J._chunked_tsne_step(jidx, jnp.asarray(p * ex), jsym, jnp.asarray(Y),
                                        jnp.asarray(vel), jnp.asarray(gains),
                                        jnp.asarray(mom), 200.0, 32)
            args = [p * ex, sym, Y, vel, gains]
            step = lambda a, f: _chunked_tsne_step(idx, *[_t(v).to(f) for v in a],
                                                   float(mom), 200.0, 32)
        got = step(args, torch.float32)
        truth = step(args, torch.float64)
        for name, g, w, t64 in zip(("Y", "velocity", "gains", "kl"), got, want, truth):
            g, w, t64 = g.numpy(), np.asarray(w), t64.numpy()
            if name != "velocity":
                assert norm(g - w) <= 1e-5 * norm(w), (it, name, norm(g - w) / norm(w))
            assert norm(g - t64) <= 2 * norm(w - t64) + 1e-6 * norm(t64), \
                (it, name, norm(g - t64), norm(w - t64))
        Y, vel, gains = (np.array(w) for w in want[:3])


class TestQuality:
    def test_blob_separation_with_sparse_k(self):
        rng = np.random.default_rng(4)
        x, lab = _blobs(rng, 600, centers=3, d=12)
        y = Tsne(method="chunked", perplexity=20.0, max_iter=250, block_size=128, seed=0,
                 device="cpu").fit_transform(x)
        cents = np.stack([y[lab == c].mean(0) for c in range(3)])
        within = max(np.linalg.norm(y[lab == c] - cents[c], axis=1).mean() for c in range(3))
        between = min(np.linalg.norm(cents[a] - cents[b])
                      for a in range(3) for b in range(a + 1, 3))
        assert between > 2.0 * within, (between, within)

    def test_separates_iris(self):
        from deeplearning4j_tpu_torch.datasets.fetchers import load_iris

        xs, ys = load_iris()
        x = np.asarray(xs, np.float64)
        y = np.argmax(np.asarray(ys), axis=1) if np.asarray(ys).ndim == 2 else np.asarray(ys)
        emb = Tsne(perplexity=20.0, max_iter=300, seed=3, device="cpu").fit_transform(x)
        assert emb.shape == (len(x), 2)
        setosa, rest = emb[y == 0], emb[y != 0]
        intra = np.linalg.norm(setosa - setosa.mean(0), axis=1).mean()
        inter = np.min(np.linalg.norm(setosa[:, None, :] - rest[None, :, :], axis=-1))
        assert inter > intra, f"inter={inter:.2f} intra={intra:.2f}"

    def test_kl_drops_and_finite(self):
        rng = np.random.default_rng(0)
        x = np.concatenate([rng.normal(0, 1, (30, 5)), rng.normal(8, 1, (30, 5))])
        t = Tsne(perplexity=10.0, max_iter=250, seed=0, device="cpu")
        emb = t.fit_transform(x)
        assert np.isfinite(emb).all()
        assert t.kl_divergence_ is not None and t.kl_divergence_ < 1.0

    def test_validation(self):
        with pytest.raises(ValueError, match="perplexity"):
            Tsne(perplexity=30.0, device="cpu").fit_transform(np.zeros((10, 3)))
        with pytest.raises(ValueError, match="method"):
            Tsne(method="barnes", device="cpu")
        with pytest.raises(ValueError, match="knn_k"):
            Tsne(method="chunked", knn_k=3, perplexity=5.0, device="cpu").fit_transform(
                np.random.default_rng(0).normal(size=(40, 3)))


@pytest.mark.skipif(os.environ.get("TSNE_BIG") != "1",
                    reason="500K-point demo: set TSNE_BIG=1 (minutes; the card if present)")
def test_500k_points_bounded_memory():
    rng = np.random.default_rng(0)
    x, _ = _blobs(rng, 500_000, centers=10, d=16)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    y = Tsne(method="chunked", perplexity=30.0, max_iter=3, stop_lying_iteration=2,
             block_size=1024, device=dev).fit_transform(x)
    assert y.shape == (500_000, 2) and np.isfinite(y).all()
