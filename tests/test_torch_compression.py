"""The port's gradient compression (``deeplearning4j_tpu_torch/ops/compression.py``)
against the JAX package's on the same numpy gradients.

What must match, and how:
  - K6's plain version ``_streaming_pack``: bitwise the JAX ``_pallas_pack``
    (interpret mode, as the JAX tests run it on the CPU) and the JAX
    ``_streaming_pack`` — index-ascending slots fix the order;
  - encoded messages: as sorted sets (and entry for entry where both
    sides order them the same way: top-k with ties to the lower index);
  - scales: exactly in the fixed-threshold modes (scale = t); within 4
    float32 spacings in the adaptive modes, whose scale is a mean of k or
    n magnitudes that XLA and PyTorch sum in different orders;
  - decoded values: bitwise, from the same message and scale; and the
    decode of each package's own encode bitwise wherever the scales are
    exact (the adaptive ones then differ only by that scale gap).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import compression as T


def _jax():
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops import compression as J
    return J, jnp


def grad(n=4096, seed=0, sparse_frac=0.02, t=1e-3):
    """Gradient where ~sparse_frac of elements clear the threshold (the
    JAX package's tests/test_fused_encode.py generator)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=n).astype(np.float32) * (t / 10)
    hot = rng.choice(n, max(1, int(n * sparse_frac)), replace=False)
    g[hot] = rng.normal(size=hot.size).astype(np.float32) * 10 * t
    return g


def exact_k(n=4096, seed=5, t=1e-3, extra=0):
    """Exactly default_k_max(n) + extra elements clear t."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-0.5, 0.5, size=n).astype(np.float32) * t
    hot = rng.choice(n, T.default_k_max(n) + extra, replace=False)
    g[hot] = np.where(rng.random(hot.size) < 0.5, -1, 1) * (t + rng.random(hot.size) * t)
    return g.astype(np.float32)


def _ulps(a, b):
    return abs(float(a) - float(b)) / float(np.spacing(np.float32(max(abs(a), abs(b), 1e-30))))


def top_k_only(g, sizes, ks, t, out=None):
    """Stands in for ``one_pass_pack``: reports every bucket as
    overflowing, so the top-k pack encodes all of them."""
    return out, torch.tensor([k + 1 for k in ks])


_PACK_CASES = [(n, kind) for n in (1024, 4096, 4096 + 77) for kind in ("hot", "none", "exact_k")]


@pytest.mark.parametrize("n,kind", _PACK_CASES, ids=[f"{n}_{k}" for n, k in _PACK_CASES])
def test_streaming_pack_is_bitwise_the_jax_pallas_kernel(n, kind):
    J, jnp = _jax()
    t = 1e-3
    g = {"hot": grad(n, seed=n), "none": grad(n, seed=n) * 1e-3,
         "exact_k": exact_k(n, seed=n)}[kind]
    k = J.default_k_max(n)
    got = T._streaming_pack(torch.from_numpy(g), torch.from_numpy(np.abs(g)), k, t, n).numpy()
    pallas = np.asarray(J._pallas_pack(jnp.asarray(g), k, t, n))
    stream = np.asarray(J._streaming_pack(jnp.asarray(g), jnp.abs(jnp.asarray(g)), k, t, n))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, stream)
    want = {"hot": None, "none": 0, "exact_k": k}[kind]
    if want is not None:
        assert int((got != 0).sum()) == want


# (name, gradient, k_max, threshold, one-pass route): with the route off
# the port's top-k pack encodes every bucket (``top_k_only``) and the JAX
# package runs with its one-pass switch off; with it on, the port routes
# as it always does and the JAX switch is on
def _encode_cases():
    lin = (np.linspace(1.0, 2.0, 64, dtype=np.float32) * np.resize([1, -1], 64)).astype(np.float32)
    return {
        "adaptive": (grad(4096, 1), 256, None, False),
        "adaptive_ragged": (grad(4096 + 77, 2), T.default_k_max(4096 + 77), None, False),
        "fixed_top_k": (grad(4096, 3), 256, 1e-3, False),
        "fixed_one_pass": (grad(4096, 3), 256, 1e-3, True),
        "overflow_top_k": (lin, 8, 0.5, False),
        "overflow_one_pass": (lin, 8, 0.5, True),
        "all_below_top_k": (np.asarray([1e-5, -2e-5, 0.0, 3e-5], np.float32), 2, 0.5, False),
        "all_below_one_pass": (np.asarray([1e-5, -2e-5, 0.0, 3e-5], np.float32), 2, 0.5, True),
        "zero_adaptive": (np.zeros(8, np.float32), 3, None, False),
        "zero_fixed_one_pass": (np.zeros(128, np.float32), 8, 1e-3, True),
        "reference_example": (np.asarray([0.5, -0.2, 0.0, 0.01, -0.9, 0.0], np.float32), 4, 0.1,
                              False),
    }


@pytest.mark.parametrize("name", list(_encode_cases()))
def test_threshold_encode_matches_jax(name, monkeypatch):
    J, jnp = _jax()
    g, k, t, on = _encode_cases()[name]
    monkeypatch.setattr(J, "FUSED_ENCODE", on)
    if not on:
        monkeypatch.setattr(T, "one_pass_pack", top_k_only)
    je, js = J.threshold_encode(jnp.asarray(g), k, t)
    te, ts = T.threshold_encode(torch.from_numpy(g), k, t)
    je = np.array(je)
    assert te.dtype == torch.int32 and te.shape == je.shape
    assert sorted(te.tolist()) == sorted(je.tolist())
    if not on or name.startswith("overflow"):
        # top-k order, ties to the lower index, on both sides
        np.testing.assert_array_equal(te.numpy(), je)
    n = g.shape[0]
    jd = np.asarray(J.threshold_decode(jnp.asarray(je), js, n))
    np.testing.assert_array_equal(T.threshold_decode(torch.from_numpy(je),
                                                     torch.tensor(float(js)), n).numpy(), jd)
    td = T.threshold_decode(te, ts, n).numpy()
    if t is None:
        assert _ulps(ts.item(), float(js)) <= 4
        np.testing.assert_array_equal(np.sign(td), np.sign(jd))
        np.testing.assert_allclose(td, jd, rtol=4 * 2.0 ** -23, atol=0)
    else:
        assert ts.item() == float(js)
        np.testing.assert_array_equal(td, jd)


def test_one_pass_orders_by_index_and_decodes_like_top_k(monkeypatch):
    g = grad(4096, 7)
    one, s1 = T.threshold_encode(torch.from_numpy(g), 256, 1e-3)
    monkeypatch.setattr(T, "one_pass_pack", top_k_only)
    top, s2 = T.threshold_encode(torch.from_numpy(g), 256, 1e-3)
    idx = (one[one != 0].abs() - 1).tolist()
    assert idx == sorted(idx) and len(idx) > 0
    assert (one.tolist() != top.tolist()) and sorted(one.tolist()) == sorted(top.tolist())
    np.testing.assert_array_equal(T.threshold_decode(one, s1, 4096).numpy(),
                                  T.threshold_decode(top, s2, 4096).numpy())


def test_bucket_encode_counts_then_routes(monkeypatch):
    """One one-pass pack takes every bucket of the step and counts each;
    a bucket whose count fits k keeps its one-pass message (index order)
    and one that overflows is encoded again by the top-k pack, as the
    reference's lax.cond does per bucket."""
    J, jnp = _jax()
    monkeypatch.setattr(J, "FUSED_ENCODE", True)
    calls = []
    one_pass = T.one_pass_pack
    monkeypatch.setattr(T, "one_pass_pack", lambda *a: calls.append(1) or one_pass(*a))
    fits, over = grad(2048, 11), grad(2048, 12, sparse_frac=0.2)
    k = T.default_k_max(2048)
    c_fit, c_over = int((np.abs(fits) >= 1e-3).sum()), int((np.abs(over) >= 1e-3).sum())
    assert c_fit <= k < c_over
    out, counts = T.threshold_encode_buckets([torch.from_numpy(b) for b in (fits, over, fits)],
                                             threshold=1e-3)
    assert len(calls) == 1 and counts == [(c_fit, k), (c_over, k), (c_fit, k)]
    for (enc, scale), b in zip(out, (fits, over, fits)):
        je, js = J.threshold_encode(jnp.asarray(b), k, 1e-3)
        assert sorted(enc.tolist()) == sorted(np.asarray(je).tolist())
        assert scale.item() == float(js)
    assert out[0][0].tolist() == out[2][0].tolist()
    np.testing.assert_array_equal(out[1][0].numpy(), np.asarray(J.threshold_encode(
        jnp.asarray(over), k, 1e-3)[0]))


def _step_case(name):
    """(bucket sizes, flat gradient, {bucket: selection count it must have})
    of one step's layout at t = 1e-3; sizes from ``GradBucketer`` where a
    case is about its bucket_bytes."""
    def layout(total, bucket_bytes):
        return T.GradBucketer([{"W": torch.zeros(total)}], bucket_bytes).bucket_sizes()

    if name == "uneven_last_bucket":
        sizes = layout(3 * 2048 + 999, 4 * 2048)
        return sizes, grad(sum(sizes), 60), {}
    if name == "bucket_bytes_not_a_multiple_of_16":
        sizes = layout(4000, 4 * 1001 + 2)          # 1001-element buckets
        return sizes, grad(sum(sizes), 61), {}
    if name == "one_bucket":
        return [4096 + 77], grad(4096 + 77, 62), {}
    k = T.default_k_max(2048)
    middle = {"no_selection": (grad(2048, 63) * 1e-3, 0),
              "exactly_k": (exact_k(2048, 64), k),
              "k_plus_1": (exact_k(2048, 65, extra=1), k + 1)}[name]
    return [2048] * 3, np.concatenate([grad(2048, 66), middle[0], grad(2048, 67)]), \
        {1: middle[1]}


_STEP_CASES = ["uneven_last_bucket", "bucket_bytes_not_a_multiple_of_16", "no_selection",
               "exactly_k", "k_plus_1", "one_bucket"]


@pytest.mark.parametrize("name", _STEP_CASES)
def test_step_encode_matches_jax_per_bucket(name, monkeypatch):
    """One step's fixed-threshold encode over every bucket: K6's plain
    version (``threshold_encode_buckets_plain``) gives, bucket by bucket,
    the JAX ``_streaming_pack`` bitwise with the counts exact; the wire that
    ``encode_wire`` builds from it (a bucket over k encoded again by the
    top-k pack) holds, bucket by bucket, the JAX package's
    ``threshold_encode`` bitwise (its one-pass switch on) and the scale t;
    and ``compressed_pmean``'s wire decodes as the JAX decode of each."""
    J, jnp = _jax()
    monkeypatch.setattr(J, "FUSED_ENCODE", True)
    t = 1e-3
    sizes, g, want = _step_case(name)
    flat = torch.from_numpy(g)
    buckets = list(flat.split(sizes))
    ks = [T.default_k_max(n) for n in sizes]
    msgs, counts = T.threshold_encode_buckets_plain(flat, sizes, ks, t)
    wire, lens, routed = T.encode_wire(buckets, "threshold", t)
    _, local = T.compressed_pmean(buckets, threshold=t, gather=lambda w: w[None])
    want_counts = [int((np.abs(b.numpy()) >= t).sum()) for b in buckets]
    assert counts.tolist() == want_counts and lens == ks
    assert routed == list(zip(want_counts, ks))
    assert all(want_counts[b] == c for b, c in want.items())
    scales = wire[sum(ks):].view(torch.float32)
    for i, (b, m, k) in enumerate(zip(buckets, T._prefix(ks), ks)):
        gb = jnp.asarray(b.numpy())
        np.testing.assert_array_equal(
            msgs[m:m + k].numpy(),
            np.asarray(J._streaming_pack(gb, jnp.abs(gb), k, t, b.numel())))
        je, js = J.threshold_encode(gb, k, t)
        np.testing.assert_array_equal(wire[m:m + k].numpy(), np.asarray(je))
        assert scales[i].item() == float(js)
        np.testing.assert_array_equal(local[i].numpy(),
                                      np.asarray(J.threshold_decode(je, js, b.numel())))


@pytest.mark.parametrize("seg_tiles", [1, 2])
def test_encode_tables_are_the_kernels_structs(seg_tiles):
    """K6's tables: per bucket int64 g_off and msg_off, then int32 n, k,
    first segment and segments (an empty bucket gets one); per segment
    int64 first element, then int32 bucket and valid elements."""
    table, segs, n_segs = T._encode_table((4096, 8193, 0, 1000), (256, 512, 3, 62), seg_tiles,
                                          torch.device("cpu"))
    rows = table.view(torch.int32).reshape(4, 8)
    assert table[:, 0].tolist() == [0, 4096, 12289, 12289]
    assert table[:, 1].tolist() == [0, 256, 768, 771]
    want = {1: ([[0, 1], [1, 3], [4, 1], [5, 1]],
                [0, 4096, 8192, 12288, 12289, 12289], [[0, 4096], [1, 4096], [1, 4096],
                                                       [1, 1], [2, 0], [3, 1000]]),
            2: ([[0, 1], [1, 2], [3, 1], [4, 1]],
                [0, 4096, 12288, 12289, 12289], [[0, 4096], [1, 8192], [1, 1], [2, 0],
                                                 [3, 1000]])}[seg_tiles]
    assert rows[:, 4:6].tolist() == [[4096, 256], [8193, 512], [0, 3], [1000, 62]]
    assert rows[:, 6:].tolist() == want[0]
    assert n_segs == len(want[1]) and segs[:, 0].tolist() == want[1]
    assert segs.view(torch.int32).reshape(-1, 4)[:, 2:].tolist() == want[2]


def test_segment_length_keeps_small_launches_one_tile_a_block():
    assert T._seg_tiles(256, 132) == 1                  # one 4 MiB bucket
    assert T._seg_tiles(39_827, 132) == T.ENC_SEG_TILES  # the 156-bucket step
    assert T._seg_tiles(4 * 1056, 132) == 4


def test_step_buckets_reach_the_one_pass_pack_as_one_view(monkeypatch):
    """The trainer's buckets are consecutive slices of one buffer: the
    one-pass pack gets that buffer itself, not a concatenation; buckets
    from separate tensors are concatenated."""
    seen = []
    one_pass = T.one_pass_pack
    monkeypatch.setattr(T, "one_pass_pack", lambda g, *a: seen.append(g) or one_pass(g, *a))
    flat = torch.from_numpy(grad(5000, 68))
    bucketer = T.GradBucketer([{"W": flat}], 4 * 1001)
    T.encode_wire(bucketer.split(flat), "threshold", 1e-3)
    assert seen[0].data_ptr() == flat.data_ptr() and seen[0].numel() == 5000
    parts = [b.clone() for b in bucketer.split(flat)]
    T.encode_wire(parts, "threshold", 1e-3)
    assert seen[1].data_ptr() != flat.data_ptr() and torch.equal(seen[1], flat)


def test_threshold_encode_kernels_raise_for_cpu_tensors():
    """On the CPU only the plain version runs; the kernels' wrappers raise."""
    with pytest.raises(ValueError, match="CUDA"):
        T.threshold_encode_buckets_cuda(torch.ones(8), [8], [1], 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        T.threshold_encode_cuda(torch.ones(8), 1, 0.5)


def test_empty_gradient_edges():
    J, jnp = _jax()
    enc, scale = T.threshold_encode(torch.zeros(0), 0)
    jenc, _ = J.threshold_encode(jnp.zeros((0,)), 0)
    assert enc.shape == tuple(jenc.shape) == (0,)
    assert T.threshold_decode(enc, scale, 0).shape == (0,)
    words, s = T.bitmap_encode(torch.zeros(0))
    assert words.shape == (0,) and T.bitmap_decode(words, s, 0).shape == (0,)


def test_rejects_nonpositive_threshold():
    with pytest.raises(ValueError, match="threshold"):
        T.threshold_encode(torch.ones(4), 2, threshold=0.0)
    with pytest.raises(ValueError, match="threshold"):
        T.bitmap_encode(torch.ones(4), threshold=-1.0)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("method,t", [("threshold", None), ("threshold", 1e-3),
                                      ("bitmap", None), ("bitmap", 1e-3)])
def test_stacked_decode_matches_jax(p, method, t):
    """P gathered messages (each from its own gradient) decode-sum to the
    JAX decode's bits."""
    J, jnp = _jax()
    n = 4096 + 77
    msgs = []
    for i in range(p):
        g = jnp.asarray(grad(n, 20 + i))
        msgs.append(J.threshold_encode(g, J.default_k_max(n), t) if method == "threshold"
                    else J.bitmap_encode(g, t))
    enc = np.stack([np.asarray(e) for e, _ in msgs])
    scales = np.stack([np.asarray(s) for _, s in msgs]).astype(np.float32)
    jdec = (J.threshold_decode if method == "threshold" else J.bitmap_decode)(
        jnp.asarray(enc), jnp.asarray(scales), n)
    tenc = torch.from_numpy(enc.view(np.int32))
    tdec = T.decode(method, tenc, torch.from_numpy(scales), n)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))


@pytest.mark.parametrize("t", [None, 0.1, 1e-3])
@pytest.mark.parametrize("n", [24, 4096 + 77])
def test_bitmap_matches_jax(n, t):
    J, jnp = _jax()
    g = grad(n, 30) if n > 24 else np.asarray([0.5, -0.2, 0.05, -0.9] + [0.0] * 20, np.float32)
    jw, js = J.bitmap_encode(jnp.asarray(g), t)
    tw, ts = T.bitmap_encode(torch.from_numpy(g), t)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))
    jd = np.asarray(J.bitmap_decode(jw, js, n))
    np.testing.assert_array_equal(
        T.bitmap_decode(tw, torch.tensor(float(js)), n).numpy(), jd)
    if t is None:
        assert _ulps(ts.item(), float(js)) <= 4
    else:
        assert ts.item() == float(js)
        np.testing.assert_array_equal(T.bitmap_decode(tw, ts, n).numpy(), jd)


def test_bitmap_zero_gradient_sends_nothing():
    w, s = T.bitmap_encode(torch.zeros(4))
    assert T.bitmap_decode(w, s, 4).tolist() == [0.0] * 4


def test_error_feedback_identity():
    """decode(encode(acc)) + residual == acc: nothing is dropped."""
    acc = torch.from_numpy(np.random.default_rng(1).normal(size=64).astype(np.float32))
    for method in T.METHODS:
        enc, scale = T.encode_buckets([acc], method)[0][0]
        dec = T.decode(method, enc, scale, 64)
        np.testing.assert_array_equal((dec + (acc - dec)).numpy(), acc.numpy())


def test_compressed_pmean_over_a_given_gather():
    """One gather carries every bucket; P identical participants average
    to the local decode."""
    buckets = [torch.from_numpy(grad(1000, 40)), torch.from_numpy(grad(77, 41))]
    for method in T.METHODS:
        means, local = T.compressed_pmean(buckets, method=method,
                                          gather=lambda w: torch.stack([w, w, w]))
        for m, loc in zip(means, local):
            np.testing.assert_array_equal(m.numpy(), (loc * 3 / 3).numpy())
        mean, loc = T.compressed_pmean(buckets[0], method=method, gather=lambda w: w[None])
        np.testing.assert_array_equal(mean.numpy(), loc.numpy())


@pytest.mark.parametrize("method,t", [("threshold", None), ("threshold", 1e-3),
                                      ("bitmap", None), ("bitmap", 1e-3)])
def test_compressed_pmean_decodes_every_bucket_like_jax(method, t):
    """Three participants, four buckets of ragged sizes: the decode over
    the whole flat buffer gives, bitwise, the JAX decode of each bucket's
    gathered stack (divided by P), and of this participant's own message."""
    J, jnp = _jax()
    sizes = [2048, 1000, 77, 4096 + 5]
    parts = [[torch.from_numpy(grad(n, 50 + 10 * p + i)) for i, n in enumerate(sizes)]
             for p in range(3)]
    msgs = [T.encode_buckets(bs, method, t)[0] for bs in parts]
    stacked = torch.stack([T.pack_messages(m) for m in msgs])
    means, local = T.compressed_pmean(parts[1], method=method, threshold=t,
                                      gather=lambda w: stacked)
    jdecode = J.threshold_decode if method == "threshold" else J.bitmap_decode
    as_wire = (lambda e: e) if method == "threshold" else (lambda e: e.view(np.uint32))
    for i, n in enumerate(sizes):
        enc = np.stack([as_wire(m[i][0].numpy()) for m in msgs])
        scales = np.stack([m[i][1].numpy() for m in msgs]).astype(np.float32)
        want = np.asarray(jdecode(jnp.asarray(enc), jnp.asarray(scales), n)) / np.float32(3)
        np.testing.assert_array_equal(means[i].numpy(), want)
        np.testing.assert_array_equal(
            local[i].numpy(), np.asarray(jdecode(jnp.asarray(enc[1]), jnp.asarray(scales[1]), n)))


def test_bucketer_partition_matches_jax():
    J, jnp = _jax()
    rng = np.random.default_rng(2)
    tree = [{"W": rng.normal(size=(3, 4)).astype(np.float32), "b": np.ones(4, np.float32)},
            {}, {"W": np.full((2, 2), 2.0, np.float32)}]
    jb = J.GradBucketer([{k: jnp.asarray(v) for k, v in l.items()} for l in tree],
                        bucket_bytes=16)
    ttree = [{k: torch.from_numpy(v) for k, v in l.items()} for l in tree]
    tb = T.GradBucketer(ttree, bucket_bytes=16)
    assert tb.total == jb.total == 20 and tb.bounds == jb.bounds
    for a, b in zip(tb.flatten(ttree), jb.flatten(jb.treedef.unflatten(
            [jnp.asarray(x) for x in (tree[0]["W"], tree[0]["b"], tree[2]["W"])]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rt = tb.unflatten(tb.flatten(ttree))
    for l, r in zip(ttree, rt):
        assert sorted(l) == sorted(r)
        for k in l:
            np.testing.assert_array_equal(l[k].numpy(), r[k].numpy())


def test_bucketer_unflatten_cast_false_keeps_f32():
    tree = [{"W": torch.ones((2, 2), dtype=torch.bfloat16)}]
    b = T.GradBucketer(tree)
    assert b.unflatten(b.flatten(tree), cast=False)[0]["W"].dtype == torch.float32
    assert b.unflatten(b.flatten(tree))[0]["W"].dtype == torch.bfloat16


@pytest.mark.parametrize("method", ["threshold", "bitmap"])
@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 20, 25_600_000, 163_131_264])
def test_wire_model_matches_jax(method, n):
    J, _ = _jax()
    assert T.encoded_message_bytes(n, method) == J.encoded_message_bytes(n, method)
    for slices in (2, 4):
        assert T.compression_stats(n, method, slices) == J.compression_stats(n, method, slices)
    if n >= 1000:
        assert T.compression_stats(n, method, 2)["wire_ratio"] >= 8.0
