"""Disaggregated prefill/decode in the port against the JAX package's
(the port's counterpart of ``tests/test_disagg.py``).

The same small LM (vocab 48, 2 blocks, d_model 32, 2 heads, max_len 32)
is saved by the JAX package and loaded by the port.  The contracts:

  - the page-transfer wire is the reference's byte for byte: bytes packed
    by either package unpack in the other bitwise, f32 and int8; corrupt,
    truncated or bad-magic input raises ``ValueError``
  - a prefill host → handoff → decode host pipeline reproduces the
    port's unified engine: tokens equal and echoed logits bitwise, greedy
    and seeded; greedy tokens equal the reference's plain engine on the
    same weights
  - a decode host refuses prompts, fails a corrupt handoff alone with its
    pool partition intact, and dedups prefix-shared pages
  - a one-way prefill host feeds a two-head-shard decode sink
  - the fleet router runs the two stages; a prefill-host kill re-runs
    requests elsewhere with the same tokens
  - the mesh is part of a warm bundle's fingerprint
  - a prefill host's /generate answers 409 ``prefill_role``
"""

import dataclasses
import json
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest

from deeplearning4j_tpu.models.transformer import TransformerDecodeAdapter as JAdapter
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.ops import kv_cache as jkv
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
from deeplearning4j_tpu_torch.ops import kv_cache as tkv
from deeplearning4j_tpu_torch.serving import (DecodeEngine, FleetHost, FleetRouter,
                                              PrefillHandoff, device_fingerprint,
                                              load_bundle, save_bundle)
from deeplearning4j_tpu_torch.utils.serializer import load_model

VOCAB, MAXLEN, PAGE = 48, 32, 8
SIZE = dict(vocab_size=VOCAB, n_layers=2, d_model=32, n_heads=2, max_len=MAXLEN)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jn = JLM(**SIZE, seed=11)
    path = str(tmp_path_factory.mktemp("ckpt") / "lm.zip")
    j_save(jn, path)
    return jn, load_model(path, device="cpu")


def _engine(net, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("default_max_new", 8)
    return DecodeEngine(TransformerDecodeAdapter(net), device="cpu", **kw).load()


@pytest.fixture(scope="module")
def unified(models):
    eng = _engine(models[1])
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def pre(models):
    eng = _engine(models[1], role="prefill")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def dec(models):
    eng = _engine(models[1], role="decode")
    yield eng
    eng.shutdown()


def _partition_ok(engine):
    st = engine._debug_page_state()
    return sorted(st["free"] + st["private"] + st["trie"]) == list(range(1, engine.total_pages))


# -- the wire ------------------------------------------------------------------------


def _f32_transfer(pkg, n_pages=3):
    rng = np.random.default_rng(0)
    shape = (2, n_pages, PAGE, 2, 16)
    return pkg.PageTransfer(n_pages=n_pages,
                            k=rng.standard_normal(shape).astype(np.float32),
                            v=rng.standard_normal(shape).astype(np.float32))


def _int8_transfer(pkg):
    rng = np.random.default_rng(1)
    q = rng.integers(-128, 128, size=(2, 2, PAGE, 2, 16), dtype=np.int8)
    scale = rng.random((2, 2, PAGE), dtype=np.float32)
    return pkg.PageTransfer(n_pages=2, k=pkg.QuantPages(q, scale),
                            v=pkg.QuantPages(q[::-1].copy(), scale * 2))


def _sides_equal(a, b):
    if isinstance(a, tuple):
        assert type(b).__name__ == "QuantPages"
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    else:
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("make", [_f32_transfer, _int8_transfer], ids=["f32", "int8"])
@pytest.mark.parametrize("src,dst", [(jkv, tkv), (tkv, jkv)], ids=["ref_to_port", "port_to_ref"])
def test_wire_round_trips_bitwise_across_packages(make, src, dst):
    t = make(src)
    data = src.pack_transfer(t)
    # the same transfer packs to the same bytes in both packages
    assert data == dst.pack_transfer(make(dst))
    back = dst.unpack_transfer(data)
    assert back.n_pages == t.n_pages
    _sides_equal(t.k, back.k)
    _sides_equal(t.v, back.v)


def test_transfer_nbytes_is_the_payload():
    t = _f32_transfer(tkv)
    assert tkv.transfer_nbytes(t) == t.k.nbytes + t.v.nbytes == jkv.transfer_nbytes(
        _f32_transfer(jkv))
    q = _int8_transfer(tkv)
    assert tkv.transfer_nbytes(q) == sum(a.nbytes for side in (q.k, q.v) for a in side)


@pytest.mark.parametrize("cut", [0, 4, 10, 40, -1])
def test_truncated_transfer_raises(cut):
    data = tkv.pack_transfer(_f32_transfer(tkv))
    with pytest.raises(ValueError):
        tkv.unpack_transfer(data[:cut])
    with pytest.raises(ValueError):
        jkv.unpack_transfer(data[:cut])


def test_bad_magic_and_corrupt_header_raise():
    data = tkv.pack_transfer(_f32_transfer(tkv))
    with pytest.raises(ValueError, match="magic"):
        tkv.unpack_transfer(b"XX" + data[2:])
    bad = bytearray(data)
    bad[20] ^= 0xFF               # inside the JSON header
    with pytest.raises(ValueError):
        tkv.unpack_transfer(bytes(bad))


@pytest.mark.parametrize("kind", ["f32", "int8", "sharded"])
def test_gather_and_set_pages_round_trip(kind):
    import torch

    n_heads = 4
    shard = [torch.device("cpu")] * 2 if kind == "sharded" else None
    kp, _ = tkv.alloc_cache(2, 6, PAGE, n_heads, 8, device="cpu",
                            kv_dtype="int8" if kind == "int8" else None,
                            shard_devices=shard)
    g = torch.Generator().manual_seed(0)
    for leaf in (kp if isinstance(kp, tuple) else (kp,)):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g).to(torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g))
    ids = torch.tensor([3, 1])
    payload = tkv.gather_pages(kp, ids)
    lead = payload.q if kind == "int8" else payload
    assert lead.shape == (2, 2, PAGE, n_heads, 8)      # all heads
    _, dst = tkv.alloc_cache(2, 6, PAGE, n_heads, 8, device="cpu",
                             kv_dtype="int8" if kind == "int8" else None,
                             shard_devices=shard)
    addrs = [leaf.data_ptr() for leaf in (dst if isinstance(dst, tuple) else (dst,))]
    tkv.set_pages(dst, torch.tensor([5, 2]), payload)
    assert addrs == [leaf.data_ptr() for leaf in (dst if isinstance(dst, tuple) else (dst,))]
    again = tkv.gather_pages(dst, torch.tensor([5, 2]))
    for a, b in zip(payload if kind == "int8" else (payload,),
                    again if kind == "int8" else (again,)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- engine-level handoff --------------------------------------------------------------


PROMPTS = ([1, 2, 3], [7, 4], list(range(12)))


def test_greedy_handoff_matches_unified_and_the_reference(models, unified, pre, dec):
    jeng = JEngine(JAdapter(models[0]), max_slots=3, page_size=PAGE).load()
    try:
        for i, prompt in enumerate(PROMPTS):
            ref = unified.generate(prompt, max_new_tokens=6, seed=i)
            h = pre.generate(prompt, max_new_tokens=6, seed=i)
            assert isinstance(h, PrefillHandoff)
            assert h.n_pages == tkv.pages_for(len(prompt), PAGE)
            got = dec.continue_async(h).result(timeout=60)
            assert got.tokens == ref.tokens
            assert got.tokens == jeng.generate(prompt, max_new_tokens=6, seed=i).tokens
    finally:
        jeng.shutdown()


def test_seeded_sampling_matches_unified(unified, pre, dec):
    kw = dict(max_new_tokens=8, temperature=0.8, top_k=5, seed=123)
    ref = unified.generate([3, 1, 4, 1, 5], **kw)
    got = dec.continue_async(pre.generate([3, 1, 4, 1, 5], **kw)).result(timeout=60)
    assert got.tokens == ref.tokens


def test_echoed_logits_are_bitwise_unified(unified, pre, dec):
    kw = dict(max_new_tokens=5, echo_logits=True, seed=0, temperature=0.7)
    ref = unified.generate([9, 8, 7, 6], **kw)
    got = dec.continue_async(pre.generate([9, 8, 7, 6], **kw)).result(timeout=60)
    assert got.tokens == ref.tokens
    assert got.logits.shape == ref.logits.shape
    np.testing.assert_array_equal(got.logits, ref.logits)


def test_handoff_counters(pre, dec):
    out0 = pre.metrics.snapshot()["counters"]["handoffs_out"]
    in0 = dec.metrics.snapshot()["counters"]["handoffs_in"]
    h = pre.generate([5, 6, 7, 8, 9, 10, 11, 12, 13], max_new_tokens=2)
    dec.continue_async(h).result(timeout=60)
    ps, ds = pre.metrics.snapshot()["counters"], dec.metrics.snapshot()["counters"]
    assert ps["handoffs_out"] == out0 + 1 and ps["pages_exported"] >= h.n_pages == 2
    assert ds["handoffs_in"] == in0 + 1 and ds["pages_attached"] >= 2
    assert pre.metrics_snapshot()["role"] == "prefill"
    assert dec.metrics_snapshot()["role"] == "decode"


def test_decode_role_refuses_prompts_and_unified_refuses_handoffs(unified, dec, pre):
    with pytest.raises(RuntimeError, match="continue_async"):
        dec.generate_async([1, 2, 3])
    with pytest.raises(RuntimeError, match="role='decode'"):
        unified.continue_async(pre.generate([1, 2], max_new_tokens=2))


def test_corrupt_handoff_fails_alone_with_the_pool_intact(pre, dec):
    h = pre.generate([1, 2, 3, 4, 5], max_new_tokens=3)
    bad = dataclasses.replace(h, pages=h.pages[:len(h.pages) // 2])
    with pytest.raises(ValueError):
        dec.continue_async(bad).result(timeout=60)
    wrong = dataclasses.replace(h, prompt=np.arange(12))     # 2 pages wanted, 1 sent
    with pytest.raises(ValueError, match="needs 2"):
        dec.continue_async(wrong).result(timeout=60)
    assert _partition_ok(dec)
    assert len(dec.continue_async(h).result(timeout=60).tokens) == 3
    assert _partition_ok(pre) and _partition_ok(dec)


def test_int8_pages_cross_bitwise(models):
    uni = _engine(models[1], kv_dtype="int8")
    p8 = _engine(models[1], kv_dtype="int8", role="prefill")
    d8 = _engine(models[1], kv_dtype="int8", role="decode")
    d32 = _engine(models[1], role="decode")
    try:
        kw = dict(max_new_tokens=6, echo_logits=True, seed=4, temperature=0.9)
        ref = uni.generate(list(range(10)), **kw)
        h = p8.generate(list(range(10)), **kw)
        t = tkv.unpack_transfer(h.pages)
        assert isinstance(t.k, tkv.QuantPages) and t.k.q.dtype == np.int8
        got = d8.continue_async(h).result(timeout=60)
        assert got.tokens == ref.tokens
        np.testing.assert_array_equal(got.logits, ref.logits)
        with pytest.raises(ValueError, match="pool layout"):      # int8 into f32
            d32.continue_async(h).result(timeout=60)
        assert _partition_ok(d32)
    finally:
        for e in (uni, p8, d8, d32):
            e.shutdown()


def test_prefix_shared_pages_are_deduped(models):
    p2 = _engine(models[1], role="prefill", prefix_cache=True, prompt_buckets=(MAXLEN,))
    d2 = _engine(models[1], role="decode", prefix_cache=True, prompt_buckets=(MAXLEN,))
    try:
        prompt = list(range(17))   # 2 full pages + 1 partial
        a = d2.continue_async(p2.generate(prompt, max_new_tokens=4)).result(timeout=60)
        dd0 = d2.metrics.snapshot()["counters"]["pages_deduped"]
        b = d2.continue_async(p2.generate(prompt, max_new_tokens=4)).result(timeout=60)
        assert a.tokens == b.tokens
        assert d2.metrics.snapshot()["counters"]["pages_deduped"] == dd0 + 2
        assert _partition_ok(d2)
    finally:
        p2.shutdown()
        d2.shutdown()


def test_role_argument_checks_are_the_references(models):
    adapter = TransformerDecodeAdapter(models[1])
    with pytest.raises(ValueError, match="role 'both'"):
        DecodeEngine(adapter, role="both", page_size=PAGE, device="cpu")
    with pytest.raises(ValueError, match="unified-role only"):
        DecodeEngine(adapter, role="decode", page_size=PAGE, prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="unified-role only"):
        DecodeEngine(adapter, role="prefill", page_size=PAGE, draft_model=adapter,
                     device="cpu")


# -- the fleet's two stages ---------------------------------------------------------


def test_two_stage_dispatch(unified, pre, dec):
    router = FleetRouter([FleetHost("pre0", decode=pre), FleetHost("dec0", decode=dec)],
                         max_retries=2)
    try:
        prompts = [[4, 4, 2], [1] * 9, [30, 20, 10, 0]]
        ref = [unified.generate(p, max_new_tokens=5, seed=i).tokens
               for i, p in enumerate(prompts)]
        got = [router.generate(p, max_new_tokens=5, seed=i).tokens
               for i, p in enumerate(prompts)]
        assert got == ref
        snap = router.metrics_snapshot()
        assert snap["counters"]["disagg_requests"] == snap["counters"]["page_transfers"] == 3
        assert snap["counters"]["transfer_bytes"] > 0
        assert snap["hosts"]["pre0"]["role"] == "prefill"
        assert snap["hosts"]["dec0"]["role"] == "decode"
        assert all("free_pages" in h for h in snap["hosts"].values())
    finally:
        router.shutdown()


def test_prefill_host_kill_gives_the_same_tokens(models, unified, dec):
    prompts = [[int(x) for x in np.random.default_rng(i).integers(0, VOCAB, size=3 + i)]
               for i in range(6)]
    ref = [unified.generate(p, max_new_tokens=4, seed=i).tokens for i, p in enumerate(prompts)]
    pre0 = _engine(models[1], role="prefill")
    pre1 = _engine(models[1], role="prefill")
    router = FleetRouter([FleetHost("pre0", decode=pre0), FleetHost("pre1", decode=pre1),
                          FleetHost("dec0", decode=dec)], max_retries=3)
    try:
        futs = [router.generate_async(p, max_new_tokens=4, seed=i)
                for i, p in enumerate(prompts)]
        pre0.shutdown()
        router.mark_host_down("pre0", reason="test-kill")
        assert [f.result(timeout=60).tokens for f in futs] == ref
        assert _partition_ok(dec)
    finally:
        router.shutdown()
        pre1.shutdown()


def test_decode_pressure_scoring():
    class _Gauges:
        role = "decode"

        def __init__(self, snap):
            self.snap = snap

        def metrics_snapshot(self):
            return self.snap

    calm = FleetHost("a", decode=_Gauges({"free_slots": 2, "free_pages": 9,
                                          "pages_per_slot": 4}))
    full = FleetHost("b", decode=_Gauges({"free_slots": 0, "free_pages": 1,
                                          "pages_per_slot": 4}))
    legacy = FleetHost("c", decode=_Gauges({}))
    for h in (calm, full, legacy):
        h.read_decode_pressure()
    assert (calm.decode_pressure(), full.decode_pressure(), legacy.decode_pressure()) == (0, 2, 0)


# -- a one-way prefill host into a two-head-shard sink ---------------------------------------


@pytest.fixture(scope="module")
def sharded_pair(models):
    import jax

    from deeplearning4j_tpu.parallel import ShardedTransformerLM as JSharded
    from deeplearning4j_tpu.parallel import build_mesh as j_mesh
    from deeplearning4j_tpu_torch.parallel import ShardedTransformerLM, build_mesh

    size = dict(SIZE, n_heads=4)
    jlm = JSharded(**size, mesh=j_mesh({"data": 1}, devices=jax.devices()[:1]), seed=3)
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    out = []
    for n in (1, 2):
        lm = ShardedTransformerLM(**size, mesh=build_mesh({"data": n}, world_size=n),
                                  device="cpu")
        lm.load_params(tree)
        out.append(lm)
    return out


def test_one_way_prefill_feeds_a_two_shard_sink(sharded_pair):
    one, two = sharded_pair
    uni = DecodeEngine(one, max_slots=3, page_size=PAGE, device="cpu").load()
    pre1 = DecodeEngine(one, max_slots=3, page_size=PAGE, role="prefill", device="cpu").load()
    sink = DecodeEngine(two, max_slots=3, page_size=PAGE, role="decode", device="cpu").load()
    try:
        assert sink.program.tp == 2 and all(len(p) == 2 for p in sink._cache)
        for i, prompt in enumerate(([3, 1, 4, 1, 5, 9, 2, 6], list(range(10, 27)))):
            kw = dict(max_new_tokens=6, seed=i, echo_logits=True)
            ref = uni.generate(prompt, **kw)
            h = pre1.generate(prompt, **kw)
            assert tkv.unpack_transfer(h.pages).k.shape[3] == 4      # all heads
            got = sink.continue_async(h).result(timeout=60)
            assert got.tokens == ref.tokens
            np.testing.assert_allclose(got.logits, ref.logits, rtol=0, atol=1e-5)
        assert _partition_ok(sink)
    finally:
        for e in (uni, pre1, sink):
            e.shutdown()


def test_fingerprint_carries_the_mesh(tmp_path):
    from deeplearning4j_tpu_torch.parallel import build_mesh

    mesh = build_mesh({"data": 2}, world_size=2)
    fp0, fp2 = device_fingerprint("cpu"), device_fingerprint("cpu", mesh=mesh)
    assert fp0 != fp2 and "mesh(" in fp2 and "data=2" in fp2
    path = str(tmp_path / "warm.bundle")
    save_bundle(path, "v0", {}, device="cpu")          # fingerprinted without a mesh
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert load_bundle(path, tag="v0", device="cpu", mesh=mesh) == {}
    assert sum(issubclass(x.category, RuntimeWarning) for x in w) == 1


def test_sharded_decode_bundle_is_refused_by_another_mesh(sharded_pair, tmp_path):
    one, two = sharded_pair
    path = str(tmp_path / "tp.warm")
    eng = DecodeEngine(two, max_slots=2, page_size=PAGE, role="decode", device="cpu").load()
    try:
        n = eng.compile_cache_size()
        eng.save_warmup_bundle(path)
    finally:
        eng.shutdown()
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # the same mesh takes the bundle silently
        again = DecodeEngine(two, max_slots=2, page_size=PAGE, role="decode",
                             device="cpu").load(warm_bundle=path)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        other = DecodeEngine(one, max_slots=2, page_size=PAGE, role="decode",
                             device="cpu").load(warm_bundle=path)
    try:
        assert again.metrics.counter_value("bundle_hits") == n
        assert other.metrics.counter_value("bundle_hits") == 0
        assert other.metrics.counter_value("bundle_misses") == n
        assert sum(issubclass(x.category, RuntimeWarning) for x in w) == 1
    finally:
        again.shutdown()
        other.shutdown()


# -- metrics: off means zero, not absent --------------------------------------------------


def test_fresh_engine_and_router_report_zero_keys(models, unified):
    eng = _engine(models[1], prompt_buckets=(MAXLEN,))
    router = FleetRouter([FleetHost("u0", decode=unified)])
    try:
        snap = eng.metrics_snapshot()
        for key in ("handoffs_out", "handoffs_in", "pages_exported", "pages_attached",
                    "pages_deduped", "swaps", "bundle_hits", "scale_ups"):
            assert snap["counters"][key] == 0
        assert snap["role"] == "unified" and snap["tp"] == 1
        assert isinstance(snap["free_pages"], int) and snap["free_slots"] == 3
        rs = router.metrics_snapshot()
        for key in ("disagg_requests", "page_transfers", "transfer_bytes"):
            assert rs["counters"][key] == 0
    finally:
        eng.shutdown()
        router.shutdown()


# -- HTTP ---------------------------------------------------------------------------------


def test_generate_on_a_prefill_host_is_409(pre):
    from deeplearning4j_tpu_torch.ui.server import UIServer

    srv = UIServer(port=0).attach_decode_engine(pre).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt_ids": [1, 2, 3], "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 409
        assert json.loads(ei.value.read())["error_class"] == "prefill_role"
    finally:
        srv.stop()
