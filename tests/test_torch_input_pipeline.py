"""The port's input pipeline against the reference on the CPU: the
normalizers (``datasets/normalizers.py``: host transforms bitwise the
reference's on the same arrays, the golden fixture, ``save``/``load``
across packages, the iterator hook, the torch ``device_transform``),
``DevicePrefetchIterator`` on ``device="cpu"`` (loss identity with the
synchronous path, ring bounds, teardown, a producer's exception on the
consumer, the on-device transform, the wire cast, stall accounting, the
capture gate, a two-rank gloo run whose prefetcher places only each rank's
rows), and the CLI's ``train --prefetch`` and ``--data`` names.

The ``--worker`` mode of this file is one gloo rank of the sharding test
(it imports neither JAX nor the JAX package).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import datasets as td
from deeplearning4j_tpu_torch.datasets import device_prefetch as tdp
from deeplearning4j_tpu_torch.datasets import normalizers as tn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
RANKS = 2


def _batches(n=6, batch=16, features=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n * batch, features)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n * batch)]
    return td.DataSet(x, y).batch_by(batch)


def _iter(pkg, n_batches=4, mb=16, f=5, seed=0):
    """The reference tests' iterator: 5 features at very different scales,
    2 label columns, in ``pkg``'s ``ListDataSetIterator``."""
    rng = np.random.default_rng(seed)
    scale, shift = np.asarray((10.0, 0.1, 3.0, 100.0, 1.0)), np.asarray((5.0, -2.0, 0.0, 50.0, 0.5))
    batches = []
    for _ in range(n_batches):
        x = (rng.normal(size=(mb, f)) * scale + shift).astype(np.float32)
        y = (rng.normal(size=(mb, 2)) * 7.0 + 3.0).astype(np.float32)
        batches.append(pkg.DataSet(x, y))
    return pkg.ListDataSetIterator(batches)


def _mlp(seed=7, features=8, classes=3):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=0.1))
            .layer(Dense(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=classes, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(features)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _threads():
    return [t for t in threading.enumerate()
            if t.name == "DevicePrefetchIterator" and t.is_alive()]


# -- normalizers: the port against the reference ----------------------------------

_NORMS = {
    "standardize": lambda m: m.NormalizerStandardize(),
    "standardize_labels": lambda m: m.NormalizerStandardize(fit_labels=True),
    "minmax": lambda m: m.NormalizerMinMaxScaler(),
    "minmax_range": lambda m: m.NormalizerMinMaxScaler(min_range=-1, max_range=1,
                                                       fit_labels=True),
    "image": lambda m: m.ImagePreProcessingScaler(min_range=-1, max_range=1),
}


@pytest.mark.parametrize("kind", list(_NORMS))
def test_host_transforms_are_bitwise_the_references(kind):
    import deeplearning4j_tpu.datasets as jd
    from deeplearning4j_tpu.datasets import normalizers as jn

    tnorm, jnorm = _NORMS[kind](tn).fit(_iter(td)), _NORMS[kind](jn).fit(_iter(jd))
    for k in tnorm._SAVE_KEYS:
        np.testing.assert_array_equal(getattr(tnorm, k), getattr(jnorm, k))
    for tds, jds in zip(_iter(td, seed=3), _iter(jd, seed=3)):
        tp, jp = tnorm.pre_process(tds), jnorm.pre_process(jds)
        np.testing.assert_array_equal(tp.features, jp.features)
        np.testing.assert_array_equal(tp.labels, jp.labels)
        np.testing.assert_array_equal(tnorm.revert(tp).features, jnorm.revert(jp).features)
        np.testing.assert_array_equal(tnorm.revert(tp).labels, jnorm.revert(jp).labels)


def test_rank4_and_masked_statistics_are_the_references():
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.datasets import normalizers as jn

    rng = np.random.default_rng(0)
    x4 = (rng.normal(size=(8, 6, 6, 3)) * [1.0, 10.0, 0.2] + [0.0, 5.0, -1.0]).astype(np.float32)
    t4 = tn.NormalizerStandardize().fit(td.DataSet(x4, None))
    j4 = jn.NormalizerStandardize().fit(JDataSet(x4, None))
    assert t4.mean.shape == (3,)
    np.testing.assert_array_equal(t4.transform(x4), j4.transform(x4))
    x3 = (rng.normal(size=(8, 10, 2)) * 3 + 50).astype(np.float32)
    mask = np.ones((8, 10), np.float32)
    mask[:, 6:] = 0.0
    x3[mask == 0] = 0.0
    for cls in ("NormalizerStandardize", "NormalizerMinMaxScaler"):
        t = getattr(tn, cls)().fit(td.DataSet(x3, None, mask, None))
        j = getattr(jn, cls)().fit(JDataSet(x3, None, mask, None))
        np.testing.assert_array_equal(t.transform(x3), j.transform(x3))
    assert tn.NormalizerMinMaxScaler().fit(td.DataSet(x3, None, mask, None)).data_min.min() > 30


def test_golden_fixture_loads_and_reproduces_its_output():
    n = tn.AbstractNormalizer.load(os.path.join(FIX, "normalizer_golden.npz"))
    got = n.transform(np.random.default_rng(12).normal(size=(4, 6)).astype(np.float32))
    want = np.load(os.path.join(FIX, "normalizer_golden_output.npy"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["standardize_labels", "minmax_range", "image"])
def test_save_load_round_trips_across_packages(kind, tmp_path):
    import deeplearning4j_tpu.datasets as jd
    from deeplearning4j_tpu.datasets import normalizers as jn

    x = next(iter(_iter(td))).features
    tnorm = _NORMS[kind](tn).fit(_iter(td))
    tnorm.save(str(tmp_path / "port.npz"))
    jback = jn.AbstractNormalizer.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(jback.transform(x), tnorm.transform(x))
    _NORMS[kind](jn).fit(_iter(jd)).save(str(tmp_path / "ref.npz"))
    tback = tn.AbstractNormalizer.load(str(tmp_path / "ref.npz"))
    assert type(tback).__name__ == type(tnorm).__name__
    np.testing.assert_array_equal(tback.transform(x), tnorm.transform(x))
    other = tn.NormalizerStandardize if kind != "standardize_labels" else tn.NormalizerMinMaxScaler
    with pytest.raises(ValueError, match=type(tnorm).__name__):
        other.load(str(tmp_path / "port.npz"))


def test_unfitted_and_bad_ranges_raise():
    with pytest.raises(ValueError, match="fit"):
        tn.NormalizerStandardize().pre_process(td.DataSet(np.zeros((2, 3), np.float32), None))
    with pytest.raises(ValueError, match="min_range"):
        tn.NormalizerMinMaxScaler(min_range=1.0, max_range=0.0)
    with pytest.raises(ValueError, match="min_range"):
        tn.ImagePreProcessingScaler(min_range=1.0, max_range=1.0)


def test_iterator_hook_applies_once_and_fit_sees_raw_data():
    it = _iter(td)
    norm = tn.NormalizerStandardize().fit(it)
    it.set_pre_processor(norm)
    xs = np.concatenate([ds.features for ds in it])
    np.testing.assert_allclose(xs.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(xs.std(axis=0), 1.0, atol=1e-3)
    again = tn.NormalizerStandardize().fit(it)
    np.testing.assert_array_equal(again.mean, norm.mean)
    assert it.pre_processor is norm
    xa = np.concatenate([ds.features for ds in td.AsyncDataSetIterator(it)])
    np.testing.assert_array_equal(xa, xs)


@pytest.mark.parametrize("kind", list(_NORMS))
def test_device_transform_on_cpu_tensors_tracks_the_host(kind):
    """The torch transform in f32 within 1e-6 of the host's f64-temp path
    (the reference's documented caveat), labels too where fitted, masks
    passed through."""
    norm = _NORMS[kind](tn).fit(_iter(td))
    fn = norm.device_transform()
    for ds in _iter(td, seed=5):
        mask = torch.ones(ds.features.shape[0])
        out = fn(td.DataSet(torch.from_numpy(ds.features), torch.from_numpy(ds.labels), mask))
        want = norm.pre_process(ds)
        assert out.features.dtype == torch.float32 and out.features_mask is mask
        np.testing.assert_allclose(out.features.numpy(), want.features, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out.labels.numpy(), want.labels, rtol=1e-6, atol=1e-6)


def test_power_of_two_pixel_scale_is_bitwise_on_the_device_path():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (32, 6, 6, 3)).astype(np.uint8)
    scaler = tn.ImagePreProcessingScaler(max_pixel=256.0)
    got = scaler.device_transform()(td.DataSet(torch.from_numpy(u8), None)).features
    np.testing.assert_array_equal(got.numpy(), scaler.transform(u8))
    # and x / 255, the default, over every uint8 value
    every = np.arange(256, dtype=np.uint8)
    s = tn.ImagePreProcessingScaler()
    np.testing.assert_array_equal(
        s.device_transform()(td.DataSet(torch.from_numpy(every), None)).features.numpy(),
        s.transform(every))


# -- DevicePrefetchIterator on the CPU ---------------------------------------------


@pytest.mark.parametrize("depth", [1, 4])
def test_prefetch_losses_are_bitwise_the_synchronous_path(depth):
    batches = _batches()
    sync = [float(s) for s in _mlp().fit(td.ListDataSetIterator(batches), epochs=3)]
    it = td.DevicePrefetchIterator(td.ListDataSetIterator(batches), depth=depth, device="cpu")
    pre = [float(s) for s in _mlp().fit(it, epochs=3)]
    it.close()
    assert pre == sync


def test_prefetched_batches_are_tensors_equal_to_the_host_and_the_ring_is_bounded():
    batches = _batches(n=6)
    it = td.DevicePrefetchIterator(td.ListDataSetIterator(batches), device="cpu")
    ds = it.next()
    assert isinstance(ds.features, torch.Tensor) and isinstance(ds.labels, torch.Tensor)
    np.testing.assert_array_equal(ds.features.numpy(), batches[0].features)
    it.close()
    it1 = td.DevicePrefetchIterator(td.ListDataSetIterator(batches), depth=1, device="cpu")
    it4 = td.DevicePrefetchIterator(td.ListDataSetIterator(batches), depth=4, device="cpu")
    deadline = time.time() + 5.0
    while it4._queue.qsize() < 4 and time.time() < deadline:
        time.sleep(0.01)
    assert it1._queue.maxsize == 1 and it4._queue.qsize() == 4 and it1._queue.qsize() <= 1
    assert [d.features.shape for d in it1] == [d.features.shape for d in it4]
    it1.close()
    it4.close()


def test_exhaustion_reset_and_midstream_teardown_leak_no_thread():
    batches = _batches(n=3)
    it = td.DevicePrefetchIterator(td.ListDataSetIterator(batches), depth=2, device="cpu")
    first = [it.next().features.clone() for _ in range(3)]
    assert not it.has_next()
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()
    it.reset()
    for a, b in zip(first, [d.features for d in it]):
        assert torch.equal(a, b)
    it.close()
    before = len(_threads())
    it = td.DevicePrefetchIterator(td.ListDataSetIterator(_batches(n=50)), depth=2, device="cpu")
    it.next()
    it.close()
    assert len(_threads()) == before
    assert not it.has_next()
    it.reset()
    assert it.has_next()
    it.close()


def test_producer_exception_is_raised_on_the_consumer():
    class Boom(td.ListDataSetIterator):
        def next(self):
            if self._pos >= 2:
                raise RuntimeError("boom in base.next()")
            return super().next()

    it = td.DevicePrefetchIterator(Boom(_batches()), depth=2, device="cpu")
    assert tuple(it.next().features.shape) == (16, 8)
    it.next()
    with pytest.raises(RuntimeError, match="boom in base.next"):
        it.next()
    with pytest.raises(RuntimeError, match="boom in base.next"):
        it.has_next()
    it.close()


def test_bad_arguments_and_no_card_raise(monkeypatch):
    base = td.ListDataSetIterator(_batches())
    with pytest.raises(ValueError, match="depth"):
        td.DevicePrefetchIterator(base, depth=0, device="cpu")
    with pytest.raises(ValueError, match="sharding OR device"):
        td.DevicePrefetchIterator(base, sharding=object(), device="cpu")
    with pytest.raises(ValueError, match="cast_dtype"):
        td.DevicePrefetchIterator(base, device="cpu", cast_dtype="not_a_dtype")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.DevicePrefetchIterator(base)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.device_put_batch({"x": np.ones(3)})


def test_transform_runs_in_the_ring_and_an_attached_normalizer_moves_there():
    batches = _batches(n=4)
    norm = tn.NormalizerStandardize().fit(td.ListDataSetIterator(batches))
    base = td.ListDataSetIterator(batches).set_pre_processor(norm)
    it = td.DevicePrefetchIterator(base, device="cpu", transform=norm)
    assert base.pre_processor is None
    got = np.concatenate([d.features.numpy() for d in it])
    it.close()
    host = np.concatenate([norm.transform(b.features) for b in batches])
    np.testing.assert_allclose(got, host, rtol=1e-6, atol=1e-6)


def test_wire_cast_narrows_float_features_only():
    it = td.DevicePrefetchIterator(td.ListDataSetIterator(_batches(n=2)), device="cpu",
                                   cast_dtype="bfloat16")
    ds = it.next()
    assert ds.features.dtype == torch.bfloat16 and ds.labels.dtype == torch.float32
    np.testing.assert_array_equal(ds.features.float().numpy(),
                                  torch.from_numpy(_batches(n=2)[0].features)
                                  .to(torch.bfloat16).float().numpy())
    it.close()
    u8 = td.DataSet(np.zeros((4, 3), np.uint8), np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
    it2 = td.DevicePrefetchIterator(td.ListDataSetIterator([u8]), device="cpu",
                                    cast_dtype=np.float16)
    assert it2.next().features.dtype == torch.uint8
    it2.close()


def test_stall_accounting_and_the_registry_collector():
    from deeplearning4j_tpu_torch.obs.metrics import get_registry

    it = td.DevicePrefetchIterator(td.ListDataSetIterator(_batches(n=3)), device="cpu")
    list(it)
    s = it.stall_stats()
    assert s["batches"] == 3 and s["depth"] == 2 and 0.0 <= s["stall_fraction"] <= 1.0
    assert any(p.get("batches") == 3 for p in get_registry().snapshot()["collected"]
               ["input_pipeline"])
    it.close()

    class Slow(td.ListDataSetIterator):
        def next(self):
            time.sleep(0.02)
            return super().next()

    it = td.DevicePrefetchIterator(Slow(_batches(n=4)), depth=1, device="cpu")
    list(it)
    s = it.stall_stats()
    assert s["stalls"] >= 3 and s["stall_fraction"] > 0.3
    it.close()


def test_producers_paused_holds_every_producer_until_released():
    with tdp.producers_paused():
        it = td.DevicePrefetchIterator(td.ListDataSetIterator(_batches(n=3)), device="cpu")
        time.sleep(0.2)
        assert it._queue.qsize() == 0
    deadline = time.time() + 5.0
    while it._queue.qsize() < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert it._queue.qsize() == 2
    it.close()


def test_device_put_batch_passes_placed_tensors_through():
    placed = td.device_put_batch({"x": np.ones(4, np.float32), "y": [np.zeros(2)]}, "cpu")
    assert isinstance(placed["x"], torch.Tensor) and isinstance(placed["y"][0], torch.Tensor)
    again = td.device_put_batch(placed, "cpu")
    assert again["x"] is placed["x"]


# -- sharding: two gloo ranks, each prefetching only its rows ------------------------


def _worker(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import (ShardedTrainer, build_mesh, initialize,
                                                   shutdown)

    initialize(init_method="file://" + os.path.join(work, "rendezvous"),
               num_processes=RANKS, process_id=rank, backend="gloo", timeout_s=100)
    batches = _batches(n=4, batch=16)
    out = {}
    for arm in ("sync", "prefetch"):
        trainer = ShardedTrainer(_mlp(), build_mesh({"data": RANKS}))
        if arm == "prefetch":
            seen = []
            real = trainer.batch_sharding.local_rows

            def local_rows(batch, real=real):
                seen.append(threading.current_thread().name)
                return real(batch)
            object.__setattr__(trainer.batch_sharding, "local_rows", local_rows)
            it = td.DevicePrefetchIterator(td.ListDataSetIterator(batches),
                                           sharding=trainer.batch_sharding)
            first = it.next()
            out["rows"] = int(first.features.shape[0])
            out["local_rows_equal"] = bool(np.array_equal(
                first.features.numpy(),
                batches[0].features[rank * 8:(rank + 1) * 8]))
            it.reset()
            losses = trainer.fit(it, epochs=2)
            out["cut_threads"] = sorted(set(seen))
            out["cuts"] = len(seen)
            it.close()
        else:
            losses = trainer.fit(batches, epochs=2)
        out[arm] = [float(v) for v in losses]
        out[f"{arm}_params"] = [t.numpy().tolist() for p in trainer.net.params
                                for t in p.values()]
    shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("prefetch_ranks"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r),
                               work], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(RANKS)]


def test_sharded_prefetch_places_only_this_ranks_rows(sharded_runs):
    for r in sharded_runs:
        assert r["rows"] == 8 and r["local_rows_equal"]
        # every batch was cut in the producer; the trainer passed them through
        assert r["cut_threads"] == ["DevicePrefetchIterator"] and r["cuts"] >= 8


def test_sharded_prefetch_trains_bitwise_the_synchronous_trainer(sharded_runs):
    for r in sharded_runs:
        assert r["prefetch"] == r["sync"]
        assert r["prefetch_params"] == r["sync_params"]
    assert sharded_runs[0]["prefetch_params"] == sharded_runs[1]["prefetch_params"]


# -- the CLI --------------------------------------------------------------------------


def test_parse_prefetch_is_the_references():
    from deeplearning4j_tpu.cli import _parse_prefetch as jparse
    from deeplearning4j_tpu_torch.cli import _parse_prefetch

    assert _parse_prefetch("2") == jparse("2") == (2, None)
    assert _parse_prefetch("4,cpu") == (4, "cpu")
    assert _parse_prefetch("0") == (0, None)
    for bad in ("-1", "x", "0,cpu"):
        with pytest.raises(SystemExit):
            _parse_prefetch(bad)


def _conf_file(tmp_path, features=4):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import NeuralNetConfiguration

    conf = (NeuralNetConfiguration.builder().seed(1)
            .layer(Dense(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(features)).build())
    cfg = tmp_path / "conf.json"
    cfg.write_text(json.dumps(conf.to_dict()))
    return str(cfg)


@pytest.mark.parametrize("spec", ["2", "2,cpu"])
def test_train_with_prefetch_prints_the_stall_line(tmp_path, capsys, spec):
    from deeplearning4j_tpu_torch.cli import main

    data = tmp_path / "d.npz"
    rng = np.random.default_rng(0)
    np.savez(data, x=rng.normal(size=(64, 4)).astype(np.float32), y=rng.integers(0, 3, 64))
    args = ["train", "--config", _conf_file(tmp_path), "--data", str(data), "--epochs", "2",
            "--batch-size", "16", "--prefetch", spec, "--device", "cpu"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "prefetch: depth 2 onto cpu" in out and "stall fraction" in out
    losses = [l for l in out.splitlines() if l.startswith("trained")]
    assert main(args[:-4] + ["--device", "cpu"]) == 0
    assert [l for l in capsys.readouterr().out.splitlines() if l.startswith("trained")] == losses


def test_prefetch_device_with_mesh_is_refused(tmp_path):
    from deeplearning4j_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="does not combine with --mesh"):
        main(["train", "--config", _conf_file(tmp_path), "--data", "iris", "--mesh", "data=1",
              "--prefetch", "2,cpu", "--device", "cpu"])


@pytest.mark.parametrize("name", ["mnist", "cifar10", "iris", "emnist", "svhn", "uci"])
def test_data_names_load_the_references_arrays(name, tmp_path, monkeypatch):
    from deeplearning4j_tpu.cli import _load_data as jload
    from deeplearning4j_tpu_torch.cli import _load_data

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    for train in (True, False):
        x, y = _load_data(name, train=train)
        jx, jy = jload(name, train=train)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
