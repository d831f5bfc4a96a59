"""The port's data sources against the reference on the CPU: the native
loader (``native/data_loader.cpp`` built by ``utils/native_build.py``:
batches bitwise the reference's for a seed, ``plain_order`` its shuffle in
Python, the logged fallback), the fetchers and their iterator functions
(the reference's arrays from real file layouts and from the synthetic
surrogates), the record readers, and remote storage (``file://`` and a
fake S3 client)."""

import gzip
import io
import logging
import os
import struct
import sys
import types

import numpy as np
import pytest

from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.datasets import native_loader as tnl
from deeplearning4j_tpu_torch.datasets import remote as tr
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.records import (
    CSVRecordReader, CSVSequenceRecordReader, ImageRecordReader,
    ImageRecordReaderDataSetIterator, RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator)


# -- the native loader -------------------------------------------------------------


def _epochs(it, n):
    """``n`` passes of a native iterator: the first without a reset, then
    each ``for`` pass (which resets, reshuffling)."""
    out = [[]]
    while it.has_next():
        out[0].append(it.next())
    for _ in range(n - 1):
        out.append(list(it))
    return out


@pytest.mark.parametrize("labels,drop", [(True, False), (False, True)])
def test_native_batches_are_bitwise_the_references(labels, drop):
    from deeplearning4j_tpu.datasets.native_loader import NativeDataSetIterator as JNative

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(100, 3, 7)).astype(np.float32)
    ys = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 100)] if labels else None
    t = tnl.NativeDataSetIterator(xs, ys, batch_size=32, seed=5, drop_remainder=drop)
    j = JNative(xs, ys, batch_size=32, seed=5, drop_remainder=drop)
    for e, (tb, jb) in enumerate(zip(_epochs(t, 3), _epochs(j, 3))):
        assert len(tb) == len(jb) == (3 if drop else 4)
        order = tnl.plain_order(100, 5, e)
        for i, (a, b) in enumerate(zip(tb, jb)):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.features, xs[order[i * 32:(i + 1) * 32]])
            if labels:
                np.testing.assert_array_equal(a.labels, b.labels)
            else:
                assert a.labels is None and b.labels is None
    t.close()
    j.close()


def test_native_library_builds_into_the_ports_build_dir():
    from deeplearning4j_tpu_torch.utils import cuda_build, native_build

    lib = tnl.load_native_lib()
    assert lib is not None
    path = native_build.library_path(tnl._SRC, "libdl4jtpu_data.so", ("-lpthread",))
    assert os.path.dirname(path) == str(cuda_build.BUILD_DIR) and os.path.exists(path)


def test_native_build_failure_is_logged_and_falls_back(tmp_path, caplog, monkeypatch):
    from deeplearning4j_tpu_torch.utils import native_build

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        assert native_build.build_and_load(str(bad), "libbroken.so") is None
    assert "libbroken.so unavailable" in caplog.text
    monkeypatch.setattr(tnl, "_LIB", False)
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        tnl.NativeDataSetIterator(np.zeros((4, 2), np.float32), None, batch_size=2)


def test_native_iterator_trains_a_port_net():
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(3, 8)) * 3
    idx = rng.integers(0, 3, 192)
    xs = (centers[idx] + rng.normal(size=(192, 8))).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[idx]
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(lr=1e-2))
            .layer(Dense(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    it = tnl.NativeDataSetIterator(xs, ys, batch_size=64, seed=2)
    losses = net.fit(it, epochs=15)
    assert float(losses[-1]) < 0.3 * float(losses[0])
    it.close()


# -- fetchers ---------------------------------------------------------------------------


def _write_idx(tmp, img_name, lbl_name, images, labels):
    with gzip.open(os.path.join(tmp, img_name), "wb") as f:
        n, r, c = images.shape
        f.write(struct.pack(">IIII", 2051, n, r, c))
        f.write(images.astype(np.uint8).tobytes())
    with gzip.open(os.path.join(tmp, lbl_name), "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.astype(np.uint8).tobytes())


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,kw", [
    ("load_mnist", {}), ("load_cifar10", {}), ("load_emnist", {"split": "letters"}),
    ("load_svhn", {}), ("load_tiny_imagenet", {"synthetic_n": 64}),
    ("load_lfw", {"synthetic_n": 16, "image_size": 32}),
    ("load_uci_synthetic_control", {})])
def test_synthetic_surrogates_are_the_references(name, kw, tmp_path, monkeypatch):
    from deeplearning4j_tpu.datasets import fetchers as jf

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    for train in (True, False):
        _same(getattr(tf, name)(train=train, **kw), getattr(jf, name)(train=train, **kw))
    _same(tf.load_iris(), jf.load_iris())


def test_real_file_layouts_parse_as_the_references(tmp_path, monkeypatch):
    import scipy.io
    from PIL import Image

    from deeplearning4j_tpu.datasets import fetchers as jf

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    _write_idx(tmp_path, "emnist-letters-train-images-idx3-ubyte.gz",
               "emnist-letters-train-labels-idx1-ubyte.gz",
               rng.integers(0, 255, (20, 28, 28)), rng.integers(1, 27, 20))
    X = rng.integers(0, 255, (32, 32, 3, 12)).astype(np.uint8)
    y = np.asarray([10, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1], np.uint8)[:, None]
    scipy.io.savemat(os.path.join(tmp_path, "train_32x32.mat"), {"X": X, "y": y})
    np.savetxt(os.path.join(tmp_path, "synthetic_control.data"), rng.normal(30, 5, (600, 60)))
    for wnid in ("n001", "n002"):
        d = tmp_path / "tiny-imagenet-200" / "train" / wnid / "images"
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)).save(
                str(d / f"{wnid}_{i}.JPEG"))
    for person, n in (("Ada_Lovelace", 5), ("Grace_Hopper", 5), ("One_Shot", 1)):
        d = tmp_path / "lfw" / person
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)).save(
                d / f"{person}_{i:04d}.jpg")
    calls = [("load_emnist", {"split": "letters", "train": True}),
             ("load_svhn", {"train": True}),
             ("load_uci_synthetic_control", {"train": True}),
             ("load_uci_synthetic_control", {"train": False}),
             ("load_tiny_imagenet", {"train": True}),
             ("load_lfw", {"train": True, "image_size": 40}),
             ("load_lfw", {"train": False, "image_size": 40})]
    for name, kw in calls:
        got = getattr(tf, name)(allow_synthetic=False, **kw)
        _same(got, getattr(jf, name)(allow_synthetic=False, **kw))
    xs, ys = tf.load_emnist("letters", allow_synthetic=False)
    assert xs.shape == (20, 28, 28, 1) and ys.min() >= 0 and ys.max() <= 25
    xs, ys = tf.load_svhn(allow_synthetic=False)
    assert ys[0] == 0 and ys[10] == 0


def test_missing_files_raise_when_synthetic_is_disallowed(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    for fn in (lambda: tf.load_mnist(allow_synthetic=False),
               lambda: tf.load_cifar10(allow_synthetic=False),
               lambda: tf.load_emnist("digits", allow_synthetic=False),
               lambda: tf.load_svhn(allow_synthetic=False),
               lambda: tf.load_tiny_imagenet(allow_synthetic=False),
               lambda: tf.load_lfw(allow_synthetic=False),
               lambda: tf.load_uci_synthetic_control(allow_synthetic=False)):
        with pytest.raises(FileNotFoundError):
            fn()
    with pytest.raises(ValueError, match="EMNIST split"):
        tf.load_emnist("nope")


@pytest.mark.parametrize("name,kw", [
    ("MnistDataSetIterator", {"batch_size": 512, "flatten": True}),
    ("Cifar10DataSetIterator", {"batch_size": 512}),
    ("IrisDataSetIterator", {"batch_size": 50}),
    ("EmnistDataSetIterator", {"batch_size": 512, "split": "digits"}),
    ("SvhnDataSetIterator", {"batch_size": 512}),
    ("TinyImageNetDataSetIterator", {"batch_size": 256, "synthetic_n": 256}),
    ("LFWDataSetIterator", {"batch_size": 8, "synthetic_n": 16, "image_size": 32}),
    ("UciSequenceDataSetIterator", {"batch_size": 100})])
def test_iterator_functions_give_the_references_batches(name, kw, tmp_path, monkeypatch):
    from deeplearning4j_tpu.datasets import fetchers as jf

    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    got, want = list(getattr(tf, name)(**kw)), list(getattr(jf, name)(**kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)


# -- record readers -----------------------------------------------------------------------


def test_csv_records_are_the_references(tmp_path):
    from deeplearning4j_tpu.datasets import records as jr

    p = tmp_path / "data.csv"
    p.write_text("# header\n1.0,2.0,0\n3.0,4.0,1\n5.0,6.0,2\n7.0,8.0,0\n")
    r = tmp_path / "reg.csv"
    r.write_text("1,2,10,20\n3,4,30,40\n")
    for m, cls_kw, reg_kw in (
            (None, dict(batch_size=2, label_index=2, num_classes=3),
             dict(batch_size=2, label_index=2, label_index_to=3, regression=True)),):
        got = list(RecordReaderDataSetIterator(CSVRecordReader(skip_lines=1)
                                               .initialize(str(p)), **cls_kw))
        want = list(jr.RecordReaderDataSetIterator(jr.CSVRecordReader(skip_lines=1)
                                                   .initialize(str(p)), **cls_kw))
        assert len(got) == len(want) == 2
        np.testing.assert_array_equal(got[0].features, [[1, 2], [3, 4]])
        np.testing.assert_array_equal(got[0].labels, [[1, 0, 0], [0, 1, 0]])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)
        b = list(RecordReaderDataSetIterator(CSVRecordReader().initialize(str(r)), **reg_kw))[0]
        np.testing.assert_array_equal(b.features, [[1, 2], [3, 4]])
        np.testing.assert_array_equal(b.labels, [[10, 20], [30, 40]])
    with pytest.raises(ValueError, match="num_classes"):
        RecordReaderDataSetIterator(CSVRecordReader(), batch_size=2, label_index=0)


def test_sequence_records_pad_and_mask_as_the_references(tmp_path):
    from deeplearning4j_tpu.datasets import records as jr

    files = {"f1": "1,1\n2,2\n3,3\n", "f2": "5,5\n", "l1": "0\n1\n0\n", "l2": "1\n"}
    for k, v in files.items():
        (tmp_path / f"{k}.csv").write_text(v)
    f = [str(tmp_path / "f1.csv"), str(tmp_path / "f2.csv")]
    lab = [str(tmp_path / "l1.csv"), str(tmp_path / "l2.csv")]
    got = list(SequenceRecordReaderDataSetIterator(
        CSVSequenceRecordReader().initialize(f), CSVSequenceRecordReader().initialize(lab),
        batch_size=2, num_classes=2))[0]
    want = list(jr.SequenceRecordReaderDataSetIterator(
        jr.CSVSequenceRecordReader().initialize(f), jr.CSVSequenceRecordReader().initialize(lab),
        batch_size=2, num_classes=2))[0]
    assert got.features.shape == (2, 3, 2)
    np.testing.assert_array_equal(got.features_mask, [[1, 1, 1], [1, 0, 0]])
    for k in ("features", "labels", "features_mask", "labels_mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_image_records_label_by_directory_as_the_references(tmp_path):
    from PIL import Image

    from deeplearning4j_tpu.datasets import records as jr

    rng = np.random.default_rng(0)
    for cls in ("cats", "dogs"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (10, 12, 3)).astype(np.uint8)).save(
                str(d / f"{i}.png"))
    reader = ImageRecordReader(height=8, width=8).initialize(str(tmp_path))
    assert reader.labels == ["cats", "dogs"] and len(reader) == 4
    got = list(ImageRecordReaderDataSetIterator(reader, batch_size=4))[0]
    want = list(jr.ImageRecordReaderDataSetIterator(
        jr.ImageRecordReader(height=8, width=8).initialize(str(tmp_path)), batch_size=4))[0]
    assert got.features.shape == (4, 8, 8, 3)
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)


# -- remote storage -------------------------------------------------------------------------


def _sets(n, seed):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(size=(4, 3)).astype(np.float32),
                    np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]) for _ in range(n)]


def test_dataset_wire_format_crosses_packages():
    import torch

    from deeplearning4j_tpu.datasets import remote as jremote

    ds = _sets(1, 0)[0]
    buf = io.BytesIO()
    tr.save_dataset(DataSet(torch.from_numpy(ds.features), ds.labels), buf)
    buf.seek(0)
    back = jremote.load_dataset(buf)
    np.testing.assert_array_equal(back.features, ds.features)
    buf = io.BytesIO()
    jremote.save_dataset(back, buf)
    buf.seek(0)
    again = tr.load_dataset(buf)
    np.testing.assert_array_equal(again.labels, ds.labels)
    assert again.features_mask is None


def test_remote_iterator_streams_a_local_uri(tmp_path):
    for i, ds in enumerate(_sets(3, 1)):
        with open(tmp_path / f"part{i}.npz", "wb") as f:
            tr.save_dataset(ds, f)
    it = tr.RemoteDataSetIterator(f"file://{tmp_path}")
    assert len(list(it)) == 3 and len(list(it)) == 3
    with pytest.raises(ValueError, match="provider"):
        tr.RemoteDataSetIterator("gs://bucket/prefix")
    with pytest.raises(FileNotFoundError):
        tr.RemoteDataSetIterator(f"file://{tmp_path}", suffix=".nothing")


class _FakeS3:
    """A boto3 S3 client over a dict: ``list_objects_v2`` pages two keys at
    a time, ``download_fileobj`` writes an object's bytes."""

    def __init__(self, objects):
        self.objects, self.calls = objects, []

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        self.calls.append(("list", Bucket, Prefix, ContinuationToken))
        keys = sorted(k for (b, k) in self.objects if b == Bucket and k.startswith(Prefix))
        start = int(ContinuationToken or 0)
        resp = {"Contents": [{"Key": k} for k in keys[start:start + 2]]}
        if start + 2 < len(keys):
            resp["NextContinuationToken"] = str(start + 2)
        return resp

    def download_fileobj(self, bucket, key, buf):
        self.calls.append(("get", bucket, key))
        buf.write(self.objects[(bucket, key)])


def test_s3_provider_streams_through_a_fake_client_as_the_references(monkeypatch):
    from deeplearning4j_tpu.datasets import remote as jremote

    objects = {}
    for i, ds in enumerate(_sets(5, 2)):
        buf = io.BytesIO()
        tr.save_dataset(ds, buf)
        objects[("bkt", f"train/part{i}.npz")] = buf.getvalue()
    objects[("bkt", "train/README")] = b"not a dataset"
    objects[("other", "train/x.npz")] = b""
    client = _FakeS3(objects)
    monkeypatch.setitem(sys.modules, "boto3", types.SimpleNamespace(client=lambda kind: client))
    got = list(tr.RemoteDataSetIterator("s3://bkt/train/", provider=tr.S3Provider()))
    want = list(jremote.RemoteDataSetIterator("s3://bkt/train/", provider=jremote.S3Provider()))
    assert len(got) == len(want) == 5
    for a, b, ds in zip(got, want, _sets(5, 2)):
        np.testing.assert_array_equal(a.features, ds.features)
        np.testing.assert_array_equal(a.features, b.features)
    assert sum(c[0] == "list" for c in client.calls) == 2 * 3   # 6 keys, 2 a page, twice


def test_s3_without_boto3_is_a_clear_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError, match="boto3"):
        tr.S3Provider()
