"""The port's elastic runtime (``deeplearning4j_tpu_torch/parallel/elastic.py``)
against the JAX package's ``ElasticTrainer`` on the CPU.

Both packages train the same Iris-shaped MLP (Dense(8, tanh) →
OutputLayer(3, softmax), Adam 0.01, the reference's weights and updater
state copied into the port) on the same full batch under the same
``FaultSchedule``: a device loss, a crashed checkpoint write, a
truncated and a bit-flipped checkpoint, a hung step (a fake clock: the
hang advances it, the watchdog reads it) and NaN gradients under the nan
guard.  Gates: equal restart counts, global step after every call,
backoff delays (same ``jitter_seed``), checkpoint lists and quarantined
files, and losses within 1e-5 at every call (f32 sums in another order).

Also: checkpoints move between the packages both ways (the residual of a
one-rank compressed trainer included), an async snapshot on the CPU is a
copy that later steps do not move, a restore followed by ``fit_batches``
trains from the restored weights, ``fit`` replays from the restored step
(the trajectory of a recovered run is the fault-free one, bitwise) and
streams its iterator, holding only the batches a restore can reach, and
the failure classification (gloo/NCCL peer loss and timeouts recoverable,
a sticky CUDA error not).
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (ChaosInjector, CheckpointManager,
                                               ElasticTrainer, FailureDetector, FaultKind,
                                               FaultSchedule, StepHangError)
from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy

N_CALLS = 14
#: a corruption and a device loss in one call: the restore meets the
#: corrupt newest checkpoint, quarantines it and falls back
SCHEDULE = {2: FaultKind.DEVICE_LOSS, 4: FaultKind.CKPT_WRITE_CRASH,
            6: [FaultKind.CKPT_TRUNCATE, FaultKind.DEVICE_LOSS], 8: FaultKind.HUNG_STEP,
            10: [FaultKind.CKPT_BITFLIP, FaultKind.DEVICE_LOSS], 11: FaultKind.NAN_GRADS}


def _data(n=150, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 4)) * 2
    ys = rng.integers(0, 3, size=n)
    xs = (centers[ys] + rng.normal(size=(n, 4))).astype(np.float32)
    return xs, np.eye(3, dtype=np.float32)[ys]


def _jax_net(seed=3):
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(lr=0.01))
            .layer(Dense(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = JNet(conf)
    net.init()
    return net


def _port_of(jnet):
    import jax

    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(jnet.conf.to_dict()),
                            device="cpu")
    net.init()
    net.params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.params),
                                   device="cpu")
    net.opt_state = params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet.opt_state),
                                      device="cpu")
    return net


class Plain:
    def __init__(self, net):
        self.net = net

    def fit_batch(self, ds):
        return self.net.fit_batch(ds)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _chaos_run(pkg, net, ds, ckpt_dir):
    """N_CALLS ``fit_batch`` calls of ``pkg``'s ElasticTrainer under
    SCHEDULE → the observations both packages are held to."""
    clock = FakeClock()
    inj = pkg.ChaosInjector(Plain(net), pkg.FaultSchedule.scripted(SCHEDULE),
                            hang_seconds=100.0, sleep_fn=clock.sleep, seed=0)
    et = pkg.ElasticTrainer(inj, ckpt_dir, checkpoint_every=2, sync_every=1,
                            keep_last=3, max_restarts=6, backoff_base=0.5,
                            jitter_seed=0, step_timeout=10.0, clock=clock,
                            sleep_fn=clock.sleep)
    inj.attach_checkpoints(et.ckpt)
    losses, steps = [], []
    for _ in range(N_CALLS):
        losses.append(float(et.fit_batch(ds)))
        steps.append(et.global_step)
    files = sorted(os.listdir(ckpt_dir))
    return {"losses": np.asarray(losses), "steps": steps,
            "restarts": et.total_restarts, "backoff": list(et.backoff_sleeps),
            "checkpoints": [f for f in files if f.endswith(".zip")],
            "quarantined": [f for f in files if f.endswith(".corrupt")],
            "tmp": [f for f in files if f.endswith(".tmp")],
            "injected": [(e["step"], e["kind"]) for e in inj.events],
            "bad_steps_seen": net._bad_steps}


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    import deeplearning4j_tpu.parallel as jpar

    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    import deeplearning4j_tpu_torch.parallel as tpar

    xs, ys = _data()
    jnet = _jax_net()
    pnet = _port_of(jnet)
    jnet.set_nan_guard(2)
    pnet.set_nan_guard(2)
    ref = _chaos_run(jpar, jnet, JDataSet(xs, ys), str(tmp_path_factory.mktemp("jax")))
    port = _chaos_run(tpar, pnet, DataSet(xs, ys), str(tmp_path_factory.mktemp("port")))
    return ref, port


@pytest.mark.parametrize("key", ["steps", "restarts", "backoff", "checkpoints",
                                 "quarantined", "tmp", "injected"])
def test_recovery_matches_the_reference(chaos_runs, key):
    """The same faults give the same recoveries: restarts, the global step
    after each call (restores go back to the same checkpoints), backoff
    delays, the surviving checkpoints, the quarantined files, no stale
    temp file, and the same fault log."""
    ref, port = chaos_runs
    assert port[key] == ref[key]
    if key == "quarantined":
        assert len(port[key]) >= 1          # a corrupt newest checkpoint met a restore
    if key == "restarts":
        assert port[key] == 5       # three device losses, the crash, the hang


def test_losses_match_the_reference_at_every_call(chaos_runs):
    ref, port = chaos_runs
    finite = np.isfinite(ref["losses"])
    np.testing.assert_array_equal(np.isfinite(port["losses"]), finite)
    np.testing.assert_allclose(port["losses"][finite], ref["losses"][finite],
                               rtol=0, atol=1e-5)
    assert not finite.all()                 # the poisoned step's loss


def _plain_net(seed=7):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(lr=0.01))
            .layer(Dense(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _batches(k=4):
    xs, ys = _data(160)
    return [DataSet(xs[i::k], ys[i::k]) for i in range(k)]


def test_chaos_off_is_bitwise_a_plain_loop(tmp_path):
    plain = _plain_net()
    want = [float(plain.fit_batch(b)) for b in _batches() * 3]
    net = _plain_net()
    et = ElasticTrainer(Plain(net), str(tmp_path), checkpoint_every=3)
    got = [float(l) for l in et.fit(_batches(), epochs=3)]
    assert got == want
    for a, b in zip(params_to_numpy(net.params), params_to_numpy(plain.params)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_fit_replays_from_the_restored_step_bitwise(tmp_path):
    """A device loss at call 6 restores step 3; ``fit`` replays positions
    3.. of the plan, so every step's loss, replays included, is the
    fault-free run's bitwise, and the final parameters are too."""
    plain = _plain_net()
    want = [float(plain.fit_batch(b)) for b in _batches() * 3]
    net = _plain_net()
    inj = ChaosInjector(Plain(net), FaultSchedule.scripted({6: FaultKind.DEVICE_LOSS}))
    et = ElasticTrainer(inj, str(tmp_path), checkpoint_every=3)
    losses = et.fit(_batches(), epochs=3)
    assert et.restored_steps == [3] and len(losses) == 12
    steps = [s for s, _ in et.step_losses]
    assert steps == [1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 10, 11, 12]
    for s, l in et.step_losses:
        assert float(l) == want[s - 1], s
    for a, b in zip(params_to_numpy(net.params), params_to_numpy(plain.params)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


class _Stream:
    """An iterable that makes each batch as it is asked for (a fresh copy
    every pass), and counts the batches made and still alive."""

    def __init__(self, batches):
        self.batches = batches
        self.made = []

    def __iter__(self):
        import weakref

        for b in self.batches:
            ds = DataSet(b.features.copy(), b.labels.copy())
            self.made.append(weakref.ref(ds))
            yield ds

    def alive(self):
        import gc

        gc.collect()
        return sum(r() is not None for r in self.made)


def test_fit_streams_and_holds_only_the_restorable_batches(tmp_path):
    """``fit`` pulls one batch ahead of the step it runs and holds only the
    batches since the oldest of the last ``keep_last`` checkpoints (here
    2 x 2 and the one pulled), where a materialised plan would hold all
    24; a device loss at call 9 replays from the held batches, bitwise
    the fault-free run."""
    plain = _plain_net()
    want = [float(plain.fit_batch(b)) for b in _batches(8) * 3]
    stream = _Stream(_batches(8))
    seen = []

    class Watch(Plain):
        def fit_batch(self, ds):
            seen.append((len(stream.made), stream.alive()))
            return super().fit_batch(ds)

    net = _plain_net()
    inj = ChaosInjector(Watch(net), FaultSchedule.scripted({9: FaultKind.DEVICE_LOSS}))
    et = ElasticTrainer(inj, str(tmp_path), checkpoint_every=2, keep_last=2)
    losses = et.fit(stream, epochs=3)
    assert et.restored_steps == [8] and len(losses) == 24
    for s, l in et.step_losses:
        assert float(l) == want[s - 1], s
    steps = [s for s, _ in et.step_losses]
    assert len(seen) == len(steps)
    for i, (made, _) in enumerate(seen):
        assert made <= max(steps[:i + 1]), (i, made)     # no batch pulled early
    assert max(alive for _, alive in seen) <= 2 * 2 + 1


def test_resume_skips_the_done_batches(tmp_path):
    """``resume`` then ``fit(skip_done=True)``: the run goes on at the
    checkpoint's step, bitwise the uninterrupted run."""
    plain = _plain_net()
    want = [float(plain.fit_batch(b)) for b in _batches() * 2]
    first = ElasticTrainer(Plain(_plain_net()), str(tmp_path), checkpoint_every=5)
    for b in _batches() + _batches()[:2]:
        first.fit_batch(b)                   # 6 steps, checkpoint @5
    net = _plain_net(seed=99)                # other weights: the restore replaces them
    et = ElasticTrainer(Plain(net), str(tmp_path), checkpoint_every=5)
    assert et.resume() == 5
    losses = et.fit(_batches(), epochs=2, skip_done=True)
    assert [float(l) for l in losses] == want[5:]


def test_async_snapshot_is_a_copy_on_the_cpu(tmp_path):
    net = _plain_net()
    b = _batches()[0]
    net.fit_batch(b)
    before = params_to_numpy(net.params)
    mgr = CheckpointManager(str(tmp_path))
    fut = mgr.save_async(Plain(net), 1)
    for _ in range(3):
        net.fit_batch(b)                     # moves the live parameters
    # the in-place moves of a graph or an optimizer must not reach it either
    with torch.no_grad():
        for layer in net.params:
            for t in layer.values():
                t.add_(1.0)
    path = fut.result()
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    saved = params_to_numpy(load_model(path, device="cpu").params)
    for a, w in zip(saved, before):
        for k in a:
            np.testing.assert_array_equal(a[k], w[k])


def test_restore_then_fit_batches_trains_from_the_restored_weights(tmp_path):
    """``fit_batches`` after a restore runs on the restored weights (on the
    card the captured graph copies them into its buffers first)."""
    bs = _batches()
    ref = _plain_net()
    ref.fit_batches(bs[:2])
    want = [float(l) for l in ref.fit_batches(bs[2:])]
    net = _plain_net()
    et = ElasticTrainer(Plain(net), str(tmp_path), checkpoint_every=2)
    net.fit_batches(bs[:2])
    et.global_step = 2
    et.ckpt.save(Plain(net), 2)
    net.fit_batches(bs)                      # moves on
    et._restore()
    assert net.iteration == 2
    assert [float(l) for l in net.fit_batches(bs[2:])] == want


def test_checkpoints_cross_packages_both_ways(tmp_path):
    """An elastic checkpoint of the port loads in the reference and the
    reverse, parameters and updater state bitwise; a one-rank compressed
    trainer's checkpoint carries its residual [1, ...]."""
    import jax

    from deeplearning4j_tpu.parallel import ElasticTrainer as JElastic
    from deeplearning4j_tpu.utils.serializer import load_model as jload
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_two_tier_mesh
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    xs, ys = _data()
    jnet = _jax_net()
    pnet = _port_of(jnet)
    trainer = ShardedTrainer(pnet, build_two_tier_mesh(1), grad_compression="threshold")
    et = ElasticTrainer(trainer, str(tmp_path / "p"), checkpoint_every=2)
    for _ in range(2):
        et.fit_batch(DataSet(xs, ys))
    path, step = et.ckpt.latest()
    ref = jload(path)
    res = jax.tree_util.tree_map(np.asarray, ref.grad_residual)
    assert step == 2 and res[0]["W"].shape == (1, 4, 8)
    np.testing.assert_array_equal(np.concatenate([r[k].reshape(-1) for r in res
                                                  for k in sorted(r)]),
                                  trainer._residual.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(ref.params),
                    [t for l in pnet.params for k in sorted(l) for t in [l[k]]]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jet = JElastic(Plain(jnet), str(tmp_path / "j"), checkpoint_every=2)
    for _ in range(2):
        jet.fit_batch(JDataSet(xs, ys))
    back = load_model(jet.ckpt.latest()[0], device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jnet.opt_state),
                    [t for l in back.opt_state for t in _leaves(l)]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _leaves(tree):
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("text,want", [
    ("RuntimeError: [pair.cc:553] Connection closed by peer [127.0.0.1]:29325", True),
    ("RuntimeError: [pair.cc:598] Connection reset by peer", True),
    ("RuntimeError: [unbound_buffer.cc:81] Timed out waiting 5000ms for recv "
     "operation to complete", True),
    ("DistBackendError: Watchdog caught collective operation timeout", True),
    ("RuntimeError: NCCL communicator was aborted on rank 1", True),
    ("RuntimeError: UNAVAILABLE: chaos — device lost", True),
    ("AcceleratorError: CUDA error: an illegal memory access was encountered", False),
    ("RuntimeError: CUDA error: device-side assert triggered (connection reset)", False),
    ("RuntimeError: shapes cannot be multiplied", False),
])
def test_failure_classification(text, want):
    kind, _, msg = text.partition(": ")
    exc = type(kind, (RuntimeError,), {})(msg)
    assert FailureDetector().is_recoverable(exc) is want


def test_hang_and_programming_errors():
    d = FailureDetector()
    assert d.is_recoverable(StepHangError(99.0, 10.0))
    assert not d.is_recoverable(ValueError("UNAVAILABLE"))
