"""The port's fault injection (``deeplearning4j_tpu_torch/parallel/chaos.py``)
against the JAX package's on the CPU: the same fault menu, random
schedules drawn from the same ``np.random.default_rng`` stream, the same
bytes after ``bitflip_file`` / ``truncate_file``, the serving and fleet
schedules' validation, and the injector's faults on a port network (a
poisoned batch drives the real nan guard; a scheduled corruption needs a
checkpoint manager; a consumed fault is not injected again on replay).
"""

import numpy as np
import pytest

import deeplearning4j_tpu.parallel.chaos as J
import deeplearning4j_tpu_torch.parallel.chaos as T
from deeplearning4j_tpu_torch.datasets import DataSet


def test_fault_menu_is_the_reference():
    for name in ("ALL", "PROCESS_KINDS", "TRAINER_KINDS", "SERVING_KINDS",
                 "SERVING_ENGINE_KINDS", "FLEET_KINDS"):
        assert getattr(T.FaultKind, name) == getattr(J.FaultKind, name), name


@pytest.mark.parametrize("seed,rate,kinds", [(0, 0.05, None), (42, 0.3, None),
                                             (7, 0.5, ["device_loss", "proc_kill"])])
def test_random_schedules_are_the_references(seed, rate, kinds):
    a = T.FaultSchedule.random(seed, 300, rate=rate, kinds=kinds)
    b = J.FaultSchedule.random(seed, 300, rate=rate, kinds=kinds)
    assert a.faults == b.faults and a.pending() == b.pending() > 0


@pytest.mark.parametrize("seed,n_flips", [(0, 8), (3, 16), (11, 1)])
def test_bitflip_is_byte_for_byte_the_references(tmp_path, seed, n_flips):
    data = np.random.default_rng(5).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    p, q = tmp_path / "a.bin", tmp_path / "b.bin"
    p.write_bytes(data)
    q.write_bytes(data)
    T.bitflip_file(str(p), n_flips=n_flips, seed=seed)
    J.bitflip_file(str(q), n_flips=n_flips, seed=seed)
    assert p.read_bytes() == q.read_bytes() != data


def test_truncate_is_the_references(tmp_path):
    p, q = tmp_path / "a.bin", tmp_path / "b.bin"
    p.write_bytes(bytes(1001))
    q.write_bytes(bytes(1001))
    T.truncate_file(str(p), 0.3)
    J.truncate_file(str(q), 0.3)
    assert p.stat().st_size == q.stat().st_size == 300


def test_schedule_validation_and_pop():
    s = T.FaultSchedule.scripted({3: "device_loss", 5: ["ckpt_truncate", "device_loss"]})
    assert s.pending() == 3 and s.pop(3) == ["device_loss"] and s.pop(3) == []
    with pytest.raises(ValueError, match="unknown fault kind"):
        T.FaultSchedule({1: ["meteor_strike"]})
    with pytest.raises(ValueError, match="not an engine-side serving fault"):
        T.ServingChaos(T.FaultSchedule.scripted({1: "poison_input"}))
    with pytest.raises(ValueError, match="not a fleet fault"):
        T.FleetChaos(T.FaultSchedule.scripted({1: "replica_crash"}))
    sc = T.ServingChaos(T.FaultSchedule.scripted({2: "replica_crash"}))
    assert sc.pop_batch(0) == [] and sc.pop_batch(1) == ["replica_crash"]
    assert sc.injected("replica_crash") == 1
    fc = T.FleetChaos(T.FaultSchedule.scripted({1: "host_kill"}))
    assert fc.pop_request() == ["host_kill"] and fc.injected() == 1


def _net():
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(5).updater(Adam(lr=0.01))
            .layer(Dense(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _ds(tensor=False):
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.normal(-2, 1, (32, 4)), rng.normal(2, 1, (32, 4))]).astype(np.float32)
    ys = np.zeros((64, 2), np.float32)
    ys[:32, 0] = ys[32:, 1] = 1
    if tensor:
        import torch
        return DataSet(torch.from_numpy(xs), torch.from_numpy(ys))
    return DataSet(xs, ys)


class Plain:
    def __init__(self, net):
        self.net = net

    def fit_batch(self, ds):
        return self.net.fit_batch(ds)


@pytest.mark.parametrize("tensor", [False, True])
def test_nan_poison_drives_the_real_guard(tmp_path, tensor):
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    from deeplearning4j_tpu_torch.utils.params import params_to_numpy

    net = _net()
    net.set_nan_guard(3)
    inj = T.ChaosInjector(Plain(net), T.FaultSchedule.scripted({2: "nan_grads"}))
    et = ElasticTrainer(inj, str(tmp_path), checkpoint_every=1, sync_every=1)
    et.fit_batch(_ds(tensor))
    before = params_to_numpy(net.params)
    et.fit_batch(_ds(tensor))                # poisoned → the guard skips the update
    for a, b in zip(params_to_numpy(net.params), before):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert net._bad_steps == 1 and inj.injected("nan_grads") == 1


def test_corruption_needs_an_attached_manager():
    inj = T.ChaosInjector(Plain(_net()), T.FaultSchedule.scripted({1: "ckpt_truncate"}))
    with pytest.raises(RuntimeError, match="attach_checkpoints"):
        inj.fit_batch(_ds())


def test_write_crash_leaves_a_stale_tmp_the_next_manager_cleans(tmp_path):
    from deeplearning4j_tpu_torch.parallel import CheckpointManager, ElasticTrainer

    net = _net()
    inj = T.ChaosInjector(Plain(net), T.FaultSchedule.scripted({2: "ckpt_write_crash"}))
    et = ElasticTrainer(inj, str(tmp_path), checkpoint_every=1, sync_every=1)
    inj.attach_checkpoints(et.ckpt)
    for _ in range(2):
        et.fit_batch(_ds())
    assert et.total_restarts == 1 and inj.injected("ckpt_write_crash") == 1
    # the retried step wrote its checkpoint under the same temp name; a
    # crash with no retry after it leaves the torn temp file behind
    inj._crash_next_write = True
    with pytest.raises(RuntimeError, match="DATA_LOSS"):
        et.ckpt.save(Plain(net), 3)
    assert any(p.name.endswith(".zip.tmp") for p in tmp_path.iterdir())
    CheckpointManager(str(tmp_path))
    assert not any(p.name.endswith(".zip.tmp") for p in tmp_path.iterdir())
