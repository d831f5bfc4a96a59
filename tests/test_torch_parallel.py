"""The port's data-parallel trainer (``deeplearning4j_tpu_torch/parallel``)
against the JAX package's ``ShardedTrainer`` on the CPU.

The JAX side runs on four of the virtual CPU devices as
``build_two_tier_mesh(2, {"data": 2})``; the port side is four processes
(gloo, a ``file://`` rendezvous under ``tmp_path``), the same mesh over
ranks, started by this file run as a script (``--worker``).  Both train
the reference test's MLP (Dense(16, tanh) → OutputLayer(3, softmax,
mcxent), SGD lr 0.05) from the same weights on the same 128-row blobs
for 5 steps in six arms: dense, threshold adaptive, threshold fixed 1e-3
through the top-k pack alone (the port's one-pass route patched out,
the JAX one-pass switch off) and routed (JAX switch on), the same routed
at 0.3, and bitmap adaptive.

Tolerances: losses within 1e-5 of the JAX run at every step; final
parameters and each slice's residual within 1e-5 (the per-rank
gradients are f32 sums in another order; the adaptive scales differ by
a few float32 spacings, tests/test_torch_compression.py); every rank's
parameters bitwise equal to every other's.  Also: the trainer's
validation errors, and the residual checkpoint both ways.

The network-state arms: a Dense → BatchNorm → Output network (SGD lr
0.05) dense and two-tier compressed (threshold 0.05), the loss,
parameters and BatchNorm statistics within 1e-5 of the JAX trainer's
after every one of the 5 steps, and bitwise equal across ranks (dense:
the moments of the global batch, all-reduced in the forward; compressed:
each rank's own moments, the new statistics averaged over the ranks);
an LSTM → RnnOutputLayer network with TBPTT 3 over 7 steps on the dense
path, 3 calls, losses and parameters within 1e-5; a network with input
dropout 0.5 whose ranks draw different masks while their parameters stay
bitwise equal, and the MLP without dropout whose training-mode
activations are bitwise equal across ranks.

The elastic arms: ``ElasticTrainer`` over sharded trainers on the four
ranks, a device loss replayed bitwise; async checkpoints with the
writer's write still in flight at the fault, every rank restoring the
step the writer waits for; a preemption notice on one rank agreed by all
at the next multiple of ``sync_every``.

The workers import neither JAX nor the JAX package; JAX is imported
inside the JAX-side helpers only.  Every spawn has a 120 s limit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
RANKS = 4
#: arm → (trainer kwargs, one-pass route: the port's as it runs, and the
#: JAX package's switch)
ARMS = {
    "dense": ({}, False),
    "threshold_adaptive": ({"grad_compression": "threshold"}, False),
    "threshold_fixed_top_k": ({"grad_compression": "threshold",
                               "compression_threshold": 1e-3}, False),
    "threshold_fixed_routed": ({"grad_compression": "threshold",
                                "compression_threshold": 1e-3}, True),
    "bitmap": ({"grad_compression": "bitmap"}, False),
    # at 1e-3 every bucket of this small MLP overflows k = n/16, so the
    # routed arm above ends in the top-k pack; at 0.3 the first step fits
    # and keeps its one-pass message
    "threshold_fixed_0.3_routed": ({"grad_compression": "threshold",
                                    "compression_threshold": 0.3}, True),
}
COMPRESSED = [a for a, (kw, _) in ARMS.items() if kw]
#: the arms of a network with BatchNormalization (its state rides the step)
BN_ARMS = {"bn_dense": {},
           "bn_compressed": {"grad_compression": "threshold", "compression_threshold": 0.05}}
TBPTT_CALLS = 3


def _blobs(n=128, f=12, classes=3, seed=0):
    """The JAX package's tests/test_compression.py data."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, f)) * 3
    ys = rng.integers(0, classes, size=n)
    xs = (centers[ys] + rng.normal(size=(n, f))).astype(np.float32)
    return xs, np.eye(classes, dtype=np.float32)[ys]


def _jax_mlp(seed=3, lr=0.05):
    """The JAX package's tests/test_compression.py ``_mlp``."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=lr))
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf)
    net.init()
    return net


def _jax_adam_clip_mlp(seed=3):
    """``_jax_mlp`` with Adam (lr 0.01) and per-layer L2 clipping at 0.5:
    the model axis's updater state slices and its layer norms summed
    over ``model``."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Adam, GradientNormalization

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(lr=0.01))
            .gradient_normalization(GradientNormalization.CLIP_L2_PER_LAYER, 0.5)
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf)
    net.init()
    return net


def _jax_graph(seed=8):
    """A ComputationGraph: in → Dense(16, tanh) and Dense(16, relu) →
    merge → Dense(8, tanh) → OutputLayer(3), Adam 0.01 with per-layer L2
    clipping at 0.5 (every vertex's leaves split over ``model``)."""
    from deeplearning4j_tpu.nn import graph as jg
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu.nn.updaters import Adam, GradientNormalization

    conf = (jg.GraphBuilder().seed(seed).updater(Adam(lr=0.01))
            .gradient_normalization(GradientNormalization.CLIP_L2_PER_LAYER, 0.5)
            .add_inputs("in").set_input_types(**{"in": InputType.feed_forward(12)})
            .add_layer("a", Dense(n_out=16, activation="tanh"), "in")
            .add_layer("b", Dense(n_out=16, activation="relu"), "in")
            .add_vertex("m", jg.MergeVertex(), "a", "b")
            .add_layer("h", Dense(n_out=8, activation="tanh"), "m")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
            .set_outputs("out").build())
    net = jg.ComputationGraph(conf)
    net.init()
    return net


def _flat_graph(tree):
    """f32 leaves of a vertex-dict tree in sorted (vertex, key) order."""
    return np.concatenate([np.asarray(tree[v][k], np.float32).reshape(-1)
                           for v in sorted(tree) for k in sorted(tree[v])])


#: the model-axis arms: name → the JAX network builder (its conf and the
#: shared weights are what the port's ranks load)
MODEL_ARMS = {"model_sgd": "_jax_mlp", "model_adam_clip": "_jax_adam_clip_mlp"}


def _jax_bn_net(seed=5):
    """Dense(16) → BatchNormalization(relu) → OutputLayer(3), SGD 0.05."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import BatchNormalization, Dense, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=0.05))
            .layer(Dense(n_out=16, activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf)
    net.init()
    return net


def _jax_tbptt_net(seed=6):
    """LSTM(6) → RnnOutputLayer(3) with TBPTT 3, SGD 0.1."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr=0.1))
            .layer(LSTM(n_out=6))
            .layer(RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(4)).tbptt(3).build())
    net = MultiLayerNetwork(conf)
    net.init()
    return net


def _sequences(n=8, t=7, f=4, classes=3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, t, f)).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, (n, t))])


def _flat(tree):
    """f32 leaves of a list-of-dicts tree in sorted-key order, concatenated."""
    return np.concatenate([np.asarray(l[k], np.float32).reshape(-1)
                           for l in tree for k in sorted(l)]) if tree else np.zeros(0)


# -- the port's ranks ---------------------------------------------------------------


def _port_net(work, conf="conf.json"):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy

    with open(os.path.join(work, conf)) as f:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(json.load(f)), device="cpu")
    w = np.load(os.path.join(work, "weights.npz"))
    net.params = params_from_numpy([{"W": w[f"{i}/W"], "b": w[f"{i}/b"]} for i in range(2)],
                                   device="cpu")
    net.state = [{}, {}]
    net.opt_state = net.init_opt_state(net.params)
    return net


def _worker(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import (ShardedTrainer, build_two_tier_mesh,
                                                   initialize, shutdown)
    from deeplearning4j_tpu_torch.utils.params import params_to_numpy
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    initialize(init_method="file://" + os.path.join(work, "rendezvous"),
               num_processes=RANKS, process_id=rank, backend="gloo", timeout_s=100)
    from deeplearning4j_tpu_torch.ops import compression

    one_pass = compression.one_pass_pack
    calls = []

    def counted(*a):
        calls.append(len(a[1]))         # the buckets this call encodes
        return one_pass(*a)

    def top_k_only(g, sizes, ks, t, out=None):
        # every bucket reports an overflow, so the top-k pack encodes it
        return out, torch.tensor([k + 1 for k in ks])

    xs, ys = _blobs()
    ds = DataSet(xs, ys)
    out = {}
    for arm, (kw, routed) in ARMS.items():
        compression.one_pass_pack = counted if routed else top_k_only
        calls.clear()
        trainer = ShardedTrainer(_port_net(work), build_two_tier_mesh(2, {"data": 2}), **kw)
        # the three entry points: fit_batch, fit_batches, fit (one epoch)
        fits = 0
        if arm == "threshold_adaptive":
            losses = trainer.fit([ds] * STEPS)
        elif arm == "bitmap":
            losses = trainer.fit_batches([ds] * STEPS)
        else:
            losses = []
            for _ in range(STEPS):
                losses.append(trainer.fit_batch(ds))
                fits += sum(c <= k for c, k in trainer.last_bucket_counts)
        out[f"{arm}/losses"] = np.asarray([float(x) for x in losses], np.float32)
        out[f"{arm}/params"] = _flat([{k: v.numpy() for k, v in p.items()}
                                      for p in trainer.net.params])
        out[f"{arm}/one_pass_calls"] = np.asarray(len(calls))
        out[f"{arm}/one_pass_buckets"] = np.asarray(sum(calls))
        out[f"{arm}/buckets_fit"] = np.asarray(fits)
        out[f"{arm}/n_buckets"] = np.asarray(trainer.bucketer.n_buckets)
        if kw:
            out[f"{arm}/residual"] = trainer._residual.numpy()
        if arm == "threshold_fixed_top_k":
            trainer.save(os.path.join(work, "port.zip"))
    compression.one_pass_pack = one_pass
    # the network-state arms
    for arm, kw in BN_ARMS.items():
        trainer = ShardedTrainer(load_model(os.path.join(work, "bn.zip"), device="cpu"),
                                 build_two_tier_mesh(2, {"data": 2}), **kw)
        losses, trace = [], []
        for _ in range(STEPS):
            losses.append(float(trainer.fit_batch(ds)))
            trace.append(np.concatenate([_flat(params_to_numpy(trainer.net.params)),
                                         _flat(params_to_numpy(trainer.net.state))]))
        out[f"{arm}/losses"] = np.asarray(losses, np.float32)
        out[f"{arm}/trace"] = np.stack(trace)
    xs_t, ys_t = _sequences()
    trainer = ShardedTrainer(load_model(os.path.join(work, "tbptt.zip"), device="cpu"),
                             build_two_tier_mesh(2, {"data": 2}))
    out["tbptt/losses"] = np.asarray([float(trainer.fit_batch(DataSet(xs_t, ys_t)))
                                      for _ in range(TBPTT_CALLS)], np.float32)
    out["tbptt/params"] = _flat(params_to_numpy(trainer.net.params))
    out["tbptt/iteration"] = np.asarray(trainer.net.iteration)
    # dropout: each rank its own masks; without dropout, the same
    drop = _port_net(work)
    drop.conf.layers[0].dropout = 0.5
    trainer = ShardedTrainer(drop, build_two_tier_mesh(2, {"data": 2}))
    out["dropout/acts"] = trainer.net.feed_forward(xs[:8], train=True)[0].numpy()
    for _ in range(2):
        trainer.fit_batch(ds)
    out["dropout/params"] = _flat(params_to_numpy(trainer.net.params))
    trainer = ShardedTrainer(_port_net(work), build_two_tier_mesh(2, {"data": 2}))
    out["no_dropout/acts"] = trainer.net.feed_forward(xs[:8], train=True)[0].numpy()
    # the model axis: {data 2, model 2}, each rank stores its slices
    from deeplearning4j_tpu_torch.parallel import build_mesh

    for arm in MODEL_ARMS:
        trainer = ShardedTrainer(_port_net(work, f"{arm}.json"),
                                 build_mesh({"data": 2, "model": 2}))
        out[f"{arm}/losses"] = np.asarray([float(trainer.fit_batch(ds))
                                           for _ in range(STEPS)], np.float32)
        out[f"{arm}/params"] = _flat(params_to_numpy(trainer.gather_params()))
        out[f"{arm}/local_sizes"] = np.asarray([t.numel() for l in trainer.net.params
                                                for k in sorted(l) for t in [l[k]]])
        out[f"{arm}/output"] = trainer.output(xs[:8]).numpy()
    # a ComputationGraph on the model axis: every vertex's leaves split
    graph = load_model(os.path.join(work, "graph.zip"), device="cpu")
    trainer = ShardedTrainer(graph, build_mesh({"data": 2, "model": 2}))
    out["graph_model/losses"] = np.asarray([float(trainer.fit_batch(ds))
                                            for _ in range(STEPS)], np.float32)
    out["graph_model/params"] = _flat_graph(params_to_numpy(trainer.gather_params()))
    out["graph_model/local"] = _flat_graph(params_to_numpy(graph.params))
    out["graph_model/output"] = trainer.output(xs[:8])[0].numpy()
    # the elastic runtime over sharded trainers: every rank snapshots (a
    # collective), rank 0 writes, all restore the same step after a fault
    from deeplearning4j_tpu_torch.parallel import ChaosInjector, ElasticTrainer, FaultSchedule

    for arm, mesh_fn, kw, conf in (
            ("elastic_model", lambda: build_mesh({"data": 2, "model": 2}), {},
             "model_adam_clip.json"),
            ("elastic_compressed", lambda: build_two_tier_mesh(2, {"data": 2}),
             ARMS["threshold_adaptive"][0], "conf.json")):
        trainer = ShardedTrainer(_port_net(work, conf), mesh_fn(), **kw)
        inj = ChaosInjector(trainer, FaultSchedule.scripted({4: "device_loss"}))
        et = ElasticTrainer(inj, os.path.join(work, arm), checkpoint_every=2, sync_every=1)
        et.fit([ds], epochs=STEPS)
        out[f"{arm}/steps"] = np.asarray([s for s, _ in et.step_losses])
        out[f"{arm}/losses"] = np.asarray([float(l) for _, l in et.step_losses], np.float32)
        out[f"{arm}/restored"] = np.asarray(et.restored_steps)
    # async checkpoints: the writer's write of step 4 (slowed by a second)
    # is still in flight when a device loss hits every rank at step 5; on
    # its own a non-writer would find only step 2 on disk
    import time

    trainer = ShardedTrainer(_port_net(work), build_two_tier_mesh(2, {"data": 2}))
    inj = ChaosInjector(trainer, FaultSchedule.scripted({5: "device_loss"}))
    et = ElasticTrainer(inj, os.path.join(work, "elastic_async"), checkpoint_every=2,
                        sync_every=1, async_checkpoints=True)
    write = et.ckpt._write

    def slow_write(*a, **kw):
        time.sleep(1.0)
        return write(*a, **kw)

    et.ckpt._write = slow_write
    et.fit([ds], epochs=STEPS)
    out["elastic_async/steps"] = np.asarray([s for s, _ in et.step_losses])
    out["elastic_async/losses"] = np.asarray([float(l) for _, l in et.step_losses],
                                             np.float32)
    out["elastic_async/restored"] = np.asarray(et.restored_steps)
    # a preemption notice rank 1 takes during step 3: with sync_every=2
    # the ranks agree it at the boundary after step 4 and leave together
    from deeplearning4j_tpu_torch.parallel.preemption import PreemptedError, PreemptionHandler

    handler = PreemptionHandler(grace_s=60)

    class NoticeAt3:
        def __init__(self, inner):
            self.trainer, self.calls = inner, 0

        @property
        def net(self):
            return self.trainer.net

        def fit_batch(self, b):
            self.calls += 1
            if rank == 1 and self.calls == 3:
                handler.notice(None)
            return self.trainer.fit_batch(b)

    trainer = ShardedTrainer(_port_net(work), build_two_tier_mesh(2, {"data": 2}))
    et = ElasticTrainer(NoticeAt3(trainer), os.path.join(work, "elastic_notice"),
                        checkpoint_every=100, sync_every=2, preemption=handler)
    try:
        et.fit([ds], epochs=STEPS)
        out["elastic_notice/step"] = np.asarray(-1)
    except PreemptedError as exc:
        out["elastic_notice/step"] = np.asarray(exc.step)
        out["elastic_notice/written"] = np.asarray(exc.checkpoint_path is not None)
    # a zip the JAX package wrote: every rank adopts its slice's residual
    net = load_model(os.path.join(work, "jax.zip"), device="cpu")
    out["adopt/loaded_shape"] = np.asarray(net.grad_residual[0]["W"].shape)
    trainer = ShardedTrainer(net, build_two_tier_mesh(2, {"data": 2}),
                             grad_compression="threshold")
    out["adopt/residual"] = trainer._residual.numpy()
    trainer.fit_batch(ds)              # and training continues
    shutdown()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


# -- the JAX side and the run -----------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' five arms (and the checkpoint exchange): the JAX arms
    in this process, then the port's four ranks as subprocesses."""
    import jax

    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.ops import compression as J
    from deeplearning4j_tpu.parallel import ShardedTrainer as JTrainer
    from deeplearning4j_tpu.parallel.mesh import build_mesh as j_mesh
    from deeplearning4j_tpu.parallel.mesh import build_two_tier_mesh as j_two_tier

    work = str(tmp_path_factory.mktemp("ranks"))
    net = _jax_mlp()
    with open(os.path.join(work, "conf.json"), "w") as f:
        json.dump(net.conf.to_dict(), f)
    np.savez(os.path.join(work, "weights.npz"),
             **{f"{i}/{k}": np.asarray(v) for i, p in enumerate(net.params) for k, v in p.items()})

    xs, ys = _blobs()
    ds = JDataSet(xs, ys)
    jax_out = {}
    fused = J.FUSED_ENCODE
    try:
        for arm, (kw, routed) in ARMS.items():
            J.FUSED_ENCODE = routed             # read when the step is traced
            trainer = JTrainer(_jax_mlp(), j_two_tier(2, {"data": 2}, jax.devices()[:4]), **kw)
            jax_out[arm] = {"losses": np.asarray([float(trainer.fit_batch(ds))
                                                  for _ in range(STEPS)], np.float32),
                            "params": _flat(jax.tree_util.tree_map(np.asarray,
                                                                   trainer.net.params))}
            if kw:
                res = jax.tree_util.tree_map(np.asarray, trainer.net.grad_residual)
                jax_out[arm]["residual"] = [_flat(jax.tree_util.tree_map(lambda a: a[s], res))
                                            for s in range(2)]
            if arm == "threshold_adaptive":
                trainer.net.save(os.path.join(work, "jax.zip"))
                jax_out["jax_zip_residual"] = jax_out[arm]["residual"]
    finally:
        J.FUSED_ENCODE = fused
    # the network-state arms
    jbn = _jax_bn_net()
    jbn.save(os.path.join(work, "bn.zip"))
    for arm, kw in BN_ARMS.items():
        trainer = JTrainer(_jax_bn_net(), j_two_tier(2, {"data": 2}, jax.devices()[:4]), **kw)
        losses, trace = [], []
        for _ in range(STEPS):
            losses.append(float(trainer.fit_batch(ds)))
            trace.append(np.concatenate([_flat(jax.tree_util.tree_map(np.asarray, t))
                                         for t in (trainer.net.params, trainer.net.state)]))
        jax_out[arm] = {"losses": np.asarray(losses, np.float32), "trace": np.stack(trace)}
    for arm, builder in MODEL_ARMS.items():
        jnet = globals()[builder]()
        with open(os.path.join(work, f"{arm}.json"), "w") as f:
            json.dump(jnet.conf.to_dict(), f)
        trainer = JTrainer(jnet, j_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4]))
        jax_out[arm] = {"losses": np.asarray([float(trainer.fit_batch(ds))
                                              for _ in range(STEPS)], np.float32),
                        "params": _flat(jax.tree_util.tree_map(np.asarray, trainer.net.params)),
                        "output": np.asarray(trainer.output(xs[:8]))}
    jgraph = _jax_graph()
    jgraph.save(os.path.join(work, "graph.zip"))
    trainer = JTrainer(jgraph, j_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4]))
    jax_out["graph_model"] = {
        "losses": np.asarray([float(trainer.fit_batch(ds)) for _ in range(STEPS)], np.float32),
        "params": _flat_graph(jax.tree_util.tree_map(np.asarray, trainer.net.params)),
        "output": np.asarray(trainer.output(xs[:8])[0])}
    _jax_tbptt_net().save(os.path.join(work, "tbptt.zip"))
    trainer = JTrainer(_jax_tbptt_net(), j_two_tier(2, {"data": 2}, jax.devices()[:4]))
    xs_t, ys_t = _sequences()
    jax_out["tbptt"] = {
        "losses": np.asarray([float(trainer.fit_batch(JDataSet(xs_t, ys_t)))
                              for _ in range(TBPTT_CALLS)], np.float32),
        "params": _flat(jax.tree_util.tree_map(np.asarray, trainer.net.params)),
        "iteration": trainer.net.iteration}

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                               str(r), work], env=env, stdout=subprocess.PIPE,
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
    port = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(RANKS)]
    return {"jax": jax_out, "port": port, "work": work}


@pytest.mark.parametrize("arm", list(ARMS))
def test_losses_match_jax_at_every_step(runs, arm):
    want = runs["jax"][arm]["losses"]
    for r in range(RANKS):
        got = runs["port"][r][f"{arm}/losses"]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert want[-1] < want[0]


@pytest.mark.parametrize("arm", list(ARMS))
def test_final_params_match_jax(runs, arm):
    np.testing.assert_allclose(runs["port"][0][f"{arm}/params"], runs["jax"][arm]["params"],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("arm", list(ARMS))
def test_ranks_stay_bitwise_equal(runs, arm):
    for r in range(1, RANKS):
        np.testing.assert_array_equal(runs["port"][r][f"{arm}/params"],
                                      runs["port"][0][f"{arm}/params"])
        np.testing.assert_array_equal(runs["port"][r][f"{arm}/losses"],
                                      runs["port"][0][f"{arm}/losses"])


@pytest.mark.parametrize("arm", list(BN_ARMS))
def test_batchnorm_state_rides_the_data_parallel_step(runs, arm):
    """Losses, parameters and BatchNorm running statistics after every step
    within 1e-5 of the JAX trainer's, and bitwise equal across ranks."""
    import jax

    want = runs["jax"][arm]
    for r in range(RANKS):
        np.testing.assert_allclose(runs["port"][r][f"{arm}/losses"], want["losses"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(runs["port"][r][f"{arm}/trace"], want["trace"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(runs["port"][r][f"{arm}/trace"],
                                      runs["port"][0][f"{arm}/trace"])
    # the statistics moved off their initial values (mean 0, var 1)
    n_params = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(
        _jax_bn_net().params))
    stats = runs["port"][0][f"{arm}/trace"][-1, n_params:]
    assert np.abs(stats[:16]).max() > 1e-3


def test_tbptt_runs_on_the_dense_path_as_the_reference(runs):
    want = runs["jax"]["tbptt"]
    for r in range(RANKS):
        np.testing.assert_allclose(runs["port"][r]["tbptt/losses"], want["losses"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(runs["port"][r]["tbptt/params"], want["params"],
                                   rtol=0, atol=1e-5)
        assert int(runs["port"][r]["tbptt/iteration"]) == want["iteration"] == 3 * TBPTT_CALLS


@pytest.mark.parametrize("arm", ["dropout", "no_dropout"])
def test_ranks_draw_their_own_dropout_masks(runs, arm):
    acts = [runs["port"][r][f"{arm}/acts"] for r in range(RANKS)]
    for r in range(1, RANKS):
        if arm == "dropout":
            assert not np.array_equal(acts[r], acts[0])
            np.testing.assert_array_equal(runs["port"][r]["dropout/params"],
                                          runs["port"][0]["dropout/params"])
        else:
            np.testing.assert_array_equal(acts[r], acts[0])


def test_one_pass_route_runs_only_where_buckets_fit(runs):
    """The routed arms run the one-pass pack once a step, over every
    bucket; only the 0.3 arm has buckets that fit k and keep its message."""
    port = runs["port"][0]
    calls = {arm: int(port[f"{arm}/one_pass_calls"]) for arm in ARMS}
    fits = {arm: int(port[f"{arm}/buckets_fit"]) for arm in ARMS}
    for arm, (_, routed) in ARMS.items():
        assert calls[arm] == (STEPS if routed else 0)
        assert int(port[f"{arm}/one_pass_buckets"]) == (
            STEPS * int(port[f"{arm}/n_buckets"]) if routed else 0)
    assert fits["threshold_fixed_0.3_routed"] > 0
    assert all(f == 0 for arm, f in fits.items() if arm != "threshold_fixed_0.3_routed")


@pytest.mark.parametrize("arm", COMPRESSED)
def test_each_slices_residual_matches_jax(runs, arm):
    """Rank r is slice r // 2 (dcn-major); both ranks of a slice hold its
    residual bitwise, and it matches the JAX slice's."""
    for r in range(RANKS):
        got = runs["port"][r][f"{arm}/residual"]
        np.testing.assert_allclose(got, runs["jax"][arm]["residual"][r // 2], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got, runs["port"][r ^ 1][f"{arm}/residual"])
    assert np.abs(runs["port"][0][f"{arm}/residual"]).max() > 0


def test_port_trainer_adopts_a_jax_residual(runs):
    """A zip the JAX trainer saved: the port reads a [2, ...] residual and
    each rank's trainer adopts its own slice, bitwise."""
    assert tuple(runs["port"][0]["adopt/loaded_shape"]) == (2, 12, 16)
    for r in range(RANKS):
        np.testing.assert_array_equal(runs["port"][r]["adopt/residual"],
                                      runs["jax"]["jax_zip_residual"][r // 2])


def test_jax_loads_the_port_trainers_residual(runs):
    """``ShardedTrainer.save`` gathers both slices' residuals into the
    zip; the JAX package's ``load_model`` reads them, bitwise."""
    import jax

    from deeplearning4j_tpu.utils.serializer import load_model as j_load

    net = j_load(os.path.join(runs["work"], "port.zip"))
    res = jax.tree_util.tree_map(np.asarray, net.grad_residual)
    assert res[0]["W"].shape == (2, 12, 16)
    for s in range(2):
        np.testing.assert_array_equal(_flat(jax.tree_util.tree_map(lambda a: a[s], res)),
                                      runs["port"][2 * s]["threshold_fixed_top_k/residual"])
    np.testing.assert_array_equal(_flat(jax.tree_util.tree_map(np.asarray, net.params)),
                                  runs["port"][0]["threshold_fixed_top_k/params"])


@pytest.mark.parametrize("arm", list(MODEL_ARMS))
def test_model_axis_matches_the_jax_trainer(runs, arm):
    """``{data 2, model 2}``: losses, the gathered parameters and
    ``output`` within 1e-5 of the JAX trainer on the same mesh after 5
    steps, bitwise across ranks; each rank stores half of each split leaf
    (Dense W [12, 16] and b [16] by columns, the head's W [16, 3] by rows,
    its b [3] whole)."""
    want = runs["jax"][arm]
    for r in range(RANKS):
        port = runs["port"][r]
        np.testing.assert_allclose(port[f"{arm}/losses"], want["losses"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(port[f"{arm}/params"], want["params"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(port[f"{arm}/output"], want["output"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(port[f"{arm}/params"], runs["port"][0][f"{arm}/params"])
        # sorted keys per layer: W then b
        assert port[f"{arm}/local_sizes"].tolist() == [12 * 8, 8, 8 * 3, 3]
    assert want["losses"][-1] < want["losses"][0]


def test_graph_model_axis_matches_the_jax_trainer(runs):
    """A ComputationGraph on ``{data 2, model 2}``: losses, the gathered
    parameters and ``output`` within 1e-5 of the JAX trainer on 4 virtual
    devices after 5 Adam steps with per-layer clipping, bitwise across
    ranks, and each rank stores half of each split leaf."""
    want = runs["jax"]["graph_model"]
    for r in range(RANKS):
        port = runs["port"][r]
        np.testing.assert_allclose(port["graph_model/losses"], want["losses"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(port["graph_model/params"], want["params"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(port["graph_model/output"], want["output"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(port["graph_model/params"],
                                      runs["port"][0]["graph_model/params"])
    # every leaf splits in two but the head's bias [3], kept whole
    local = runs["port"][0]["graph_model/local"]
    assert local.size == (want["params"].size - 3) // 2 + 3
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("arm,plain", [("elastic_model", "model_adam_clip"),
                                       ("elastic_compressed", "threshold_adaptive")])
def test_elastic_snapshot_of_a_sharded_trainer(runs, arm, plain):
    """An ElasticTrainer over a sharded trainer on four ranks: every rank
    takes the checkpoint's snapshot (gathered slices, every slice's
    residual), only rank 0 writes, and nobody waits forever; after a
    device loss at call 4 every rank restores step 2 and replays, the
    losses bitwise the fault-free run's at every step."""
    for r in range(RANKS):
        port = runs["port"][r]
        assert port[f"{arm}/restored"].tolist() == [2]
        assert port[f"{arm}/steps"].tolist() == [1, 2, 3, 3, 4, 5]
        want = runs["port"][r][f"{plain}/losses"]
        for s, l in zip(port[f"{arm}/steps"], port[f"{arm}/losses"]):
            assert l == want[s - 1], (r, s)


def test_async_checkpoints_restore_one_step_on_every_rank(runs):
    """Async checkpoints on four ranks, a device loss right after the
    checkpoint of step 4 while the writer's write of it is in flight:
    every rank restores step 4 (the writer waits for its write and
    broadcasts the step), and the losses are bitwise the fault-free
    run's."""
    want = runs["port"][0]["dense/losses"]
    for r in range(RANKS):
        port = runs["port"][r]
        assert port["elastic_async/restored"].tolist() == [4], r
        assert port["elastic_async/steps"].tolist() == [1, 2, 3, 4, 5], r
        for s, l in zip(port["elastic_async/steps"], port["elastic_async/losses"]):
            assert l == want[s - 1], (r, s)


def test_a_notice_is_agreed_every_sync_every_steps(runs):
    """Rank 1 takes a preemption notice during step 3; the ranks agree on
    notices only every ``sync_every`` = 2 steps, so every rank leaves
    at step 4 and only rank 0 writes the emergency checkpoint."""
    for r in range(RANKS):
        port = runs["port"][r]
        assert int(port["elastic_notice/step"]) == 4, r
        assert bool(port["elastic_notice/written"]) == (r == 0), r


def test_trainer_forwards_the_schedule():
    """The reference's ``test_trainer_forwards_schedule``: LeNet accepts
    ``pipeline_schedule="1f1b"`` (it has no pipe dimension and ignores
    it); a network with a ``schedule`` attribute gets it."""
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_mesh

    net = LeNet(height=8, width=8, channels=1, num_classes=4, device="cpu")
    trainer = ShardedTrainer(net, build_mesh(), pipeline_schedule="1f1b")
    assert trainer.pipeline_schedule == "1f1b"
    with pytest.raises(ValueError, match="pipeline_schedule"):
        ShardedTrainer(net, build_mesh(), pipeline_schedule="nope")
    net.schedule = "gpipe"
    ShardedTrainer(net, build_mesh(), pipeline_schedule="1f1b")
    assert net.schedule == "1f1b"


# -- validation, in one process -------------------------------------------------------


def _cpu_mlp():
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(lr=0.05))
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


_INVALID = {
    "grad_compression": (lambda m: m.build_two_tier_mesh(2, {"data": 4}, world_size=8),
                         {"grad_compression": "gzip"}, ValueError),
    "dcn": (lambda m: m.build_mesh({"data": 8}, world_size=8),
            {"grad_compression": "threshold"}, ValueError),
    "model": (lambda m: m.build_mesh({"dcn": 2, "data": 2, "model": 2}, world_size=8),
              {"grad_compression": "threshold"}, ValueError),
    "pipeline_schedule": (lambda m: m.build_mesh(), {"pipeline_schedule": "zigzag"}, ValueError),
    # a seq axis still raises, as in the reference; the message names where
    # sequence parallelism runs (the case keeps its id)
    "queue 9": (lambda m: m.build_mesh({"data": 2, "seq": 2}, world_size=4), {},
                NotImplementedError, "sequence and pipeline parallelism run in "
                "ShardedTransformerLM"),
    # accepted and kept, as in the reference (tests/test_pipeline_1f1b.py)
    "pipeline schedules": (lambda m: m.build_mesh(), {"pipeline_schedule": "1f1b"}, None),
    "nan_guard": (lambda m: m.build_mesh(), {"nan_guard": 0}, ValueError),
    "initialize": (lambda m: m.build_two_tier_mesh(2, world_size=2), {}, RuntimeError),
}


@pytest.mark.parametrize("match", list(_INVALID))
def test_trainer_validation_errors(match):
    """The reference's errors (tests/test_compression.py), plus what a
    MultiLayerNetwork does not train over (a ``seq`` axis), a nan guard
    budget below 1 (the guard itself is ported:
    tests/test_torch_multilayer_surface.py) and a mesh wider than the
    process group.  A 1F1B schedule is accepted, as the reference accepts
    it for any network."""
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, mesh

    make_mesh, kw, err, *pattern = _INVALID[match]
    match = pattern[0] if pattern else match
    if err is None:
        assert ShardedTrainer(_cpu_mlp(), make_mesh(mesh), **kw).pipeline_schedule == "1f1b"
        return
    with pytest.raises(err, match=match):
        ShardedTrainer(_cpu_mlp(), make_mesh(mesh), **kw)


@pytest.mark.parametrize("model", [2, 4])
def test_shard_rule_matches_the_reference(model):
    """``mesh.shard_axis`` / ``infer_param_shardings`` split each leaf on
    the axis the reference's ``_shard_leaf`` picks (the trailing-most
    axis divisible by the ``model`` size and at least twice it), or keep
    it whole where the reference replicates it."""
    import jax

    from deeplearning4j_tpu.parallel.mesh import _shard_leaf
    from deeplearning4j_tpu.parallel.mesh import build_mesh as j_mesh
    from deeplearning4j_tpu_torch.parallel import build_mesh, infer_param_shardings, shard_axis

    jmesh = j_mesh({"data": 1, "model": model}, devices=jax.devices()[:model])
    shapes = [(), (3,), (4,), (8,), (16, 3), (3, 16), (12, 16), (5, 5), (3, 3, 8, 16),
              (7, 9, 4), (model,), (2 * model, 1)]
    for shape in shapes:
        spec = _shard_leaf(jmesh, np.zeros(shape, np.float32), "model").spec
        want = next((i for i, a in enumerate(spec) if a == "model"), None)
        assert shard_axis(shape, model) == want, shape
    mesh = build_mesh({"data": 1, "model": model}, world_size=model)
    tree = [{"W": torch.zeros(12, 16), "b": torch.zeros(3)}, {}]
    assert infer_param_shardings(tree, mesh) == [{"W": 1, "b": None}, {}]


def test_mesh_layout_and_errors():
    from deeplearning4j_tpu_torch.parallel import build_mesh, build_two_tier_mesh

    m = build_two_tier_mesh(2, world_size=8)
    assert m.shape == {"dcn": 2, "data": 4} and m.size == 8
    assert build_mesh().shape == {"data": 1}
    with pytest.raises(ValueError, match="n_slices"):
        build_two_tier_mesh(0)
    with pytest.raises(ValueError, match="dcn"):
        build_two_tier_mesh(2, {"dcn": 2})
    with pytest.raises(ValueError, match="devices"):
        build_mesh({"data": 3}, world_size=8)


def test_single_rank_compressed_training_runs_without_a_process_group():
    """One rank, one slice: the exchange gathers only itself; the loss falls."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_two_tier_mesh

    trainer = ShardedTrainer(_cpu_mlp(), build_two_tier_mesh(1), grad_compression="bitmap")
    xs, ys = _blobs()
    losses = [float(x) for x in trainer.fit([DataSet(xs, ys)] * 5, epochs=2)]
    assert losses[-1] < losses[0] and trainer.net.iteration == 10 and trainer.net.epoch == 2
    assert trainer.wire_bytes_last_step == 0
    assert trainer.gather_residual()[0]["W"].shape == (1, 12, 16)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
