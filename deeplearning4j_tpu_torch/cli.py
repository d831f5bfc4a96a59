"""Command-line front end of the port (mirrors ``deeplearning4j_tpu/cli.py``:
``train``, ``evaluate``, ``summary``, ``predict``, ``generate`` for a
TransformerLM checkpoint through the decode engine or a recurrent one
through ``rnn_time_step``, and ``serve``).  Runs on ``cuda`` unless
``--device cpu`` is given.

    python -m deeplearning4j_tpu_torch train --config mlp.json --data iris --output m.zip
    python -m deeplearning4j_tpu_torch train --zoo lenet --data mnist --output lenet.zip
    python -m deeplearning4j_tpu_torch train --config mlp.json --data iris --dashboard out.html
    python -m deeplearning4j_tpu_torch summary --zoo resnet50
    python -m deeplearning4j_tpu_torch evaluate --model m.zip --data iris
    python -m deeplearning4j_tpu_torch summary --model m.zip
    python -m deeplearning4j_tpu_torch predict --model m.zip --input x.npz --output y.npz
    python -m deeplearning4j_tpu_torch generate --model m.zip --prompt "hello"
        [--prefix-cache] [--speculate DRAFT_CKPT[,k]] [--kv-dtype {float32,int8}]
    python -m deeplearning4j_tpu_torch serve --model m.zip --port 9000 [--smoke N]
        [--models a=a.zip,b=b.zip] [--tenants tenants.json] [--warm-bundle W]
        [--compile-cache DIR] [--trace T] [--decode-role {unified,prefill,decode}]
    python -m deeplearning4j_tpu_torch serve --fleet 127.0.0.1:9001,127.0.0.1:9002
    python -m deeplearning4j_tpu_torch train --zoo lenet --data mnist --elastic-dir ckpts \
        [--chaos device_loss@5,ckpt_truncate@9] [--checkpoint-every 4] [--grace 30]
    python -m deeplearning4j_tpu_torch launch --nprocs 2 --bootstrap distributed \
        -- train --zoo lenet --data mnist --mesh dcn=2,data=1,compress=threshold \
        --elastic-dir ckpts --checkpoint-every 4
    python -m deeplearning4j_tpu_torch train --zoo lenet --data cifar10 --prefetch 2
    python -m deeplearning4j_tpu_torch flywheel --generations 5 \
        --chaos nan,regression,host_kill,crash --hosts 2 [--max-divergence 0.1]

``--data`` accepts a built-in name (mnist / cifar10 / iris / emnist / svhn /
uci) or a .npz file with arrays ``x`` and ``y``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Tuple

import numpy as np


def _num_classes_of(net) -> Optional[int]:
    """The model's (first) output width, so index labels one-hot to the
    right width even when a split lacks the highest class."""
    layers = getattr(net.conf, "layers", None)
    if layers:
        return getattr(layers[-1], "n_out", None) or None
    outputs = getattr(net.conf, "network_outputs", None)
    if outputs:
        spec = next(v for v in net.conf.vertices if v.name == outputs[0])
        return getattr(getattr(spec.vertex, "layer", None), "n_out", None) or None
    return None


def _load_data(spec: str, train: bool = True,
               num_classes: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A built-in name (``mnist``, ``cifar10``, ``iris``, ``emnist``,
    ``svhn``, ``uci``) or an ``.npz`` holding ``x`` and ``y`` → (x, y)
    float32, index labels one-hot (the reference's rules)."""
    from .datasets import fetchers

    builtin = {
        "mnist": lambda: fetchers.load_mnist(train=train),
        "cifar10": lambda: fetchers.load_cifar10(train=train),
        "iris": fetchers.load_iris,
        "emnist": lambda: fetchers.load_emnist(train=train),
        "svhn": lambda: fetchers.load_svhn(train=train),
        "uci": lambda: fetchers.load_uci_synthetic_control(train=train),
    }
    if spec in builtin:
        xs, ys = builtin[spec]()
    else:
        data = np.load(spec)
        if "x" not in data or "y" not in data:
            raise SystemExit(f"{spec}: .npz must contain arrays 'x' and 'y'")
        xs, ys = data["x"], data["y"]
    if ys.ndim == 1:  # class indices → one-hot
        width = num_classes or int(ys.max()) + 1
        if int(ys.max()) >= width:
            raise SystemExit(f"label {int(ys.max())} out of range for "
                             f"{width} classes")
        ys = np.eye(width, dtype=np.float32)[ys.astype(np.int64)]
    return np.asarray(xs, np.float32), np.asarray(ys, np.float32)


def _build_model(args):
    if args.zoo:
        from .models import ZOO

        name = args.zoo.lower()
        if name not in ZOO:
            raise SystemExit(f"unknown zoo model '{args.zoo}' — one of {sorted(ZOO)}")
        kw = json.loads(args.zoo_args) if args.zoo_args else {}
        try:
            net = ZOO[name](**kw, device=args.device)
        except NotImplementedError as e:
            raise SystemExit(str(e))
        if not net.params:
            net.init()
        return net
    if getattr(args, "config", None):
        from .nn.multilayer import MultiLayerConfiguration, MultiLayerNetwork

        with open(args.config) as f:
            conf = MultiLayerConfiguration.from_dict(json.load(f))
        net = MultiLayerNetwork(conf, device=args.device)
        net.init()
        return net
    raise SystemExit("pass --zoo NAME or --config conf.json")


def _parse_mesh(spec: str, n_ranks: Optional[int] = None) -> tuple:
    """'data=4,model=2[,schedule=1f1b][,compress=threshold]' →
    ({"data": 4, "model": 2}, schedule, compress): the reference's
    grammar and error texts; -1 is inferred from the rank count
    (``n_ranks``, default the process group's), and a ``data`` axis is
    always there."""
    from .ops.compression import METHODS
    from .parallel.pipeline import SCHEDULES

    axes = {}
    schedule = "gpipe"
    compress = None
    seen_schedule = False
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if name == "schedule":
            if seen_schedule:
                raise SystemExit(f"bad --mesh {spec!r}: duplicate schedule token")
            if size.strip() not in SCHEDULES:
                raise SystemExit(
                    f"bad --mesh {spec!r}: schedule must be one of "
                    f"{'/'.join(SCHEDULES)}, got {size.strip()!r}")
            schedule = size.strip()
            seen_schedule = True
            continue
        if name == "compress":
            if compress is not None:
                raise SystemExit(f"bad --mesh {spec!r}: duplicate compress token")
            if size.strip() not in METHODS:
                raise SystemExit(
                    f"bad --mesh {spec!r}: compress must be one of "
                    f"{'/'.join(METHODS)}, got {size.strip()!r}")
            compress = size.strip()
            continue
        if name in axes:
            raise SystemExit(f"bad --mesh {spec!r}: duplicate axis {name!r}")
        try:
            axes[name] = int(size)
        except ValueError:
            size = ""  # fall through to the shared message
        if not name or not size or axes.get(name) == 0 or (axes.get(name, 0) < -1):
            raise SystemExit(
                f"bad --mesh {spec!r}: expected name=size[,name=size...] "
                "with positive integer sizes (or one -1 to infer), "
                "e.g. 'data=8', 'data=4,model=2' or "
                "'data=2,pipe=4,schedule=1f1b'")
    axes.setdefault("data", 1)
    if list(axes.values()).count(-1) > 1:
        raise SystemExit(f"bad --mesh {spec!r}: at most one -1 (infer) axis")
    if -1 in axes.values():
        if n_ranks is None:
            from .parallel.distributed import process_count
            n_ranks = process_count()
        known = 1
        for v in axes.values():
            if v != -1:
                known *= v
        if known == 0 or n_ranks % known:
            raise SystemExit(f"bad --mesh {spec!r}: cannot infer -1 axis "
                             f"from {n_ranks} device(s)")
        axes = {k: (n_ranks // known if v == -1 else v) for k, v in axes.items()}
    if compress is not None and "dcn" not in axes:
        raise SystemExit(f"bad --mesh {spec!r}: compress={compress} needs a "
                         "dcn axis, e.g. 'dcn=2,data=4,compress=threshold'")
    return axes, schedule, compress


def _parse_prefetch(spec: str):
    """'DEPTH[,DEVICE]' → (depth, device_spec|None).  depth 0 = the
    synchronous path (bitwise-unchanged pre-prefetch behavior); DEVICE is
    a torch device ('cuda:0', 'cpu') or a bare card index.  Every parse
    failure is a one-line CLI error, not a traceback."""
    depth_s, _, dev = spec.partition(",")
    try:
        depth = int(depth_s)
        if depth < 0:
            raise ValueError
    except ValueError:
        raise SystemExit(f"bad --prefetch {spec!r}: expected "
                         "DEPTH[,DEVICE] with DEPTH >= 0, e.g. '2' or "
                         "'2,cuda:0' (0 = synchronous feeding)")
    dev = dev.strip() or None
    if depth == 0 and dev:
        raise SystemExit(f"bad --prefetch {spec!r}: a device makes no "
                         "sense with depth 0 (synchronous feeding)")
    return depth, dev


def _resolve_device(spec: str):
    """'cuda:0' / 'cpu' / '1' → a torch.device (clean CLI errors)."""
    import torch

    from .utils.device import resolve_device

    try:
        dev = resolve_device(f"cuda:{spec}" if spec.isdigit() else spec)
        if dev.type == "cuda" and dev.index is not None \
                and dev.index >= torch.cuda.device_count():
            raise IndexError(f"no card {dev.index} (found {torch.cuda.device_count()})")
        return dev
    except (RuntimeError, IndexError, ValueError) as e:
        raise SystemExit(f"bad --prefetch device {spec!r}: {e}")


def _parse_chaos(spec: str):
    """'kind@step[,kind@step...][,seed=S][,hang=SECONDS][,slow=SECONDS]' →
    (FaultSchedule, seed, hang_seconds, slow_seconds), with the reference's
    error texts."""
    from .parallel.chaos import FaultKind, FaultSchedule

    faults: dict = {}
    seed, hang, slow = 0, 5.0, None
    for part in spec.split(","):
        part = part.strip()
        if "=" in part and "@" not in part:
            key, _, val = part.partition("=")
            try:
                if key == "seed":
                    seed = int(val)
                elif key == "hang":
                    hang = float(val)
                elif key == "slow":
                    slow = float(val)
                else:
                    raise SystemExit(f"bad --chaos {spec!r}: unknown option "
                                     f"{key!r} (seed=, hang=, slow=)")
            except ValueError:
                raise SystemExit(f"bad --chaos {spec!r}: {key}= needs a number")
            continue
        kind, _, step = part.partition("@")
        if kind not in FaultKind.ALL:
            raise SystemExit(f"bad --chaos {spec!r}: unknown fault kind "
                             f"{kind!r} — one of {'/'.join(FaultKind.ALL)}")
        try:
            step_i = int(step)
            if step_i < 1:
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --chaos {spec!r}: {kind} needs a positive "
                             f"step, e.g. '{kind}@5'")
        faults.setdefault(step_i, []).append(kind)
    if not faults:
        raise SystemExit(f"bad --chaos {spec!r}: no faults — expected "
                         "kind@step[,kind@step...], e.g. "
                         "'device_loss@5,nan_grads@9,seed=1'")
    return FaultSchedule(faults), seed, hang, slow


def _parse_chaos_worker(specs):
    """['1:proc_kill@10', ...] → {worker: chaos spec} (clean CLI errors)."""
    out = {}
    for item in specs or []:
        worker_s, sep, spec = item.partition(":")
        try:
            worker = int(worker_s)
            if worker < 0 or not sep or not spec:
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --chaos-worker {item!r}: expected "
                             "WORKER:SPEC, e.g. '1:proc_kill@10'")
        if worker in out:
            raise SystemExit(f"bad --chaos-worker {item!r}: duplicate "
                             f"worker {worker}")
        _parse_chaos(spec)   # validate now; workers parse it again from the env
        out[worker] = spec
    return out


def _setup_trace(args):
    """Arm span tracing from ``--trace PATH`` (``{process}`` expands) or
    the launcher's ``DL4J_TPU_TRACE_DIR`` (worker{i}.inc{j}.trace.json)
    → the armed path, or None."""
    import os

    from .parallel.distributed import ENV_INCARNATION, ENV_TRACE_DIR, resolve_process_index

    path = getattr(args, "trace", None)
    if path:
        path = path.replace("{process}", str(resolve_process_index()))
    else:
        trace_dir = os.environ.get(ENV_TRACE_DIR)
        if trace_dir:
            inc = os.environ.get(ENV_INCARNATION, "0")
            path = os.path.join(trace_dir,
                                f"worker{resolve_process_index()}.inc{inc}.trace.json")
    if not path:
        return None
    from .obs import trace as obs_trace

    obs_trace.enable_tracing(path=path)
    return path


def _flush_trace(trace_path) -> None:
    if not trace_path:
        return
    from .obs import trace as obs_trace

    written = obs_trace.flush()
    if written:
        print(f"trace: {written} (chrome://tracing / ui.perfetto.dev)")


class _Plain:
    """A network as a trainer (``fit_batch`` and ``net``)."""

    def __init__(self, net):
        self.net = net

    def fit_batch(self, ds):
        return self.net.fit_batch(ds)


def cmd_train(args) -> int:
    import os

    from .datasets import DataSet, ListDataSetIterator
    from .optimize.listeners import ScoreIterationListener
    from .parallel.distributed import (ENV_CHAOS, ENV_COORDINATOR, process_count,
                                       resolve_process_index)
    from .parallel.launcher import Heartbeat, maybe_bootstrap_from_env
    from .parallel.preemption import PreemptedError

    from .serving.warmcache import enable_compile_cache

    cache_dir = enable_compile_cache(args.compile_cache)
    if cache_dir:
        print(f"compile cache: {cache_dir}")
    chaos_spec = args.chaos or os.environ.get(ENV_CHAOS) or None
    if chaos_spec and not args.elastic_dir:
        raise SystemExit("--chaos needs --elastic-dir (faults are injected "
                         "into the ElasticTrainer recovery loop)")
    if args.elastic_dir:
        # a replayed step must equal the step it replays
        import torch

        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    # under `launch`: beat the shared membership (the bootstrap waits for
    # every worker's beat), then join the process group when the launcher
    # exported a coordinator
    heartbeat = Heartbeat.start_from_env()
    if maybe_bootstrap_from_env(collective_timeout_s=args.step_timeout):
        print(f"distributed: process {resolve_process_index()}/{process_count()}")
    trace_path = _setup_trace(args)

    net = _build_model(args)
    xs, ys = _load_data(args.data, train=True, num_classes=_num_classes_of(net))
    batches = DataSet(xs, ys).shuffle(args.seed).batch_by(args.batch_size)
    mesh_axes, schedule, compress = (_parse_mesh(args.mesh) if args.mesh
                                     else (None, "gpipe", None))
    if mesh_axes:
        dp = mesh_axes["data"] * mesh_axes.get("dcn", 1)
        if args.batch_size % dp:
            raise SystemExit(f"--batch-size {args.batch_size} not divisible "
                             f"by mesh data axis {dp}")
        full = [b for b in batches if len(b.features) == args.batch_size]
        dropped = len(xs) - len(full) * args.batch_size
        if not full:
            raise SystemExit(
                f"dataset ({len(xs)} samples) has no full batch of "
                f"{args.batch_size}; lower --batch-size for --mesh training")
        if dropped:
            print(f"mesh training drops the ragged tail: {dropped} of "
                  f"{len(xs)} samples not in a full batch of {args.batch_size}")
        batches = full
    listeners = [ScoreIterationListener(args.print_every)]
    storage = None
    if args.dashboard:
        from .ui import InMemoryStatsStorage, StatsListener

        storage = InMemoryStatsStorage()
        listeners.append(StatsListener(storage, session_id="cli_train"))
    net.set_listeners(*listeners)
    trainer = None

    def sharded():
        from .parallel import ShardedTrainer, build_mesh

        return ShardedTrainer(net, build_mesh(mesh_axes), pipeline_schedule=schedule,
                              grad_compression=compress, nan_guard=args.nan_guard)

    if mesh_axes:
        total = 1
        for v in mesh_axes.values():
            total *= v
        if total != process_count():
            raise SystemExit(f"--mesh {args.mesh!r} needs {total} process(es), "
                             f"found {process_count()} (run it under launch "
                             "--bootstrap distributed)")
        trainer = sharded()
        print(f"mesh: {dict(trainer.mesh.shape)} over {trainer.mesh.size} rank(s)"
              + (f", pipeline schedule {schedule}" if schedule != "gpipe" else "")
              + (f", grad compression {compress}" if compress else "")
              + (f", nan guard budget {args.nan_guard}" if args.nan_guard else ""))
    elif args.nan_guard is not None:
        net.set_nan_guard(args.nan_guard)
        print(f"nan guard armed (budget {args.nan_guard})")
    data = ListDataSetIterator(batches)
    prefetcher = None
    if args.prefetch:
        depth, dev_spec = _parse_prefetch(args.prefetch)
        if depth > 0:
            # the device-resident input pipeline: batches cross to the card
            # from a background thread on a stream of their own, only this
            # rank's rows on a mesh run (the trainer then passes them
            # through its row split)
            from .datasets.device_prefetch import DevicePrefetchIterator

            if mesh_axes and dev_spec:
                raise SystemExit("--prefetch DEVICE does not combine with "
                                 "--mesh (batches land on the mesh's batch "
                                 "sharding)")
            sharding = trainer.batch_sharding if trainer is not None else None
            device = (_resolve_device(dev_spec) if dev_spec
                      else None if sharding is not None else net.device)
            prefetcher = data = DevicePrefetchIterator(data, depth=depth,
                                                       sharding=sharding, device=device)
            where = "mesh batch sharding" if sharding is not None else str(device)
            print(f"prefetch: depth {depth} onto {where}")
    et = None
    if args.elastic_dir:
        from .parallel import ChaosInjector, ElasticTrainer
        from .parallel.preemption import PreemptionHandler

        inner = trainer if trainer is not None else _Plain(net)
        injector = None
        if chaos_spec:
            sched, seed, hang, slow = _parse_chaos(chaos_spec)
            injector = inner = ChaosInjector(inner, sched, hang_seconds=hang, seed=seed,
                                             slow_seconds=slow)
            print(f"chaos armed: {sched.pending()} fault(s) scheduled")
        preemption = PreemptionHandler.install_from_env(grace_s=args.grace)
        rebuild_fn = None
        if trainer is not None and process_count() > 1 and os.environ.get(ENV_COORDINATOR):
            def rebuild_fn():
                # a peer left: rejoin once the ledger lists every process
                # again, load whole parameters for the new trainer to slice
                # (the recovery's restore then sets the step every rank
                # agrees on), rebuild the mesh
                from .parallel.launcher import rejoin_from_env

                rejoin_from_env(collective_timeout_s=args.step_timeout)
                model, _ = et.ckpt.restore_latest(et.loader)
                if model is not None:
                    net.params, net.state, net.opt_state = (model.params, model.state,
                                                            model.opt_state)
                    net.grad_residual = model.grad_residual
                new = sharded()
                if injector is not None:
                    injector.trainer = new
                    return injector
                return new
        et = ElasticTrainer(inner, args.elastic_dir, checkpoint_every=args.checkpoint_every,
                            sync_every=min(10, args.checkpoint_every),
                            step_timeout=args.step_timeout, backoff_base=0.5, jitter_seed=0,
                            preemption=preemption, rebuild_fn=rebuild_fn)
        if injector is not None:
            injector.attach_checkpoints(et.ckpt)
        if heartbeat is not None:
            heartbeat.set_step_fn(lambda: et.global_step)
            heartbeat.set_ckpt_step_fn(lambda: et.last_checkpoint_step)
        resumed = et.resume()
        if resumed:
            print(f"resumed from checkpoint @ step {resumed}")
    try:
        if et is not None:
            losses = et.fit(data, epochs=args.epochs, skip_done=True)
        else:
            runner = trainer if trainer is not None else net
            losses = runner.fit(data, epochs=args.epochs)
    except PreemptedError as exc:
        print(f"preempted: {exc}")
        _write_losses(args, et, exc)
        _flush_trace(trace_path)
        if heartbeat is not None:
            heartbeat.stop()
        return exc.exit_code
    if et is not None:
        print(f"elastic: {et.total_restarts} recovery(ies), "
              f"{et.recovery_seconds:.1f}s in recovery, final checkpoint @ "
              f"step {et.global_step} in {args.elastic_dir}")
        _write_losses(args, et)
    if losses:
        print(f"trained {args.epochs} epoch(s), {len(losses)} iterations, "
              f"final loss {float(losses[-1]):.5f}")
    if prefetcher is not None:
        s = prefetcher.stall_stats()
        prefetcher.close()
        print(f"prefetch: stall fraction {s['stall_fraction']:.3f} "
              f"({s['stalls']} stall(s), avg {s['avg_stall_ms']:.1f}ms) over "
              f"{s['batches']} batches, depth {s['depth']}")
    if args.dashboard:
        from .ui import render_dashboard

        render_dashboard(storage, args.dashboard)
        print(f"dashboard: {args.dashboard}")
    if args.output:
        out_path = args.output.replace("{process}", str(resolve_process_index()))
        if trainer is not None:
            trainer.save(out_path)          # a collective: rank 0 writes
        else:
            net.save(out_path)
        print(f"saved: {out_path}")
    _flush_trace(trace_path)
    if heartbeat is not None:
        heartbeat.stop()
    return 0


def _write_losses(args, et, preempted=None) -> None:
    """``--losses-out``: every completed step's (global step, loss) as JSON,
    replays included (Python floats: exact), the training kernels' launch
    counts of this process, its recoveries, and the preemption's step and
    emergency checkpoint seconds when the run was preempted."""
    if not getattr(args, "losses_out", None) or et is None:
        return
    import os

    from .nn.train_graph import TRAIN_COUNTERS
    from .ops import compression
    from .parallel.distributed import ENV_INCARNATION, resolve_process_index

    path = (args.losses_out.replace("{process}", str(resolve_process_index()))
            .replace("{incarnation}", os.environ.get(ENV_INCARNATION, "0")))
    launches = {n: c.launches for n, c in TRAIN_COUNTERS.items()}
    launches["threshold_encode"] = compression.threshold_encode_buckets_cuda.launches
    out = {"steps": [[s, float(l)] for s, l in et.step_losses], "launches": launches,
           "restarts": et.total_restarts}
    if preempted is not None:
        out["preempted"] = {"step": preempted.step, "seconds": preempted.seconds,
                            "stored": preempted.stored,
                            "checkpoint": preempted.checkpoint_path}
    with open(path, "w") as f:
        json.dump(out, f)


def cmd_evaluate(args) -> int:
    from .utils.serializer import load_model

    net = load_model(args.model, device=args.device)
    xs, ys = _load_data(args.data, train=False, num_classes=_num_classes_of(net))
    ev = net.evaluate((xs, ys))
    print(ev.stats())
    return 0


def cmd_summary(args) -> int:
    from .nn.conf.memory import memory_report
    from .utils.serializer import load_model

    if args.model is None and args.zoo is None:
        raise SystemExit("pass --model ZIP or --zoo NAME")
    net = load_model(args.model, device=args.device) if args.model else _build_model(args)
    print(f"model: {type(net).__name__}, {net.num_params():,} params")
    print(memory_report(net, minibatch=args.batch_size))
    return 0


def cmd_predict(args) -> int:
    from .utils.serializer import load_model

    net = load_model(args.model, device=args.device)
    data = np.load(args.input)
    x = data["x"] if "x" in data else data[data.files[0]]
    out = net.output(np.asarray(x, np.float32))
    out = (out[0] if isinstance(out, list) else out).float().cpu().numpy()
    np.savez(args.output, predictions=out)
    print(f"wrote {out.shape} predictions to {args.output}")
    return 0


def _sample_probs(probs: np.ndarray, temperature: float, top_k: int,
                  top_p: float, rng: np.random.Generator) -> int:
    """Host-side sampling from a probability row (the char-RNN path: its
    output layer already applied softmax).  The decode engine's knobs:
    temperature <= 0 greedy, top_k 0 / top_p >= 1 off."""
    if temperature <= 0.0:
        return int(np.argmax(probs))
    p = np.asarray(probs, np.float64) ** (1.0 / max(temperature, 1e-6))
    if top_k and top_k < p.shape[0]:
        p[np.argsort(p)[:-top_k]] = 0.0
    if top_p < 1.0:
        order = np.argsort(p)[::-1]
        cum = np.cumsum(p[order]) / max(p.sum(), 1e-30)
        p[order[1:][cum[:-1] >= top_p]] = 0.0   # keep top-1 always
    p /= p.sum()
    return int(rng.choice(p.shape[0], p=p))


def _parse_speculate(spec):
    """'DRAFT_CKPT[,k]' → (path, k), k 4 by default, with a clean CLI
    error for a bad k."""
    if spec is None:
        return None, 4
    path, sep, ks = spec.rpartition(",")
    if sep and path:
        try:
            k = int(ks)
            if k < 1:
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --speculate {spec!r}: expected "
                             "DRAFT_CKPT[,k] with k >= 1")
        return path, k
    return spec, 4


def _decode_opts(args) -> dict:
    """``DecodeEngine`` arguments for the decode flags of ``generate`` and
    ``serve``: --prefix-cache, --speculate DRAFT_CKPT[,k], --kv-dtype and
    (serve) --decode-role."""
    from .models.transformer import TransformerDecodeAdapter
    from .utils.serializer import load_model

    draft_path, k = _parse_speculate(args.speculate)
    draft = None
    if draft_path:
        draft = TransformerDecodeAdapter(load_model(draft_path, device=args.device))
    return {"prefix_cache": bool(args.prefix_cache), "draft_model": draft,
            "speculate_k": k,
            "kv_dtype": None if args.kv_dtype in (None, "float32") else args.kv_dtype,
            "role": getattr(args, "decode_role", None) or "unified"}


def cmd_generate(args) -> int:
    """Text generation.  Text <-> token ids is byte-valued (ord/chr
    clamped to the model's vocab).  Two model families:

      transformer LM  the paged-KV decode engine
      recurrent nets  ``rnn_time_step`` streaming, one step per token
    """
    from .models.transformer import TransformerBlock
    from .utils.serializer import load_model

    net = load_model(args.model, device=args.device)
    if any(isinstance(l, TransformerBlock) for l in net.conf.layers):
        return _generate_decode_engine(net, args)
    return _generate_recurrent(net, args)


def _page_size(adapter, page: int) -> int:
    """``page`` halved until two pages fit in the position table."""
    pos_rows = int(adapter.params["pos"]["P"].shape[0])
    while page > 1 and page > pos_rows // 2:
        page //= 2
    return page


def _generate_decode_engine(net, args) -> int:
    from .models.transformer import TransformerDecodeAdapter
    from .serving import DecodeEngine

    adapter = TransformerDecodeAdapter(net)
    vocab = adapter.vocab_size
    page = _page_size(adapter, args.page_size)
    prompt_ids = [min(ord(c), vocab - 1) for c in args.prompt]
    if not prompt_ids:
        raise SystemExit("--prompt must be non-empty")
    eng = DecodeEngine(adapter, max_slots=1, page_size=page,
                       default_max_new=args.max_tokens, device=args.device,
                       **_decode_opts(args)).load()
    try:
        if len(prompt_ids) > eng.max_prompt:
            raise SystemExit(f"prompt longer than the largest bucket "
                             f"(max {eng.max_prompt} tokens)")
        res = eng.generate(prompt_ids, max_new_tokens=args.max_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, seed=args.seed)
        text = "".join(chr(t) if t < 0x110000 else "?" for t in res.tokens)
        print(f"[decode engine: {len(res.tokens)} tokens, "
              f"finish={res.finish_reason}, ttft={res.ttft_ms:.3f}ms, "
              f"tpot={res.tpot_ms}ms]", file=sys.stderr)
        print(args.prompt + text)
    finally:
        eng.shutdown()
    return 0


def generate_recurrent(net, prompt_ids, max_tokens: int, temperature: float = 0.0,
                       top_k: int = 0, top_p: float = 1.0, seed: int = 0):
    """The recurrent branch of ``generate``: feed the prompt through
    ``rnn_time_step`` in one call, then sample a token from the last
    distribution and feed it back, ``max_tokens`` times → the tokens."""
    rng = np.random.default_rng(seed)
    net.rnn_clear_previous_state()
    probs = net.rnn_time_step(np.asarray([prompt_ids], np.int32))
    dist = probs[0, -1] if probs.ndim == 3 else probs[0]
    toks = []
    for _ in range(max_tokens):
        tok = _sample_probs(dist.float().cpu().numpy(), temperature, top_k, top_p, rng)
        toks.append(tok)
        dist = net.rnn_time_step(np.asarray([tok], np.int32))[0]
    net.rnn_clear_previous_state()
    return toks


def _generate_recurrent(net, args) -> int:
    if args.prefix_cache or args.speculate or args.kv_dtype not in (None, "float32"):
        raise SystemExit(
            "--prefix-cache/--speculate/--kv-dtype need a transformer LM "
            "checkpoint (they live in the paged decode engine)")
    out_layer = net.conf.layers[-1]
    vocab = int(getattr(out_layer, "n_out", 256) or 256)
    prompt_ids = [min(ord(c), vocab - 1) for c in args.prompt]
    if not prompt_ids:
        raise SystemExit("--prompt must be non-empty")
    toks = generate_recurrent(net, prompt_ids, args.max_tokens, args.temperature,
                              args.top_k, args.top_p, args.seed)
    print(f"[rnn_time_step: {len(toks)} tokens]", file=sys.stderr)
    print(args.prompt + "".join(chr(t) if t < 0x110000 else "?" for t in toks))
    return 0


def _parse_tenants(path):
    """tenants.json → ``serving.TenantTable``: a JSON list of tenant rows
    (or an object with a "tenants" list), each a ``TenantConfig`` dict
    such as {"tenant": "acme", "weight": 2.0, "quota_qps": 100,
    "admission": "shed"}.  A parse or validation failure is a one-line
    CLI error."""
    from .serving import TenantTable

    try:
        with open(path) as f:
            rows = json.load(f)
    except OSError as e:
        raise SystemExit(f"bad --tenants {path!r}: {e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"bad --tenants {path!r}: invalid JSON ({e})")
    if isinstance(rows, dict):
        rows = rows.get("tenants", rows)
    if not isinstance(rows, list) or not rows or not all(
            isinstance(r, dict) for r in rows):
        raise SystemExit(f"bad --tenants {path!r}: expected a non-empty "
                         "JSON list of tenant rows (or "
                         '{"tenants": [...]})')
    try:
        return TenantTable.from_specs(rows)
    except (TypeError, ValueError) as e:
        raise SystemExit(f"bad --tenants {path!r}: {e}")


def _parse_models(spec):
    """'NAME=PATH[,NAME=PATH...]' (or bare checkpoint paths, named by the
    file stem) → [(name, path)], with clean CLI errors."""
    import os

    out, seen = [], set()
    for part in [p.strip() for p in spec.split(",") if p.strip()]:
        name, sep, path = part.partition("=")
        if not sep:
            name = os.path.splitext(os.path.basename(part))[0]
            path = part
        if not name or not path:
            raise SystemExit(f"bad --models {spec!r}: expected "
                             "NAME=PATH[,NAME=PATH...] or a comma-"
                             "separated list of checkpoint paths")
        if name in seen:
            raise SystemExit(f"bad --models {spec!r}: duplicate model "
                             f"name {name!r}")
        seen.add(name)
        out.append((name, path))
    if not out:
        raise SystemExit(f"bad --models {spec!r}: no models")
    return out


def cmd_serve(args) -> int:
    """Serve checkpoints: register them in a ``ModelRegistry`` (alias
    ``prod``), warm every bucket of a predict ``Engine`` (``--models``
    places more models beside the first, ``--tenants`` arms tenant lanes
    and quotas, ``--warm-bundle`` names the graphs to capture) and answer
    POST /predict, GET /metrics and GET /healthz; or, with ``--fleet``,
    run a ``FleetRouter`` over remote serve hosts; or, with ``--smoke N``,
    push N synthetic requests through the engine, print its metrics
    snapshot and exit.  A TransformerLM checkpoint is served decode-only:
    POST /generate through a ``DecodeEngine`` of ``--decode-role``
    (a prefill host answers /generate with 409; a fleet router carries
    its handoffs), /predict answers 503.  ``--compile-cache DIR`` builds
    the kernels into DIR, where a restarted host finds them built.  A
    SIGTERM preemption notice drains and exits 75.  Runs until
    interrupted."""
    import os

    from .models.transformer import TransformerBlock, TransformerDecodeAdapter
    from .parallel.distributed import ENV_SERVE_PORT, PREEMPTED_EXIT_CODE
    from .parallel.launcher import Heartbeat
    from .parallel.preemption import PreemptionHandler
    from .serving import DecodeEngine, Engine, FleetRouter, HttpHost, ModelRegistry
    from .serving.warmcache import enable_compile_cache
    from .ui import UIServer

    trace_path = _setup_trace(args)
    cache_dir = enable_compile_cache(args.compile_cache)
    if cache_dir:
        print(f"compile cache: {cache_dir}")
    if not args.fleet and not args.model and not args.models:
        raise SystemExit("serve needs --model/--models "
                         "(or --fleet HOST:PORT,...)")
    tenants = _parse_tenants(args.tenants) if args.tenants else None
    net = None
    is_lm = False
    if args.fleet:
        if args.smoke:
            raise SystemExit("serve --smoke is incompatible with --fleet")
        if tenants is not None:
            raise SystemExit("--tenants configures a serve HOST's "
                             "admission — pass it to each `serve --model` "
                             "worker, not the --fleet router")
        engine = FleetRouter(max_retries=args.max_retries,
                             request_timeout_s=args.forward_timeout,
                             breaker_threshold=args.breaker_threshold)
        for ep in [e.strip() for e in args.fleet.split(",") if e.strip()]:
            url = ep if ep.startswith("http") else f"http://{ep}"
            engine.add_host(ep, engine=HttpHost(url, timeout_s=args.forward_timeout or 5.0))
        print(f"fleet router over {sorted(engine.hosts())}: "
              f"max_retries={args.max_retries}, "
              f"request_timeout={args.forward_timeout}")
    else:
        model_pairs = _parse_models(args.models) if args.models else []
        if args.model:
            model_pairs = [(args.name, args.model)] + model_pairs
        name, default_path = model_pairs[0]
        reg = ModelRegistry(device=args.device)
        version = reg.load(name, default_path, version=args.version)
        _, net = reg.resolve(name, version)
        is_lm = any(isinstance(l, TransformerBlock)
                    for l in getattr(net.conf, "layers", ()))
        engine = None
        if is_lm:
            # a transformer LM has no float /predict surface: it serves
            # decode-only (POST /generate), /predict answers 503
            if len(model_pairs) > 1:
                raise SystemExit("--models needs predict checkpoints "
                                 "(float feature inputs) — a transformer "
                                 "LM serves decode-only via --model")
        else:
            reg.set_alias(name, "prod", version)
            engine = Engine.from_registry(
                reg, name, "prod", max_batch=args.max_batch, slo_ms=args.slo_ms,
                replicas=args.replicas, max_queue=args.queue_cap,
                admission=args.admission, forward_timeout_s=args.forward_timeout,
                max_retries=args.max_retries, breaker_threshold=args.breaker_threshold,
                tenants=tenants, device=args.device)
            # an explicit --warm-bundle wins, else the registry's
            # provenance finds <checkpoint>.warm
            engine.load(warm_bundle=args.warm_bundle)
            for extra_name, extra_path in model_pairs[1:]:
                v = reg.load(extra_name, extra_path)
                reg.set_alias(extra_name, "prod", v)
                engine.add_model_from_registry(reg, extra_name, "prod")
            print(f"serving {name} v{version} (alias 'prod'): "
                  f"max_batch={args.max_batch}, slo={args.slo_ms}ms, "
                  f"replicas={len(engine._replicas)}, admission={args.admission}, "
                  f"warmed buckets {engine.batcher.buckets}, "
                  f"programs {engine.compile_cache_size()}")
            if len(model_pairs) > 1:
                print(f"models placed: {engine.placed_models()}")
    if tenants is not None:
        print(f"tenants: {sorted(tenants.tenants())} from {args.tenants}")
    if args.smoke:
        if engine is None:
            raise SystemExit("serve --smoke needs a predict checkpoint (float "
                             "feature inputs), not a transformer LM — use POST "
                             "/generate instead")
        shape = engine._example_shape
        rng = np.random.default_rng(0)
        futs = [engine.output_async(
            rng.normal(size=(1 + i % 4,) + shape).astype(np.float32))
            for i in range(args.smoke)]
        for f in futs:
            f.result(timeout=120)
        print(json.dumps(engine.metrics_snapshot()))
        engine.shutdown()
        _flush_trace(trace_path)
        return 0

    # under `launch --serve` each worker gets a stable port; --port wins
    port = args.port
    if port == 9000 and os.environ.get(ENV_SERVE_PORT):
        port = int(os.environ[ENV_SERVE_PORT])
    server = UIServer(port=port, host=args.host)
    if engine is not None:
        server.attach_engine(engine)
    decode_eng = None
    wants_decode = (is_lm or args.prefix_cache or args.speculate
                    or args.decode_role not in (None, "unified")
                    or args.kv_dtype not in (None, "float32"))
    if wants_decode:
        if args.fleet:
            raise SystemExit("--prefix-cache/--speculate/--kv-dtype need "
                             "a local --model, not --fleet")
        if not is_lm:
            raise SystemExit("--prefix-cache/--speculate/--kv-dtype need a "
                             "transformer LM checkpoint")
        adapter = TransformerDecodeAdapter(net)
        opts = _decode_opts(args)
        decode_eng = DecodeEngine(adapter, page_size=_page_size(adapter, 16),
                                  tenants=tenants, device=args.device,
                                  **opts).load(warm_bundle=args.warm_bundle)
        server.attach_decode_engine(decode_eng)
        print(f"decode engine on POST /generate: role={opts['role']}, "
              f"prefix_cache={args.prefix_cache}, speculate={args.speculate}, "
              f"kv_dtype={args.kv_dtype}, programs {decode_eng.compile_cache_size()}")
    server.start()
    heartbeat = Heartbeat.start_from_env()
    handler = PreemptionHandler.install_from_env()
    print(f"listening on http://{args.host}:{server.port} — "
          "POST /predict, POST /generate, GET /metrics, GET /healthz", flush=True)
    preempted = False
    try:
        while not handler.requested:
            time.sleep(0.2)
        preempted = True
        # a preemption notice: shed new requests, let queued ones finish
        # inside the grace window, then hand the port back
        for e in (engine, decode_eng):
            if e is not None:
                e.begin_drain()
        print(f"serve: preemption notice — draining "
              f"({handler.remaining_s:.1f}s grace)", flush=True)
        drain_of = engine if engine is not None else decode_eng
        while _serve_queue_depth(drain_of) > 0 and handler.remaining_s > 0.5:
            time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        for e in (engine, decode_eng):
            if e is not None:
                e.shutdown()
        if heartbeat is not None:
            heartbeat.stop()
        handler.uninstall()
        _flush_trace(trace_path)
    return PREEMPTED_EXIT_CODE if preempted else 0


def _serve_queue_depth(engine) -> int:
    """Requests still queued in a serving engine (the drain waits for 0)."""
    batcher = getattr(engine, "batcher", None)
    if batcher is not None:
        return batcher.qsize()
    return int(engine.metrics_snapshot().get("queue_depth", 0))


def cmd_launch(args) -> int:
    """The pod launcher: fork N workers running the subcommand after
    ``--`` (``python -m deeplearning4j_tpu_torch <cmd>``), or join an
    existing cluster with ``--join``; watch heartbeats and relaunch
    workers that die or hang."""
    import os

    rest = list(args.worker_args or [])
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        raise SystemExit("launch needs a worker command after '--', e.g. "
                         "launch --nprocs 2 -- train --zoo lenet ...")
    if rest[0] not in ("train", "evaluate", "predict", "serve", "summary"):
        raise SystemExit(f"launch worker command must be a "
                         f"deeplearning4j_tpu_torch subcommand, got {rest[0]!r}")
    # the cache is armed before any worker exists: the exported
    # DL4J_TPU_COMPILE_CACHE reaches the forked workers and a --join re-exec
    from .serving.warmcache import enable_compile_cache
    cache_dir = enable_compile_cache(args.compile_cache)
    if cache_dir:
        print(f"launch: compile cache {cache_dir}")
    if args.join:
        from .parallel.distributed import (ENV_CONNECT_TIMEOUT, ENV_COORDINATOR,
                                           ENV_NUM_PROCESSES, ENV_PROCESS_ID, ENV_RUN_DIR)
        if args.process_id is None:
            raise SystemExit("launch --join needs --process-id")
        if args.coordinator:
            os.environ[ENV_COORDINATOR] = args.coordinator
        os.environ[ENV_PROCESS_ID] = str(args.process_id)
        os.environ[ENV_NUM_PROCESSES] = str(args.nprocs)
        os.environ[ENV_CONNECT_TIMEOUT] = str(args.connect_timeout)
        if args.run_dir:
            os.environ[ENV_RUN_DIR] = args.run_dir
        return main(rest)
    from .parallel.launcher import PodLauncher

    run_dir = args.run_dir
    if not run_dir:
        import tempfile
        run_dir = tempfile.mkdtemp(prefix="dl4j_tpu_launch_")
    trace_dir = None
    if args.trace:
        from .obs import trace as obs_trace
        trace_dir = os.path.join(run_dir, "trace")
        obs_trace.enable_tracing(path=os.path.join(trace_dir, "launcher.trace.json"),
                                 process_id=-1, process_name="launcher")
    chaos = _parse_chaos_worker(args.chaos_worker)
    launcher = PodLauncher(
        [sys.executable, "-m", "deeplearning4j_tpu_torch"] + rest,
        num_workers=args.nprocs, run_dir=run_dir,
        devices_per_worker=args.devices_per_proc, chaos=chaos or None,
        bootstrap=args.bootstrap, heartbeat_timeout=args.heartbeat_timeout,
        max_restarts=args.max_restarts, deadline_s=args.deadline,
        connect_timeout_s=args.connect_timeout, megascale_slices=args.megascale_slices,
        trace_dir=trace_dir, grace_s=args.grace, straggler_factor=args.straggler_factor,
        straggler_beats=args.straggler_beats, straggler_policy=args.straggler_policy,
        serve=args.serve)
    print(f"launch: {args.nprocs} worker(s) x "
          f"{args.devices_per_proc or 'default'} device(s), "
          f"bootstrap={args.bootstrap}, run dir {run_dir}"
          + (f", chaos {chaos}" if chaos else ""), flush=True)
    if args.serve:
        print("launch: fleet endpoints " + ",".join(launcher.serve_endpoints()), flush=True)
    report = launcher.run()
    print(f"launch: completed={report['completed']} "
          f"restarts={report['restarts']} "
          f"planned_leaves={report['planned_leaves']} "
          f"stragglers={len(report['stragglers'])} "
          f"epoch={report['epoch']} "
          f"last_ckpt_step={report['last_checkpoint_step']} "
          f"leaked={report['leaked_killed']} "
          f"wall={report['wall_seconds']}s")
    for e in report["events"]:
        print(f"  [{e['t']:8.2f}s] {e['kind']}"
              + (f" worker {e['worker']}" if 'worker' in e else "")
              + (f" ({e['cause']}, rc={e.get('rc')})"
                 if e['kind'] in ('leave', 'unrecovered') else ""))
    if args.report:
        with open(args.report, "w") as f:
            json.dump({k: v for k, v in report.items() if k != "pod_metrics"}, f,
                      default=str)
    if args.trace:
        merged = launcher.merge_trace(args.trace)
        if merged is None:
            print(f"trace: no worker traces found under {trace_dir}")
        else:
            print(f"trace: pod timeline ({merged['metadata']['events']} "
                  f"events) -> {args.trace}")
    if report["unrecovered"]:
        print(f"launch: UNRECOVERED workers {report['unrecovered']} — "
              f"logs under {run_dir}/logs")
        return 1
    return 0


def cmd_flywheel(args) -> int:
    """Headless train→eval→canary→fleet-promote flywheel on a synthetic
    task (the reference's ``flywheel``): a ``PromotionPipeline`` drives
    --generations lifecycle rounds against an in-process registry and a
    fleet of predict ``Engine`` hosts on --device, with optional chaos
    kinds fired on successive generations after the bootstrap.  One JSON
    line per generation; the journal makes a killed run resumable (re-run
    with the same --journal)."""
    import os
    import tempfile
    import threading

    import torch

    from .datasets import DataSet
    from .datasets.iterators import ListDataSetIterator
    from .earlystopping import DataSetLossCalculator
    from .nn.conf.inputs import InputType
    from .nn.layers import Dense, OutputLayer
    from .nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from .nn.updaters import Sgd, tree_map
    from .parallel import ChaosInjector, ElasticTrainer, FaultKind, FaultSchedule
    from .serving import Engine, EvalGate, FleetRouter, ModelRegistry, PromotionPipeline
    from .utils.device import resolve_device
    from .utils.serializer import load_model

    chaos_plan = [c.strip() for c in (args.chaos or "").split(",") if c.strip()]
    known = {"device_loss", "nan", "regression", "host_kill", "crash"}
    bad = set(chaos_plan) - known
    if bad:
        print(f"unknown --chaos kind(s): {sorted(bad)} (known: {sorted(known)})",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    # chaos kinds fire one per generation, starting at gen 2: the
    # bootstrap generation always runs clean (there is nothing to roll
    # back to before the first promote)
    chaos_at = {i + 2: kind for i, kind in enumerate(chaos_plan)}

    rng = np.random.default_rng(args.seed)
    teacher = rng.standard_normal((12, 3)).astype(np.float32)

    def data(n, seed):
        r = np.random.default_rng(seed)
        x = r.standard_normal((n, 12)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.argmax(x @ teacher, axis=1)]
        return DataSet(features=x, labels=y)

    def mlp(seed, lr=0.05):
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater(Sgd(lr=lr))
                .layer(Dense(n_out=16, activation="tanh"))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(12)).build())
        net = MultiLayerNetwork(conf, device=device)
        net.init()
        return net

    train_ds, eval_ds = data(96, args.seed + 1), data(48, args.seed + 2)
    workdir = args.workdir or tempfile.mkdtemp(prefix="flywheel_")
    os.makedirs(workdir, exist_ok=True)
    journal = args.journal or os.path.join(workdir, "flywheel.jsonl")
    reg = ModelRegistry(device=device)
    router = FleetRouter(max_retries=3)
    killable = {"host": None}

    def train_fn(gen):
        kind = chaos_at.get(gen)
        if kind == "nan":
            net = mlp(args.seed + gen)
            net.params = tree_map(lambda a: torch.full_like(a, float("nan")), net.params)
            return {"model": net, "run_id": f"flywheel-g{gen}"}
        labels = train_ds.labels
        if kind == "regression":
            net = mlp(args.seed + gen, lr=0.1)
            labels = np.roll(labels, 1, axis=1)   # confidently wrong
        elif gen == 1:
            net = mlp(args.seed, lr=0.08)
        else:
            net = load_model(reg.checkpoint_path("flywheel", args.alias), device=device)
        trainee = net
        if kind == "device_loss":
            trainee = ChaosInjector(net, FaultSchedule.scripted({3: FaultKind.DEVICE_LOSS}))
        tr = ElasticTrainer(trainee, checkpoint_dir=os.path.join(workdir, f"gen{gen}"),
                            checkpoint_every=2, sync_every=1, run_id=f"flywheel-g{gen}")
        idx = np.random.default_rng(args.seed + 10 * gen).permutation(train_ds.features.shape[0])
        xs, ys = train_ds.features[idx], labels[idx]
        batches = ListDataSetIterator([DataSet(features=xs[i:i + 24], labels=ys[i:i + 24])
                                       for i in range(0, xs.shape[0], 24)])
        tr.fit(batches, epochs=1 if kind == "regression" else args.epochs)
        return tr

    class _Crash(Exception):
        pass

    crash_armed = {g for g, k in chaos_at.items() if k == "crash"}

    def stage_hook(stage, gen):
        if stage == "CANARY" and gen in crash_armed:
            crash_armed.discard(gen)
            raise _Crash(f"controller crash injected at gen {gen}")

    thresholds = {}
    if args.max_divergence is not None:
        thresholds["max_divergence"] = args.max_divergence

    def make_pipe():
        return PromotionPipeline(
            reg, router, "flywheel", train_fn,
            EvalGate(DataSetLossCalculator(eval_ds), threshold=args.eval_threshold),
            alias=args.alias, journal_path=journal,
            canary_frac=args.canary, canary_window=args.canary_window,
            canary_timeout_s=args.canary_timeout_s,
            canary_thresholds=thresholds, stage_hook=stage_hook,
            bundle_engine_kwargs={"max_batch": 8, "replicas": 1, "slo_ms": 30_000.0,
                                  "device": device})

    pipe = make_pipe()
    resumed = pipe.resume()
    if resumed["completed"] or resumed["partial"] is not None:
        print(f"resumed from journal: completed={resumed['completed']} "
              f"partial={resumed['partial']}", file=sys.stderr)

    stop = threading.Event()
    traffic = None
    dropped = [0]
    try:
        while len(pipe.completed) < args.generations:
            gen_no = max(pipe.completed, default=0) + 1
            if chaos_at.get(gen_no) == "host_kill" and killable["host"] is not None:
                killable["host"].kill_on_swap = True
            try:
                rec = pipe.run_generation()
            except _Crash as exc:
                print(f"# {exc} — resuming from the journal", file=sys.stderr)
                pipe = make_pipe()
                pipe.resume()
                rec = pipe.run_generation()
            print(json.dumps(rec), flush=True)
            if args.hosts > 0 and not router.hosts():
                # fleet birth after the bootstrap promote: every host loads
                # with the registry's warm bundle
                kw = dict(max_batch=8, slo_ms=30_000.0, replicas=1, admission="block",
                          device=device)
                h0 = Engine.from_registry(reg, "flywheel", args.alias, **kw)
                h0.load()
                router.add_host("h0", engine=h0)
                v, model = reg.resolve("flywheel", args.alias)
                for i in range(1, args.hosts):
                    eng = Engine(model, **kw)
                    eng.swap_model(model, tag=f"flywheel:v{v}")
                    eng.load()
                    host = _KillableEngine(eng)
                    killable["host"] = host
                    router.add_host(f"h{i}", engine=host)

                def loop():   # canary mirror windows need live traffic
                    probes = [rng.standard_normal((r, 12)).astype(np.float32)
                              for r in (1, 2, 4)]
                    i = 0
                    while not stop.is_set():
                        try:
                            router.output(probes[i % 3], slo_ms=30_000.0)
                        except Exception:   # counted: expected in chaos windows
                            dropped[0] += 1
                        i += 1
                        time.sleep(0.002)
                traffic = threading.Thread(target=loop, daemon=True, name="flywheel-traffic")
                traffic.start()
    finally:
        stop.set()
        if traffic is not None:
            traffic.join(timeout=10)
        router.shutdown(shutdown_hosts=True)
    print(json.dumps({"stats": pipe.stats(),
                      "alias": reg.resolve("flywheel", args.alias)[0],
                      "traffic_dropped": dropped[0],
                      "journal": journal}), flush=True)
    return 0


class _KillableEngine:
    """``flywheel``'s --chaos host_kill seam: dies the moment a rolling
    swap touches it."""

    def __init__(self, inner):
        self.inner = inner
        self.kill_on_swap = False
        self.killed = False

    def output_async(self, x, slo_ms=None):
        from .serving import ServingUnavailableError
        if self.killed:
            raise ServingUnavailableError("host killed (chaos)")
        return self.inner.output_async(x, slo_ms=slo_ms)

    def swap_model(self, model, tag=None, warm_bundle=None):
        if self.kill_on_swap or self.killed:
            self.killed = True
            raise RuntimeError("host killed mid-roll (chaos)")
        return self.inner.swap_model(model, tag, warm_bundle=warm_bundle)

    @property
    def current_tag(self):
        return self.inner.current_tag

    def metrics_snapshot(self):
        return self.inner.metrics_snapshot()

    def health_snapshot(self):
        if self.killed:
            return {"status": "unready", "ready": False}
        return self.inner.health_snapshot()

    def shutdown(self, timeout: float = 5.0):
        self.inner.shutdown(timeout=timeout)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="PyTorch/CUDA port of deeplearning4j_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model")
    t.add_argument("--zoo", help="zoo model name (e.g. lenet, resnet50)")
    t.add_argument("--zoo-args", help="JSON kwargs for the zoo constructor")
    t.add_argument("--config", help="MultiLayerConfiguration JSON file")
    t.add_argument("--data", required=True, help="builtin name (mnist/cifar10/iris/"
                   "emnist/svhn/uci) or .npz with arrays 'x' and 'y'")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch-size", type=int, default=128)
    t.add_argument("--seed", type=int, default=12345)
    t.add_argument("--print-every", type=int, default=10)
    t.add_argument("--output", help="checkpoint zip to write")
    t.add_argument("--nan-guard", type=int, default=None, metavar="BUDGET",
                   help="arm the divergence guard: steps with non-finite "
                   "gradients apply no update; more than BUDGET consecutive "
                   "bad steps raise")
    t.add_argument("--mesh", metavar="SPEC",
                   help="train on a mesh of ranks, e.g. 'data=2' or "
                   "'dcn=2,data=1,compress=threshold' (name=size axes, one "
                   "-1 inferred from the rank count; schedule=gpipe|1f1b; "
                   "compress=threshold|bitmap over a dcn axis); needs the "
                   "ranks of `launch --bootstrap "
                   "distributed`; the ragged tail batch is dropped")
    t.add_argument("--elastic-dir", metavar="DIR",
                   help="checkpoint-restore recovery: rolling checkpoints in "
                   "DIR, recoverable failures restore the newest intact one "
                   "and replay from it; a relaunched worker resumes there")
    t.add_argument("--checkpoint-every", type=int, default=100, metavar="N",
                   help="checkpoint every N steps with --elastic-dir (default 100)")
    t.add_argument("--step-timeout", type=float, default=None, metavar="SECONDS",
                   help="a step slower than this is hung and recovered; also "
                   "the process group's collective timeout")
    t.add_argument("--chaos", metavar="SPEC",
                   help="inject scripted faults into the --elastic-dir run, "
                   "e.g. 'device_loss@5,ckpt_truncate@9,seed=1,hang=2'")
    t.add_argument("--grace", type=float, default=None, metavar="SECONDS",
                   help="preemption grace budget for --elastic-dir runs: on "
                   "SIGTERM/SIGUSR1 the next step boundary writes an "
                   "emergency checkpoint and exits 75 (default: "
                   "DL4J_TPU_GRACE_S, else 30)")
    t.add_argument("--trace", metavar="PATH",
                   help="write a Chrome trace of the run's spans to PATH "
                   "({process} expands to the process index)")
    t.add_argument("--losses-out", metavar="PATH",
                   help="with --elastic-dir: write every completed step's "
                   "(global step, loss) and the training kernels' launch counts "
                   "as JSON ({process} and {incarnation} expand)")
    t.add_argument("--compile-cache", metavar="DIR",
                   help="persistent kernel-build cache: the CUDA kernels are "
                   "built into DIR and later processes load them without "
                   "nvcc (default: the DL4J_TPU_COMPILE_CACHE variable; unset "
                   "= the package's _build/)")
    t.add_argument("--prefetch", default=None, metavar="DEPTH[,DEVICE]",
                   help="device-resident input pipeline: a background thread "
                   "copies DEPTH batches ahead of the step (pinned staging, a "
                   "CUDA stream of its own; this rank's rows under --mesh), "
                   "onto DEVICE (default the network's device); 0 = "
                   "synchronous feeding")
    t.add_argument("--dashboard", help="HTML training report to write")
    t.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    t.set_defaults(fn=cmd_train)

    ln = sub.add_parser(
        "launch", help="multi-process pod launcher: fork N workers (or join a "
        "cluster) with heartbeat membership and host leave/join recovery")
    ln.add_argument("--nprocs", type=int, default=2,
                    help="number of worker processes (cluster size)")
    ln.add_argument("--devices-per-proc", type=int, default=None, metavar="K",
                    help="each worker sees K cards (CUDA_VISIBLE_DEVICES, "
                    "wrapping around the cards there are)")
    ln.add_argument("--bootstrap", choices=("replica", "distributed"),
                    default="replica",
                    help="'distributed' = workers form one process group; "
                    "'replica' = independent replicas (default)")
    ln.add_argument("--run-dir", help="shared run directory for heartbeats/"
                    "membership/logs (default: a fresh temp dir)")
    ln.add_argument("--heartbeat-timeout", type=float, default=5.0, metavar="S",
                    help="a worker whose heartbeat is older than this is "
                    "declared hung, killed, and relaunched")
    ln.add_argument("--max-restarts", type=int, default=2,
                    help="per-worker relaunch budget (host rejoin)")
    ln.add_argument("--deadline", type=float, default=600.0, metavar="S",
                    help="overall run deadline; survivors are reaped")
    ln.add_argument("--connect-timeout", type=float, default=60.0, metavar="S",
                    help="coordinator bootstrap budget; a dead coordinator "
                    "raises CoordinatorUnreachableError instead of hanging")
    ln.add_argument("--megascale-slices", type=int, default=None, metavar="N",
                    help="export MEGASCALE_NUM_SLICES=N to workers; distributed "
                    "bootstrap defaults it to --nprocs")
    ln.add_argument("--grace", type=float, default=30.0, metavar="S",
                    help="preemption grace budget exported to workers and the "
                    "launcher's escalation deadline; PREEMPTED exits (75) "
                    "relaunch without spending the restart budget")
    ln.add_argument("--straggler-factor", type=float, default=2.0, metavar="K",
                    help="flag a worker whose step time exceeds K x its peers' "
                    "median (default 2.0)")
    ln.add_argument("--straggler-beats", type=int, default=3, metavar="M",
                    help="consecutive over-threshold heartbeats before a worker "
                    "is flagged (default 3)")
    ln.add_argument("--straggler-policy", choices=("off", "flag", "relaunch"),
                    default="flag", help="what to do with a flagged straggler")
    ln.add_argument("--chaos-worker", action="append", metavar="I:SPEC",
                    help="arm worker I with a --chaos spec (repeatable), e.g. "
                    "'1:proc_kill@10'; only its first incarnation gets it")
    ln.add_argument("--trace", metavar="PATH",
                    help="trace every worker and merge the files and the "
                    "launcher's events into one pod timeline at PATH")
    ln.add_argument("--serve", action="store_true",
                    help="assign each worker a stable serve port "
                    "(DL4J_TPU_SERVE_PORT) and print the endpoints")
    ln.add_argument("--compile-cache", metavar="DIR",
                    help="export DL4J_TPU_COMPILE_CACHE=DIR to every worker: they "
                    "share one kernel-build cache, so a relaunched worker (or "
                    "the next run) loads the built kernels without nvcc")
    ln.add_argument("--report", metavar="PATH",
                    help="write the run report (events, restarts, epoch) as JSON")
    ln.add_argument("--join", action="store_true",
                    help="join an existing cluster as one worker instead of forking")
    ln.add_argument("--process-id", type=int, default=None,
                    help="this host's index (with --join)")
    ln.add_argument("--coordinator", metavar="HOST:PORT",
                    help="coordinator address (with --join)")
    ln.add_argument("worker_args", nargs=argparse.REMAINDER,
                    help="-- followed by the worker subcommand, e.g. "
                    "-- train --zoo lenet --data mnist --elastic-dir ckpts")
    ln.set_defaults(fn=cmd_launch)

    e = sub.add_parser("evaluate", help="evaluate a saved model")
    e.add_argument("--model", required=True)
    e.add_argument("--data", required=True)
    e.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    e.set_defaults(fn=cmd_evaluate)

    s = sub.add_parser("summary", help="model + memory summary")
    s.add_argument("--model", help="checkpoint zip")
    s.add_argument("--zoo", help="zoo model name, built afresh (instead of --model)")
    s.add_argument("--zoo-args", help="JSON kwargs for the zoo constructor")
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    s.set_defaults(fn=cmd_summary)

    r = sub.add_parser("predict", help="run inference")
    r.add_argument("--model", required=True)
    r.add_argument("--input", required=True, help=".npz with array 'x'")
    r.add_argument("--output", required=True, help=".npz to write")
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    r.set_defaults(fn=cmd_predict)

    g = sub.add_parser("generate", help="autoregressive text generation: the "
                       "paged-KV decode engine for a transformer LM, "
                       "rnn_time_step for a recurrent net")
    g.add_argument("--model", required=True, help="checkpoint zip")
    g.add_argument("--prompt", required=True,
                   help="prompt text (byte-valued char vocab)")
    g.add_argument("--max-tokens", type=int, default=64,
                   help="tokens to generate (default 64)")
    g.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature; 0 = greedy (default)")
    g.add_argument("--top-k", type=int, default=0,
                   help="keep only the k highest-probability tokens (0 = off)")
    g.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 = off)")
    g.add_argument("--seed", type=int, default=0,
                   help="sampling seed — same seed, same text")
    g.add_argument("--page-size", type=int, default=16,
                   help="KV-cache page size in tokens (auto-shrunk for "
                   "short position tables)")
    g.add_argument("--prefix-cache", action="store_true",
                   help="radix prefix cache over the paged KV pool "
                   "(transformer path)")
    g.add_argument("--speculate", metavar="DRAFT_CKPT[,k]",
                   help="speculative decoding: DRAFT_CKPT proposes k tokens "
                   "per step (default k=4); temperature-0 output is the "
                   "plain decode's")
    g.add_argument("--kv-dtype", choices=("float32", "int8"), default="float32",
                   help="KV page storage; int8 quantizes pages per row "
                   "(about 4x less pool memory)")
    g.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    g.set_defaults(fn=cmd_generate)

    v = sub.add_parser("serve", help="serve a saved model over HTTP")
    v.add_argument("--model", default=None,
                   help="checkpoint zip to serve (required unless --fleet or "
                   "--models)")
    v.add_argument("--models", metavar="NAME=PATH,...",
                   help="a multi-model host: comma-separated checkpoints "
                   "(NAME=PATH, or bare paths named by the file stem) on one "
                   "engine; the first (or --model) is the default, the rest "
                   "answer the request's 'model' field")
    v.add_argument("--tenants", metavar="JSON",
                   help="per-tenant admission: a JSON list of rows {tenant, "
                   "model?, slo_ms?, weight?, quota_qps?, quota_concurrent?, "
                   "admission?} enforced by the batcher's weighted-fair "
                   "lanes; over-quota requests answer 429 with the tenant")
    v.add_argument("--fleet", metavar="HOST:PORT,...",
                   help="run a fleet router instead of a local engine: "
                   "least-loaded dispatch over the comma-separated serve "
                   "hosts, session affinity, dead-host failover")
    v.add_argument("--name", default="model",
                   help="registry name for the model (default: 'model')")
    v.add_argument("--version", type=int, default=None,
                   help="registry version number (default: auto-assign)")
    v.add_argument("--max-batch", type=int, default=32,
                   help="dynamic batcher fused-batch cap")
    v.add_argument("--slo-ms", type=float, default=50.0,
                   help="per-request deadline budget; queued requests past "
                   "it fail fast with DeadlineExceededError")
    v.add_argument("--replicas", type=int, default=-1,
                   help="engine replicas (-1 = one per card)")
    v.add_argument("--admission", choices=("block", "shed"), default="shed",
                   help="overload policy: block callers or shed with "
                   "OverloadedError (HTTP 429)")
    v.add_argument("--queue-cap", type=int, default=256,
                   help="admission queue bound in requests")
    v.add_argument("--port", type=int, default=9000)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--forward-timeout", type=float, default=None, metavar="SECONDS",
                   help="declare a replica hung (abandon, retry its batch "
                   "elsewhere, respawn it) when one forward exceeds this "
                   "(default: disabled)")
    v.add_argument("--max-retries", type=int, default=1,
                   help="per-request retry budget after a replica failure "
                   "(deadline-aware, different replica; default 1)")
    v.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive replica failures that trip its circuit "
                   "breaker (default 3)")
    v.add_argument("--compile-cache", metavar="DIR",
                   help="persistent kernel-build cache: a restarted server "
                   "loads DIR's built kernels without nvcc (default: the "
                   "DL4J_TPU_COMPILE_CACHE variable)")
    v.add_argument("--warm-bundle", metavar="PATH",
                   help="warm bundle naming the programs to prepare at load "
                   "(default: <checkpoint>.warm next to --model when present)")
    v.add_argument("--smoke", type=int, default=0, metavar="N",
                   help="push N synthetic requests through the engine, print "
                   "the metrics snapshot, and exit (self-test)")
    v.add_argument("--trace", metavar="PATH",
                   help="record request/batch spans and write them to PATH as "
                   "a Chrome trace on exit")
    v.add_argument("--prefix-cache", action="store_true",
                   help="radix prefix cache for POST /generate (transformer LM)")
    v.add_argument("--speculate", metavar="DRAFT_CKPT[,k]",
                   help="speculative decoding for POST /generate")
    v.add_argument("--kv-dtype", choices=("float32", "int8"), default="float32",
                   help="KV page storage of the decode engine")
    v.add_argument("--decode-role", choices=("unified", "prefill", "decode"),
                   default="unified",
                   help="disaggregated serving role of the decode engine: "
                   "'prefill' hosts prefill and export KV pages as handoffs "
                   "(/generate answers 409), 'decode' hosts attach handoffs "
                   "and stream tokens; a fleet router routes the two stages")
    v.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    v.set_defaults(fn=cmd_serve)
    fw = sub.add_parser(
        "flywheel", help="continuous train→eval→canary→fleet-promote "
        "lifecycle on a synthetic task: repeated PromotionPipeline generations "
        "with lineage-aware rollback, a crash-resumable journal, and optional "
        "per-generation chaos")
    fw.add_argument("--generations", type=int, default=3, metavar="K",
                    help="lifecycle generations to complete (default 3)")
    fw.add_argument("--eval-threshold", type=float, default=3.0,
                    help="eval-gate loss ceiling; non-finite scores always fail "
                    "(default 3.0)")
    fw.add_argument("--canary", type=float, default=1.0, metavar="FRAC",
                    help="fraction of live batches mirrored to the canary "
                    "(default 1.0)")
    fw.add_argument("--canary-window", type=int, default=4,
                    help="mirrored batches per canary decision (default 4)")
    fw.add_argument("--canary-timeout-s", type=float, default=60.0,
                    help="canary window deadline; an unfilled window is a "
                    "rejection (default 60)")
    fw.add_argument("--max-divergence", type=float, default=None,
                    help="canary prediction-divergence ceiling (mean abs diff vs "
                    "the incumbent; default off)")
    fw.add_argument("--hosts", type=int, default=2,
                    help="fleet hosts; host 0 is the subscribed canary engine, the "
                    "rest roll via rolling_swap; 0 = no fleet, alias-only "
                    "promotion (default 2)")
    fw.add_argument("--chaos", default="", metavar="KIND[,KIND...]",
                    help="chaos kinds fired one per generation starting at gen 2: "
                    "device_loss (mid-train, recovered), nan (eval gate catches), "
                    "regression (canary rejects), host_kill (mid-roll, lineage "
                    "rollback), crash (controller dies at CANARY, journal resume)")
    fw.add_argument("--workdir", help="checkpoint/journal directory (default: fresh "
                    "temp dir)")
    fw.add_argument("--journal", help="journal path override — reuse one to resume "
                    "a killed run (default: <workdir>/flywheel.jsonl)")
    fw.add_argument("--alias", default="prod")
    fw.add_argument("--epochs", type=int, default=3,
                    help="training epochs per generation (default 3)")
    fw.add_argument("--seed", type=int, default=12345)
    fw.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the CPU)")
    fw.set_defaults(fn=cmd_flywheel)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
