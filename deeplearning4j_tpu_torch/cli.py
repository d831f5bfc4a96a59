"""Command-line front end of the port (mirrors ``deeplearning4j_tpu/cli.py``:
``train``, ``evaluate``, ``summary``, ``predict``, ``generate`` for a
TransformerLM checkpoint through the decode engine or a recurrent one
through ``rnn_time_step``, and ``serve``).  Runs on ``cuda`` unless
``--device cpu`` is given.

    python -m deeplearning4j_tpu_torch train --config mlp.json --data iris --output m.zip
    python -m deeplearning4j_tpu_torch train --zoo lenet --data mnist --output lenet.zip
    python -m deeplearning4j_tpu_torch summary --zoo resnet50
    python -m deeplearning4j_tpu_torch evaluate --model m.zip --data iris
    python -m deeplearning4j_tpu_torch summary --model m.zip
    python -m deeplearning4j_tpu_torch predict --model m.zip --input x.npz --output y.npz
    python -m deeplearning4j_tpu_torch generate --model m.zip --prompt "hello"
        [--prefix-cache] [--speculate DRAFT_CKPT[,k]] [--kv-dtype {float32,int8}]
    python -m deeplearning4j_tpu_torch serve --model m.zip --port 9000 [--smoke N]
    python -m deeplearning4j_tpu_torch train --zoo lenet --data mnist --elastic-dir ckpts \
        [--chaos device_loss@5,ckpt_truncate@9] [--checkpoint-every 4] [--grace 30]
    python -m deeplearning4j_tpu_torch launch --nprocs 2 --bootstrap distributed \
        -- train --zoo lenet --data mnist --mesh dcn=2,data=1,compress=threshold \
        --elastic-dir ckpts --checkpoint-every 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Tuple

import numpy as np


#: train flags that wait for later ports, with the ROADMAP item that ports them
LATER_FLAGS = {
    "prefetch": "queue 1 item 9 (datasets/device_prefetch)",
    "compile_cache": "queue 1 item 8.2 (the serve and launch flags)",
    "dashboard": "queue 1 item 9 (ui/)",
}


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
    """``iris``, ``mnist`` or an ``.npz`` holding ``x`` and ``y`` → (x, y)
    float32, index labels one-hot (the reference's rules)."""
    from .datasets import fetchers

    builtin = {"mnist": lambda: fetchers.load_mnist(train=train),
               "iris": fetchers.load_iris}
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

    for flag, item in LATER_FLAGS.items():
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet "
                             f"(ROADMAP {item})")
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
    net.set_listeners(ScoreIterationListener(args.print_every))
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
            losses = et.fit(batches, epochs=args.epochs, skip_done=True)
        else:
            runner = trainer if trainer is not None else net
            losses = runner.fit(ListDataSetIterator(batches), epochs=args.epochs)
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
    """``DecodeEngine`` arguments for the decode flags of ``generate``:
    --prefix-cache, --speculate DRAFT_CKPT[,k], --kv-dtype."""
    from .models.transformer import TransformerDecodeAdapter
    from .utils.serializer import load_model

    draft_path, k = _parse_speculate(args.speculate)
    draft = None
    if draft_path:
        draft = TransformerDecodeAdapter(load_model(draft_path, device=args.device))
    return {"prefix_cache": bool(args.prefix_cache), "draft_model": draft,
            "speculate_k": k,
            "kv_dtype": None if args.kv_dtype in (None, "float32") else args.kv_dtype}


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


def cmd_serve(args) -> int:
    """Serve a checkpoint: register it in a ``ModelRegistry`` (alias
    ``prod``), warm every bucket of a predict ``Engine`` and answer POST
    /predict, GET /metrics and GET /healthz on the HTTP server; or, with
    ``--smoke N``, push N synthetic requests through the engine, print its
    metrics snapshot and exit.  A TransformerLM checkpoint is served
    decode-only: POST /generate through a ``DecodeEngine`` (the decode
    flags as ``generate``'s), /predict answers 503.  Runs until
    interrupted."""
    from .models.transformer import TransformerBlock, TransformerDecodeAdapter
    from .serving import DecodeEngine, Engine, ModelRegistry
    from .ui import UIServer

    reg = ModelRegistry(device=args.device)
    version = reg.load(args.name, args.model, version=args.version)
    _, net = reg.resolve(args.name, version)
    is_lm = any(isinstance(l, TransformerBlock) for l in getattr(net.conf, "layers", ()))
    engine = None
    if not is_lm:
        reg.set_alias(args.name, "prod", version)
        engine = Engine.from_registry(
            reg, args.name, "prod", max_batch=args.max_batch, slo_ms=args.slo_ms,
            replicas=args.replicas, max_queue=args.queue_cap,
            admission=args.admission, forward_timeout_s=args.forward_timeout,
            max_retries=args.max_retries, breaker_threshold=args.breaker_threshold,
            device=args.device).load()
        print(f"serving {args.name} v{version} (alias 'prod'): "
              f"max_batch={args.max_batch}, slo={args.slo_ms}ms, "
              f"replicas={len(engine._replicas)}, admission={args.admission}, "
              f"warmed buckets {engine.batcher.buckets}, "
              f"programs {engine.compile_cache_size()}")
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
        return 0
    import os

    from .parallel.distributed import ENV_SERVE_PORT, PREEMPTED_EXIT_CODE
    from .parallel.launcher import Heartbeat
    from .parallel.preemption import PreemptionHandler

    # under `launch --serve` each worker gets a stable port; --port wins
    port = args.port
    if port == 9000 and os.environ.get(ENV_SERVE_PORT):
        port = int(os.environ[ENV_SERVE_PORT])
    server = UIServer(port=port, host=args.host)
    if engine is not None:
        server.attach_engine(engine)
    decode_eng = None
    if is_lm or args.prefix_cache or args.speculate or args.kv_dtype not in (None, "float32"):
        if not is_lm:
            raise SystemExit("--prefix-cache/--speculate/--kv-dtype need a "
                             "transformer LM checkpoint")
        adapter = TransformerDecodeAdapter(net)
        decode_eng = DecodeEngine(adapter, page_size=_page_size(adapter, 16),
                                  device=args.device, **_decode_opts(args)).load()
        server.attach_decode_engine(decode_eng)
        print(f"decode engine on POST /generate: prefix_cache={args.prefix_cache}, "
              f"speculate={args.speculate}, kv_dtype={args.kv_dtype}")
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
    if args.compile_cache is not None:
        raise SystemExit("--compile-cache is not ported yet "
                         f"(ROADMAP {LATER_FLAGS['compile_cache']})")
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="PyTorch/CUDA port of deeplearning4j_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model")
    t.add_argument("--zoo", help="zoo model name (e.g. lenet, resnet50)")
    t.add_argument("--zoo-args", help="JSON kwargs for the zoo constructor")
    t.add_argument("--config", help="MultiLayerConfiguration JSON file")
    t.add_argument("--data", required=True, help="builtin name (iris/mnist) or .npz "
                   "with arrays 'x' and 'y'")
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
    for flag in LATER_FLAGS:
        t.add_argument("--" + flag.replace("_", "-"), default=None,
                       help=f"not ported yet (ROADMAP {LATER_FLAGS[flag]})")
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
                    help=f"not ported yet (ROADMAP {LATER_FLAGS['compile_cache']})")
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
    v.add_argument("--model", required=True, help="checkpoint zip to serve")
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
    v.add_argument("--smoke", type=int, default=0, metavar="N",
                   help="push N synthetic requests through the engine, print "
                   "the metrics snapshot, and exit (self-test)")
    v.add_argument("--prefix-cache", action="store_true",
                   help="radix prefix cache for POST /generate (transformer LM)")
    v.add_argument("--speculate", metavar="DRAFT_CKPT[,k]",
                   help="speculative decoding for POST /generate")
    v.add_argument("--kv-dtype", choices=("float32", "int8"), default="float32",
                   help="KV page storage of the decode engine")
    v.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    v.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
