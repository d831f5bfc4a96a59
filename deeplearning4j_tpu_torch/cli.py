"""Command-line front end of the port (mirrors ``deeplearning4j_tpu/cli.py``:
the ``predict`` subcommand, ``generate`` for a TransformerLM checkpoint
through the decode engine or a recurrent one through ``rnn_time_step``,
and ``serve``).  Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m deeplearning4j_tpu_torch predict --model m.zip --input x.npz --output y.npz
    python -m deeplearning4j_tpu_torch generate --model m.zip --prompt "hello"
        [--prefix-cache] [--speculate DRAFT_CKPT[,k]] [--kv-dtype {float32,int8}]
    python -m deeplearning4j_tpu_torch serve --model m.zip --port 9000 [--smoke N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def cmd_predict(args) -> int:
    from .utils.serializer import load_model

    net = load_model(args.model, device=args.device)
    data = np.load(args.input)
    x = data["x"] if "x" in data else data[data.files[0]]
    out = net.output(np.asarray(x, np.float32)).float().cpu().numpy()
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
    is_lm = any(isinstance(l, TransformerBlock) for l in net.conf.layers)
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
    server = UIServer(port=args.port, host=args.host)
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
    print(f"listening on http://{args.host}:{server.port} — "
          "POST /predict, POST /generate, GET /metrics, GET /healthz", flush=True)
    try:
        while True:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        for e in (engine, decode_eng):
            if e is not None:
                e.shutdown()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="PyTorch/CUDA port of deeplearning4j_tpu (inference and serving)")
    sub = p.add_subparsers(dest="cmd", required=True)

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
