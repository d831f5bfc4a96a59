"""Command-line front end of the port (mirrors ``deeplearning4j_tpu/cli.py``:
the ``predict`` subcommand, and ``generate`` for a TransformerLM checkpoint
through the decode engine or a recurrent one through ``rnn_time_step``).
Runs on ``cuda`` unless ``--device cpu`` is given.

    python -m deeplearning4j_tpu_torch predict --model m.zip --input x.npz --output y.npz
    python -m deeplearning4j_tpu_torch generate --model m.zip --prompt "hello"
"""

from __future__ import annotations

import argparse
import sys

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


def _generate_decode_engine(net, args) -> int:
    from .models.transformer import TransformerDecodeAdapter
    from .serving import DecodeEngine

    adapter = TransformerDecodeAdapter(net)
    vocab = adapter.vocab_size
    pos_rows = int(adapter.params["pos"]["P"].shape[0])
    page = args.page_size
    while page > 1 and page > pos_rows // 2:
        page //= 2
    prompt_ids = [min(ord(c), vocab - 1) for c in args.prompt]
    if not prompt_ids:
        raise SystemExit("--prompt must be non-empty")
    eng = DecodeEngine(adapter, max_slots=1, page_size=page,
                       default_max_new=args.max_tokens,
                       device=args.device).load()
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="PyTorch/CUDA port of deeplearning4j_tpu (inference)")
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
    g.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    g.set_defaults(fn=cmd_generate)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
