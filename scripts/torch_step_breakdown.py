#!/usr/bin/env python3
"""Where the device time goes on the PyTorch/CUDA port's main path (one GPU).

    python3 scripts/torch_step_breakdown.py [--trace-dir DIR] [--decode-rows 64,128]
                                            [--rnn-only]

Builds the full-width TransformerLM that ``chip_smoke.py`` drives (vocab
50304, 12 layers, d_model 768, 12 heads, f32, random weights from the
same numpy seed), then its char-RNN, and traces these pieces of work with
``torch.profiler``:

  score    one ``MultiLayerNetwork.output`` on [4, 1024] tokens (kernel K1)
  prefill  one decode prefill of a 512-token prompt (bucket 512, L 1024;
           kernel D1)
  step     8 decode steps over 4 active slots near position 300, each
           with its sampling (two greedy slots, two at temperature 0.8 /
           top_k 50), as the engine runs them (kernel D1)
  train    one ``fit_batch`` on [8, 1024] tokens, Adam with
           ``DL4J_TPU_FUSED_UPDATE=1`` (kernels K1-K4)
  train_per_leaf  the same with the switch at 0: the per-leaf Adam step
           instead of K4, for the A/B of the two update paths
  rnn_train  one ``fit_batch`` of ``chip_smoke.py``'s char-RNN (bench
           config 4: vocab 96, 2 x LSTM(256), TBPTT 50) on [64, 100] ids,
           K4 on (K5a once per layer and TBPTT chunk, K5b every step)
  rnn_train_plain_loop  the same with the plain per-step loop under
           autograd patched in where the layers call the sequence
           (``recurrent.lstm_sequence``), for the K5 A/B
  rnn_stream  8 streamed tokens of the trained char-RNN at batch 1, each
           an ``rnn_time_step`` and the host's greedy pick, as the CLI's
           recurrent ``generate`` runs them (K5a)
  dp_one_pass, dp_top_k, dp_adaptive, dp_dense  one ``ShardedTrainer``
           step of ``chip_smoke.py``'s compressed phase: two rank processes
           on cuda:0 (gloo, dcn=2), [4, 1024] rows each of one [8, 1024]
           batch, threshold 1e-3 as the port runs it (one K6 launch over
           every bucket, top-k where a bucket overflows) and with the top-k
           pack on every bucket (``chip_smoke.top_k_only``), adaptive, and
           dense.  Rank 0 reports; its trace holds only its
           own kernels, so "busy" is rank 0's and "idle" counts the other
           rank's kernels as idle

``--decode-rows`` measures prefill and step once for each chunk size of
the decode program's per-position ops (``models.transformer.DECODE_ROWS``,
64 by default); rows past the first are named ``prefill@R``/``step@R``.

For each it prints one JSON line: the median wall time of 3 untraced
repeats after warm-up calls (2; 3 for a training step), each on the host
clock around work that ends in ``torch.cuda.synchronize``; the
device-busy time of one traced run right after them (the union of its
kernels' intervals); the device's idle share (1 - busy / wall); and the
kernel time grouped by class and by name.  ``--trace-dir`` also writes
each Chrome trace.  Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: kernel-name fragments → class, first match wins
_CLASSES = (
    ("flash_fwd", "K1 flash_fwd"),
    ("flash_bwd_dkdv", "K2 flash_bwd_dkdv"), ("flash_bwd_dq", "K3 flash_bwd_dq"),
    ("fused_update", "K4 fused_update"), ("det_attention", "D1 det_attention"),
    ("lstm_seq_fwd", "K5a lstm_seq_fwd"), ("lstm_cell_bwd", "K5b lstm_cell_bwd"),
    ("threshold_", "K6 threshold_encode"),
    ("gemm", "gemm"), ("gemv", "gemm"), ("nvjet", "gemm"), ("xmma", "gemm"),
    ("cutlass", "gemm"),
    ("softmax", "softmax"),
    ("reduce", "reduce"),
    ("index", "gather/scatter"), ("scatter", "gather/scatter"),
    ("gather", "gather/scatter"),
    ("sort", "sort/scan"), ("scan", "sort/scan"), ("radix", "sort/scan"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("copy", "copy"), ("memcpy", "copy"), ("memset", "copy"),
)


def _cls(name: str) -> str:
    low = name.lower()
    for frag, cls in _CLASSES:
        if frag in low:
            return cls
    return "other"


def _kernels(prof):
    import torch
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _busy_us(spans) -> float:
    total, end = 0.0, None
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def measure(name: str, fn, trace_dir, warm: int = 2, repeats: int = 3, report: bool = True):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):                  # allocator, cuBLAS heuristics
        fn()
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = _kernels(prof)
    by_cls, by_name = {}, {}
    for n, a, b in spans:
        by_cls[_cls(n)] = by_cls.get(_cls(n), 0.0) + (b - a) / 1e3
        c, t = by_name.get(n, (0, 0.0))
        by_name[n] = (c + 1, t + (b - a) / 1e3)
    busy_ms = _busy_us(spans) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    rec = {"phase": name, "wall_ms": wall_ms, "wall_ms_repeats": walls,
           "device_busy_ms": busy_ms if spans else None,
           "idle_share": 1 - busy_ms / wall_ms if spans else None,
           "kernels": len(spans),
           "class_ms": dict(sorted(by_cls.items(), key=lambda kv: -kv[1])),
           "top": [{"name": n[:120], "count": c, "ms": t} for n, (c, t) in top]}
    if not report:
        return rec
    print(json.dumps(rec), flush=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    return rec


def rnn_rows(rng, trace_dir) -> None:
    """The rnn_train, rnn_train_plain_loop and rnn_stream rows."""
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.ops import lstm_kernel, update_kernel

    dev = torch.device("cuda")
    os.environ[update_kernel.ENV_SWITCH] = "1"
    chars = torch.from_numpy(rng.integers(0, cs.RNN_VOCAB, (cs.RNN_B, cs.RNN_T + 1))).to(dev)
    rnn_batch = DataSet(chars[:, :-1], chars[:, 1:])
    rnn = cs.build_rnn("cuda")
    for name, seq in (("rnn_train", lstm_kernel.lstm_sequence),
                      ("rnn_train_plain_loop", lstm_kernel.lstm_sequence_plain)):
        recurrent.lstm_sequence = seq
        measure(name, lambda: rnn.fit_batch(rnn_batch), trace_dir, warm=3)
    recurrent.lstm_sequence = lstm_kernel.lstm_sequence
    rnn.rnn_clear_previous_state()
    rnn.rnn_time_step(chars[:1, :16])      # a 16-token prompt

    def stream():                          # the CLI's loop: step, then greedy pick on host
        tok = 0
        for _ in range(8):
            tok = int(rnn.rnn_time_step(torch.tensor([tok], device=dev))[0].argmax().cpu())

    measure("rnn_stream", stream, trace_dir)
    del rnn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None,
                    help="also write one Chrome trace per phase here")
    ap.add_argument("--rnn-only", action="store_true",
                    help="only the char-RNN rows (rnn_train, rnn_train_plain_loop, rnn_stream)")
    ap.add_argument("--decode-rows", default="64",
                    help="comma-separated chunk sizes of the decode program's "
                         "per-position ops to measure prefill and step at")
    args = ap.parse_args()
    decode_rows = [int(r) for r in args.decode_rows.split(",")]

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_step_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.models import transformer
    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.ops.kv_cache import alloc_cache
    from deeplearning4j_tpu_torch.ops.sampling import sample_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": cs.card_line(), "torch": torch.__version__}), flush=True)
    if args.rnn_only:
        rnn_rows(np.random.default_rng(cs.SEED + 3), args.trace_dir)
        return 0
    net = cs.build_model()
    rng = np.random.default_rng(cs.SEED + 3)
    tokens = rng.integers(0, cs.VOCAB, (4, cs.MAX_LEN))
    measure("score", lambda: net.output(tokens), args.trace_dir)

    adapter = TransformerDecodeAdapter(net)
    prog = adapter.decode_program(page_size=16, max_len=cs.MAX_LEN)
    params, dev = adapter.params, torch.device("cuda")
    pps = prog.pages_per_slot
    kp, vp = alloc_cache(prog.n_layers, 1 + 4 * pps, prog.page_size, prog.n_heads,
                         prog.d_head, device=dev)
    table = torch.arange(1, 1 + 4 * pps, device=dev).reshape(4, pps)
    prompt = torch.from_numpy(rng.integers(0, cs.VOCAB, 512)).to(dev)
    toks = torch.from_numpy(rng.integers(0, cs.VOCAB, 4)).to(dev)
    pos = torch.tensor([300, 310, 320, 330], device=dev)
    act = torch.ones(4, dtype=torch.bool, device=dev)

    def steps():                           # the engine's step: forward + sampling
        for j in range(8):
            _, _, lgs = prog.step(params, kp, vp, table, toks, pos + j, act)
            sample_tokens(lgs, [0.0, 0.8, 0.0, 0.8], [0, 50, 0, 50],
                          [1.0] * 4, [1, 2, 3, 4], [j] * 4, prog.vocab_size)

    with torch.inference_mode():
        for i in range(4):                 # fill each slot's first 512 rows
            prog.prefill(params, kp, vp, table[i], prompt, 512)
        for n, rows in enumerate(decode_rows):
            transformer.DECODE_ROWS = rows  # read by per_row at each call
            tag = "" if n == 0 else f"@{rows}"
            measure("prefill" + tag,
                    lambda: prog.prefill(params, kp, vp, table[0], prompt, 512),
                    args.trace_dir)
            measure("step" + tag, steps, args.trace_dir)
        transformer.DECODE_ROWS = decode_rows[0]

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ops import update_kernel

    seq = torch.from_numpy(rng.integers(0, cs.VOCAB, (8, cs.MAX_LEN + 1))).to(dev)
    batch = DataSet(seq[:, :-1], seq[:, 1:])
    for name, switch in (("train", "1"), ("train_per_leaf", "0")):
        os.environ[update_kernel.ENV_SWITCH] = switch
        measure(name, lambda: net.fit_batch(batch), args.trace_dir, warm=3)

    rnn_rows(rng, args.trace_dir)
    del net
    torch.cuda.empty_cache()

    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank",
                                   str(r), work, args.trace_dir or ""]) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=900)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return 0 if all(p.returncode == 0 for p in procs) else 1


def dp_rank(rank: int, work: str, trace_dir) -> None:
    """One of the two ranks of the dp_* rows."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ops import compression, update_kernel
    from deeplearning4j_tpu_torch.parallel import (ShardedTrainer, build_two_tier_mesh,
                                                   initialize, shutdown)

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=600)
    os.environ[update_kernel.ENV_SWITCH] = "1"
    rng = np.random.default_rng(cs.SEED + 3)
    seq = torch.from_numpy(rng.integers(0, cs.VOCAB, (8, cs.MAX_LEN + 1))).to("cuda")
    batch = DataSet(seq[:, :-1], seq[:, 1:])
    one_pass = compression.one_pass_pack
    for name, method, t, top_k in (("dp_one_pass", "threshold", cs.COMPRESS_T, False),
                                   ("dp_top_k", "threshold", cs.COMPRESS_T, True),
                                   ("dp_adaptive", "threshold", None, False),
                                   ("dp_dense", None, None, False)):
        compression.one_pass_pack = cs.top_k_only if top_k else one_pass
        trainer = ShardedTrainer(cs.build_model(), build_two_tier_mesh(2, {"data": 1}),
                                 grad_compression=method, compression_threshold=t)
        measure(name, lambda: trainer.fit_batch(batch), trace_dir, warm=3, report=rank == 0)
        del trainer
        torch.cuda.empty_cache()
    shutdown()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4] or None)
        sys.exit(0)
    sys.exit(main())
