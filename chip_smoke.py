#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, on cuda:0

It builds every CUDA kernel of the port from ``deeplearning4j_tpu_torch/csrc``
with ``nvcc`` (one process per source, started together), then drives the
port's main paths — TransformerLM inference, decode serving and training
at the full width of the repository's benchmarked model (vocab 50304, 12
layers, d_model 768, 12 heads, d_ff 3072, max_len 1024, f32, ~163M
parameters; weights random from a numpy seed with GPT-2's initialisation),
and the recurrent path's training and streaming:

  kernel  each kernel against its plain PyTorch version on the same inputs
          at the shapes the main path gives it: errors, median time, the
          plain version's time, the least time the card could take (bound)
          and one PyTorch library call's time as a yardstick.  K1 (flash
          forward, at [4, 12, 1024, 64] and the train phase's B = 8),
          K2/K3 (flash backward dK/dV and dQ, at the train phase's
          [8, 12, 1024, 64] and more cases at B = 4) and D1 (decode
          attention, on the decode program's strided and paged K/V
          views; its split-key launch at the step, its tiled launch at
          the prefill and the re-encode) run first; K1's, K2's, K3's and
          D1's times and their yardsticks' (SDPA; autograd of SDPA for
          K2/K3) are device times (``device_ms``) beside the same calls
          timed alone with CUDA events (``cuda_ms``, the wrapper's host
          cost included); a second launch of K2 and of K3 must be
          bitwise the first; K4 (fused Adam) runs after the train phase
          on the model's real per-layer buffers and must match bitwise;
  score   ``MultiLayerNetwork.output`` on [4, 1024] tokens; K1 must have
          launched; the result must be a distribution and agree with the
          port run on the CPU at a smaller cut ([1, 256]);
  serve   ``DecodeEngine(max_slots=4, page_size=16, max_len=1024)`` answers
          8 concurrent requests (prompts of 16-512 tokens, 32 new tokens,
          half greedy, half seeded at temperature 0.8 / top_k 50); every
          future resolves, the pool drains to 0 pages, D1 launched, greedy
          tokens equal the argmax of the re-encode logits, every decode
          logit is bitwise the re-encode logit, and the decode
          log-probabilities agree with ``output()`` (K1, which shares
          neither D1 nor the 64-row chunks) within 1e-4;
  train   ``fit_batch`` 5 times on one fixed [8, 1024] batch with Adam
          (lr 3e-4, per-layer L2 clipping 1.0) and ``DL4J_TPU_FUSED_UPDATE=1``:
          the loss is finite and falls on every step, each step launches
          K1 12, K2 12, K3 12 and K4 15 times, and one step's loss and
          per-layer clipped gradients agree with the port on the CPU with
          the same weights at a cut ([1, 128] tokens);
  recurrent  the char-RNN that bench config 4 trains, at its full width
          (vocab 96, 2 x 256 units, softmax/mcxent head, Adam lr 1e-3,
          elementwise clipping 1.0, TBPTT 50, one fixed [64, 100] batch of
          ids, weights from a seed), K4 switched on: the LSTM stack as the
          port runs it (K5a once per layer and TBPTT chunk, K5b every step
          of the backward) and, for the A/B, with the plain per-step loop
          patched in (``recurrent.lstm_sequence`` =
          ``lstm_sequence_plain``), 5 ``fit_batch`` calls each, in turns
          (losses finite and falling, equal across the arms within 1e-5,
          4 K5a and 200 K5b launches per call through the kernels and none
          with the plain loop); the zoo's ``TextGenerationLSTM``
          (GravesLSTM peephole cells, which never reach K5) 5 calls; one
          kernel call at [4, 100] against the port on the CPU (loss and
          every parameter within 1e-4); then the trained net saved, loaded
          on the card and serving 64 greedy tokens from a 16-token prompt
          through the CLI's recurrent ``generate`` path: K5a launches twice
          for the prompt and twice per token, and every streamed
          distribution equals ``output()`` over the whole sequence within
          1e-5, through K5a and with the plain loop.
          K5a (one launch per layer and sequence) is held to the plain loop
          (evaluated in f32) at the chunk's [64, 50, 256], [64, 100, 512],
          [7, 13, 256], the stream's [1, 1, 256], n % 4 != 0, a mask,
          reverse, more tiles than the card holds at once (RW streamed) and
          bf16 (f32 2e-5 abs and 1e-5 norm-relative; bf16 1e-2
          norm-relative and 2e-2 abs or one bf16 spacing; a second launch
          bitwise the first), and timed against cuDNN's LSTM on the same
          layer's forward; at T = 1 with h0 = 0 and b = 0 (z = zx) against
          the plain cell (2e-6) at the old cell shapes; K5b against its
          plain version at [64, 256], [64, 512], [7, 256], [1, 256],
          [64, 255], [3, 3] and [4096, 256], in f32 and bf16.
  compressed  data-parallel training of the TransformerLM through
          ``parallel.ShardedTrainer`` over ``torch.distributed``: two rank
          processes on cuda:0 (gloo; mesh dcn=2, data=1), each taking
          [4, 1024] of one fixed [8, 1024] batch, Adam with per-layer
          clipping, K4 on, 4 MiB buckets, 5 steps in each of four arms from
          the same weights: (a) threshold fixed ``COMPRESS_T`` as the port
          runs it (K6 encodes and counts every bucket; the buckets whose
          count exceeds k are encoded again by the top-k pack), (b) the
          same with the top-k pack on every bucket (``top_k_only`` patched
          in for the one-pass pack), (c) threshold adaptive, (d) dense.
          Gates: both ranks' parameters bitwise equal after every step in
          every arm (an exact integer fingerprint of the f32 bits), (a)
          bitwise (b) (losses and fingerprints), losses finite and falling,
          one K6 launch over every bucket in every step of (a) and none of
          the one-bucket launch, the bytes gathered per step equal to
          ``compression_stats``'s and at least 8x below dense.  It also
          reads, from a ``torch.profiler`` trace of one all-gather of a
          step's wire buffer, whether gloo copied the CUDA tensors through
          host memory.  K6 is held to its plain version bitwise over the
          phase's whole 156-bucket layout (2%-hot gradient; a second launch
          bitwise the first; timed against its 0.207 ms bound and against
          ``torch.nonzero`` plus a pack of every bucket), and as one bucket
          at n = 1024, 4096, 2^20 and 2^20 + 333 with no selection, exactly
          k selections and a 2%-hot gradient.

Each phase prints JSON lines; then one ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero without that last line, as does a run
without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

VOCAB, LAYERS, D_MODEL, HEADS, D_FF, MAX_LEN = 50304, 12, 768, 12, 3072, 1024
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` launches, each timed
    with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn`` with the host's enqueue
    hidden: a sleep kernel holds the stream while the calls are queued, so
    the two events time only their work on the device (the gaps between
    its kernels there included).  Where the enqueue outlasts the sleep the
    time would include host waits: the run is repeated with a sleep four
    times longer, and after three such runs it raises."""
    import torch
    for _ in range(warmup):
        fn()
    cycles = 50_000_000                      # tens of ms at the card's clock
    for _ in range(3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        queued = not a.query()               # the sleep still holds the stream
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / iters
        cycles *= 4
    raise AssertionError("device_ms: the host's enqueue outlasted every sleep")


# -- kernel phase ----------------------------------------------------------------


def timed(kernel, library) -> dict:
    """A kernel's and its library yardstick's times: device time per call
    with the host's enqueue hidden (``device_ms``: "ms", "library_ms")
    and each call timed alone with CUDA events, the wrapper's host cost
    included (``cuda_ms``: "cuda_ms", "library_cuda_ms")."""
    return {"ms": device_ms(kernel), "cuda_ms": cuda_ms(kernel, 20),
            "library_ms": device_ms(library), "library_cuda_ms": cuda_ms(library, 20)}


def flash_case(name, dtype, kmask_frac, B=4, H=HEADS, T=MAX_LEN, D=D_MODEL // HEADS):
    """K1 against its plain version on one input set; returns its record."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention as att

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, D), dtype=np.float32))
               .to(dev, dtype) for _ in range(3))
    kmask = None
    if kmask_frac:
        km = (rng.random((B, T)) >= kmask_frac).astype(np.int32)
        km[:, 0] = 1
        kmask = torch.from_numpy(km).to(dev)
    scale = 1.0 / math.sqrt(D)
    o, lse = att.flash_forward_cuda(q, k, v, kmask, True, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = att.flash_forward_plain(q, k, v, kmask, True, scale)
    diff = o.float() - o_ref.float()
    err = float(diff.abs().max())
    rel_err = float(diff.norm() / o_ref.float().norm())
    lse_err = float((lse - lse_ref).abs().max())
    kernel = lambda: att.flash_forward_cuda(q, k, v, kmask, True, scale)
    plain_ms = cuda_ms(lambda: att.flash_forward_plain(q, k, v, kmask, True, scale), 5)
    if kmask is None:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    else:
        allowed = (torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None, None]
                   & (kmask != 0)[:, None, None, :])
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
    # the work this input needs: (query, live key) pairs on or below the diagonal
    live = torch.ones(B, T, device=dev) if kmask is None else kmask.float()
    pairs = float((torch.cumsum(live, dim=1).sum()) * H)
    flops = 4.0 * D * pairs
    nbytes = (4 * B * H * T * D) * q.element_size() + B * H * T * 4 + (
        0 if kmask is None else B * T * 4)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    t_ops, t_bytes = flops / PEAK_FLOPS[dname] * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = {"phase": "kernel", "case": name, "dtype": dname,
           "shape": [B, H, T, D], "causal": True, "kmask": kmask is not None,
           "max_abs_err": err, "rel_err": rel_err, "lse_max_abs_err": lse_err,
           **timed(kernel, lib),
           "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    emit(rec)
    return rec


def bound(flops, nbytes, dname):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    for the inputs' type and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dname] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bwd_case(name, dtype, kmask_frac, B=4, H=HEADS, T=MAX_LEN, D=D_MODEL // HEADS):
    """K2 and K3 against their plain versions on one input set (causal,
    the forward's O and LSE from K1); returns its record."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention as att

    rng = np.random.default_rng(SEED + 10)
    dev = torch.device("cuda")
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, T, D), dtype=np.float32))
                  .to(dev, dtype) for _ in range(4))
    kmask = None
    if kmask_frac:
        km = (rng.random((B, T)) >= kmask_frac).astype(np.int32)
        km[:, 0] = 1
        kmask = torch.from_numpy(km).to(dev)
    scale = 1.0 / math.sqrt(D)
    o, lse = att.flash_forward_cuda(q, k, v, kmask, True, scale)
    delta = att.flash_delta(o, g)
    args = (q, k, v, g, lse, delta, kmask, True, scale)
    dk, dv = att.flash_bwd_dkdv_cuda(*args)
    dq = att.flash_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    rk, rv = att.flash_bwd_dkdv_plain(*args)
    rq = att.flash_bwd_dq_plain(*args)

    def errs(pairs):
        d = [(a.float() - b.float()) for a, b in pairs]
        return (max(float(x.abs().max()) for x in d),
                max(float(x.norm() / b.float().norm()) for x, (_, b) in zip(d, pairs)))

    # the library's backward of the same attention, timed only
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    if kmask is None:
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    else:
        allowed = (torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None, None]
                   & (kmask != 0)[:, None, None, :])
        o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=allowed)
    lib = lambda: torch.autograd.grad(o_lib, (qr, kr, vr), g, retain_graph=True)
    live = torch.ones(B, T, device=dev) if kmask is None else kmask.float()
    pairs = float((torch.cumsum(live, dim=1).sum()) * H)
    es = q.element_size()
    reads = 4 * B * H * T * D * es + 2 * B * H * T * 4 + (0 if kmask is None else B * T * 4)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    rec = {"phase": "kernel", "case": "bwd_" + name, "dtype": dname,
           "shape": [B, H, T, D], "causal": True, "kmask": kmask is not None,
           "errors": {n: errs((pair,)) for n, pair in
                      (("dq", (dq, rq)), ("dk", (dk, rk)), ("dv", (dv, rv)))},
           "library_ms": device_ms(lib), "library_cuda_ms": cuda_ms(lib, 10),
           "library": "autograd of scaled_dot_product_attention"}
    for kname, fn, plain, pairs_err, flops_per, writes in (
            ("flash_bwd_dkdv", att.flash_bwd_dkdv_cuda, att.flash_bwd_dkdv_plain,
             ((dk, rk), (dv, rv)), 8, 2 * B * H * T * D * es),
            ("flash_bwd_dq", att.flash_bwd_dq_cuda, att.flash_bwd_dq_plain,
             ((dq, rq),), 6, B * H * T * D * es)):
        err, rel = errs(pairs_err)
        # a second launch on the same inputs must give the same bits: each
        # gradient element is summed by one thread in a fixed order
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        bitwise = all(torch.equal(a, b) for a, (b, _) in zip(again, pairs_err))
        flops, nbytes = flops_per * D * pairs, reads + writes
        b_ms, b_by = bound(flops, nbytes, dname)
        rec[kname] = {"max_abs_err": err, "rel_err": rel, "bitwise_repeat": bitwise,
                      "ms": device_ms(lambda: fn(*args)), "cuda_ms": cuda_ms(lambda: fn(*args), 20),
                      "plain_ms": cuda_ms(lambda: plain(*args), 5),
                      "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
    emit(rec)
    return rec


def det_case(name, B, Tq, L, q_pos, paged, H=HEADS, d=D_MODEL // HEADS, page=16):
    """D1 against its plain version, with K/V laid out as the decode
    program hands them over: [B, L, H, d] rows seen as [B, H, L, d]
    strided views, gathered from a page pool through a shuffled page table
    when ``paged`` (prefill and step), else one projection's output
    (re-encode).  Query row i of batch b sits at position ``q_pos[b][i]``
    and sees keys 0..q_pos; a one-row case takes the step's [B, 1, 1, L]
    bias.  Returns its record."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import kv_cache as kvc

    rng = np.random.default_rng(SEED + 20)
    dev = torch.device("cuda")
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
    q = rand(B, H, Tq, d)
    if paged:
        pps = L // page
        table = torch.from_numpy(1 + rng.permutation(B * pps).reshape(B, pps)).to(dev)
        k, v = (kvc.gather_layer(rand(1, 1 + B * pps, page, H, d), 0, table).transpose(1, 2)
                for _ in range(2))
    else:
        k, v = (rand(B, L, H, d).transpose(1, 2) for _ in range(2))
    pos = torch.as_tensor(q_pos, device=dev)                        # [B, Tq]
    vis = torch.arange(L, device=dev)[None, None, :] <= pos[..., None]
    bias = torch.where(vis, 0.0, kvc.NEG_INF).float()
    bias = bias[:, None, None, 0] if Tq == 1 else bias[:, None]     # [B, 1, Tq, L]
    out = kvc.det_attention_cuda(q, k, v, bias)
    torch.cuda.synchronize()
    err = float((out - kvc.det_attention_plain(q, k, v, bias)).abs().max())
    plain_ms = cuda_ms(lambda: kvc.det_attention_plain(q, k, v, bias), 5)
    times = timed(lambda: kvc.det_attention_cuda(q, k, v, bias),
                  lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
    pairs = float(vis.sum()) * H
    flops = 4.0 * d * pairs
    # q and out once, the bias once, and only the K/V rows some query of
    # the batch entry sees: the kernel skips masked keys' rows
    keys = float(vis.any(dim=1).sum())
    nbytes = 4 * (2 * q.numel() + bias.numel() + 2 * keys * H * d)
    b_ms, b_by = bound(flops, nbytes, "float32")
    rec = {"phase": "kernel", "case": "det_" + name, "shape": [B, H, Tq, L, d],
           "kv_layout": "paged" if paged else "strided", "bias_shape": list(bias.shape),
           "max_abs_err": err, "launch": "split-key" if Tq <= kvc.SPLIT_ROWS else "tiled",
           **times, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
    emit(rec)
    return rec


def phase_kernel():
    import torch
    # O: max abs error, and its norm relative to the plain O's (a wrong
    # scale or mask moves every row, not only the largest |O|); the LSE
    # is f32 from the same inputs in either dtype
    tol = {"float32": 2e-5, "bfloat16": 2e-2}
    rel_tol = {"float32": 1e-5, "bfloat16": 1e-2}
    # [4, 12, 1024, 64] first (the kernels line reports it), then the
    # train phase's B = 8
    recs = [flash_case("f32", torch.float32, 0.0),
            flash_case("f32_train", torch.float32, 0.0, B=8),
            flash_case("bf16", torch.bfloat16, 0.0),
            flash_case("f32_kmask", torch.float32, 0.25)]
    bad = [r["case"] for r in recs
           if not (r["max_abs_err"] <= tol[r["dtype"]]
                   and r["rel_err"] <= rel_tol[r["dtype"]]
                   and r["lse_max_abs_err"] <= 2e-5)]
    # the train phase's shape [8, 12, 1024, 64] first (the kernels line
    # reports it), then bf16 and a key mask at [4, 12, 1024, 64]
    bwd = [flash_bwd_case("f32_train", torch.float32, 0.0, B=8),
           flash_bwd_case("f32", torch.float32, 0.0),
           flash_bwd_case("bf16", torch.bfloat16, 0.0),
           flash_bwd_case("f32_kmask", torch.float32, 0.25)]
    bad += [f"{r['case']}/{kn}" for r in bwd for kn in ("flash_bwd_dkdv", "flash_bwd_dq")
            if not (r[kn]["max_abs_err"] <= tol[r["dtype"]]
                    and r[kn]["rel_err"] <= rel_tol[r["dtype"]]
                    and r[kn]["bitwise_repeat"])]
    # decode attention at the serve phase's shapes and layouts: a 4-slot
    # step at positions spread over the cache, a 512-token prefill into
    # L = 1024, and a re-encode of 544 tokens (512 + 32)
    det = [det_case("step", 4, 1, MAX_LEN, [[15], [300], [700], [MAX_LEN - 1]], True),
           det_case("prefill", 1, 512, MAX_LEN, [list(range(512))], True),
           det_case("reencode", 1, 544, 544, [list(range(544))], False)]
    bad += [r["case"] for r in det if not r["max_abs_err"] <= 2e-5]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return recs[0], bwd[0], det[0]


def fused_update_case(net):
    """K4 on the model's real per-layer buffers (params and Adam moments
    after the train phase; gradients from a seeded generator): bitwise
    against its plain version; the kernel's time over every layer, the
    plain version's, the whole fused step's (concatenate, kernel, split)
    and ``torch.optim.Adam(fused=True).step`` on the same tensors."""
    import torch

    from deeplearning4j_tpu_torch.nn.updaters import _bias_corrections, tree_leaves
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    upd = net.conf.updater
    it = net._iter_tensor()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    bc1, bc2 = _bias_corrections(upd.beta1, upd.beta2, it)
    sc = torch.stack([upd.lr_at(it).float(), bc1, bc2])
    layers, grads = [], []
    for p, st in zip(net.params, net.opt_state):
        if not p:
            continue
        g = {k: 1e-3 * torch.randn(t.shape, device="cuda", generator=gen)
             for k, t in p.items()}
        grads.append((p, g, st))
        flat = lambda tree: torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])
        layers.append((flat(p), flat(g), flat(st["m"]), flat(st["v"])))
    hp = (upd.beta1, upd.beta2, upd.eps)
    bitwise = True
    for buf in layers:
        a = uk.fused_update_cuda("adam", *buf, sc, *hp)
        b = uk.fused_update_plain("adam", *buf, sc, *hp)
        bitwise = bitwise and all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    ms = cuda_ms(lambda: [uk.fused_update_cuda("adam", *buf, sc, *hp) for buf in layers], 10)
    plain_ms = cuda_ms(lambda: [uk.fused_update_plain("adam", *buf, sc, *hp)
                                for buf in layers], 5)
    os.environ[uk.ENV_SWITCH] = "1"
    apply_ms = cuda_ms(lambda: [uk.fused_apply("adam", upd, p, g, st, it)
                                for p, g, st in grads], 5)
    # the library's fused Adam on per-tensor copies, timed only
    tensors = [t.detach().clone() for p, _, _ in grads for t in tree_leaves(p)]
    for t, gr in zip(tensors, [x for _, g, _ in grads for x in tree_leaves(g)]):
        t.grad = gr
    opt = torch.optim.Adam(tensors, lr=3e-4, fused=True)
    library_ms = cuda_ms(opt.step, 10)
    n = sum(buf[0].numel() for buf in layers)
    b_ms, b_by = bound(12.0 * n, 28.0 * n, "float32")
    rec = {"phase": "kernel", "case": "fused_update", "elements": n, "layers": len(layers),
           "bitwise": bitwise, "max_abs_err": 0.0 if bitwise else None, "ms": ms,
           "plain_ms": plain_ms, "apply_ms": apply_ms, "library_ms": library_ms,
           "library": "torch.optim.Adam(fused=True).step", "bound_ms": b_ms,
           "bound_by": b_by, "bytes": 28.0 * n}
    emit(rec)
    if not bitwise:
        raise AssertionError("K4 does not match its plain version bitwise")
    return rec


# the counted operations of one (row, unit) of the LSTM cell, a
# transcendental as one: 3 sigmoids (4 each), 2 tanhs, c' (3), h' (1);
# the backward recomputes them and adds 22 products and differences
LSTM_FWD_OPS, LSTM_BWD_OPS = 18, 40
RNN_VOCAB, RNN_HIDDEN, RNN_B, RNN_T, RNN_TBPTT = 96, 256, 64, 100, 50


def lstm_case(mb, n, dtype):
    """K5b against its plain version, and K5a through one step of the
    sequence (T = 1, h0 = 0, b = 0, so z = zx exactly) against the plain
    cell, on one input set; returns its record.  K5b's times are device
    times (``device_ms``): one launch takes a few microseconds on the card
    and tens on the host, so a launch timed alone (``launch_ms``) reads the
    host's enqueue.  z ~ N(0, 1), c ~ N(0, 0.25), dh and dc' ~ N(0, 0.01),
    a trained cell's ranges.  bf16 is held against the plain version
    evaluated in f32 on the same bf16 inputs, element by element in units
    of one bf16 spacing (2^-7 of the value, plus 1e-6): the kernels round
    each result once, so each is within half a spacing; the bf16 plain
    version rounds after every op (its gap is printed too).  The library's
    ``_thnn_fused_lstm_cell_backward_impl`` (gate order [i|f|g|o], columns
    permuted before timing) is a yardstick only."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

    rng = np.random.default_rng(SEED + 40 + mb + n)
    dev = torch.device("cuda")
    t = lambda shape, sd: torch.from_numpy(sd * rng.standard_normal(shape, dtype=np.float32))
    z, c, dh, dcn = (x.to(dev, dtype) for x in (t((mb, 4 * n), 1.0), t((mb, n), 0.5),
                                                 t((mb, n), 0.1), t((mb, n), 0.1)))
    rw = t((n, 4 * n), 1.0).to(dev, dtype)
    zeros = torch.zeros(mb, n, device=dev, dtype=dtype)
    hs, _, _, _, c_new = lk.lstm_seq_fwd_cuda(z[:, None].contiguous(), rw,
                                              torch.zeros(4 * n, device=dev, dtype=dtype),
                                              zeros, c)
    got = [hs[:, 0], c_new] + list(lk.lstm_cell_bwd_cuda(z, c, dh, dcn))
    torch.cuda.synchronize()
    f32 = lambda *ts: [x.float() for x in ts]
    want = lk.lstm_cell_plain(*f32(z, c)) + lk.lstm_cell_bwd_plain(*f32(z, c, dh, dcn))
    same = lk.lstm_cell_plain(z, c) + lk.lstm_cell_bwd_plain(z, c, dh, dcn)
    err = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
    spacings = [float(((a.float() - w).abs() / (2.0 ** -7 * w.abs() + 1e-6)).max())
                for a, w in zip(got, want)]
    err_same = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, same)]
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    rec = {"phase": "kernel", "case": f"lstm_cell_{mb}x{n}_{dname}", "shape": [mb, n],
           "dtype": dname, "library": "aten._thnn_fused_lstm_cell_backward_impl",
           "lstm_seq_t1": {"max_abs_err": max(err[:2]),
                           "max_err_bf16_spacings": max(spacings[:2]),
                           "max_abs_err_vs_same_dtype_plain": max(err_same[:2])}}
    # the library's cell: its gates [i|f|g|o], the hidden gates zero
    zl = torch.cat([z[:, :2 * n], z[:, 3 * n:], z[:, 2 * n:3 * n]], dim=1).contiguous()
    lib = getattr(torch.ops.aten, "_thnn_fused_lstm_cell", None)
    lib_bwd = None
    if lib is None:
        rec["library_error"] = "this torch has no aten._thnn_fused_lstm_cell"
    else:
        try:
            hy, cy, ws = lib(zl, torch.zeros_like(zl), c)
            lib_bwd = lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
                dh, dcn, c, cy, ws, False)
            lib_bwd()
        except RuntimeError as e:        # a yardstick only: its absence is recorded
            lib_bwd = None
            rec["library_error"] = str(e).splitlines()[0]
    es = z.element_size()
    fn = lambda: lk.lstm_cell_bwd_cuda(z, c, dh, dcn)
    b_ms, b_by = bound(float(LSTM_BWD_OPS * mb * n), float(12 * mb * n * es), "float32")
    rec["lstm_cell_bwd"] = {
        "max_abs_err": max(err[2:]), "max_err_bf16_spacings": max(spacings[2:]),
        "max_abs_err_vs_same_dtype_plain": max(err_same[2:]),
        "ms": device_ms(fn), "plain_ms": device_ms(lambda: lk.lstm_cell_bwd_plain(z, c, dh, dcn)),
        "library_ms": None if lib_bwd is None else device_ms(lib_bwd),
        "launch_ms": cuda_ms(fn, 20), "bound_ms": b_ms, "bound_by": b_by,
        "bytes": 12 * mb * n * es}
    emit(rec)
    return rec


def lstm_seq_inputs(mb, t_len, n, dtype, seed):
    """zx ~ N(0, 1) [mb, T, 4n], RW ~ N(0, 1/n), b ~ N(0, 0.01), h0 and c0
    ~ N(0, 0.25) and a 0/1 mask [mb, T] (first step kept), on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda shape, sd: torch.from_numpy(sd * rng.standard_normal(shape, dtype=np.float32))
    ins = [t((mb, t_len, 4 * n), 1.0), t((n, 4 * n), 1.0 / math.sqrt(n)), t((4 * n,), 0.1),
           t((mb, n), 0.5), t((mb, n), 0.5)]
    mask = (rng.random((mb, t_len)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return [x.to("cuda", dtype) for x in ins], torch.from_numpy(mask).to("cuda")


def cudnn_layer(W, RW, b):
    """``torch.nn.LSTM`` (cuDNN) holding one port LSTM layer's weights: its
    gates [i|f|g|o], W_ih = Wᵀ, W_hh = RWᵀ, b_ih = b, b_hh = 0."""
    import torch

    n = RW.shape[0]
    perm = torch.cat([torch.arange(0, 2 * n), torch.arange(3 * n, 4 * n),
                      torch.arange(2 * n, 3 * n)]).to(W.device)
    lstm = torch.nn.LSTM(W.shape[0], n, batch_first=True).to(W.device, W.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(W[:, perm].t())
        lstm.weight_hh_l0.copy_(RW[:, perm].t())
        lstm.bias_ih_l0.copy_(b[perm])
        lstm.bias_hh_l0.zero_()
    return lstm


def lstm_seq_case(mb, t_len, n, dtype, masked=False, reverse=False, timed=False):
    """K5a over a whole sequence against the plain per-step loop evaluated
    in f32 on the same inputs (and, for bf16, the plain loop in bf16, whose
    gap is printed); a second launch must be bitwise the first.  With
    ``timed``: device times of the kernel and the plain loop, its bound,
    and (f32) the layer forward, x @ W then K5a on a dense [mb, T, n] input,
    against cuDNN's LSTM holding the same weights, the yardstick."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

    ins, mask = lstm_seq_inputs(mb, t_len, n, dtype, SEED + 70 + mb + t_len + n)
    mask = mask if masked else None
    got = lk.lstm_seq_fwd_cuda(*ins, mask, reverse)
    plan = lk.lstm_seq_fwd_cuda.plan
    again = lk.lstm_seq_fwd_cuda(*ins, mask, reverse)
    torch.cuda.synchronize()
    want = lk.lstm_seq_fwd_plain(*(x.float() for x in ins), mask, reverse)
    names = ("hs", "z", "c", "h_last", "c_last")
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    atol, rtol = (2e-5, 1e-5) if dtype == torch.float32 else (2e-2, 1e-2)
    errs, ok = {}, all(torch.equal(a, b) for a, b in zip(got, again))
    bitwise = ok
    for name, a, w in zip(names, got, want):
        d = (a.float() - w).abs()
        limit = (torch.full_like(w, atol) if dtype == torch.float32
                 else torch.clamp(2.0 ** -7 * w.abs(), min=atol))
        errs[name] = {"max_abs_err": float(d.max()),
                      "rel_err": float(d.norm() / w.norm().clamp_min(1e-30))}
        ok = ok and bool((d <= limit).all()) and errs[name]["rel_err"] <= rtol
    rec = {"phase": "kernel",
           "case": f"lstm_seq_{mb}x{t_len}x{n}_{dname}{'_masked' if masked else ''}"
                   f"{'_reverse' if reverse else ''}",
           "shape": [mb, t_len, n], "dtype": dname, "masked": masked, "reverse": reverse,
           "grid": plan[0], "rw_resident": plan[1], "errors": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "rel_err": max(e["rel_err"] for e in errs.values()),
           "bitwise_second_launch": bitwise, "ok": ok}
    if dtype != torch.float32:
        same = lk.lstm_seq_fwd_plain(*ins, mask, reverse)
        rec["max_abs_err_of_the_bf16_plain_vs_f32"] = max(
            float((s.float() - w).abs().max()) for s, w in zip(same, want))
    if timed:
        es = ins[0].element_size()
        cells = mb * t_len * n
        flops = 2.0 * cells * 4 * n + (LSTM_FWD_OPS + 8) * cells
        nbytes = es * (4 * n * n + 4 * n + 4 * mb * n + 2 * 4 * cells + 2 * cells) + (
            4 * mb * t_len if masked else 0)
        rec["bound_ms"], rec["bound_by"] = bound(flops, float(nbytes), dname)
        rec["flops"], rec["bytes"] = flops, nbytes
        kernel = lambda: lk.lstm_seq_fwd_cuda(*ins, mask, reverse)
        rec["ms"] = device_ms(kernel)
        rec["cuda_ms"] = cuda_ms(kernel, 20)
        # one call: the loop's ~14 launches a step fill the card's queue of
        # pending launches (about a thousand), which would block the enqueue
        rec["plain_ms"] = device_ms(lambda: lk.lstm_sequence_plain(*ins, mask, reverse),
                                    iters=1)
        rec["library_ms"] = None
        if dtype == torch.float32 and not masked and not reverse:
            # layer 2's forward: x [mb, T, n] (layer 1's output, in (-1, 1)) @ W,
            # then K5a
            rng = np.random.default_rng(SEED + 71)
            x = torch.from_numpy(np.tanh(rng.standard_normal((mb, t_len, n), dtype=np.float32)))
            W = torch.from_numpy(rng.standard_normal((n, 4 * n), dtype=np.float32) / math.sqrt(n))
            x, W = x.to("cuda"), W.to("cuda")
            RW, b, h0, c0 = ins[1:]
            lstm = cudnn_layer(W, RW, b)
            with torch.no_grad():
                lib = lambda: lstm(x, (h0[None], c0[None]))
                layer = lambda: lk.lstm_seq_fwd_cuda(x @ W, RW, b, h0, c0)
                ours, theirs = layer()[0], lib()[0]
                rec["library"] = "torch.nn.LSTM (cuDNN), the whole layer forward"
                rec["library_max_abs_err"] = float((ours - theirs).abs().max())
                rec["layer_ms"] = device_ms(layer)
                rec["library_ms"] = device_ms(lib, iters=2)   # cuDNN launches per step
                rec["library_cuda_ms"] = cuda_ms(lib, 20)
    emit(rec)
    return rec


def phase_kernel_lstm():
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    # K5a over sequences: the char-RNN's chunk first (the kernels line
    # reports it), then a wider layer, ragged rows, the stream's step,
    # n % 4 != 0, masks, reverse, more tiles than the card holds at once
    # (RW streamed from L2), bf16
    seqs = [lstm_seq_case(RNN_B, RNN_TBPTT, RNN_HIDDEN, f32, timed=True),
            lstm_seq_case(RNN_B, RNN_TBPTT, RNN_HIDDEN, bf16, timed=True),
            lstm_seq_case(1, 1, RNN_HIDDEN, f32, timed=True),
            lstm_seq_case(1, 1, RNN_HIDDEN, bf16),
            lstm_seq_case(RNN_B, 2 * RNN_TBPTT, 512, f32),
            lstm_seq_case(7, 13, RNN_HIDDEN, f32),
            lstm_seq_case(5, 9, 255, f32),
            lstm_seq_case(RNN_B, RNN_TBPTT, RNN_HIDDEN, f32, masked=True),
            lstm_seq_case(RNN_B, RNN_TBPTT, RNN_HIDDEN, f32, reverse=True),
            lstm_seq_case(7, 13, 255, f32, masked=True, reverse=True),
            lstm_seq_case(7, 13, 255, bf16, masked=True, reverse=True),
            lstm_seq_case(2048, 3, RNN_HIDDEN, f32)]
    # f32: 2e-6 max abs (the same rounded ops; expf/tanhf may differ in the
    # last bit); bf16: every element within one bf16 spacing
    ok = {"float32": lambda r: r["max_abs_err"] <= 2e-6,
          "bfloat16": lambda r: r["max_err_bf16_spacings"] <= 1.0}
    # the char-RNN's shape first (the kernels line reports it), then
    # n % 4 != 0 and a batch of many waves of K5b's blocks
    cells = [lstm_case(mb, n, dt) for dt in (f32, bf16)
             for mb, n in ((RNN_B, RNN_HIDDEN), (RNN_B, 512), (7, RNN_HIDDEN), (1, RNN_HIDDEN),
                           (RNN_B, 255), (3, 3), (4096, RNN_HIDDEN))]
    bad = [r["case"] for r in seqs if not r["ok"]]
    bad += [f"{r['case']}/{k}" for r in cells for k in ("lstm_seq_t1", "lstm_cell_bwd")
            if not ok[r["dtype"]](r[k])]
    if seqs[-1]["rw_resident"] or not seqs[0]["rw_resident"]:
        bad.append("K5a's layouts: RW must stay resident at the chunk's shape and be "
                   "streamed when the tiles outnumber the card")
    if bad:
        raise AssertionError(f"LSTM kernels disagree with their plain versions: {bad}")
    return {"lstm_seq_fwd": seqs[0], "lstm_cell_bwd": cells[0]["lstm_cell_bwd"]}


# -- K6: the one-pass threshold encode ------------------------------------------------

#: the fixed threshold of the compressed phase's arms (a) and (b): the
#: reference EncodingHandler's default
COMPRESS_T = 1e-3


def encode_input(n, kind, t=COMPRESS_T):
    """float32[n] on the card: "hot" has ~2% of its elements at |g| >= t
    (the JAX package's tests/test_fused_encode.py generator), "none" none,
    "exact_k" exactly k = n/16."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import compression as comp

    rng = np.random.default_rng(SEED + 60 + n)
    if kind == "exact_k":
        g = rng.uniform(-0.5, 0.5, size=n).astype(np.float32) * t
        hot = rng.choice(n, comp.default_k_max(n), replace=False)
        g[hot] = np.where(rng.random(hot.size) < 0.5, -1, 1) * t * (1 + rng.random(hot.size))
    else:
        g = rng.normal(size=n).astype(np.float32) * (t / 10)
        hot = rng.choice(n, max(1, int(n * 0.02)), replace=False)
        g[hot] = rng.normal(size=hot.size).astype(np.float32) * 10 * t
        if kind == "none":
            g *= 1e-3
    return torch.from_numpy(g.astype(np.float32)).to("cuda")


def encode_case(n, kind, t=COMPRESS_T):
    """K6 against its plain version ``_streaming_pack`` on one input,
    bitwise, with its selection count exact; device times (``device_ms``) of both and the bound (4n bytes
    read, 4k written).  The library yardstick is ``torch.nonzero`` of the
    selection plus the same pack, timed with CUDA events: ``nonzero``
    copies its size to the host, so the stream cannot be held for it."""
    import torch

    from deeplearning4j_tpu_torch.ops import compression as comp

    g = encode_input(n, kind, t)
    k = comp.default_k_max(n)
    got, got_count = comp.threshold_encode_cuda(g, k, t)
    want = comp._streaming_pack(g, g.abs(), k, t, n)
    torch.cuda.synchronize()
    count = int((g.abs() >= t).sum())
    bitwise = bool(torch.equal(got, want)) and int(got_count) == count

    def library():
        idx = torch.nonzero(g.abs() >= t).squeeze(1)
        out = torch.zeros(k, dtype=torch.int32, device=g.device)
        out[:idx.numel()] = torch.where(g[idx] >= 0, 1, -1).to(torch.int32) * (idx + 1).int()
        return out

    lib_ok = bool(torch.equal(library(), want))
    b_ms, b_by = bound(0.0, 4.0 * n + 4.0 * k, "float32")
    rec = {"phase": "kernel", "case": f"threshold_encode_{n}_{kind}", "kind": kind, "n": n,
           "k": k,
           "count": count, "bitwise": bitwise, "max_abs_err": 0.0 if bitwise else None,
           "library_matches": lib_ok,
           "ms": device_ms(lambda: comp.threshold_encode_cuda(g, k, t)),
           "plain_ms": device_ms(lambda: comp._streaming_pack(g, g.abs(), k, t, n)),
           "library_ms": cuda_ms(library, 20), "library": "torch.nonzero + pack",
           "launch_ms": cuda_ms(lambda: comp.threshold_encode_cuda(g, k, t), 20),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": 4.0 * n + 4.0 * k}
    emit(rec)
    return rec


#: the compressed phase's buckets: ``GradBucketer`` at 4 MiB over the
#: TransformerLM's 163,131,264 parameters (``main`` checks it on the model)
DP_BUCKET_SIZES = [1 << 20] * 155 + [601_984]


def step_gradient(sizes, t=COMPRESS_T, seed=SEED + 65, frac=0.02):
    """A flat f32 gradient over buckets of ``sizes`` on the card, ~``frac``
    of it at |g| >= t (the hot generator's distribution), drawn on the card
    from a generator seeded with ``seed``.  The card tests and
    ``scripts/encode_lstm_ab.py`` draw their gradients here too."""
    import torch

    dev = torch.device("cuda")
    n = sum(sizes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, device=dev, generator=gen) * (t / 10)
    hot = torch.rand(n, device=dev, generator=gen) < frac
    return torch.where(hot, torch.randn(n, device=dev, generator=gen) * (10 * t), g)


def encode_step_case(sizes, t=COMPRESS_T):
    """One K6 launch over a whole step's buckets (``sizes``: the compressed
    phase's layout) against its plain version on a 2%-hot gradient drawn
    on the card (``step_gradient``): bitwise, the counts exact, a
    second launch bitwise the first.  The launch's device time
    (``device_ms``), the plain version's by events, the bound (4 bytes per
    element read, 4 per slot written), and the yardstick: ``torch.nonzero`` of the
    selection over the flat buffer plus a pack of every bucket at once,
    timed with CUDA events (``nonzero`` copies its size to the host)."""
    import torch

    from deeplearning4j_tpu_torch.ops import compression as comp

    dev = torch.device("cuda")
    n = sum(sizes)
    g = step_gradient(sizes, t)
    ks = [comp.default_k_max(m) for m in sizes]
    kernel = lambda: comp.threshold_encode_buckets_cuda(g, sizes, ks, t)
    plain = lambda: comp.threshold_encode_buckets_plain(g, sizes, ks, t)
    got, counts = kernel()
    again, again_counts = kernel()
    want, want_counts = plain()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(got, want)) and bool(torch.equal(counts, want_counts))
    repeat = bool(torch.equal(again, got)) and bool(torch.equal(again_counts, counts))
    as_t = lambda xs: torch.tensor(xs, dtype=torch.int64, device=dev)
    starts, slots, caps = as_t(comp._prefix(sizes)), as_t(comp._prefix(ks)), as_t(ks)

    def library():
        idx = torch.nonzero(g.abs() >= t).squeeze(1)
        b = torch.searchsorted(starts, idx, right=True) - 1     # each selection's bucket
        slot = torch.arange(idx.numel(), device=dev) - torch.searchsorted(idx, starts)[b]
        keep = slot < caps[b]
        local = (idx - starts[b] + 1).to(torch.int32)
        out = torch.zeros(sum(ks), dtype=torch.int32, device=dev)
        out[(slots[b] + slot)[keep]] = torch.where(g[idx] >= 0, local, -local)[keep]
        return out

    lib_ok = bool(torch.equal(library(), want))
    nbytes = 4.0 * n + 4.0 * sum(ks)
    b_ms, b_by = bound(0.0, nbytes, "float32")
    rec = {"phase": "kernel", "case": "threshold_encode_step", "buckets": len(sizes),
           "n": n, "k_total": sum(ks), "count": int(counts.sum()),
           "bitwise": bitwise, "bitwise_repeat": repeat,
           "max_abs_err": 0.0 if bitwise else None, "library_matches": lib_ok,
           # the plain version launches ~2,000 kernels a call, whose enqueue
           # outlasts device_ms's sleep: it is timed with events
           "ms": device_ms(kernel), "plain_ms": cuda_ms(plain, 3), "plain_timing": "events",
           "library_ms": cuda_ms(library, 10),
           "library": "torch.nonzero + pack of every bucket",
           "launch_ms": cuda_ms(kernel, 20),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    emit(rec)
    return rec


def phase_kernel_encode(step_sizes):
    recs = [encode_case(n, kind) for n in (1 << 20, 1024, 4096, (1 << 20) + 333)
            for kind in ("hot", "none", "exact_k")]
    want = {"none": lambda r: 0, "exact_k": lambda r: r["k"], "hot": lambda r: r["count"]}
    bad = [r["case"] for r in recs if not r["bitwise"] or r["count"] != want[r["kind"]](r)]
    step = encode_step_case(step_sizes)
    if not (step["bitwise"] and step["bitwise_repeat"] and step["library_matches"]):
        bad.append(step["case"])
    if bad:
        raise AssertionError(f"K6 disagrees with its plain version: {bad}")
    return recs[0], step                # the 4 MiB bucket, 2% hot; the whole step


# -- the model ----------------------------------------------------------------------


def build_model():
    """The full-width TransformerLM on the card, weights from a numpy seed
    with GPT-2's initialisation: matrices N(0, 0.02), the two projections
    back into the residual stream (Wo, W2) N(0, 0.02/sqrt(2·layers)),
    positions N(0, 0.01), biases 0, layer-norm gains 1."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy

    net = TransformerLM(vocab_size=VOCAB, n_layers=LAYERS, d_model=D_MODEL,
                        n_heads=HEADS, d_ff=D_FF, max_len=MAX_LEN, device="cuda")
    rng = np.random.default_rng(SEED)
    tree = []
    for p in net.params:
        layer = {}
        for name, t in p.items():
            shape = tuple(t.shape)
            if name == "P":
                std = 0.01
            elif name in ("Wo", "W2"):
                std = 0.02 / math.sqrt(2 * LAYERS)
            elif len(shape) == 2:
                std = 0.02
            else:
                std = 0.0
            if name.startswith("ln") and name.endswith("_g"):
                a = np.ones(shape, np.float32)
            else:
                a = (std * rng.standard_normal(shape)).astype(np.float32)
            layer[name] = a
        tree.append(layer)
    net.params = params_from_numpy(tree, device="cuda")
    return net


# -- score phase --------------------------------------------------------------------


def phase_score(net):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import attention as att

    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, VOCAB, (4, MAX_LEN))
    net.output(tokens[:1, :64])               # warm the allocator and cuBLAS
    torch.cuda.synchronize()

    att.flash_forward_cuda.launches = 0
    t0 = time.perf_counter()
    y = net.output(tokens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"flash_fwd": att.flash_forward_cuda.launches}
    if launches["flash_fwd"] < 1:
        raise AssertionError("output() did not launch the flash kernel")
    if tuple(y.shape) != (4, MAX_LEN, VOCAB) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"bad output {tuple(y.shape)}")
    row_sum_err = float((y.sum(-1) - 1).abs().max())
    del y
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]

    # the same weights on the CPU at a smaller cut
    cut = tokens[:1, :256]
    y_gpu = net.output(cut).cpu()
    cpu = MultiLayerNetwork(net.conf, device="cpu")
    cpu.params = [{k: v.cpu() for k, v in p.items()} for p in net.params]
    cpu.state = [{} for _ in net.params]
    y_cpu = cpu.output(cut)
    dp = float((y_gpu - y_cpu).abs().max())
    dlogp = float((y_gpu.clamp_min(1e-30).log()
                   - y_cpu.clamp_min(1e-30).log()).abs().max())
    rec = {"phase": "score", "batch": [4, MAX_LEN], "launches": launches,
           "first_call_s": first_s, "median_s": med,
           "tokens_per_s": 4 * MAX_LEN / med, "row_sum_max_err": row_sum_err,
           "cpu_cut": [1, 256], "cpu_max_abs_prob_diff": dp,
           "cpu_max_abs_logprob_diff": dlogp, "tolerance_prob": 1e-5,
           "tolerance_logprob": 1e-4}
    emit(rec)
    # log-probabilities too: at vocab 50304 a typical probability is
    # ~2e-5, so the probability limit alone would miss a small shift
    if not (row_sum_err <= 1e-3 and dp <= 1e-5 and dlogp <= 1e-4):
        raise AssertionError("score phase disagrees with the CPU run or is "
                             "not a distribution")
    return rec


# -- serve phase ----------------------------------------------------------------------


def phase_serve(net):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    from deeplearning4j_tpu_torch.ops import kv_cache as kvc

    adapter = TransformerDecodeAdapter(net)
    eng = DecodeEngine(adapter, max_slots=4, page_size=16, max_len=MAX_LEN,
                       device="cuda").load()
    rng = np.random.default_rng(SEED + 2)
    lens = [16, 48, 96, 160, 256, 352, 448, 512]
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in lens]
    kws = [dict(temperature=0.0) if i % 2 == 0 else
           dict(temperature=0.8, top_k=50, seed=1000 + i) for i in range(len(lens))]
    try:
        kvc.det_attention_cuda.launches = 0
        t0 = time.perf_counter()
        futs = [eng.generate_async(p, max_new_tokens=32, echo_logits=True, **kw)
                for p, kw in zip(prompts, kws)]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {"det_attention": kvc.det_attention_cuda.launches}
        deadline = time.monotonic() + 5
        while eng.metrics.gauge("pages_in_use") and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = eng.metrics_snapshot()
    finally:
        eng.shutdown()

    prog = eng.program
    greedy_ok, max_diff, bitwise, k1_dlogp = True, 0.0, True, 0.0
    with torch.inference_mode():
        for p, kw, r in zip(prompts, kws, results):
            seq = torch.tensor([p + r.tokens[:-1]], device="cuda")
            ref = prog.reencode(eng.params, seq)[0, len(p) - 1:].float().cpu().numpy()
            max_diff = max(max_diff, float(np.abs(ref - r.logits).max()))
            bitwise = bitwise and bool(np.array_equal(ref, r.logits))
            if kw["temperature"] == 0.0:
                greedy_ok = greedy_ok and ref.argmax(-1).tolist() == r.tokens
            # the re-encode shares D1 and per_row with decode; output()
            # (K1, whole-sequence GEMMs) shares neither
            logp = torch.log_softmax(torch.as_tensor(r.logits), -1)
            k1 = net.output(seq)[0, len(p) - 1:].cpu().clamp_min(1e-30).log()
            k1_dlogp = max(k1_dlogp, float((logp - k1).abs().max()))
    n_tok = sum(len(r.tokens) for r in results)
    rec = {"phase": "serve", "requests": len(results), "prompt_lens": lens,
           "launches": launches,
           "tokens": n_tok, "finish": sorted({r.finish_reason for r in results}),
           "pages_in_use_after": snap["pages_in_use"],
           "greedy_equals_reencode_argmax": greedy_ok,
           "decode_vs_reencode_max_abs_diff": max_diff,
           "decode_vs_reencode_bitwise": bitwise,
           "decode_vs_output_max_abs_logprob_diff": k1_dlogp,
           "tolerance_output_logprob": 1e-4,
           "ttft_p50_ms": snap["ttft_ms"]["p50_ms"],
           "ttft_p99_ms": snap["ttft_ms"]["p99_ms"],
           "tpot_p50_ms": snap["tpot_ms"]["p50_ms"],
           "tpot_p99_ms": snap["tpot_ms"]["p99_ms"],
           "decode_step_p50_ms": snap["decode_step_ms"]["p50_ms"],
           "wall_s": wall, "tokens_per_s": n_tok / wall}
    emit(rec)
    # the reference's contract: decode logits are bitwise the re-encode's;
    # and both agree with output() as f32 sums in another order do (the
    # score phase's log-probability limit)
    if not (len(results) == 8 and greedy_ok and bitwise and k1_dlogp <= 1e-4
            and snap["pages_in_use"] == 0
            and launches["det_attention"] > 0
            and all(len(r.tokens) == 32 for r in results)):
        raise AssertionError("serve phase failed")
    return rec


# -- train phase -------------------------------------------------------------------


def phase_train(net):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import normalize_gradients, tree_leaves
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    os.environ[uk.ENV_SWITCH] = "1"
    conf = net.conf
    rng = np.random.default_rng(SEED + 3)
    seq = rng.integers(0, VOCAB, (8, MAX_LEN + 1))
    dev = torch.device("cuda")
    ds = DataSet(torch.from_numpy(seq[:, :-1]).to(dev), torch.from_numpy(seq[:, 1:]).to(dev))

    # one step's loss and clipped gradients, card against CPU, same weights, at a cut
    cut = DataSet(seq[:1, :128], seq[:1, 1:129])
    cpu = MultiLayerNetwork(conf, device="cpu")
    cpu.params = [{k: v.cpu() for k, v in p.items()} for p in net.params]
    cpu.state = [{} for _ in net.params]
    clipped = []
    for m in (net, cpu):
        loss, grads, _ = m._loss_and_grads(cut)
        clipped.append((float(loss), [
            [t.cpu() for t in tree_leaves(normalize_gradients(
                g, conf.gradient_normalization, conf.gradient_normalization_threshold))]
            for g, p in zip(grads, m.params) if p]))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = clipped
    grad_rel = max(float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(lg, lc)))
                         / torch.sqrt(sum((b ** 2).sum() for b in lc)).clamp_min(1e-30))
                   for lg, lc in zip(g_gpu, g_cpu))
    grad_abs = max(float((a - b).abs().max()) for lg, lc in zip(g_gpu, g_cpu)
                   for a, b in zip(lg, lc))
    del cpu, clipped, g_gpu, g_cpu

    counters = (att.flash_forward_cuda, att.flash_bwd_dkdv_cuda, att.flash_bwd_dq_cuda,
                uk.fused_update_cuda)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(net.fit_batch(ds))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(zip(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "fused_update"),
                        (c.launches for c in counters)))
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    med = sorted(times)[2]
    per_step = {k: v / 5 for k, v in launches.items()}
    want = {"flash_fwd": LAYERS, "flash_bwd_dkdv": LAYERS, "flash_bwd_dq": LAYERS,
            "fused_update": sum(1 for p in net.params if p)}
    rec = {"phase": "train", "batch": [8, MAX_LEN], "steps": 5, "losses": losses,
           "step_s": times, "median_step_s": med, "tokens_per_s": 8 * MAX_LEN / med,
           "peak_memory_gib": peak / 2 ** 30, "launches": launches,
           "launches_per_step": per_step, "launches_per_step_expected": want,
           "cpu_cut": [1, 128], "cpu_loss_abs_diff": abs(l_gpu - l_cpu),
           "cpu_clipped_grad_rel_diff": grad_rel, "cpu_clipped_grad_max_abs_diff": grad_abs,
           "tolerance_loss": 1e-4, "tolerance_grad_rel": 1e-4}
    emit(rec)
    finite = all(math.isfinite(x) for x in losses)
    falling = all(b < a for a, b in zip(losses, losses[1:]))
    # f32 sums in another order through 12 layers: 1e-4 on the loss and on
    # each layer's clipped gradient relative to its norm
    if not (finite and falling and per_step == want and abs(l_gpu - l_cpu) <= 1e-4
            and grad_rel <= 1e-4):
        raise AssertionError("train phase failed")
    return rec


# -- recurrent phase -------------------------------------------------------------------


def build_rnn(device, cell: str = "LSTM"):
    """Bench config 4's char-RNN (``bench.py``: ``TextGenerationLSTM`` at
    vocab 96 with Adam lr 1e-3) with ``cell`` layers, weights drawn from
    the configuration's seed, so every build starts from the same ones."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam, GradientNormalization

    conf = (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(lr=1e-3))
            .gradient_normalization(GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE, 1.0)
            .layer(getattr(L, cell)(n_out=RNN_HIDDEN)).layer(getattr(L, cell)(n_out=RNN_HIDDEN))
            .layer(L.RnnOutputLayer(n_out=RNN_VOCAB, activation="softmax", loss="mcxent"))
            .tbptt(RNN_TBPTT).set_input_type(InputType.recurrent(RNN_VOCAB)).build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net


def phase_recurrent():
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk
    from deeplearning4j_tpu_torch.ops import update_kernel as uk
    from deeplearning4j_tpu_torch.utils.serializer import load_model, save_model

    os.environ[uk.ENV_SWITCH] = "1"
    rng = np.random.default_rng(SEED + 50)
    seq = rng.integers(0, RNN_VOCAB, (RNN_B, RNN_T + 1)).astype(np.int32)
    dev = torch.device("cuda")
    ds = DataSet(torch.from_numpy(seq[:, :-1]).to(dev), torch.from_numpy(seq[:, 1:]).to(dev))
    counters = {"lstm_seq_fwd": lk.lstm_seq_fwd_cuda, "lstm_cell_bwd": lk.lstm_cell_bwd_cuda,
                "fused_update": uk.fused_update_cuda}

    def plain_loop(fn):
        """``fn()`` with the plain per-step loop patched in where the layers
        call the sequence: the A/B's other arm."""
        recurrent.lstm_sequence = lk.lstm_sequence_plain
        try:
            return fn()
        finally:
            recurrent.lstm_sequence = lk.lstm_sequence

    def call(net):
        """One fit_batch; the counts are set to 0 just before it and read
        just after."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = net.fit_batch(ds)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return float(loss), sec, {k: c.launches for k, c in counters.items()}

    # the two arms in turns, so drift on the host touches both alike
    arms = {"k5": build_rnn("cuda"), "plain_loop": build_rnn("cuda")}
    runs = {name: [] for name in arms}
    for _ in range(5):
        runs["k5"].append(call(arms["k5"]))
        runs["plain_loop"].append(plain_loop(lambda: call(arms["plain_loop"])))
    zoo = TextGenerationLSTM(vocab_size=RNN_VOCAB, updater=Adam(lr=1e-3), seed=SEED,
                             device="cuda")
    runs["zoo_graves"] = [call(zoo) for _ in range(5)]
    chunks = -(-RNN_T // RNN_TBPTT)
    # K5a once per layer and TBPTT chunk, K5b once per layer and step
    want = {"k5": {"lstm_seq_fwd": 2 * chunks, "lstm_cell_bwd": 2 * RNN_T,
                   "fused_update": 3 * chunks},
            "plain_loop": {"lstm_seq_fwd": 0, "lstm_cell_bwd": 0, "fused_update": 3 * chunks},
            "zoo_graves": {"lstm_seq_fwd": 0, "lstm_cell_bwd": 0, "fused_update": 3 * chunks}}
    arms_rec = {}
    for name, rs in runs.items():
        losses = [r[0] for r in rs]
        med = sorted(r[1] for r in rs)[2]
        arms_rec[name] = {"losses": losses, "fit_batch_s": [r[1] for r in rs],
                          "median_fit_batch_ms": med * 1e3,
                          "chars_per_s": RNN_B * RNN_T / med,
                          "launches_per_call": [r[2] for r in rs],
                          "launches_ok": all(r[2] == want[name] for r in rs),
                          "finite_and_falling": (all(math.isfinite(x) for x in losses)
                                                 and losses[-1] < losses[0])}
    arm_gap = max(abs(a[0] - b[0]) for a, b in zip(runs["k5"], runs["plain_loop"]))

    # one K5 call at [4, 100], card against the port on the CPU, same weights
    small = DataSet(seq[:4, :-1], seq[:4, 1:])
    pair = [build_rnn("cuda"), build_rnn("cpu")]
    cpu_losses = [float(m.fit_batch(small)) for m in pair]
    rel = max(float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
              for pa, pb in zip(pair[0].params, pair[1].params) for a, b in
              ((pa[k], pb[k]) for k in pa))

    # serve: the trained K5 net through a checkpoint and the CLI's path
    net = arms["k5"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "charrnn.zip")
        save_model(net, path)
        served = load_model(path, device="cuda")
    prompt = rng.integers(0, RNN_VOCAB, 16).tolist()
    stamps, streamed = [], []
    step_fn = served.rnn_time_step

    def timed_step(x):
        stamps.append(time.perf_counter())
        y = step_fn(x)
        streamed.append(y)
        return y

    served.rnn_time_step = timed_step
    cli.generate_recurrent(served, prompt, 4)          # warm the allocator and cuBLAS
    stamps.clear()
    streamed.clear()
    lk.lstm_seq_fwd_cuda.launches = 0
    toks = cli.generate_recurrent(served, prompt, 64)
    stamps.append(time.perf_counter())
    k5a_serve = lk.lstm_seq_fwd_cuda.launches
    del served.rnn_time_step
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:]))
    stream = torch.cat([streamed[0][0]] + streamed[1:], dim=0)   # [16 + 64, vocab]
    whole = np.asarray([prompt + toks], np.int32)
    full = served.output(whole)[0]
    stream_err = float((stream - full).abs().max())
    # the stream ran K5a at [1, 1, 256]; the plain loop is its independent check
    stream_plain_err = float((stream - plain_loop(lambda: served.output(whole))[0]).abs().max())
    greedy = [int(streamed[k][0, -1].argmax()) if k == 0 else int(streamed[k][0].argmax())
              for k in range(64)]
    rec = {"phase": "recurrent", "config": {"vocab": RNN_VOCAB, "layers": [RNN_HIDDEN] * 2,
                                            "batch": [RNN_B, RNN_T], "tbptt": RNN_TBPTT,
                                            "updater": "Adam(lr=1e-3)", "clip": 1.0},
           "arms": arms_rec, "arm_loss_max_abs_diff": arm_gap, "tolerance_arms": 1e-5,
           "cpu_cut": [4, RNN_T], "cpu_loss_abs_diff": abs(cpu_losses[0] - cpu_losses[1]),
           "cpu_param_rel_diff": rel, "tolerance_cpu": 1e-4,
           "serve": {"prompt": 16, "tokens": len(toks), "k5a_launches": k5a_serve,
                     "k5a_prompt_and_per_token": [2, (k5a_serve - 2) / len(toks)],
                     "prompt_ms": (stamps[1] - stamps[0]) * 1e3,
                     "token_ms_p50": gaps[len(gaps) // 2],
                     "token_ms_p99": gaps[min(len(gaps) - 1, int(0.99 * len(gaps)))],
                     "stream_vs_output_max_abs_diff": stream_err,
                     "stream_vs_plain_loop_output_max_abs_diff": stream_plain_err,
                     "greedy_is_stream_argmax": greedy == toks}}
    emit(rec)
    ok = (all(a["launches_ok"] and a["finite_and_falling"] for a in arms_rec.values())
          and arm_gap <= 1e-5 and abs(cpu_losses[0] - cpu_losses[1]) <= 1e-4 and rel <= 1e-4
          and len(toks) == 64 and k5a_serve == 2 + 2 * 64 and stream_err <= 1e-5
          and stream_plain_err <= 1e-5 and greedy == toks)
    if not ok:
        raise AssertionError("recurrent phase failed")
    return rec


# -- compressed phase ----------------------------------------------------------------

#: (arm, grad_compression, threshold, the top-k pack on every bucket)
COMPRESS_ARMS = (("a_one_pass", "threshold", COMPRESS_T, False),
                 ("b_top_k", "threshold", COMPRESS_T, True),
                 ("c_adaptive", "threshold", None, False),
                 ("d_dense", None, None, False))
COMPRESS_STEPS = 5


def top_k_only(g, sizes, ks, t, out=None):
    """Stands in for ``ops.compression.one_pass_pack`` in arm (b): reports
    every bucket as overflowing, so the top-k pack encodes all of them."""
    import torch
    return out, torch.tensor([k + 1 for k in ks], device=g.device)


def gloo_host_copies(words: int, group) -> dict:
    """Memory copies between the card and the host in a ``torch.profiler``
    trace of one all-gather of a ``words``-long int32 CUDA buffer over
    ``group`` (a collective: every rank of it calls this)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import compression as comp

    wire = torch.zeros(words, dtype=torch.int32, device="cuda")
    comp.all_gather_stack(wire, group)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        comp.all_gather_stack(wire, group)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_to_host": sum("DtoH" in n for n in names),
            "host_to_device": sum("HtoD" in n for n in names),
            "device_events": len(names)}


def fingerprint(params):
    """Two int64 sums over the f32 bit patterns of every parameter: of the
    bits, and of the bits times their 1-based position, modulo 2^64.  The
    sums are exact integer arithmetic, so equal parameters give equal
    fingerprints whatever the order of the sums; two that differ in any
    bit give equal ones with negligible chance."""
    import torch

    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves

    flat = torch.cat([t.reshape(-1).float() for p in params for t in tree_leaves(p)])
    bits = flat.view(torch.int32).to(torch.int64)
    pos = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
    return [int(bits.sum()), int((bits * pos).sum())]


def compressed_rank(rank: int, work: str) -> None:
    """One rank of the compressed phase (``--compressed-rank R DIR``): the
    four arms in turn, each from the same weights; writes DIR/rankR.json."""
    import gc
    import statistics

    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import compression as comp
    from deeplearning4j_tpu_torch.ops import update_kernel as uk
    from deeplearning4j_tpu_torch.parallel import (ShardedTrainer, build_two_tier_mesh,
                                                   initialize, shutdown)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=600)
    os.environ[uk.ENV_SWITCH] = "1"
    seq = np.random.default_rng(SEED + 70).integers(0, VOCAB, (8, MAX_LEN + 1))
    dev = torch.device("cuda")
    ds = DataSet(torch.from_numpy(seq[:, :-1]).to(dev), torch.from_numpy(seq[:, 1:]).to(dev))
    counters = {"flash_fwd": att.flash_forward_cuda, "flash_bwd_dkdv": att.flash_bwd_dkdv_cuda,
                "flash_bwd_dq": att.flash_bwd_dq_cuda, "fused_update": uk.fused_update_cuda,
                "threshold_encode": comp.threshold_encode_cuda,
                "threshold_encode_buckets": comp.threshold_encode_buckets_cuda}
    out = {"rank": rank, "arms": {}}
    one_pass = comp.one_pass_pack
    for name, method, t, top_k in COMPRESS_ARMS:
        comp.one_pass_pack = top_k_only if top_k else one_pass
        net = build_model()
        trainer = ShardedTrainer(net, build_two_tier_mesh(2, {"data": 1}),
                                 grad_compression=method, compression_threshold=t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        steps = []
        for _ in range(COMPRESS_STEPS):
            before = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            loss = float(trainer.fit_batch(ds))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = [] if top_k else trainer.last_bucket_counts
            ratios = sorted(c / k for c, k in counts)
            steps.append({"loss": loss, "ms": ms, "fingerprint": fingerprint(net.params),
                          "launches": {k: c.launches - before[k] for k, c in counters.items()},
                          "wire_bytes": trainer.wire_bytes_last_step,
                          "buckets_fit": sum(c <= k for c, k in counts),
                          "buckets_overflow": sum(c > k for c, k in counts),
                          "count_over_k_min_median_max": (
                              [ratios[0], statistics.median(ratios), ratios[-1]]
                              if ratios else None)})
        out["arms"][name] = {
            "grad_compression": method, "threshold": t, "top_k_only": top_k,
            "steps": steps, "launches": {k: c.launches for k, c in counters.items()},
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "n_params": trainer.bucketer.total, "n_buckets": trainer.bucketer.n_buckets}
        if name == "a_one_pass":
            out["gloo_host_copies"] = gloo_host_copies(
                trainer.wire_bytes_last_step // 4, trainer.mesh.group(trainer.dcn_axis))
        del trainer, net
        gc.collect()
        torch.cuda.empty_cache()
    comp.one_pass_pack = one_pass
    shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_compressed():
    import statistics
    import tempfile

    from deeplearning4j_tpu_torch.ops import compression as comp

    with tempfile.TemporaryDirectory() as work:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--compressed-rank", str(r), work]) for r in range(2)]
        try:
            deadline = time.monotonic() + 900
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        if rcs != [0, 0]:
            raise AssertionError(f"compressed phase: a rank failed (exit codes {rcs})")
        ranks = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))

    arms, bad = {}, []
    a0 = ranks[0]["arms"]
    want_kernels = {"flash_fwd": LAYERS, "flash_bwd_dkdv": LAYERS, "flash_bwd_dq": LAYERS,
                    "fused_update": LAYERS + 3}
    for name, method, t, _ in COMPRESS_ARMS:
        steps = [rk["arms"][name]["steps"] for rk in ranks]
        losses = [s["loss"] for s in steps[0]]
        n = a0[name]["n_params"]
        stats = comp.compression_stats(n, method or "threshold", 2)
        rec = {"grad_compression": method, "threshold": t, "losses": losses,
               "step_ms": [s["ms"] for s in steps[0]],
               "median_step_ms": statistics.median(s["ms"] for s in steps[0]),
               "peak_memory_gib_per_rank": [rk["arms"][name]["peak_memory_gib"] for rk in ranks],
               "launches_per_step": [s["launches"] for s in steps[0]],
               "ranks_bitwise_equal": all(x["fingerprint"] == y["fingerprint"]
                                          and x["loss"] == y["loss"]
                                          for x, y in zip(*steps)),
               "finite_and_falling": (all(math.isfinite(x) for x in losses)
                                      and losses[-1] < losses[0])}
        if method is not None:
            wire = [s["wire_bytes"] for s in steps[0]]
            rec.update(wire_bytes_per_step=wire,
                       compression_stats_wire_bytes=stats["compressed_wire_bytes_per_step"],
                       wire_ratio_vs_dense=stats["dense_wire_bytes_per_step"] / max(wire),
                       n_buckets=a0[name]["n_buckets"])
            if any(w != stats["compressed_wire_bytes_per_step"] for w in wire) \
                    or rec["wire_ratio_vs_dense"] < 8.0:
                bad.append(f"{name}: wire bytes")
        if t is not None and name.startswith("a_"):
            rec["buckets_k6_kept_per_step"] = [s["buckets_fit"] for s in steps[0]]
            rec["buckets_overflow_per_step"] = [s["buckets_overflow"] for s in steps[0]]
            rec["count_over_k_per_step"] = [s["count_over_k_min_median_max"] for s in steps[0]]
            rec["k6_launches"] = a0[name]["launches"]["threshold_encode_buckets"]
            if any(s["launches"]["threshold_encode_buckets"] != 1
                   or s["launches"]["threshold_encode"] != 0
                   or s["buckets_fit"] + s["buckets_overflow"] != a0[name]["n_buckets"]
                   or s["buckets_fit"] < 1 for s in steps[0]):
                bad.append(f"{name}: K6 did not run once over every bucket of every step")
        elif any(s["launches"]["threshold_encode"] or s["launches"]["threshold_encode_buckets"]
                 for s in steps[0]):
            bad.append(f"{name}: K6 launched outside arm (a)")
        if any({k: v for k, v in s["launches"].items() if not k.startswith("threshold_encode")}
               != want_kernels for s in steps[0]):
            bad.append(f"{name}: K1-K4 launches")
        if not rec["ranks_bitwise_equal"]:
            bad.append(f"{name}: ranks differ")
        if not rec["finite_and_falling"]:
            bad.append(f"{name}: loss")
        arms[name] = rec
    a_is_b = all(x["loss"] == y["loss"] and x["fingerprint"] == y["fingerprint"]
                 for x, y in zip(a0["a_one_pass"]["steps"], a0["b_top_k"]["steps"]))
    if not a_is_b:
        bad.append("arms (a) and (b) differ")
    rec = {"phase": "compressed", "ranks": 2, "mesh": {"dcn": 2, "data": 1},
           "backend": "gloo", "device": "cuda:0 (both ranks)",
           # the trainer hands gloo the CUDA tensors (a refusal would have
           # failed a rank); gloo's own copies through host memory, read
           # from a trace of one all-gather of arm (a)'s wire buffer
           "gloo_given_cuda_tensors": True,
           "gloo_host_copies": ranks[0]["gloo_host_copies"],
           "gloo_stages_through_host": ranks[0]["gloo_host_copies"]["device_to_host"] > 0,
           "batch": [8, MAX_LEN],
           "rank_batch": [4, MAX_LEN], "steps": COMPRESS_STEPS, "bucket_mb": 4.0,
           "one_pass_bitwise_top_k": a_is_b, "arms": arms, "failures": bad}
    emit(rec)
    if bad:
        raise AssertionError(f"compressed phase failed: {bad}")
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from deeplearning4j_tpu_torch.utils import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})

    t0 = time.perf_counter()
    built = cuda_build.build(cuda_build.sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(str(v), REPO) for k, v in built.items()}})

    k1, bwd, det = phase_kernel()
    k5 = phase_kernel_lstm()
    net = build_model()
    score = phase_score(net)
    serve = phase_serve(net)
    train = phase_train(net)
    k4 = fused_update_case(net)
    from deeplearning4j_tpu_torch.ops.compression import GradBucketer
    if GradBucketer(net.params).bucket_sizes() != DP_BUCKET_SIZES:
        raise AssertionError("DP_BUCKET_SIZES is not the model's bucket layout")
    del net
    torch.cuda.empty_cache()
    rnn = phase_recurrent()
    k5_launches = rnn["arms"]["k5"]["launches_per_call"][0]
    _, k6 = phase_kernel_encode(DP_BUCKET_SIZES)
    compressed = phase_compressed()

    def entry(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda",
                "source": f"deeplearning4j_tpu_torch/csrc/{source}", "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    # D1 is a repair with no Pallas counterpart: it replaces the reference's
    # plain XLA det_attention.  K2 and K3 share one library yardstick, the
    # whole attention backward.
    bwd_lib = {"library_ms": bwd["library_ms"]}
    emit({"kernels": [
        entry("flash_fwd", "flash_fwd.cu", "deeplearning4j_tpu/ops/attention.py:138",
              score["launches"]["flash_fwd"], k1),
        entry("flash_bwd_dkdv", "flash_bwd.cu", "deeplearning4j_tpu/ops/attention.py:329",
              train["launches"]["flash_bwd_dkdv"], {**bwd["flash_bwd_dkdv"], **bwd_lib}),
        entry("flash_bwd_dq", "flash_bwd.cu", "deeplearning4j_tpu/ops/attention.py:366",
              train["launches"]["flash_bwd_dq"], {**bwd["flash_bwd_dq"], **bwd_lib}),
        entry("fused_update", "fused_update.cu", "deeplearning4j_tpu/ops/update_kernel.py:84",
              train["launches"]["fused_update"], k4),
        entry("det_attention", "det_attention.cu",
              "deeplearning4j_tpu/ops/kv_cache.py:362",
              serve["launches"]["det_attention"], det),
        entry("lstm_seq_fwd", "lstm_cell.cu", "deeplearning4j_tpu/ops/lstm_kernel.py:81",
              k5_launches["lstm_seq_fwd"], k5["lstm_seq_fwd"]),
        entry("lstm_cell_bwd", "lstm_cell.cu", "deeplearning4j_tpu/ops/lstm_kernel.py:87",
              k5_launches["lstm_cell_bwd"], k5["lstm_cell_bwd"]),
        entry("threshold_encode", "threshold_encode.cu",
              "deeplearning4j_tpu/ops/compression.py:128",
              compressed["arms"]["a_one_pass"]["k6_launches"], k6),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compressed-rank"]:
        compressed_rank(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
