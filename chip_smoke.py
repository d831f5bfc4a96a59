#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase, on cuda:0
    python3 chip_smoke.py --trace-probe N  # serve's and predict's traced
                                           # replays, N traces each way
    python3 chip_smoke.py --canary-probe N # predict_features arm (e)
                                           # alone, N times, timed
    python3 chip_smoke.py --phase kernel   # the build and the kernel
                                           # phase alone (no result line)
    python3 chip_smoke.py --phase sharded  # the build and the sharded
                                           # phase alone (no result line)
    python3 chip_smoke.py --phase elastic  # the build and the elastic
                                           # phase alone (no result line)
    python3 chip_smoke.py --phase predict_features  # the build and the
                                           # predict_features phase alone
    python3 chip_smoke.py --phase fleet    # the build and the fleet phase
                                           # alone
    python3 chip_smoke.py --phase flywheel # the build and the flywheel
                                           # phase alone
    python3 chip_smoke.py --phase learning # the build and the learning
                                           # phase alone
    python3 chip_smoke.py --phase ui       # the build and the ui phase
                                           # alone
    python3 chip_smoke.py --phase train    # the build and the train phase
                                           # alone
    python3 chip_smoke.py --phase wide_heads  # the build and the
                                           # wide_heads phase alone

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
          forward, at [4, 12, 1024, 64] and the train phase's B = 8; f32
          on the SIMT kernel, bf16 on the tensor-core kernel, both at
          both shapes, B = 8 in bf16 being bench config 7's attention),
          K2/K3 (flash backward dK/dV and dQ, at the train phase's
          [8, 12, 1024, 64] and more cases at B = 4; bf16 dK/dV and dQ
          on the tensor cores at both) and D1 (decode
          attention, on the decode program's strided and paged K/V
          views; its split-key launch at the step and at speculative
          verify's 5 rows a slot, its tiled launch at the prefill, at a
          128-row chunk at offset 256 and at the re-encode; a row of the
          two new shapes launched alone must be bitwise the same row) run
          first; K1's, K2's, K3's and
          D1's times and their yardsticks' (SDPA; autograd of SDPA for
          K2/K3) are device times (``device_ms``) beside the same calls
          timed alone with CUDA events (``cuda_ms``, the wrapper's host
          cost included); a second launch of K2 and of K3 must be
          bitwise the first; the new instances: f16 K1-K3 at [8, 12,
          1024, 64], K1-K3 at head width 256 ([4, 16, 2048, 256], the
          wide_heads phase's attention) and 160 ([2, 4, 300, 160], a key
          mask) in f32, bf16 and f16 (bf16 / f16 repeats bitwise), D1 at
          d 256 (step, 512-row prefill, re-encode; rows alone bitwise),
          K5a/K5b in f16, and HGMMA in the SASS of all six tensor-core
          instances of each of K1-K3; K4 (fused Adam) runs after the train phase
          on the model's real per-layer buffers and must match bitwise;
  score   ``MultiLayerNetwork.output`` on [4, 1024] tokens; K1 must have
          launched; the result must be a distribution and agree with the
          port run on the CPU at a smaller cut ([1, 256]);
  serve   ``DecodeEngine(max_slots=4, page_size=16, max_len=1024)`` answers
          8 concurrent requests (prompts of 16-512 tokens, 32 new tokens,
          half greedy, half seeded at temperature 0.8 / top_k 50, echoed
          logits) in arms, one engine each, each shut down before the next,
          D1's count set to 0 before each and read after.  (a) the plain
          engine: every future resolves, the pool drains to 0 pages, D1
          launched, greedy tokens equal the argmax of the re-encode logits,
          every decode logit is bitwise the re-encode logit, and the decode
          log-probabilities agree with ``output()`` (K1, which shares
          neither D1 nor the 64-row chunks) within 1e-4.  (b) the fused
          horizon H = 2, 4, 8, one CUDA-graph replay of ``step_multi`` a
          dispatch: tokens equal (a)'s, echoed logits bitwise (a)'s, replays
          = fused dispatches, D1 launches = 12 per prefill + 12·H per replay.
          (c) chunked prefill of 128: bitwise (a)'s, chunks as the prompts
          imply.  (d) prefix cache: 8 prompts sharing a 256-token prefix
          (suffixes 16-256), the first sent alone: >= 7 hits, logits
          bitwise the re-encode, every page free or held by the trie.  (e)
          int8 pages: >= 2x fewer pool bytes than (a)'s, greedy tokens the
          f32 re-encode's argmax on >= 80% of positions.  (f) speculation,
          k = 4, with the target as its own draft (every proposal accepted)
          and with a 2-layer draft of the same vocabulary, width and
          max_len: greedy tokens equal (a)'s, seeded requests repeat
          exactly.  (g) a crash set mid-serve at H = 4: every request ends
          with (a)'s tokens after a retry; with ``max_retries=0`` the
          requests in flight fail with ``ReplicaCrashError`` and the queued
          ones are served after it.  Each arm prints TTFT and TPOT p50/p99,
          tokens/s and wall per token beside (a)'s;
  predict the replicated predict ``Engine`` over the same network
          (``max_batch=4``, 2 replicas on cuda:0, buckets 1, 2, 4, each pair
          captured as a CUDA graph per replica at ``load()``) answers 16
          requests of 1-3 rows of float32 token ids [rows, 1024] from 4
          client threads: every future completes, every request's rows are
          bitwise the eager forward of the padded bucket it was served in
          and within 1e-4 in log-probability of ``output()`` on its rows
          alone, no batch runs unwarmed, the graph count is 6 before and
          after, and K1 launches 12 per graph replay by its counter (a
          torch.profiler trace of one replay per bucket reported beside:
          a profiler can lose records at a trace's ends).  Prints
          requests/s, e2e p50/p99,
          and per bucket a replay's and the eager forward's time (CUDA
          events, one call) and the rows' copy to the host;
  predict_features  the predict engine's features over the same network.
          (a) ``Engine(replicas=2, max_batch=4)`` loaded with
          ``quantize="int8"`` (calibrated on 4 seeded rows of ids: the
          head's W, the one 2-D ``W`` leaf a matmul uses, becomes an
          ``Int8Weight`` served through ``torch._int_mm``), 16 requests of
          1-3 rows from 4 threads: graphs flat at 6, no capture and no
          unwarmed serve while serving, K1 12 per replay (by the counter;
          a trace's count reported), every row bitwise the eager quantized forward of its
          bucket, the head's int32 accumulator on the card bitwise the
          CPU's ``_int_mm`` on the same int8 operands (64 rows), every
          request within 0.05 relative of the f32 network (the
          reference's envelope; top-1 agreement printed); the f32 and int8
          head products at bucket 4 timed against their bounds.  (b) the
          Iris MLP in f32 and ``init_pretrained_int8`` on the 150 Iris rows
          placed on that engine while GPT-2 traffic flows: each request
          bitwise its own model's eager bucket, 6 programs per model
          before and after, a batch never mixes models, int8 accuracy
          > 0.97 and agreement with f32 >= 0.99, an unplaced name answers
          HTTP 404 ``model_not_loaded``, ``remove_model`` strands no
          future.  (c) tenants at weights 3:1 with quotas on an Iris
          engine: a 64-request burst of the light tenant, the heavy one's
          e2e p99 below the burst's and all its requests in the first half
          of the batches; 16 threads racing a ``DynamicBatcher``'s quotas
          (5/3/7) are admitted exactly to the caps; over a QPS quota HTTP
          answers 429 ``tenant_overloaded``.  (g) /metrics with both
          engines: the ``registry`` key holds both collectors, every
          histogram ``buckets_ms`` and ``counts``.  (f) GPT-2 f32, one
          replica: ``save_warmup_bundle``; a fresh engine with
          ``load(warm_bundle=)`` counts 3 hits and 0 misses and serves
          bitwise the first; a corrupted bundle warns once, counts 3
          misses, serves bitwise; ``load()`` seconds of each.  (d)
          ``enable_autoscale`` (1-2 replicas) under a burst of 24 requests:
          a born replica captures its 3 graphs before it is routable, then
          serves; idle retires it; 3 graphs a replica throughout, no
          unwarmed serve, no capture on a replica thread, K1 12 per replay.
          (e) v1 → v2 (the weights nudged by 1e-4) through
          ``set_alias(canary=0.5, canary_window=4)`` under traffic, then a
          v3 whose head bias is NaN: v2 promoted, v3 rolled back,
          ``canary_history`` holds both, 12 captures in all, none on a
          replica thread, no unwarmed serve, users never see a non-finite
          row; under a 300 s limit whose expiry prints every thread's
          stack and fails the run, with the canaries, the engine's warm,
          swap and drain steps, each capture and the replica calls timed;
  http    ``UIServer`` on 127.0.0.1 at an ephemeral port with an ``Engine``
          over the repository's Iris MLP checkpoint and a ``DecodeEngine``
          over the TransformerLM: POST /predict bitwise the engine's direct
          ``output``; a NaN row among four concurrent requests answers 422
          ``poison_input`` alone while the others answer 200, its batch
          holding at least one of them (so bisection ran); malformed JSON
          400; POST /generate (greedy, a 32-token prompt) the tokens of a
          direct ``generate``; GET /healthz 200 with both engines ready; GET
          /metrics both engines' counters; ``serve --smoke 8`` on the Iris
          checkpoint exits 0.  Then the Iris MLP with float32 parameters
          computed in bfloat16 takes 20 steps of its Adam (K4 on) on the card
          and on the CPU from the same weights: the loss falls, parameters
          stay float32, losses within two bfloat16 spacings and parameters
          within 1e-2 of their norm of the CPU's;
  fleet   the serving fleet (``serving/fleet.py``) over the same network.
          First K1 at the predict hosts' shapes [1 | 2 | 4, 12, 256, 64]
          f32 against its plain version (the kernel phase's tolerances).
          (a) a ``FleetRouter`` over two in-process hosts, each
          ``Engine(replicas=1, max_batch=4)`` (buckets 1, 2, 4 captured at
          ``load()`` for [rows, 256] token ids), 32 requests of 1-3 rows
          from 4 threads, ``FleetChaos`` killing host h1 (engine shut
          down, host marked down) at request 12: every future delivers
          exactly once (delivered 32, failed 0, late discards 0), the
          router's retries equal the attempts h1 failed, every request
          bitwise the eager forward of the padded bucket it was served in
          (from its host's ``batch_log``), no unwarmed serve, K1 12 per
          replay.  (b) a fresh h2 beside h0: ``rolling_swap`` v0 → v2 (the
          weights nudged by 1e-4) under two threads of traffic: no request
          dropped, each bitwise the eager bucket of the version its batch's
          tag names (both versions served), 6 captures, none on a replica
          thread; then a swap to v3 in which h2 dies: h2 down, h0 rolled
          back to v0 and serving it bitwise.  (c) ``DecodeEngine`` roles:
          a prefill host and a decode host (``max_slots=4``,
          ``page_size=16``) behind the router against a unified engine on
          the serve phase's 8 requests, f32 and int8 pages: tokens equal,
          echoed logits bitwise, every pool back to 0 pages; each
          request's handoff bytes, the pack → unpack → ``set_pages`` stages
          of a 512-token prompt (f32 and int8, bitwise), TTFT and TPOT p50
          against the unified engine's; the f32 ``ShardedTransformerLM``'s
          one-way prefill host into a sink of two head shards: every
          token equal, echoed logits within 1e-5.  (d) 8 sessions twice each on two unified hosts: every
          session on its ring host; an ``HttpHost`` over a loopback
          ``UIServer`` of the Iris engine answers bitwise the in-process
          engine; a prefill host's /generate answers 409
          ``prefill_role``.  (e) a fused-horizon decode engine's warm
          bundle: it names the one captured graph, which the loaded
          engine captures again (a hit, no miss) and serves bitwise;
          ``compile_cache_size`` flat on every engine of the
          phase; ``enable_compile_cache(tmp)`` builds D1 and K1 there and
          a fresh process pointed at it loads both with no ``nvcc``;
  train   ``fit_batch`` 5 times on one fixed [8, 1024] batch with Adam
          (lr 3e-4, per-layer L2 clipping 1.0) and ``DL4J_TPU_FUSED_UPDATE=1``:
          the loss is finite and falls on every step, each step launches
          K1 12, K2 12, K3 12 and K4 15 times, and one step's loss and
          per-layer clipped gradients agree with the port on the CPU with
          the same weights at a cut ([1, 128] tokens).  Then
          ``fit_batches(2)`` on two [8, 1024] batches, captured as one CUDA
          graph of both steps, against 2 ``fit_batch`` calls from the same
          parameters, Adam moments and iteration: losses and parameters
          bitwise, the graph count 1 after a second call, and one traced
          replay adding K1, K2 and K3 24 times and K4 30 times to the
          wrappers' counters (the trace's counts reported beside them);
          prints ms per step eager and replayed and peak memory.
          Last, ``fit_batch`` with tracing off, on, on, off, each from
          the same state: the traced steps' spans are the reference's
          (``train/step`` over ``train/h2d`` and ``train/dispatch``, then
          ``train/device_sync`` on the loss's read) and every step's loss
          and parameters are bitwise the first's; prints the step times;
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
          1e-5, through K5a and with the plain loop.  The mixed arm: the
          LSTM(256) char-RNN with float32 parameters computed in bfloat16
          (integer ids, so K5a/K5b run in bfloat16) takes 5 ``fit_batch``
          calls on the card and on the CPU from the same weights, with the
          Iris arm's gates; each arm prints its kernels' launches and dtypes.
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
  mlp     bench config 1 at full width: Dense 512 relu → Dense 256 relu →
          OutputLayer 10 softmax mcxent on 784 inputs, Nesterovs(0.1, 0.9),
          batch 512, on [4096, 784] MNIST-shaped data from a numpy seed
          (the reference's synthetic MNIST surrogate).  (a) the CLI's
          ``train`` (one epoch, to a zip), ``evaluate`` and ``summary``, each
          its own process: every command exits 0, the trained zip's loss
          is below the fresh network's, and its output on 512 rows is
          within 1e-5 of the same training run in this process.  (b)
          ``fit_batches(8)`` as one CUDA graph against 8 ``fit_batch`` calls
          from the same start: losses, parameters and momenta bitwise, one
          graph after a second call; prints ms per step and images/s eager
          and replayed (eager, graph, graph, eager), and each one's device
          busy time, idle share and kernels per step from a trace.  (c) the
          nan guard, budget 2, on a batch holding one NaN: each skipped
          step leaves parameters and momenta bitwise, the third bad step
          raises ``DivergenceError``, a good step resets the count.  (d)
          dropout 0.5 on both hidden layers and DropConnect(0.9) (on the
          output layer, where the reference's training leaves it inert, and
          on the second hidden layer): 20 steps eagerly and 20 as
          fit_batches(4) replays, each twice from one seed: losses fall,
          repeat bitwise, and the kept share of the first layer's input in
          an eager step is within 0.01 of 0.5.  (e) float64 on the card
          against the port on the CPU, 5 steps: losses and the first
          step's gradients within 1e-10, parameters within one float32
          spacing (the updaters compute in float32, as the reference's do);
  attention  ``EmbeddingSequence(50304, 768)`` → ``SelfAttention(12 heads,
          causal)`` → ``LayerNorm`` → ``RnnOutputLayer`` on [4, 1024] ids with
          a 25% key mask: 2 ``fit_batch`` steps and an ``output`` launch K1 3
          times and K2/K3 twice, with the mask; the attention layer's rows
          where the mask is 0 are exactly zero; the same 2 steps at a cut
          ([2, 256]) on the card and on the CPU from the same weights agree
          within 1e-4 (losses, outputs, parameters);
          ``LearnedSelfAttention(n_queries=3)`` forward on [4, 1024, 768]
          through K1 (3 queries against 1024 keys) within 2e-5 of ``mha``.
  conv    the conv path and ComputationGraph.  ResNet-50 as bench config
          3 trains it (``ComputationGraph`` from the zoo, 224x224x3, 1000
          classes, Nesterovs(0.1, 0.9), one fixed [128, 224, 224, 3] batch
          of seeded images): (a) f32 ``fit_batch``, 8 warm-up steps (the
          bench's lr makes the first steps' loss rise) then 5 timed, (b) the
          same net with ``compute_dtype = "bfloat16"``, 2 warm-up and 5
          timed; each prints ms per step (median of 5), images/s, peak
          memory, and from one traced step the idle share, kernels and the
          top kernels by device time; the loss is finite and falls over the
          5 steps.  The conv weights' copy to cuDNN's channels-last layout
          is timed alone.  (c) f32 ``output()`` on the batch: images/s, rows
          are distributions.  (d) ``fit_batches(2)`` on two [32, 224, 224,
          3] batches as one CUDA graph against 2 ``fit_batch`` calls from
          the same start under deterministic cuDNN: losses, parameters,
          momenta and BatchNorm statistics bitwise, one graph after a
          repeat call; the eager steps also run once under
          ``torch.use_deterministic_algorithms(warn_only)``, and the ops
          that warn are printed.  (e) ResNet-50 at 32x32 (10 classes) on
          the card against the port on the CPU from the same weights:
          f32 ``output()`` on 4 images within 1e-4, and one training step
          in float64 at batch 8 within 1e-4 (loss, output, parameters,
          momenta, statistics); the f32 step at batch 4 is printed, not
          gated (train-mode BatchNorm over stage 4's 1x1 activations
          amplifies rounding by up to 1/sqrt(eps) a layer).  (f) the
          checkpoint zip saved, loaded on the card: ``output()`` bitwise.
          (g) LeNet as bench config 2 (32x32x3, 10 classes, Nesterovs(0.01,
          0.9), [256, 32, 32, 3]): eager ``fit_batch`` and ``fit_batches(8)``
          replays, ms per step and idle share; ``train --zoo lenet``
          through the CLI exits 0; an ``Engine`` over it (buckets 1, 2, 4)
          serves 12 requests of 1-3 rows bitwise the eager forward of their
          padded bucket, 0 unwarmed serves, 3 graphs before and after.  (h)
          a recurrent ComputationGraph (2 x LSTM(256), vocab 96, outputs at
          every step and through ``LastTimeStepVertex`` →
          ``DuplicateToTimeSeriesVertex``, Adam lr 1e-3 with K4, TBPTT 50,
          one-hot [64, 100] inputs): 5 ``fit_batch`` calls launch K5a 20,
          K5b 1000 and K4 40 times, the loss falls; 64 steps streamed with
          ``rnn_time_step`` launch K5a 128 times and agree with
          ``output()`` within 1e-5; one call at [4, 100] on the card
          against the CPU within 1e-4 (loss, parameters, output).
  heads   the rest of nn/ and optimize/, Adam's fused update (K4) on; the
          K4 launches of the first step of (a), (b), (e), (f) and of (g)'s
          supervised steps are held bitwise against K4's plain version on
          their own buffers (odd lengths, the VAE's nested lists).  (a)
          TinyYOLO (tiny-yolo-voc: 416x416x3, 20 classes, 5 anchors, Adam
          1e-3) ``fit_batch`` on one fixed [64, 416, 416, 3] batch with the
          reference's label dict (3 objects an image at random cells and
          anchors), 2 warm-up steps then 5 timed, (b) the same net with
          ``compute_dtype = "bfloat16"``; each prints ms per step (median of
          5), images/s, peak memory and, from one traced step, the idle
          share, kernels per step and top kernels; the loss is finite and
          falls over the 5 steps (cuDNN's defaults).  (c) ``fit_batches(2)``
          on two [32, 416, 416, 3] batches as one CUDA graph against 2
          ``fit_batch`` calls from the same start under deterministic cuDNN:
          losses, parameters, Adam moments and BatchNorm statistics bitwise,
          one graph after a repeat call; ``decode_predictions`` on
          ``output()`` gives the reference's keys and shapes, confidences in
          [0, 1] and class rows that are distributions.  (d) card against
          CPU: TinyYOLO at 64x64 and InceptionResNetV1 with 1/1/1 blocks at
          15x15 (its stem's smallest input), dropout fed one numpy stream:
          ``output()`` in f32 within 1e-4, one float64 training step within
          1e-10 (loss, BatchNorm statistics, centres) and 1e-6
          (parameters: the updaters compute in f32).  (e)
          InceptionResNetV1 (5/10/5 blocks, 1000 classes, center loss) on
          [64, 160, 160, 3]: eager ``fit_batch`` median of 5 and traced,
          then ``fit_batches(2)`` bitwise 2 eager steps from the same
          generator state (dropout included), centres included, the centres
          of exactly the labelled classes moved.  (f) FaceNetNN4Small2
          (96x96, pnorm pooling, LRN, center loss) ``fit_batch`` median of
          5, the loss falls.  (g) a VAE (784 → 32, encoder and decoder
          [256, 256], Bernoulli) → OutputLayer(10) on the mlp phase's MNIST
          surrogate clipped to [0, 1], batch 512: 5 ``pretrain_layer(0)``
          steps (the ELBO falls), ``reconstruction_log_probability`` with 5
          samples on the card against the CPU from one noise stream within
          1e-4, 5 supervised steps.  (h) ``TransferLearning`` on LeNet
          (layers 0-3 frozen, n_out 5, Adam 1e-3, 5 steps: frozen parameters
          bitwise unchanged), ``featurize`` → ``fit_featurized`` within 1e-5
          of fine-tuning the whole network, early stopping on Iris with a
          ``LocalFileModelSaver`` (the restored model's output bitwise the
          best zip's), and 20 L-BFGS iterations on the Iris MLP (losses never
          rise; the final loss within 1e-4 of the CPU's plus twice the
          distance the CPU's own path moves when its inputs move by one
          float32 spacing);
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
          k selections and a 2%-hot gradient.  Arm (e): TinyYOLO at 416
          with BatchNorm on the two ranks, 8 rows each, SGD 1e-3, 2 steps
          dense and 2 compressed at ``COMPRESS_T``, then 2 dense in float64:
          both ranks' parameters and BatchNorm statistics bitwise equal
          after every step; the float64 dense arm against one process
          stepping the 16-row global batch (in float32 merely reordering
          the rows' sums moves TinyYOLO's initial gradients by up to 8%):
          loss and statistics within 1e-4 relative after each step, every
          parameter leaf within 1e-6 of its largest value after step 1,
          the parameters within 1e-4 in norm after step 2; the compressed
          arm's first statistics within 1e-6 of the mean of the two ranks'
          local updates, its first K6 launch (TinyYOLO's 16 buckets, the
          last ragged) bitwise K6's plain version on the same gradient;
          K6 launches once per rank per compressed step.
  sharded ``parallel.ShardedTransformerLM`` and the parallel axes.  (a)
          bench config 7 at full width on one rank: GPT-2-small (vocab
          50304, 12 x 768, 12 heads, max_len 1024), bf16 compute, Adam(3e-4,
          bf16 moments), one fixed [8, 1024] batch of seeded ids (targets
          rolled by one), 2 warm-up and 5 timed ``fit_batch`` steps (median
          ms, tokens/s, peak memory), one traced step (idle share, kernels,
          device ms by class and of K1, K2, K3; K1-K3 12 each in bf16 by
          the wrappers' counters, all three on the tensor cores); the loss
          is finite and falls.  (b) ``fit_batches(2)`` at (a)'s size as one CUDA graph:
          losses, parameters and Adam moments bitwise two ``fit_batch``
          calls from the same state, one graph after a repeat call.  (c) a
          2-layer cut at GPT-2 widths in f32 on [2, 128], 2 SGD steps, on
          the card and on the CPU: losses (relative) and parameters within
          1e-4.  (f) K1-K3 in bf16 at [4, 6, 1024, 64] (a TP 2 x pipe 2
          microbatch), [8, 3, 1024, 64] (Ulysses at tp 2 x sp 2) and (a)'s
          [8, 12, 1024, 64] against their plain versions (2e-2 abs, 1e-2
          norm-relative, a second K2/K3 launch bitwise the first; K1-K3
          on the tensor cores), D1 at a
          6-head shard (a step and a 512-row prefill) within 2e-5.  (e) the
          f32 LM at GPT-2 widths cut to (d)'s 4 layers, behind ``DecodeEngine`` with
          the serve phase's 8 requests, one-way and tensor-parallel with
          two head shards on cuda:0: every echoed logit bitwise the
          program's own re-encode, the pool back to 0 pages, the snapshot's
          ``tp``, D1 4 (one-way) and 8 (two shards) a step by its counter
          (a trace's count reported),
          and one-way log-probabilities within 1e-4 of ``logits()``
          (K1); TTFT and TPOT p50.  (g) ``ShardedTrainer`` on ``{model 2}``:
          two gloo ranks on cuda:0 train an Iris MLP (Adam, per-layer
          clipping, K4 on) 5 steps: losses and the gathered parameters
          within 1e-5 of one process, each rank holding half of each split
          leaf, the first step's K4 calls on the slices bitwise K4's plain
          version.  (d) four gloo ranks on cuda:0, GPT-2 widths cut to 4
          layers, a global [8, 1024] batch, 2 SGD steps a mesh from the
          same weights: ``{model 2, seq 2}`` with ring and with Ulysses,
          ``{model 2, pipe 2}`` with GPipe and 1F1B at M = 2 and 4, in f32,
          and Ulysses and GPipe in bf16; the f32 losses within 1e-4
          relative and the gathered parameters within 1e-4 of a one-rank
          run on the card, 1F1B's first loss bitwise GPipe's at the same
          M, the leaves a line of ranks shares bitwise equal along it;
          step ms and peak memory of each rank.
  elastic the elastic runtime (``parallel/elastic.py``, ``chaos.py``,
          ``preemption.py``, ``launcher.py``, the CLI's ``launch``), MoE and
          the graph's ``model`` axis.  (c)/(d) first: three ``launch
          --nprocs 2 --bootstrap distributed`` runs at once of ``train --zoo
          lenet --data mnist --batch-size 256 --epochs 3 --mesh
          dcn=2,data=1,compress=threshold --elastic-dir D
          --checkpoint-every 4`` (the reference's launch example: the zoo's
          LeNet on the 2048-image MNIST surrogate, 24 steps, 128 rows a
          rank, two gloo ranks on cuda:0, the adaptive threshold, which
          encodes by top-k and launches no K6):
          chaos-off; ``proc_kill`` of worker 1 at step 8 (relaunched once,
          the membership epoch past the chaos-off run's, both workers
          resume the same checkpoint and complete, no orphan, every step's
          loss, replays included, bitwise the chaos-off run's); a
          preemption notice to worker 0 at step 10 (the ranks agree the
          notice at the next boundary of ``sync_every`` = 4 steps, step
          12; the emergency checkpoint lands within the 60 s grace, exit
          75, relaunched without spending the budget, resumed at the
          preempted step, bitwise the chaos-off run); K6 bitwise its plain
          version on one step of LeNet's buckets at a fixed threshold
          (``ShardedTrainer(compression_threshold=1e-3)``).  (a) bench
          config 2's LeNet
          ([256, 32, 32, 3], Nesterovs(0.01, 0.9), nan guard 2) under
          ``ElasticTrainer(step_timeout=1.5, backoff_base=0.05,
          jitter_seed=0)``, 30 steps, deterministic cuDNN: chaos-off
          bitwise a plain ``fit_batch`` loop; a device loss, a crashed
          checkpoint write, a 2 s hung step, a truncated and a bit-flipped
          newest checkpoint (each with a device loss, so the restore meets
          it) and NaN gradients: 5 recoveries, both corrupt checkpoints
          quarantined and the restore fallen back to an older intact one,
          no stale .tmp, every step before the guarded NaN step (replays
          included) bitwise the fault-free run.  (g) ``ParallelInference``
          over LeNet, buckets 1/2/4: every result bitwise the eager forward
          of its bucket, a request after ``shutdown`` fails.  (e)/(f) two
          gloo ranks on cuda:0: ``moe_forward_ep`` on ``{model 2}`` at GPT-2
          widths (d_model 768, d_ff 3072, 8 experts, k 2, 8,192 tokens, f32,
          capacity factor 1.0, so the busiest experts drop routings) against the same function in one process
          (forward 1e-5, gradients 1e-4 relative in norm) and against
          ``moe_forward_dense`` on the tokens none of whose routings
          dropped (1e-5), the dropped routings those counted from the
          gates; then the zoo's ResNet-50 graph at 224x224 on
          ``ShardedTrainer({model 2})``, batch 16, 3 SGD steps,
          deterministic cuDNN: losses (relative) and the gathered
          parameters within 1e-4 of one process, each rank holding half of
          each split leaf; ms and peak memory per rank.  (b) runs around
          them: GPT-2-small (the train phase's model, f32, Adam 3e-4 with
          per-layer clipping, K4 on) under
          ``ElasticTrainer(async_checkpoints=True, checkpoint_every=2)``
          takes steps 1-2 first, and the step-2 checkpoint deflates on its
          background thread while (c)-(g) run; then a device loss at step
          3: the restored parameters and Adam moments bitwise the
          fault-free run's at step 2, the replayed step's loss bitwise,
          K1-K3 12 and K4 15 launches per step run; prints the
          checkpoint's bytes, the snapshot ms, the deflate/write seconds,
          whether the write had landed before the restore, the restore
          seconds and the step ms before and after.
  flywheel  the promotion flywheel (``serving/lifecycle.py``) and the input
          pipeline (``datasets/``); it runs none of K1-K6 or D1.  (a) the
          CLI's ``flywheel --generations 5 --chaos
          nan,regression,host_kill,crash --hosts 2`` on cuda:0, as users run
          it (a process of its own, ``--flywheel-cli`` wrapping the CLI's
          ``main`` in a ``GraphSpy`` and counting ``FleetRouter.output``),
          beside the same with ``--max-divergence 0.1``: every generation's
          outcome, version, rollback target and parent the reference CLI's
          on the CPU (``FW_EXPECTED``), promoted 3 / rolled back 2 / resumes
          1, alias 5; gen 3 rejected at 0.1 as the reference's; every
          traffic call returned or counted in ``traffic_dropped``; no graph
          captured on a replica thread; each run's canary decisions and
          GC pauses printed.  (b) ``PromotionPipeline`` over LeNet at bench
          config 2 ([256, 32, 32, 3], Nesterovs(0.01, 0.9)), 3 generations
          under deterministic cuDNN: TRAIN an ``ElasticTrainer`` fed by
          ``Cifar10DataSetIterator`` (the synthetic surrogate) through
          ``DevicePrefetchIterator(depth=2, transform=
          ImagePreProcessingScaler())``, EVAL ``EvalGate`` over
          ``DataSetLossCalculator``, REGISTER with a warm bundle, CANARY on
          the subscribed host under live traffic, ROLL over two LeNet
          ``Engine`` hosts (buckets 1/2/4): every generation promoted, gen
          1's losses bitwise the same batches fed synchronously through the
          same device transform, every served row bitwise its version's
          eager bucket, 0 unwarmed serves, bundle hits and 0 misses, the
          journal replayed by a second controller to the same records, no
          capture on a replica thread; ``ROCMultiClass`` AUCs and
          ``EvaluationCalibration`` errors of the promoted model printed.
          (c) ResNet-50 (bench config 3) on six [128, 224, 224, 3] uint8
          batches from a numpy seed, in the native loader's row order, from
          one start: synchronous and scaled on the host, synchronous with
          the device transform, and through the prefetch ring: step ms
          (median), the ring's ``stall_stats()``, one traced step's idle
          share each, and where the ring's copies ran and how long they
          overlapped compute kernels; the ring's losses and parameters
          bitwise the device arm's, the device-scaled inputs bitwise the
          host's (losses within 1e-6 relative); a ``fit_batches(2)``
          capture at batch 32 with a producer alive completes (a watchdog
          fails the run after 300 s).  (d) the same rows from a
          ``NativeDataSetIterator`` (its library must load) through the
          ring: batches bitwise ``plain_order``'s rows, training bitwise
          the device arm.  (e) ``train --zoo lenet --data cifar10
          --prefetch 2``: exit 0 and the stall line.
  learning  the learning libraries (``nlp/``, ``graph/``, ``clustering/``,
          ``plot/``, ``streaming/``); it runs none of K1-K6 or D1 (their
          counters are gated at 0).  (a) bench config 4's Word2Vec
          (``bench.py:560-568``: 48,000 sentences of 20 words over 2,000
          words from numpy seed 0, ``layer_size=128, window=5, negative=5,
          batch_size=4096, subsampling=0``): a warm fit, then three fits
          timed with ``word_vector("w0")`` inside the window, the best
          words/s; the native window library loaded, the tables finite,
          and on the first 2,000 sentences the card's ``syn0`` within rtol
          1e-4, atol 1e-5 of the port's on the CPU, a fit stacking 16
          batches a dispatch bitwise a one-batch fit, a repeat fit (the
          ordered scatter) and an eager fit (no CUDA graph replays).  (a2) the same at the published
          300-wide embedding: 100,000 sentences of 20 Zipf(1.1) ids over
          100,000 ids: words/s, and the device share of a torch.profiler
          window of 2 dispatches (32 batches) inside the fit.  (b) on the
          reference tests' two-topic corpus: CBOW and SG-HS on 20,000
          sentences, one epoch (within > across + 0.2);
          ``ParagraphVectors`` with the reference test's recipe (20
          epochs): DM and DBOW at its 120 documents and DBOW at 1,000 (the
          documents' mean within-topic cosine > across + 0.15, and
          ``infer`` on 100 unseen documents: 80% of their 10 nearest
          documents of their topic; DBOW at 1,000 within 1e-3 of the
          reference package's within and across,
          ``scripts/torch_pv_recipe_scale.py``, which also holds the
          20,000-document fits, where the recipe separates in neither
          package); ``Glove`` (width 128) on (a)'s corpus for 2 epochs:
          the loss falls, ms a batch.  (c)
          ``DistributedWord2Vec`` on two gloo ranks on cuda:0 over (a)'s
          first 8,000 sentences: the ranks' tables bitwise equal and within
          rtol 1e-4, atol 1e-5 of one-rank ``Word2Vec``; bytes gathered a
          batch.  (d) ``DeepWalk`` on a planted graph of 10 communities of
          500 vertices, walks of 40, 10 a vertex, lr 0.05, HS and negative
          sampling: within-community cosine > across + 0.2.  (e)
          ``NearestNeighbors`` over 1,000,000 x 128 f32 points, 8,192
          queries at k = 10, euclidean and cosine: ms a 4,096-query block
          against its bound; on 256 queries every neighbour's float64
          distance (computed on the card) within 1e-6 relative of the
          float64 oracle's at its rank (indices may differ only at ties);
          the index behind ``NearestNeighborsServer``: 64 ``/knnnew`` and
          ``/knn`` requests answer exactly the direct ``knn`` calls, p50
          and p99.  (f) ``KMeansClustering`` k = 256 on 200,000 x 128
          points: ``predict`` equals the training assignment, the inertia
          never rises, the first Lloyd step equals the same step on the
          CPU (assignments but at ties within 1e-5, centroids within 1e-5
          x (1 + |c|), inertia 1e-5 relative), ms a Lloyd step.  (g) t-SNE: exact on 5,000 points
          (300 iterations; the KL finite and below the first
          unexaggerated iteration's), chunked on 200,000 points of the
          reference's large demo (10 blobs, d = 16, perplexity 30, 3
          iterations, block 1,024): finite, peak ``max_memory_allocated``
          under 1/10 of a dense [N, N] f32 buffer, the last iteration's
          new velocity of 2,048 rows within 1e-4 in norm and its KL within
          1e-5 of a float64 evaluation of its formula on the card, seconds
          for the kNN and a gradient iteration.  (h) a ``TensorBroker`` on loopback carries 200
          batches of [512, 784] f32 (and one-hot labels) into bench config
          1's MLP ``fit_batch`` on the card: every batch consumed bitwise
          the one published, the loss falls (mean of the last 10 below the
          first 10), MB/s.
  ui      the training UI, the Keras importer and the wrappers.  (a)
          GPT-2-small (f32, [8, 1024], K4 on) takes 6 ``fit_batch`` steps in
          each of four arms (the yardstick's 3, ~6 s each): no listener;
          ``StatsListener`` (every iteration, 20-bin histograms: each
          leaf's statistics computed on the card, one copy of every leaf's
          min and max and one of all the numbers to the host); the same
          without histograms; and the reference's host route as a
          yardstick (every leaf copied to the host, numpy's statistics:
          ``host_stats_listener``), beside which the device route rides on
          the same parameters, timed apart.
          Each arm prints step ms (median; the yardstick's also less the
          rider's time), the listener's ms per recorded iteration (timed
          alone, the step synced out) and peak memory.  The gate, on the
          yardstick arm's 3 records of both routes: histogram counts and
          edges equal, min and max bitwise, std, mean magnitude and update
          ratios within rtol 1e-5, the mean within 1e-5 x the mean
          magnitude, ``memory`` present and nonzero.  (b) ``train --zoo
          resnet50 --data <npz> --prefetch 2 --dashboard`` (bench config
          3: 512 uint8 [224, 224, 3] images, 4 steps of 128) in this
          process: exit 0, the page names ``cli_train``, every record
          carries ``input_pipeline`` with a ``stall_fraction``.  (c) LeNet
          (bench config 2) posts its records through a
          ``RemoteStatsRouter`` to ``UIServer(port=0).attach(storage)
          .enable_remote_listener()`` in this process, beside a local
          storage on the same pinned clock: the stored records equal the
          local ones (but ``memory``: each listener's own copy of the
          parameters moves the allocator's count), ``/metrics``
          ``sessions`` counts them, ``/trace`` (tracing on) validates as a
          Chrome trace and holds the fit's span, ``/train/0/lenet``
          answers 200.  (d) ``profile_trace`` around 2 GPT-2 steps: its
          span says the profiler started and the written trace names
          ``flash_fwd`` and ``fused_update`` kernels.  (e) Keras VGG16
          (Sequential, 138,357,544 weights) and ResNet50 (functional,
          25,636,712: ZeroPadding2D, BN epsilon 1.001e-5, Add,
          GlobalAveragePooling2D) built by ``keras_vgg16`` /
          ``keras_resnet50`` with numpy weights from a seed, imported
          through the importer's stages after the read from memory
          (``KerasFile``, no ``h5py`` needed): the published weight
          counts, ``output()`` on 4 images on the card within 1e-4 of the
          port on the CPU, VGG16's categorical cross-entropy head takes a
          ``fit_batch`` with a finite loss (the functional import makes
          no loss head, as the reference's); a ``NeuralNetClassifier`` on
          bench config 1's MLP fits one epoch on the card and ``predict``
          is the argmax of its network's ``output``.  K1-K4's launches in
          (a), (b) and (d) go on the kernels line.
  wide_heads  the repository's ``TransformerLM`` at GPT-J-6B's attention
          widths (d_model 4096, 16 heads of 256, d_ff 16384, vocab 50,400,
          2,048 positions; the repository's block, not GPT-J's rotary,
          parallel one), 4 of its 28 layers, ~1.2 G parameters of its own
          initialisation drawn on the card from a seed: the DP 256
          instances of K1-K3 and D1.  (c) f32
          ``output()`` on [4, 2048]: K1 4 times at f32/256 by its
          instance counter, rows distributions; (d) a ``DecodeEngine``
          over that network, the serve phase's 8 requests: decode logits
          bitwise the re-encode's, D1 only at d 256, 0 pages after; (a)
          3 ``fit_batch`` steps on [4, 2048] with every leaf bf16 (the
          blocks compute in their input's dtype): K1-K3 12 each at
          bf16/256, the loss finite and falling; (b) the same in float16,
          K1-K3 at f16/256, the last loss below the first; (e) a 2-layer
          cut, f32, [2, 128], 2 SGD(0.1) steps on the card and on the
          port on the CPU from the same weights: losses 1e-4 relative,
          parameters 1e-4.  Step ms, tokens/s and peak memory printed.
          Its launches go on the kernels line as the DP 256 instances.

Each phase prints JSON lines; then one ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero without that last line, as does a run
without a CUDA device or outside the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bf16 and fp16 on the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES = 3.35e12

VOCAB, LAYERS, D_MODEL, HEADS, D_FF, MAX_LEN = 50304, 12, 768, 12, 3072, 1024
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


#: the script's start, for the per-phase walls
T_START = time.perf_counter()


def run_phase(name: str, phase, *args):
    """``phase(*args)``, then a line with its wall seconds and the script's
    seconds so far (the whole run must stay inside its time limit)."""
    t = time.perf_counter()
    out = phase(*args)
    now = time.perf_counter()
    emit({"wall": name, "seconds": now - t, "script_s": now - T_START})
    return out


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


def dtype_name(dtype) -> str:
    """``torch.float16`` → ``"float16"``."""
    return str(dtype).replace("torch.", "")


def head_bucket(D: int) -> int:
    """The kernel instance a head width takes (64, 128 or 256)."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


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
    tc0 = att.flash_forward_tc_cuda.launches
    o, lse = att.flash_forward_cuda(q, k, v, kmask, True, scale)
    torch.cuda.synchronize()
    tensor_cores = att.flash_forward_tc_cuda.launches - tc0 == 1
    # bf16, f16: a second launch on the same inputs gives the same bits (the
    # wgmma K1 has no atomics)
    bitwise = None
    if dtype != torch.float32:
        o2, lse2 = att.flash_forward_cuda(q, k, v, kmask, True, scale)
        bitwise = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
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
    dname = dtype_name(dtype)
    t_ops, t_bytes = flops / PEAK_FLOPS[dname] * 1e3, nbytes / PEAK_BYTES * 1e3
    if tensor_cores != (dtype != torch.float32):
        raise AssertionError(f"{name}: K1 took the wrong kernel (tensor cores {tensor_cores})")
    rec = {"phase": "kernel", "case": name, "dtype": dname,
           "instance": f"{dname}_d{head_bucket(D)}",
           "kernel": ("tensor cores, wgmma (flash_fwd_tc.cu)" if tensor_cores
                      else "SIMT (flash_fwd.cu)"),
           "shape": [B, H, T, D], "causal": True, "kmask": kmask is not None,
           "max_abs_err": err, "rel_err": rel_err, "lse_max_abs_err": lse_err,
           "bitwise_repeat": bitwise,
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
    tc0 = att.flash_bwd_dkdv_tc_cuda.launches, att.flash_bwd_dq_tc_cuda.launches
    dk, dv = att.flash_bwd_dkdv_cuda(*args)
    dq = att.flash_bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    tc = (att.flash_bwd_dkdv_tc_cuda.launches - tc0[0],
          att.flash_bwd_dq_tc_cuda.launches - tc0[1])
    if tc != ((1, 1) if dtype != torch.float32 else (0, 0)):
        raise AssertionError(f"bwd_{name}: K2 / K3 took the wrong kernels "
                             f"(tensor-core launches {tc})")
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
    dname = dtype_name(dtype)
    rec = {"phase": "kernel", "case": "bwd_" + name, "dtype": dname,
           "instance": f"{dname}_d{head_bucket(D)}",
           "dkdv_kernel": ("tensor cores (flash_bwd_tc.cu)" if dtype != torch.float32
                           else "SIMT (flash_bwd.cu)"),
           "dq_kernel": ("tensor cores (flash_bwd_tc.cu)" if dtype != torch.float32
                         else "SIMT (flash_bwd.cu)"),
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


def det_case(name, B, Tq, L, q_pos, paged, H=HEADS, d=D_MODEL // HEADS, page=16,
             alone_rows=()):
    """D1 against its plain version, with K/V laid out as the decode
    program hands them over: [B, L, H, d] rows seen as [B, H, L, d]
    strided views, gathered from a page pool through a shuffled page table
    when ``paged`` (prefill and step), else one projection's output
    (re-encode).  Query row i of batch b sits at position ``q_pos[b][i]``
    and sees keys 0..q_pos; a one-row case takes the step's [B, 1, 1, L]
    bias.  Each query row in ``alone_rows`` is launched alone too and must
    be bitwise the same row of the whole launch.  Returns its record."""
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
    alone = all(torch.equal(kvc.det_attention_cuda(q[:, :, r:r + 1], k, v,
                                                   bias[:, :, r:r + 1]), out[:, :, r:r + 1])
                for r in alone_rows)
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
           "rows_alone_bitwise": alone, "rows_alone": list(alone_rows),
           **times, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes}
    emit(rec)
    return rec


def wgmma_in_sass() -> dict:
    """The warpgroup MMA instructions (``HGMMA`` in SASS) of each K1, K2
    and K3 tensor-core kernel instance (bf16 and f16, head widths up to 64,
    128 and 256) in the built ``flash_fwd_tc`` and ``flash_bwd_tc``
    libraries, by function name; raises where an instance has none or
    the libraries lack one of the six instances of a kernel."""
    import shutil

    from deeplearning4j_tpu_torch.utils import cuda_build

    libs = cuda_build.build(["flash_fwd_tc", "flash_bwd_tc"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib in libs.values():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        for func in sass.split("Function : ")[1:]:
            name = func.split(None, 1)[0]
            for kernel in FLASH_TC_KERNELS:
                if kernel in name:
                    counts[name] = func.count("HGMMA")
    want = {(k, dp, t) for k in FLASH_TC_KERNELS for dp in (64, 128, 256)
            for t in ("13__nv_bfloat16", "6__half")}
    have = {(k, dp, t) for n in counts for k, dp, t in want
            if k in n and f"ILi{dp}E{t}E" in n}
    if not all(counts.values()) or have != want:
        raise AssertionError(f"K1 / K2 / K3 (flash_fwd_tc, flash_bwd_tc) without wgmma in SASS: "
                             f"{counts}")
    return counts


def phase_kernel():
    import torch
    # O: max abs error, and its norm relative to the plain O's (a wrong
    # scale or mask moves every row, not only the largest |O|); the LSE
    # is f32 from the same inputs in either dtype
    tol = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
    rel_tol = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2}
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # [4, 12, 1024, 64] first (the kernels line reports it), then the
    # train phase's B = 8; bf16 (the tensor-core kernel) at both, B = 8
    # being bench config 7's attention
    recs = [flash_case("f32", torch.float32, 0.0),
            flash_case("f32_train", torch.float32, 0.0, B=8),
            flash_case("bf16", torch.bfloat16, 0.0),
            flash_case("bf16_train", torch.bfloat16, 0.0, B=8),
            flash_case("f32_kmask", torch.float32, 0.25)]
    # the new instances: f16 on the tensor cores at config 7's shape; head
    # width 256 (the DP 256 instances) at the wide_heads phase's attention
    # [4, 16, 2048, 256] in every dtype; a ragged width and length
    # [2, 4, 300, 160] with a key mask in every dtype
    wide_fwd = {"f16": flash_case("f16_train", f16, 0.0, B=8)}
    for tag, dt in (("f32", f32), ("bf16", bf16), ("f16", f16)):
        wide_fwd[f"{tag}_d256"] = flash_case(f"{tag}_d256", dt, 0.0, B=WIDE_B,
                                             H=GPTJ["n_heads"], T=WIDE_T, D=256)
        wide_fwd[f"{tag}_d160"] = flash_case(f"{tag}_d160_ragged", dt, 0.25, B=2, H=4,
                                             T=300, D=160)
    recs += list(wide_fwd.values())
    bad = [r["case"] for r in recs
           if not (r["max_abs_err"] <= tol[r["dtype"]]
                   and r["rel_err"] <= rel_tol[r["dtype"]]
                   and r["lse_max_abs_err"] <= 2e-5
                   and r["bitwise_repeat"] is not False)]
    # the train phase's shape [8, 12, 1024, 64] first (the kernels line
    # reports it), then bf16 (K2 on the tensor cores) at [4, 12, 1024, 64]
    # and at bench config 7's [8, 12, 1024, 64], and a key mask
    bwd = [flash_bwd_case("f32_train", torch.float32, 0.0, B=8),
           flash_bwd_case("f32", torch.float32, 0.0),
           flash_bwd_case("bf16", torch.bfloat16, 0.0),
           flash_bwd_case("bf16_train", torch.bfloat16, 0.0, B=8),
           flash_bwd_case("f32_kmask", torch.float32, 0.25)]
    # the new instances, as K1's above
    wide_bwd = {"f16": flash_bwd_case("f16_train", f16, 0.0, B=8)}
    for tag, dt in (("f32", f32), ("bf16", bf16), ("f16", f16)):
        wide_bwd[f"{tag}_d256"] = flash_bwd_case(f"{tag}_d256", dt, 0.0, B=WIDE_B,
                                                 H=GPTJ["n_heads"], T=WIDE_T, D=256)
        wide_bwd[f"{tag}_d160"] = flash_bwd_case(f"{tag}_d160_ragged", dt, 0.25, B=2, H=4,
                                                 T=300, D=160)
    bwd_all = bwd + list(wide_bwd.values())
    bad += [f"{r['case']}/{kn}" for r in bwd_all for kn in ("flash_bwd_dkdv", "flash_bwd_dq")
            if not (r[kn]["max_abs_err"] <= tol[r["dtype"]]
                    and r[kn]["rel_err"] <= rel_tol[r["dtype"]]
                    and r[kn]["bitwise_repeat"])]
    # bf16 K1, K2 and K3 are built from wgmma: each kernel's SASS holds HGMMA
    emit({"phase": "kernel", "case": "wgmma_in_sass", "hgmma": wgmma_in_sass()})
    # decode attention at the serve phase's shapes and layouts: a 4-slot
    # step at positions spread over the cache, a 512-token prefill into
    # L = 1024, and a re-encode of 544 tokens (512 + 32)
    # and the shapes of speculative verify (k + 1 = 5 rows a slot, split-key)
    # and of a 128-token prefill chunk at offset 256 (tiled)
    det = [det_case("step", 4, 1, MAX_LEN, [[15], [300], [700], [MAX_LEN - 1]], True),
           det_case("prefill", 1, 512, MAX_LEN, [list(range(512))], True),
           det_case("reencode", 1, 544, 544, [list(range(544))], False),
           det_case("spec_verify", 4, 5, MAX_LEN,
                    [[p + i for i in range(5)] for p in (15, 300, 700, MAX_LEN - 5)], True,
                    alone_rows=range(5)),
           det_case("chunk_at_256", 1, 128, MAX_LEN, [list(range(256, 384))], True,
                    alone_rows=(0, 31, 64, 127))]
    # D1's DP 256 instance at the wide_heads phase's decode (16 heads of
    # 256): a step, a 512-row prefill and a re-encode, rows launched alone
    # bitwise the same rows of the whole launch (split-key and tiled)
    gh = GPTJ["n_heads"]
    wide_det = {
        "step": det_case("step_d256", 4, 1, MAX_LEN, [[15], [300], [700], [MAX_LEN - 1]], True,
                         H=gh, d=256),
        "prefill": det_case("prefill_d256", 1, 512, MAX_LEN, [list(range(512))], True, H=gh,
                            d=256, alone_rows=(0, 31, 32, 255, 511)),
        "reencode": det_case("reencode_d256", 1, 544, 544, [list(range(544))], False, H=gh,
                             d=256, alone_rows=(0, 543))}
    det += list(wide_det.values())
    bad += [r["case"] for r in det if not (r["max_abs_err"] <= 2e-5
                                           and r["rows_alone_bitwise"])]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    wide = {"fwd": wide_fwd, "bwd": wide_bwd, "det": wide_det}
    return recs[0], bwd[0], det[0], recs[3], bwd[3], wide


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


@contextlib.contextmanager
def recorded(module, name):
    """While open, the kernel wrapper ``module.name`` also keeps a copy of
    each call's arguments (taken before the launch) and results (after
    it) in the list it yields; it launches and counts as before.  Callers
    reach the wrapper through its module, so a step run under it is the
    main path's own step.  The wrapper counts its launches through the
    module's name, so the stand-in carries the count while the block is
    open and hands it back when it closes."""
    import torch

    fn, calls = getattr(module, name), []

    def keep(*args):
        kept = [a.clone() if torch.is_tensor(a) else a for a in args]
        out = fn(*args)
        calls.append((kept, [t.clone() for t in out]))
        return out
    keep.launches = fn.launches
    setattr(module, name, keep)
    try:
        yield calls
    finally:
        fn.launches = keep.launches
        setattr(module, name, fn)


def k4_against_plain(calls) -> dict:
    """Every K4 call ``recorded`` in a training step held bitwise against
    its plain version on the same buffers: the calls, their lengths and
    how many are odd (not a whole number of the kernel's float4 vectors)."""
    import torch

    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    bitwise, err = True, 0.0
    for args, outs in calls:
        for x, y in zip(outs, uk.fused_update_plain(*args)):
            bitwise = bitwise and bool(torch.equal(x, y))
            err = max(err, float((x - y).abs().max()))
    n = [int(args[1].numel()) for args, _ in calls]
    return {"calls": len(calls), "elements": sum(n), "shortest": min(n, default=0),
            "longest": max(n, default=0), "not_multiple_of_4": sum(k % 4 != 0 for k in n),
            "bitwise": bitwise and bool(calls), "max_abs_err": err}


# the counted operations of one (row, unit) of the LSTM cell, a
# transcendental as one: 3 sigmoids (4 each), 2 tanhs, c' (3), h' (1);
# the backward recomputes them and adds 22 products and differences
LSTM_FWD_OPS, LSTM_BWD_OPS = 18, 40
#: the relative spacing of the 2-byte dtypes (2^-mantissa bits)
SPACING = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
RNN_VOCAB, RNN_HIDDEN, RNN_B, RNN_T, RNN_TBPTT = 96, 256, 64, 100, 50


def lstm_case(mb, n, dtype):
    """K5b against its plain version, and K5a through one step of the
    sequence (T = 1, h0 = 0, b = 0, so z = zx exactly) against the plain
    cell, on one input set; returns its record.  K5b's times are device
    times (``device_ms``): one launch takes a few microseconds on the card
    and tens on the host, so a launch timed alone (``launch_ms``) reads the
    host's enqueue.  z ~ N(0, 1), c ~ N(0, 0.25), dh and dc' ~ N(0, 0.01),
    a trained cell's ranges.  bf16 and f16 are held against the plain
    version evaluated in f32 on the same inputs, element by element in
    units of one spacing of the dtype (``SPACING``: 2^-7 or 2^-10 of the
    value, plus 1e-6): the kernels round each result once, so each is
    within half a spacing; the plain version in the dtype rounds after
    every op (its gap is printed too).  The library's
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
    sp = SPACING.get(dtype_name(dtype), 2.0 ** -7)
    spacings = [float(((a.float() - w).abs() / (sp * w.abs() + 1e-6)).max())
                for a, w in zip(got, want)]
    err_same = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, same)]
    dname = dtype_name(dtype)
    rec = {"phase": "kernel", "case": f"lstm_cell_{mb}x{n}_{dname}", "shape": [mb, n],
           "dtype": dname, "library": "aten._thnn_fused_lstm_cell_backward_impl",
           "lstm_seq_t1": {"max_abs_err": max(err[:2]),
                           "max_err_spacings": max(spacings[:2]),
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
        "max_abs_err": max(err[2:]), "max_err_spacings": max(spacings[2:]),
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
    dname = dtype_name(dtype)
    atol, rtol = (2e-5, 1e-5) if dtype == torch.float32 else (2e-2, 1e-2)
    errs, ok = {}, all(torch.equal(a, b) for a, b in zip(got, again))
    bitwise = ok
    for name, a, w in zip(names, got, want):
        d = (a.float() - w).abs()
        limit = (torch.full_like(w, atol) if dtype == torch.float32
                 else torch.clamp(SPACING[dname] * w.abs(), min=atol))
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
        rec["max_abs_err_of_the_same_dtype_plain_vs_f32"] = max(
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
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # K5a over sequences: the char-RNN's chunk first (the kernels line
    # reports it), then a wider layer, ragged rows, the stream's step,
    # n % 4 != 0, masks, reverse, more tiles than the card holds at once
    # (RW streamed from L2), bf16, f16
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
            lstm_seq_case(2048, 3, RNN_HIDDEN, f32),
            lstm_seq_case(RNN_B, RNN_TBPTT, RNN_HIDDEN, f16, timed=True),
            lstm_seq_case(7, 13, 255, f16, masked=True, reverse=True)]
    # f32: 2e-6 max abs (the same rounded ops; expf/tanhf may differ in the
    # last bit); bf16, f16: every element within one spacing of the dtype
    ok = {"float32": lambda r: r["max_abs_err"] <= 2e-6,
          "bfloat16": lambda r: r["max_err_spacings"] <= 1.0,
          "float16": lambda r: r["max_err_spacings"] <= 1.0}
    # the char-RNN's shape first (the kernels line reports it), then
    # n % 4 != 0 and a batch of many waves of K5b's blocks
    cells = [lstm_case(mb, n, dt) for dt in (f32, bf16)
             for mb, n in ((RNN_B, RNN_HIDDEN), (RNN_B, 512), (7, RNN_HIDDEN), (1, RNN_HIDDEN),
                           (RNN_B, 255), (3, 3), (4096, RNN_HIDDEN))]
    cells += [lstm_case(RNN_B, RNN_HIDDEN, f16), lstm_case(RNN_B, 255, f16)]
    bad = [r["case"] for r in seqs if not r["ok"]]
    bad += [f"{r['case']}/{k}" for r in cells for k in ("lstm_seq_t1", "lstm_cell_bwd")
            if not ok[r["dtype"]](r[k])]
    if seqs[11]["rw_resident"] or not seqs[0]["rw_resident"]:
        bad.append("K5a's layouts: RW must stay resident at the chunk's shape and be "
                   "streamed when the tiles outnumber the card")
    if bad:
        raise AssertionError(f"LSTM kernels disagree with their plain versions: {bad}")
    return {"lstm_seq_fwd": seqs[0], "lstm_cell_bwd": cells[0]["lstm_cell_bwd"],
            "lstm_seq_fwd_f16": seqs[12], "lstm_cell_bwd_f16": cells[14]["lstm_cell_bwd"]}


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

SERVE_LENS = [16, 48, 96, 160, 256, 352, 448, 512]
SERVE_NEW = 32
#: the prefix arm's prompts: one 256-token prefix, suffixes of 16-256 tokens
PREFIX_LEN, PREFIX_SUFFIXES = 256, [16, 48, 80, 112, 144, 176, 208, 256]


def serve_requests():
    """The serve phase's 8 requests: prompts of 16-512 tokens, half greedy,
    half seeded at temperature 0.8 / top_k 50."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in SERVE_LENS]
    kws = [dict(temperature=0.0) if i % 2 == 0 else
           dict(temperature=0.8, top_k=50, seed=1000 + i) for i in range(len(SERVE_LENS))]
    return prompts, kws


#: seconds a traced replay keeps from each end of its trace: replays
#: traced hard against the profiler's start and stop came back short of
#: their kernels now and then, with no message from the profiler
#: (``--trace-probe`` counts them)
TRACE_PAUSE_S = 0.01


def traced_kernels(replay, names, pause: float = TRACE_PAUSE_S) -> int:
    """Kernels on the card whose name holds one of ``names``, counted from
    a torch.profiler trace of one call of ``replay``, which starts
    ``pause`` seconds into the trace and finishes ``pause`` before its
    end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            replay()
            torch.cuda.synchronize()
            time.sleep(pause)
    return sum(any(n in e.name for n in names)
               for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def traced_replay_d1(graph) -> int:
    """D1 calls in one replay of ``graph`` (a ``StepMultiGraph``), counted
    from a torch.profiler trace of the card: each call runs one
    ``det_attention_split`` or ``det_attention_tiled`` kernel (a split
    also its combine).  The replay runs with no slot active, so it writes
    only the scratch page, and it adds to no launch count."""
    import torch
    with torch.inference_mode():
        graph.inputs["active"].zero_()
        graph.inputs["page_table"].zero_()
    return traced_kernels(graph.graph.replay, ("det_attention_split", "det_attention_tiled"))


def traced_replay_k1(graph) -> int:
    """K1 calls in one replay of ``graph`` (a predict ``ForwardGraph``), on
    its own stream, counted from a torch.profiler trace of the card (each
    call runs one ``flash_fwd_kernel``).  It adds to no launch count."""
    import torch

    def replay():
        with torch.cuda.stream(graph.stream):
            graph.graph.replay()
    return traced_kernels(replay, ("flash_fwd_kernel",))


def serve_run(adapter, prompts, kws, *, crash_after=None, first_alone=False,
              **engine_kw):
    """One engine (``max_slots=4``, ``page_size=16``, ``max_len=1024``,
    ``engine_kw`` on top) answers ``prompts`` concurrently with
    ``echo_logits``, then shuts down.  D1's launch count is set to 0 just
    before the requests and read just after.  ``crash_after``: once that
    many decode dispatches have run, set the engine's crash hook.
    ``first_alone``: the first request is served before the others are
    sent.  Futures that fail keep their exception in ``outcomes``.  With a
    fused horizon, one more replay of its graph is traced after the
    requests (``d1_traced_per_replay``)."""
    import torch

    from deeplearning4j_tpu_torch.ops import kv_cache as kvc
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(adapter, max_slots=4, page_size=16, max_len=MAX_LEN, device="cuda",
                       **engine_kw).load()
    try:
        kvc.det_attention_cuda.launches = 0
        t0 = time.perf_counter()
        send = lambda p, kw: eng.generate_async(p, max_new_tokens=SERVE_NEW, echo_logits=True,
                                                **kw)
        futs = []
        if first_alone:
            futs.append(send(prompts[0], kws[0]))
            futs[0].exception(timeout=600)
        futs += [send(p, kw) for p, kw in list(zip(prompts, kws))[len(futs):]]
        if crash_after is not None:
            deadline = time.monotonic() + 300
            while (eng.metrics.counter("decode_steps") < crash_after
                   and time.monotonic() < deadline):
                time.sleep(0.002)
            with eng._lock:
                eng._crash_next = True
        outcomes = [f.exception(timeout=600) or f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches = {"det_attention": kvc.det_attention_cuda.launches}
        deadline = time.monotonic() + 5
        while (eng.metrics.gauge("pages_in_use") > eng.metrics.gauge("shared_pages")
               and time.monotonic() < deadline):
            time.sleep(0.01)
        snap = eng.metrics_snapshot()
        pages = eng._debug_page_state()
        pool_bytes = kvc.pool_nbytes(eng._cache)
        graph = eng.step_multi_graph
        replays = None if graph is None else graph.replays
        per_replay = None if graph is None else graph.launches["det_attention"]
        traced = None if graph is None else traced_replay_d1(graph)
    finally:
        eng.shutdown()
        torch.cuda.empty_cache()
    ok = [o for o in outcomes if not isinstance(o, BaseException)]
    n_tok = sum(len(r.tokens) for r in ok)
    return {"engine": eng, "outcomes": outcomes, "snap": snap, "wall": wall,
            "launches": launches, "pages": pages, "pool_bytes": pool_bytes,
            "replays": replays, "d1_per_replay": per_replay, "d1_traced_per_replay": traced,
            "metrics": {"ttft_p50_ms": snap["ttft_ms"]["p50_ms"],
                        "ttft_p99_ms": snap["ttft_ms"]["p99_ms"],
                        "tpot_p50_ms": snap["tpot_ms"]["p50_ms"],
                        "tpot_p99_ms": snap["tpot_ms"]["p99_ms"],
                        "tokens_per_s": n_tok / wall,
                        "wall_ms_per_token": wall * 1e3 / max(n_tok, 1),
                        "wall_s": wall, "tokens": n_tok}}


def reencode_rows(eng, prompt, tokens):
    """The re-encode logits of ``prompt + tokens[:-1]`` from the prompt's
    last row on, on the host."""
    import torch
    with torch.inference_mode():
        seq = torch.tensor([prompt + tokens[:-1]], device=eng.device)
        return eng.program.reencode(eng.params, seq)[0, len(prompt) - 1:].float().cpu().numpy()


def same_as(results, base):
    """(tokens equal, echoed logits bitwise) of ``results`` against ``base``."""
    import numpy as np
    toks = all(r.tokens == b.tokens for r, b in zip(results, base))
    bits = all(np.array_equal(r.logits, b.logits) for r, b in zip(results, base))
    return toks, bits


def phase_serve(net):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (TransformerDecodeAdapter,
                                                             TransformerLM)
    from deeplearning4j_tpu_torch.serving import ReplicaCrashError

    adapter = TransformerDecodeAdapter(net)
    prompts, kws = serve_requests()

    # (a) the plain engine
    run = serve_run(adapter, prompts, kws)
    eng, results, snap, wall = run["engine"], run["outcomes"], run["snap"], run["wall"]
    launches = run["launches"]
    if any(isinstance(r, BaseException) for r in results):
        raise AssertionError(f"serve arm (a): a request failed: {results}")
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
    rec = {"phase": "serve", "arm": "a_plain", "requests": len(results),
           "prompt_lens": SERVE_LENS, "launches": launches,
           "tokens": n_tok, "finish": sorted({r.finish_reason for r in results}),
           "pages_in_use_after": snap["pages_in_use"],
           "greedy_equals_reencode_argmax": greedy_ok,
           "decode_vs_reencode_max_abs_diff": max_diff,
           "decode_vs_reencode_bitwise": bitwise,
           "decode_vs_output_max_abs_logprob_diff": k1_dlogp,
           "tolerance_output_logprob": 1e-4,
           **run["metrics"],
           "decode_step_p50_ms": snap["decode_step_ms"]["p50_ms"],
           "pool_bytes": run["pool_bytes"]}
    emit(rec)
    # the reference's contract: decode logits are bitwise the re-encode's;
    # and both agree with output() as f32 sums in another order do (the
    # score phase's log-probability limit)
    if not (len(results) == 8 and greedy_ok and bitwise and k1_dlogp <= 1e-4
            and snap["pages_in_use"] == 0
            and launches["det_attention"] > 0
            and all(len(r.tokens) == 32 for r in results)):
        raise AssertionError("serve phase failed")
    base, arms, bad = results, {"a_plain": rec}, []

    def arm(name, run, gates, **extra):
        r = {"phase": "serve", "arm": name, **run["metrics"], "launches": run["launches"],
             "vs_a": {k: run["metrics"][k] / rec[k] if rec[k] else None
                      for k in ("tpot_p50_ms", "wall_ms_per_token", "tokens_per_s")},
             "gates": gates, **extra}
        emit(r)
        arms[name] = r
        bad.extend(f"{name}:{g}" for g, ok in gates.items() if not ok)

    # (b) fused horizons: one graph replay per dispatch, D1 counted through
    # them at LAYERS calls a step (a traced replay's count reported beside)
    for H in (2, 4, 8):
        run = serve_run(adapter, prompts, kws, decode_horizon=H)
        c = run["snap"]["counters"]
        toks, bits = same_as(run["outcomes"], base)
        want_d1 = LAYERS * (len(prompts) + run["replays"] * H)
        arm(f"b_fused_h{H}", run, {
            "tokens_equal_a": toks, "logits_bitwise_a": bits,
            "one_replay_per_dispatch": c["fused_dispatches"] == run["replays"] > 0,
            "d1_launches_through_replays": run["launches"]["det_attention"] == want_d1,
            "d1_per_replay": run["d1_per_replay"] == LAYERS * H,
            "pool_drained": run["snap"]["pages_in_use"] == 0},
            fused_dispatches=c["fused_dispatches"], graph_replays=run["replays"],
            d1_per_replay=run["d1_per_replay"],
            d1_traced_per_replay=run["d1_traced_per_replay"],
            tokens_per_dispatch=c["tokens_per_dispatch"] / max(c["fused_dispatches"], 1))

    # (c) chunked prefill
    run = serve_run(adapter, prompts, kws, prefill_chunk=128)
    c = run["snap"]["counters"]
    toks, bits = same_as(run["outcomes"], base)
    arm("c_chunked_128", run, {
        "tokens_equal_a": toks, "logits_bitwise_a": bits,
        "prefill_chunks": c["prefill_chunks"] == sum(-(-n // 128) for n in SERVE_LENS),
        "chunked_prefills": c["chunked_prefills"] == sum(n > 128 for n in SERVE_LENS),
        "pool_drained": run["snap"]["pages_in_use"] == 0},
        prefill_chunks=c["prefill_chunks"], chunked_prefills=c["chunked_prefills"])

    # (d) prefix cache: a shared 256-token prefix, the first request alone
    rng = np.random.default_rng(SEED + 4)
    prefix = rng.integers(0, VOCAB, PREFIX_LEN).tolist()
    pprompts = [prefix + rng.integers(0, VOCAB, n).tolist() for n in PREFIX_SUFFIXES]
    run = serve_run(adapter, pprompts, kws, prefix_cache=True, first_alone=True)
    c, pages = run["snap"]["counters"], run["pages"]
    outs = run["outcomes"]
    hit_bits = all(np.array_equal(reencode_rows(run["engine"], p, r.tokens), r.logits)
                   for p, r in zip(pprompts, outs))
    ids = sorted(pages["free"] + pages["private"] + pages["trie"])
    arm("d_prefix", run, {
        "hits_ge_7": c["prefix_hits"] >= 7, "logits_bitwise_reencode": hit_bits,
        "partition_clean": (not pages["private"] and ids == list(range(1, run["engine"].total_pages))
                            and run["snap"]["shared_pages"] == len(pages["trie"]))},
        prefix_hits=c["prefix_hits"], prefix_hit_tokens=c["prefix_hit_tokens"],
        trie_pages=len(pages["trie"]), ttft_miss_ms=outs[0].ttft_ms,
        ttft_hits_ms=[r.ttft_ms for r in outs[1:]],
        suffix_lens=PREFIX_SUFFIXES)

    # (e) int8 pages: an envelope against the f32 re-encode, not identity
    run = serve_run(adapter, prompts, kws, kv_dtype="int8")
    agree = total = 0
    for p, kw, r in zip(prompts, kws, run["outcomes"]):
        if kw["temperature"] == 0.0:
            ref = reencode_rows(eng, p, r.tokens).argmax(-1)
            agree += int((ref == np.asarray(r.tokens)).sum())
            total += len(r.tokens)
    ratio = rec["pool_bytes"] / run["pool_bytes"]
    arm("e_int8", run, {"pool_bytes_halved": ratio >= 2.0, "greedy_agree_ge_80pct":
                        agree / total >= 0.80},
        pool_bytes=run["pool_bytes"], pool_bytes_ratio=ratio, greedy_agreement=agree / total)

    # (f) speculative decoding, k = 4: the target as its own draft, and a
    # 2-layer draft of the same vocabulary, width and max_len
    small = TransformerLM(vocab_size=VOCAB, n_layers=2, d_model=D_MODEL, n_heads=HEADS,
                          d_ff=D_FF, max_len=MAX_LEN, seed=SEED + 5, device="cuda")
    for name, draft in (("f_spec_self", adapter), ("f_spec_2layer",
                                                   TransformerDecodeAdapter(small))):
        run = serve_run(adapter, prompts, kws, draft_model=draft, speculate_k=4)
        again = serve_run(adapter, prompts[1::2], kws[1::2], draft_model=draft,
                          speculate_k=4)
        c = run["snap"]["counters"]
        outs = run["outcomes"]
        greedy = all(r.tokens == b.tokens for r, b, kw in zip(outs, base, kws)
                     if kw["temperature"] == 0.0)
        repeat = [r.tokens for r in outs[1::2]] == [r.tokens for r in again["outcomes"]]
        gates = {"greedy_tokens_equal_a": greedy, "seeded_runs_repeat": repeat,
                 "pool_drained": run["snap"]["pages_in_use"] == 0}
        if draft is adapter:
            gates["self_draft_accepts_all"] = c["spec_accepted"] == c["spec_proposed"] > 0
        arm(name, run, gates, spec_steps=c["spec_steps"], spec_proposed=c["spec_proposed"],
            spec_accepted=c["spec_accepted"], spec_committed=c["spec_committed"],
            acceptance=c["spec_accepted"] / max(c["spec_proposed"], 1),
            accepted_tokens_per_step=run["snap"]["accepted_tokens_per_step"])
    del small

    # (g) a crash in the middle of arm (b) at H = 4: retried to (a)'s tokens;
    # then with no retries the requests in flight (at most 4 slots) fail and
    # the engine serves the queued ones after the crash
    run = serve_run(adapter, prompts, kws, decode_horizon=4, crash_after=2)
    c = run["snap"]["counters"]
    retried = [r for r in run["outcomes"] if not isinstance(r, BaseException)]
    toks = len(retried) == 8 and same_as(retried, base)[0]
    run0 = serve_run(adapter, prompts, kws, decode_horizon=4, crash_after=2, max_retries=0)
    failed = [i for i, r in enumerate(run0["outcomes"]) if isinstance(r, ReplicaCrashError)]
    served = [i for i in range(8) if i not in failed]
    arm("g_crash_h4", run, {
        "retried_tokens_equal_a": toks, "retries_gt_0": c["retries"] > 0,
        "no_retry_in_flight_fail": 1 <= len(failed) <= 4 and run0["snap"]["counters"][
            "errors"] == len(failed),
        "no_retry_next_requests_served": len(served) >= 4 and all(
            run0["outcomes"][i].tokens == base[i].tokens for i in served)},
        retries=c["retries"], replica_crashes=c["replica_crashes"],
        no_retry_failed=failed)

    total = sum(a["launches"]["det_attention"] for a in arms.values())
    if bad:
        raise AssertionError(f"serve arms failed their gates: {bad}")
    return {"launches": {"det_attention": total}, "arms": arms}


# -- predict phase -------------------------------------------------------------------

PREDICT_BUCKETS = (1, 2, 4)
PREDICT_REQUESTS, PREDICT_CLIENTS = 16, 4


def eager_bucket(net, x, bucket):
    """The eager forward of ``x`` zero-padded to ``bucket`` rows, on the
    card (all rows)."""
    import numpy as np
    import torch
    pad = np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)
    with torch.inference_mode():
        xp = torch.from_numpy(np.concatenate([x, pad])).to("cuda")
        return net._apply_layers(net.params, net.state, xp, None, train=False)[0]


def phase_predict(net):
    """The replicated predict ``Engine`` over the full-width TransformerLM
    (2 replicas on cuda:0, buckets 1, 2, 4, each pair captured as a CUDA
    graph per replica at ``load()``) answers 16 requests of 1-3 rows of
    float32 token ids [rows, 1024] from 4 client threads."""
    import threading

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    eng = Engine(net, max_batch=4, replicas=2, slo_ms=600_000, device="cuda").load(
        input_shape=(MAX_LEN,))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    try:
        graphs_before = eng.compile_cache_size()
        programs = dict(eng._current.programs)
        rng = np.random.default_rng(SEED + 6)
        xs = [rng.integers(0, VOCAB, (1 + (5 * i) % 3, MAX_LEN)).astype(np.float32)
              for i in range(PREDICT_REQUESTS)]
        futs, outs, errors = [None] * len(xs), [None] * len(xs), []

        def client(k):
            for i in range(k, len(xs), PREDICT_CLIENTS):
                futs[i] = eng.output_async(xs[i])
                try:
                    outs[i] = futs[i].result(timeout=600)
                except Exception as e:   # gated below: every future completes
                    errors.append(f"request {i}: {type(e).__name__}: {e}")

        replays0 = sum(g.replays for g in programs.values())
        log0 = len(eng.batch_log)
        att.flash_forward_cuda.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(PREDICT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        k1 = att.flash_forward_cuda.launches
        replays = sum(g.replays for g in programs.values()) - replays0
        snap = eng.metrics_snapshot()
        graphs_after = eng.compile_cache_size()
        batches = eng.batch_log[log0:]
        completed = all(f is not None and f.done() for f in futs)

        # each request's rows against the eager forward of the padded
        # bucket it was served in (bitwise), and against output() on its
        # rows alone (1e-4 in log-probability: with 50,304 tokens a
        # probability is ~2e-5, so an absolute limit on it says little)
        index = {id(f): i for i, f in enumerate(futs)}
        bitwise, max_dlogp, served_rows = True, 0.0, 0
        per_bucket = {}
        for b in batches:
            members = [index[r] for r in b["request_ids"]]
            bucket = b["rows"] + b["padded"]
            per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
            x = np.concatenate([xs[i] for i in members])
            y = eager_bucket(net, x, bucket)
            ofs = 0
            for i in members:
                got = torch.from_numpy(outs[i]).to("cuda")
                bitwise = bitwise and torch.equal(got, y[ofs:ofs + xs[i].shape[0]])
                ofs += xs[i].shape[0]
                alone = net.output(xs[i])
                max_dlogp = max(max_dlogp, float((got.clamp_min(1e-30).log()
                                                  - alone.clamp_min(1e-30).log()).abs().max()))
                served_rows += xs[i].shape[0]
            del y
        # K1 in one replay of each bucket's graph, from a trace of the card:
        # a report beside the counters' 12 a replay (a profiler can lose
        # records at a trace's ends)
        traced = {b: traced_replay_k1(programs[(0, b, "float32")])
                  for b in PREDICT_BUCKETS}
        # time per bucket, in this call: a graph replay against the eager
        # forward of the same bucket (both by CUDA events around one call),
        # and the served rows' copy to the host
        timing = {}
        for bucket in PREDICT_BUCKETS:
            g = programs[(0, bucket, "float32")]
            x = rng.integers(0, VOCAB, (bucket, MAX_LEN)).astype(np.float32)
            xd = torch.from_numpy(x).to("cuda")
            with torch.inference_mode():
                eager = cuda_ms(lambda: net._apply_layers(net.params, net.state, xd, None,
                                                          train=False), 3)
                with torch.cuda.stream(g.stream):
                    g.input.copy_(xd)
                    replay = cuda_ms(g.graph.replay, 5)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    g.output.cpu()
                    copy_ms = (time.perf_counter() - t1) * 1e3
                    eq = torch.equal(g.output, eager_bucket(net, x, bucket))
            timing[bucket] = {"replay_ms": replay, "eager_ms": eager,
                              "host_copy_ms": copy_ms,
                              "host_copy_bytes": g.output.numel() * 4,
                              "replay_bitwise_eager": eq}
        att.flash_forward_cuda.launches = k1     # the timing adds no launch to the gate
    finally:
        eng.shutdown()
        torch.cuda.empty_cache()
    rec = {"phase": "predict", "engine": {"replicas": 2, "buckets": list(PREDICT_BUCKETS),
                                          "max_batch": 4, "device": "cuda:0"},
           "requests": PREDICT_REQUESTS, "clients": PREDICT_CLIENTS,
           "rows": served_rows, "batches": len(batches), "batches_by_bucket": per_bucket,
           "load_s": load_s, "graphs_before": graphs_before, "graphs_after": graphs_after,
           "graph_replays": replays, "launches": {"flash_fwd": k1},
           "k1_per_replay": k1 / max(replays, 1), "k1_traced_per_replay": traced,
           "unwarmed_serves": snap["counters"]["unwarmed_serves"],
           "errors": errors, "all_futures_completed": completed,
           "bitwise_eager_bucket": bitwise, "max_abs_logprob_diff_vs_output": max_dlogp,
           "tolerance_logprob": 1e-4, "wall_s": wall, "requests_per_s": PREDICT_REQUESTS / wall,
           "e2e_p50_ms": snap["e2e_ms"]["p50_ms"], "e2e_p99_ms": snap["e2e_ms"]["p99_ms"],
           "queue_wait_p50_ms": snap["queue_wait_ms"]["p50_ms"],
           "per_bucket": timing}
    emit(rec)
    want_graphs = len(PREDICT_BUCKETS) * 2
    ok = (completed and not errors and bitwise and max_dlogp <= 1e-4
          and rec["unwarmed_serves"] == 0 and graphs_before == graphs_after == want_graphs
          and replays > 0 and k1 == LAYERS * replays
          and all(t["replay_bitwise_eager"] for t in timing.values()))
    if not ok:
        raise AssertionError("predict phase failed")
    return rec


# -- predict_features phase ------------------------------------------------------------

PF_REQUESTS, PF_CLIENTS = 16, 4
PF_BURST, PF_RACE_THREADS, PF_RACE_PER_THREAD = 64, 16, 9
PF_RACE_CAPS = {"t0": 5, "t1": 3, "t2": 7}
PEAK_INT8_OPS = 1979e12          # H100 SXM int8 tensor cores, dense (data sheet)


class GraphSpy:
    """Counts ``ForwardGraph`` replays and captures (the thread of each
    capture too) for the length of a ``with`` block, so a window's K1
    launches can be held to 12 per replay and 24 per capture's two eager
    warm-up forwards, even on graphs released inside the window.  It also
    times them: each capture's seconds, and the replica calls' (input
    copy, replay, rows to the host) count, total and longest seconds."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.serving import cuda_graphs as cg
        self.cg, self.replays, self.captures = cg, 0, []
        self.capture_s, self.call_s_max, self.call_s_total = [], 0.0, 0.0
        self._call, self._init = cg.ForwardGraph.__call__, cg.ForwardGraph.__init__
        spy = self

        def call(g, *a, **k):
            t = time.perf_counter()
            try:
                return spy._call(g, *a, **k)
            finally:
                dt = time.perf_counter() - t
                spy.replays += 1
                spy.call_s_total += dt
                spy.call_s_max = max(spy.call_s_max, dt)

        def init(g, *a, **k):
            spy.captures.append(threading.current_thread().name)
            t = time.perf_counter()
            try:
                return spy._init(g, *a, **k)
            finally:
                spy.capture_s.append(time.perf_counter() - t)
        cg.ForwardGraph.__call__, cg.ForwardGraph.__init__ = call, init
        return self

    def __exit__(self, *exc):
        self.cg.ForwardGraph.__call__ = self._call
        self.cg.ForwardGraph.__init__ = self._init

    def served_captures(self) -> int:
        """Captures made on a replica thread: a capture at serve time."""
        return sum(name.startswith("engine-replica-") for name in self.captures)


def run_clients(eng, xs, clients=PF_CLIENTS, **kw):
    """``xs`` through ``eng.output_async`` from ``clients`` threads →
    (futures, results, errors, wall s)."""
    futs, outs, errors = [None] * len(xs), [None] * len(xs), []

    def client(k):
        for i in range(k, len(xs), clients):
            futs[i] = eng.output_async(xs[i], **kw)
            try:
                outs[i] = futs[i].result(timeout=600)
            except Exception as e:   # gated: every future completes
                errors.append(f"request {i}: {type(e).__name__}: {e}")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return futs, outs, errors, time.perf_counter() - t0


def bitwise_buckets(eng, model, xs, futs, outs, log0):
    """Every request's rows bitwise the eager forward of ``model`` over the
    padded bucket it was served in (from ``batch_log``'s request ids)."""
    import numpy as np
    import torch
    index = {id(f): i for i, f in enumerate(futs) if f is not None}
    ok, n = True, 0
    for b in eng.batch_log[log0:]:
        members = [index[r] for r in b["request_ids"] if r in index]
        if not members:
            continue
        x = np.concatenate([xs[i] for i in members])
        y = eager_bucket(model, x, b["rows"] + b["padded"])
        ofs = 0
        for i in members:
            got = torch.from_numpy(outs[i]).to("cuda")
            ok = ok and torch.equal(got, y[ofs:ofs + xs[i].shape[0]].float())
            ofs += xs[i].shape[0]
            n += 1
        del y
    return ok and n > 0


def int8_head_times(w_f32, q):
    """The head product at bucket 4 ([4096, 768] x [768, 50304]) in f32 and
    in int8 (``Int8Weight``: quantize, ``torch._int_mm``, dequantize):
    device ms, bound ms and what binds."""
    import torch
    m, k, n = 4 * MAX_LEN, D_MODEL, VOCAB
    x = torch.randn(4, MAX_LEN, k, device="cuda") * 0.5
    flops = 2.0 * m * k * n
    f32 = {"ms": device_ms(lambda: x @ w_f32, iters=10)}
    f32["bound_ms"], f32["bound_by"] = bound(flops, (m * k + k * n + m * n) * 4, "float32")
    i8 = {"ms": device_ms(lambda: x @ q, iters=10)}
    nbytes = m * k * 4 + k * n + n * 4 + m * n * 4      # x, W int8, scales in; y out
    t_ops, t_bytes = flops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    i8["bound_ms"], i8["bound_by"] = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                                           else "bytes")
    # the accumulator's round trip, which the product's own layout adds
    i8["with_int32_accumulator_ms"] = (nbytes + 2 * m * n * 4) / PEAK_BYTES * 1e3
    return {"f32": f32, "int8": i8}


def pf_int8(net, rng):
    """(a) ``Engine(GPT-2-small, replicas=2, max_batch=4)`` loaded int8."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops.quantize import Int8Weight
    from deeplearning4j_tpu_torch.serving import Engine

    calib = rng.integers(0, VOCAB, (4, MAX_LEN)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(net, max_batch=4, replicas=2, slo_ms=600_000, device="cuda").load(
        input_shape=(MAX_LEN,), quantize="int8", calibration_inputs=calib)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    qm = eng._current.model
    head = len(qm.params) - 1
    q = qm.params[head]["W"]
    graphs_before = eng.compile_cache_size()
    xs = [rng.integers(0, VOCAB, (1 + (5 * i) % 3, MAX_LEN)).astype(np.float32)
          for i in range(PF_REQUESTS)]
    log0 = len(eng.batch_log)
    with GraphSpy() as spy:
        att.flash_forward_cuda.launches = 0
        futs, outs, errors, wall = run_clients(eng, xs)
        k1 = att.flash_forward_cuda.launches
    graphs_after = eng.compile_cache_size()
    snap = eng.metrics_snapshot()
    bitwise = bitwise_buckets(eng, qm, xs, futs, outs, log0)
    # against the f32 network: the reference's relative envelope, top-1
    rel, agree, rows = 0.0, 0, 0
    for x, y in zip(xs, outs):
        y32 = net.output(x)
        y8 = torch.from_numpy(y).to("cuda")
        rel = max(rel, float((y8 - y32).abs().max() / y32.abs().max()))
        agree += int((y8.argmax(-1) == y32.argmax(-1)).sum())
        rows += y8.shape[0] * y8.shape[1]
        del y32, y8
    # the head's int32 accumulator on the card against the CPU's _int_mm on
    # the same int8 operands (64 rows of a request's head input)
    with torch.inference_mode():
        h = qm._apply_layers(qm.params, qm.state, torch.from_numpy(xs[0]).cuda(), None,
                             train=False, upto=head)[0]
        xq = q.quantize_input(h).reshape(-1, D_MODEL)[:64]
        acc_card = q.int_mm(xq).cpu()
        acc_cpu = q.to("cpu").int_mm(xq.cpu())
    acc_bitwise = bool(torch.equal(acc_card, acc_cpu))
    programs = dict(eng._current.programs)
    timing = {}
    for bucket in PREDICT_BUCKETS:
        g = programs[(0, bucket, "float32")]
        with torch.inference_mode(), torch.cuda.stream(g.stream):
            g.input.copy_(torch.from_numpy(rng.integers(0, VOCAB, (bucket, MAX_LEN))
                                           .astype(np.float32)).cuda())
            timing[bucket] = {"replay_ms": cuda_ms(g.graph.replay, 5)}
    traced = traced_replay_k1(programs[(0, 4, "float32")])
    head_times = int8_head_times(net.params[head]["W"], q)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = {"arm": "a_int8", "load_s": load_s, "graphs_before": graphs_before,
           "graphs_after": graphs_after, "replays": spy.replays, "k1": k1,
           "k1_per_replay": k1 / max(spy.replays, 1), "k1_traced_per_replay": traced,
           "unwarmed_serves": snap["counters"]["unwarmed_serves"], "errors": errors,
           "bitwise_eager_quantized_bucket": bitwise, "int32_acc_card_bitwise_cpu": acc_bitwise,
           "max_rel_diff_vs_f32": rel, "top1_agreement_vs_f32": agree / rows,
           "requests_per_s": len(xs) / wall, "e2e_p50_ms": snap["e2e_ms"]["p50_ms"],
           "e2e_p99_ms": snap["e2e_ms"]["p99_ms"], "per_bucket": timing,
           "head_product": head_times, "peak_gib": peak_gib,
           "int8_leaves": sum(isinstance(v, Int8Weight) for p in qm.params for v in p.values())}
    bad = []
    if not (graphs_before == graphs_after == 6 and rec["unwarmed_serves"] == 0 and not errors
            and spy.captures == [] and spy.replays > 0 and k1 == LAYERS * spy.replays):
        bad.append(f"a: graphs {graphs_before}/{graphs_after}, k1 {k1} over {spy.replays} "
                   f"replays (traced {traced}), errors {errors[:2]}")
    if not (bitwise and acc_bitwise and rel < 0.05 and rec["int8_leaves"] == 1):
        bad.append(f"a: bitwise {bitwise}, acc {acc_bitwise}, rel {rel}, "
                   f"int8 leaves {rec['int8_leaves']}")
    return eng, rec, bad


def pf_named(eng, rng, tmp):
    """(b) the Iris MLP in f32 and int8 placed beside the int8 GPT-2 while it
    serves; an unplaced name over HTTP; a removal that strands nothing."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.fetchers import load_iris
    from deeplearning4j_tpu_torch.models import pretrained
    from deeplearning4j_tpu_torch.serving import ModelNotLoadedError
    from deeplearning4j_tpu_torch.ui import UIServer
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    xs_all, ys = load_iris()
    iris = load_model(os.path.join(REPO, IRIS_ZIP), device="cuda")
    iris8 = pretrained.init_pretrained_int8("iris_mlp", "iris", calibration_inputs=xs_all,
                                            cache_dir=tmp, device="cuda")
    stop, gpt_errors, gpt_done = threading.Event(), [], []

    def gpt_traffic():
        while not stop.is_set():
            try:
                gpt_done.append(eng.output(rng.integers(0, VOCAB, (1, MAX_LEN))
                                           .astype(np.float32)).shape)
            except Exception as e:
                gpt_errors.append(repr(e))
    t = threading.Thread(target=gpt_traffic)
    t.start()
    try:
        eng.add_model("iris", iris)
        eng.add_model("iris_int8", iris8)
        counts0 = {m: eng.compile_cache_size(model=m) for m in ("iris", "iris_int8")}
        xs = [xs_all[i:i + 1 + i % 3] for i in range(0, 120, 5)]
        names = ["iris" if i % 2 else "iris_int8" for i in range(len(xs))]
        log0 = len(eng.batch_log)
        futs = [eng.output_async(x, model=m) for x, m in zip(xs, names)]
        outs = [f.result(timeout=120) for f in futs]
        ok_f = bitwise_buckets(eng, iris, [x if m == "iris" else None for x, m in
                                           zip(xs, names)],
                               [f if m == "iris" else None for f, m in zip(futs, names)],
                               outs, log0)
        ok_q = bitwise_buckets(eng, iris8, xs, [f if m == "iris_int8" else None
                                                for f, m in zip(futs, names)], outs, log0)
        one_model = all(b["model"] in ("iris", "iris_int8") or b["model"] is None
                        for b in eng.batch_log[log0:])
        # accuracy and agreement over the 150 rows, served
        f32 = np.concatenate([eng.output(xs_all[i:i + 4], model="iris")
                              for i in range(0, 150, 4)])
        i8 = np.concatenate([eng.output(xs_all[i:i + 4], model="iris_int8")
                             for i in range(0, 150, 4)])
        acc8, agree = float((i8.argmax(1) == ys).mean()), float((i8.argmax(1)
                                                                 == f32.argmax(1)).mean())
        counts1 = {m: eng.compile_cache_size(model=m) for m in ("iris", "iris_int8")}
        server = UIServer(port=0, host="127.0.0.1").attach_engine(eng).start()
        try:
            code, r = http_call(f"http://127.0.0.1:{server.port}/predict",
                                {"inputs": xs_all[:1].tolist(), "model": "nope"})
        finally:
            server.stop()
        late = [eng.output_async(xs_all[i:i + 2], model="iris") for i in range(8)]
        removed = eng.remove_model("iris")
        # every future resolves: served before the removal, or typed after
        late_kinds = sorted({"ok" if f.exception(timeout=60) is None
                             else type(f.exception()).__name__ for f in late})
        late_done = all(f.done() for f in late)
        try:
            eng.output(xs_all[:1], model="iris")
            gone = False
        except ModelNotLoadedError:
            gone = True
    finally:
        stop.set()
        t.join(timeout=600)
    rec = {"arm": "b_named", "programs_before": counts0, "programs_after": counts1,
           "bitwise_f32": ok_f, "bitwise_int8": ok_q, "one_model_a_batch": one_model,
           "iris_int8_accuracy": acc8, "iris_int8_agreement_f32": agree,
           "http_unplaced": [code, r.get("error_class")], "removed": removed,
           "late_requests_done": late_done, "late_outcomes": late_kinds,
           "removed_then_404": gone, "gpt2_requests_meanwhile": len(gpt_done),
           "gpt2_errors": gpt_errors, "models": eng.placed_models()}
    bad = []
    if not (counts0 == counts1 == {"iris": 6, "iris_int8": 6} and ok_f and ok_q and one_model
            and acc8 > 0.97 and agree >= 0.99 and code == 404
            and r.get("error_class") == "model_not_loaded" and removed and late_done
            and gone and not gpt_errors and len(gpt_done) > 0):
        bad.append(f"b: {rec}")
    return rec, bad


def pf_tenants(rng):
    """(c) two tenants at weights 3:1 with quotas on the Iris MLP; the light
    one bursts; 16 threads race the caps; over quota is 429."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving import (DynamicBatcher, Engine, TenantOverloadedError,
                                                  TenantTable)
    from deeplearning4j_tpu_torch.ui import UIServer
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    iris = load_model(os.path.join(REPO, IRIS_ZIP), device="cuda")
    table = TenantTable.from_specs([
        {"tenant": "gold", "weight": 3.0, "quota_concurrent": 16},
        {"tenant": "free", "weight": 1.0, "quota_concurrent": PF_BURST},
        {"tenant": "metered", "quota_qps": 1, "burst": 1}])
    eng = Engine(iris, max_batch=4, replicas=2, slo_ms=60_000, max_wait_ms=1.0,
                 device="cuda", tenants=table).load()
    x = iris_data(1)[0]
    lat = {"gold": [], "free": []}

    def timed_submit(tenant):
        t0 = time.perf_counter()
        f = eng.output_async(x, tenant=tenant)
        f.add_done_callback(lambda _f: lat[tenant].append((time.perf_counter() - t0) * 1e3))
        return f
    log0 = len(eng.batch_log)
    burst = [timed_submit("free") for _ in range(PF_BURST)]
    gold = [timed_submit("gold") for _ in range(8)]
    for f in burst + gold:
        f.result(timeout=60)
    ids = {id(f) for f in gold}
    order = [i in ids for b in eng.batch_log[log0:] for i in b["request_ids"]]
    last_gold = max(k for k, g in enumerate(order) if g)
    p99 = {t: float(np.percentile(v, 99)) for t, v in lat.items()}
    # the quota race on the engine's front door (its DynamicBatcher kind)
    caps_table = TenantTable.from_specs([{"tenant": k, "quota_concurrent": v}
                                         for k, v in PF_RACE_CAPS.items()])
    b = DynamicBatcher(max_batch=4, slo_ms=10_000, max_queue=10_000, tenants=caps_table)
    start = threading.Barrier(PF_RACE_THREADS)
    admitted, shed, lock = [], [], threading.Lock()

    def pump(tid):
        tenant = f"t{tid % 3}"
        start.wait()
        for _ in range(PF_RACE_PER_THREAD):
            try:
                b.submit(x, tenant=tenant)
                with lock:
                    admitted.append(tenant)
            except TenantOverloadedError as e:
                with lock:
                    shed.append((tenant, e.tenant))
    threads = [threading.Thread(target=pump, args=(i,)) for i in range(PF_RACE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    b.close(fail_pending=True)
    race = {k: admitted.count(k) for k in PF_RACE_CAPS}
    server = UIServer(port=0, host="127.0.0.1").attach_engine(eng).start()
    try:
        url = f"http://127.0.0.1:{server.port}/predict"
        first = http_call(url, {"inputs": x.tolist(), "tenant": "metered"})
        second = http_call(url, {"inputs": x.tolist(), "tenant": "metered"})
    finally:
        server.stop()
    rec = {"arm": "c_tenants", "burst": PF_BURST, "gold_requests": len(gold),
           "e2e_p99_ms": p99, "last_gold_position": last_gold, "served": len(order),
           "race_admitted": race, "race_caps": PF_RACE_CAPS,
           "race_shed_typed": all(a == b_ for a, b_ in shed),
           "over_quota": [first[0], second[0], second[1].get("error_class"),
                          second[1].get("tenant"), second[1].get("reason")],
           "tenants": eng.metrics_snapshot()["tenants"]}
    bad = []
    if not (p99["gold"] < p99["free"] and last_gold < len(order) // 2 and race == PF_RACE_CAPS
            and rec["race_shed_typed"] and len(admitted) + len(shed)
            == PF_RACE_THREADS * PF_RACE_PER_THREAD
            and first[0] == 200 and second[0] == 429
            and second[1].get("error_class") == "tenant_overloaded"
            and table.concurrent("gold") == table.concurrent("free") == 0):
        bad.append(f"c: {rec}")
    return eng, rec, bad


def pf_metrics(engines):
    """(g) /metrics with both engines attached: the ``registry`` key holds
    each engine's collector, every histogram has ``buckets_ms`` and
    ``counts``."""
    from deeplearning4j_tpu_torch.ui import UIServer
    server = UIServer(port=0, host="127.0.0.1")
    for e in engines:
        server.attach_engine(e)
    server.start()
    try:
        code, m = http_call(f"http://127.0.0.1:{server.port}/metrics")
    finally:
        server.stop()
    names = [e.metrics.global_name for e in engines]
    hists = [s[k] for s in m.get("serving", []) for k in ("queue_wait_ms", "device_time_ms",
                                                          "e2e_ms")]
    ok = (code == 200 and "registry" in m
          and all(n in m["registry"]["collected"] for n in names)
          and len(hists) == 3 * len(engines)
          and all("buckets_ms" in h and "counts" in h and sum(h["counts"]) == h["count"]
                  for h in hists))
    rec = {"arm": "g_metrics", "status": code, "collectors": names,
           "registry_collected": sorted(m.get("registry", {}).get("collected", {})),
           "histograms_with_buckets": len(hists)}
    return rec, ([] if ok else [f"g: {rec}"])


def pf_bundle(net, rng, tmp):
    """(f) ``save_warmup_bundle``, a fresh engine ``load(warm_bundle=)``, and
    a corrupted bundle (GPT-2-small f32, one replica)."""
    import warnings

    import numpy as np

    from deeplearning4j_tpu_torch.serving import Engine

    xs = [rng.integers(0, VOCAB, (r, MAX_LEN)).astype(np.float32) for r in (1, 3)]
    path = os.path.join(tmp, "gpt2.zip.warm")
    loads, outs, counts, warned = {}, {}, {}, {}
    for arm in ("first", "bundle", "corrupt"):
        if arm == "corrupt":
            with open(path, "r+b") as f:
                f.seek(os.path.getsize(path) // 2)
                f.write(b"\x00" * 64)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            eng = Engine(net, max_batch=4, replicas=1, slo_ms=600_000, device="cuda").load(
                input_shape=(MAX_LEN,), warm_bundle=None if arm == "first" else path)
            loads[arm] = time.perf_counter() - t0
        warned[arm] = sum(issubclass(x.category, RuntimeWarning) for x in w)
        try:
            outs[arm] = [eng.output(x) for x in xs]
            counts[arm] = {k: int(eng.metrics.counter_value(k))
                           for k in ("bundle_hits", "bundle_misses", "unwarmed_serves")}
            if arm == "first":
                eng.save_warmup_bundle(path)
        finally:
            eng.shutdown()
    same = {a: all(np.array_equal(u, v) for u, v in zip(outs[a], outs["first"]))
            for a in ("bundle", "corrupt")}
    rec = {"arm": "f_bundle", "load_s": loads, "counters": counts, "warnings": warned,
           "bitwise_first": same}
    ok = (counts["first"]["bundle_misses"] == 3 and counts["bundle"] == {
        "bundle_hits": 3, "bundle_misses": 0, "unwarmed_serves": 0}
          and counts["corrupt"]["bundle_misses"] == 3 and counts["corrupt"]["bundle_hits"] == 0
          and warned == {"first": 0, "bundle": 0, "corrupt": 1} and all(same.values()))
    return rec, ([] if ok else [f"f: {rec}"])


def pf_autoscale(net, rng):
    """(d) ``enable_autoscale`` with bounds 1-2 over GPT-2-small f32."""
    import numpy as np

    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.serving import Engine

    eng = Engine(net, max_batch=4, replicas=1, slo_ms=600_000, device="cuda").load(
        input_shape=(MAX_LEN,))
    births = []
    real = eng._rewarm_replica

    def watch(idx):
        routable = idx < len(eng._replicas)
        t0 = time.perf_counter()
        real(idx)
        births.append({"replica": idx, "routable_before_capture": routable,
                       "graphs_after_capture": eng.compile_cache_size(),
                       "capture_s": time.perf_counter() - t0})
    eng._rewarm_replica = watch
    try:
        per_replica = eng.compile_cache_size()
        eng.enable_autoscale(min_replicas=1, max_replicas=2, up_load=2.0, down_load=0.5,
                             up_ticks=2, down_ticks=5, cooldown_s=1.0, interval_s=0.1)
        xs = [rng.integers(0, VOCAB, (1 + i % 3, MAX_LEN)).astype(np.float32)
              for i in range(24)]
        with GraphSpy() as spy:
            att.flash_forward_cuda.launches = 0
            t0 = time.perf_counter()
            futs = [eng.output_async(x) for x in xs]
            errors = []
            for f in futs:
                try:
                    f.result(timeout=600)
                except Exception as e:
                    errors.append(repr(e))
            burst_s = time.perf_counter() - t0
            k1 = att.flash_forward_cuda.launches
        peak = {"replicas": len(eng._replicas), "graphs": eng.compile_cache_size()}
        deadline = time.monotonic() + 30
        while eng.metrics.counter_value("scale_downs") < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        c = eng.metrics_snapshot()["counters"]
        by_replica = {}
        for b in eng.batch_log:
            by_replica[b["replica"]] = by_replica.get(b["replica"], 0) + 1
        rec = {"arm": "d_autoscale", "births": births, "burst_s": burst_s, "peak": peak,
               "after": {"replicas": len(eng._replicas), "graphs": eng.compile_cache_size()},
               "scale_ups": c["scale_ups"], "scale_downs": c["scale_downs"],
               "unwarmed_serves": c["unwarmed_serves"], "batches_by_replica": by_replica,
               "replays": spy.replays, "captures": len(spy.captures),
               "served_captures": spy.served_captures(), "k1": k1, "errors": errors}
    finally:
        eng.shutdown()
    ok = (c["scale_ups"] >= 1 and c["scale_downs"] >= 1 and c["unwarmed_serves"] == 0
          and births and not births[0]["routable_before_capture"]
          and births[0]["graphs_after_capture"] == 2 * per_replica == 6
          and peak["graphs"] == per_replica * peak["replicas"]
          and rec["after"] == {"replicas": 1, "graphs": per_replica}
          and by_replica.get(1, 0) > 0 and spy.served_captures() == 0 and not errors
          and k1 == LAYERS * (spy.replays + 2 * len(spy.captures)))
    return rec, ([] if ok else [f"d: {rec}"])


def perturbed(net, fill_nan=False, seed=SEED + 60):
    """Another version of ``net``: the same network object's configuration,
    its parameters cloned on the card and nudged by 1e-4 of noise (or the
    head's bias NaN)."""
    import copy

    import torch
    other = copy.copy(net)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    other.params = [{k: v + 1e-4 * torch.randn(v.shape, generator=gen, device="cuda")
                     for k, v in p.items()} for p in net.params]
    if fill_nan:
        other.params[-1]["b"] = torch.full_like(other.params[-1]["b"], float("nan"))
    return other


#: arm (e)'s time limit: a guard (its usual wall is ~15-25 s); past it
#: every thread's stack is printed and the run fails
PF_CANARY_LIMIT_S = 300
#: arm (e)'s watchdog fires this long into the arm, before the limit, and
#: prints the state of every forward-graph call in flight
PF_CANARY_WATCH_S = 240
#: the longest a watchdog waits on one question to the card (an event's
#: query, the free memory): a driver lock that holds a stalled copy could
#: hold the question too
PF_CANARY_ASK_S = 5.0


def ask_card(fn, timeout=PF_CANARY_ASK_S):
    """``fn()`` on a helper thread → its value (or the error it raised, as
    text), or the string "query blocked" where it has not returned within
    ``timeout`` seconds (the helper is left to finish on its own)."""
    out = []

    def ask():
        try:
            out.append(fn())
        except Exception as e:   # reported, not raised: the watchdog only reads
            out.append(f"error: {e!r}")
    t = threading.Thread(target=ask, daemon=True)
    t.start()
    t.join(timeout)
    return out[0] if out else "query blocked"


def host_memory() -> dict:
    """The host's MemAvailable and SwapFree and this process's VmRSS and
    VmSwap, in kB, as /proc reports them (read only)."""
    out = {}
    for path, keys in (("/proc/meminfo", ("MemAvailable", "SwapFree")),
                       ("/proc/self/status", ("VmRSS", "VmSwap"))):
        try:
            with open(path) as f:
                for line in f:
                    name, _, rest = line.partition(":")
                    if name in keys:
                        out[name + "_kB"] = int(rest.split()[0])
        except OSError as e:
            out[path] = repr(e)
    return out


def thread_states(gap_s: float = 1.0) -> list:
    """Each Python thread of this process as the kernel sees it (read only
    from /proc/self/task): its scheduler state, wait channel and system
    call (its number, or "running"), and the CPU ticks it used over
    ``gap_s`` seconds.  A thread asleep in a futex (202 on x86-64) with no
    ticks waits on a lock (the interpreter's among them); one in an ioctl
    (16) waits in the CUDA driver; one running with ticks spins, as a
    CUDA synchronisation does by default."""
    import threading as th

    def sample(tid):
        base = f"/proc/self/task/{tid}"
        try:
            with open(f"{base}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            extra = []
            for leaf in ("wchan", "syscall"):
                try:
                    with open(f"{base}/{leaf}") as f:
                        extra.append(f.read().split(" ", 1)[0].strip())
                except OSError:
                    extra.append(None)
            return fields[0], int(fields[11]) + int(fields[12]), *extra
        except (OSError, IndexError, ValueError):
            return None
    threads = [(t.name, t.native_id) for t in th.enumerate() if t.native_id is not None]
    first = {tid: sample(tid) for _, tid in threads}
    time.sleep(gap_s)
    out = []
    for name, tid in threads:
        a, b = first[tid], sample(tid)
        if a is None or b is None:
            continue
        out.append({"thread": name, "state": b[0], "wchan": b[2], "syscall": b[3],
                    "cpu_ticks": b[1] - a[1]})
    return out


class CanaryWatch:
    """Arm (e)'s instrument.  While open, every ``ForwardGraph`` call is
    recorded with its thread, bucket, replica and version tag and the
    moment each of its stages began: the input copy, the replay enqueued,
    the finiteness read and the host copy (with the bytes it moves).  At
    the start, and ``PF_CANARY_WATCH_S`` seconds in if the arm is still
    running, it prints one JSON line with the host's and the card's memory
    and, for every call in flight, its stages' ages and whether the event
    recorded after its replay has completed (``Event.query()``, asked on a
    helper thread); when the watchdog fires, also every thread's state as
    the kernel sees it (``thread_states``) and its innermost frame, the
    last versions whose graphs were released (entered and left), and
    every thread's stack on stderr.  It changes nothing the engine does:
    the stages are marked by wrapping ``CUDAGraph.replay``,
    ``rows_to_host`` and ``host_copy`` (the wrappers call the real ones),
    the releases by wrapping ``_ModelVersion.release``, and the replica
    and the version come from the engine's ``_run_forward``."""

    def __init__(self, eng):
        self.eng, self.inflight, self.fired = eng, {}, False
        self.local = threading.local()
        self.lock = threading.Lock()

    def line(self, at: str) -> dict:
        import torch
        calls = []
        now = time.perf_counter()
        with self.lock:
            recs = list(self.inflight.values())
        for r in recs:
            # copies: the calling thread goes on marking its record
            rec = dict(r)
            stages, g = dict(rec.pop("stages")), rec.pop("graph")
            rec["stage_age_s"] = {k: now - t for k, t in stages.items()}
            # the event recorded after this call's replay (before the replay
            # is enqueued it still holds the last call's)
            rec["replay_event"] = ask_card(
                lambda g=g: "completed" if g._events[1].query() else "not completed")
            calls.append(rec)
        free = ask_card(lambda: list(torch.cuda.mem_get_info()))
        return {"phase": "predict_features", "arm": "e_watchdog", "at": at,
                "host": host_memory(), "cuda_mem_get_info": free,
                "cuda_memory_reserved": torch.cuda.memory_reserved(),
                "calls_in_flight": calls}

    def fire(self):
        import faulthandler
        self.fired = True
        rec = self.line(f"{PF_CANARY_WATCH_S} s")
        rec["switch_interval_s"] = sys.getswitchinterval()
        rec["threads"] = thread_states()
        rec["frames"] = self.frames()
        with self.lock:
            rec["releases"] = list(self.releases)
        emit(rec)
        # to the process's stderr, beside the limit's
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)

    @staticmethod
    def frames() -> dict:
        """Each thread's innermost frame (file, line, last instruction)."""
        import threading as th
        names = {t.ident: t.name for t in th.enumerate()}
        return {names.get(ident, str(ident)): [f.f_code.co_filename.rsplit("/", 1)[-1],
                                               f.f_lineno, f.f_lasti]
                for ident, f in sys._current_frames().items()}

    def __enter__(self):
        import torch

        from deeplearning4j_tpu_torch.serving import cuda_graphs as cg
        from deeplearning4j_tpu_torch.serving import engine as em
        watch, local = self, self.local
        self.cg, self.em, self.torch = cg, em, torch
        self._call, self._replay = cg.ForwardGraph.__call__, torch.cuda.CUDAGraph.replay
        self._rows, self._copy, self._run = cg.rows_to_host, cg.host_copy, self.eng._run_forward
        self._release = em._ModelVersion.release
        self.releases = []              # (thread, version, enter/exit, s into the arm)
        t_arm = time.perf_counter()

        def release(v, *a, **k):
            def note(what):
                with watch.lock:
                    watch.releases.append((threading.current_thread().name, v.tag, what,
                                           time.perf_counter() - t_arm))
                    del watch.releases[:-16]
            note("enter")
            try:
                return watch._release(v, *a, **k)
            finally:
                note("exit")

        def mark(stage, **extra):
            rec = getattr(local, "rec", None)
            if rec is not None:
                rec["stages"][stage] = time.perf_counter()
                rec.update(extra)

        def run_forward(v, idx, xs, rows=None):
            local.ctx = (idx, v.tag)
            try:
                return watch._run(v, idx, xs, rows)
            finally:
                local.ctx = None

        def call(g, x, rows):
            idx, tag = getattr(local, "ctx", None) or (None, None)
            rec = {"thread": threading.current_thread().name, "bucket": g.input.shape[0],
                   "replica": idx, "version": tag, "graph": g,
                   "stages": {"input_copy": time.perf_counter()}}
            with watch.lock:
                watch.inflight[id(rec)] = rec
            local.rec = rec
            try:
                return watch._call(g, x, rows)
            finally:
                local.rec = None
                with watch.lock:
                    watch.inflight.pop(id(rec), None)

        def replay(graph):
            mark("replay_enqueued")
            return watch._replay(graph)

        def rows_to_host(y, rows, *a):
            mark("finite_read")
            return watch._rows(y, rows, *a)

        def host_copy(y, pinned=None):
            size = 4 if y.dtype == torch.bfloat16 else y.element_size()   # bf16 widens
            mark("host_copy", host_copy_bytes=y.numel() * size,
                 host_copy_pinned=pinned is not None)
            return watch._copy(y, pinned)

        cg.ForwardGraph.__call__, torch.cuda.CUDAGraph.replay = call, replay
        cg.rows_to_host, cg.host_copy, self.eng._run_forward = rows_to_host, host_copy, run_forward
        em._ModelVersion.release = release
        emit(self.line("start"))
        self.timer = threading.Timer(PF_CANARY_WATCH_S, self.fire)
        self.timer.daemon = True
        self.timer.start()
        return self

    def __exit__(self, *exc):
        self.timer.cancel()
        self.cg.ForwardGraph.__call__ = self._call
        self.torch.cuda.CUDAGraph.replay = self._replay
        self.cg.rows_to_host, self.cg.host_copy = self._rows, self._copy
        self.em._ModelVersion.release = self._release
        del self.eng._run_forward


class StepTimes:
    """Seconds of each call of the named methods of ``obj`` (a class or
    an instance), for the length of a ``with`` block: name → [s, ...]."""

    def __init__(self, obj, names):
        self.obj, self.names, self.seconds = obj, names, {n: [] for n in names}

    def __enter__(self):
        self.real = {n: getattr(self.obj, n) for n in self.names}
        for n in self.names:
            def timed(*a, _n=n, **k):
                t = time.perf_counter()
                try:
                    return self.real[_n](*a, **k)
                finally:
                    self.seconds[_n].append(time.perf_counter() - t)
            setattr(self.obj, n, timed)
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            setattr(self.obj, n, f)


def pf_canary(net, rng):
    """(e) v1 → v2 of GPT-2-small through ``set_alias(canary=0.5,
    canary_window=4)``, then a NaN-poisoned v3.  Under a time limit
    (``PF_CANARY_LIMIT_S``) whose expiry prints every thread's stack and
    fails the run; the record times the two canaries, the engine's warm,
    swap and drain steps, each capture and the replica calls."""
    import faulthandler

    faulthandler.dump_traceback_later(PF_CANARY_LIMIT_S, exit=True)
    try:
        return _pf_canary(net, rng)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _pf_canary(net, rng):
    import numpy as np

    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.serving import Engine, ModelRegistry

    reg = ModelRegistry(device="cuda")
    v1 = reg.register("gpt2", net)
    v2 = reg.register("gpt2", perturbed(net))
    v3 = reg.register("gpt2", perturbed(net, fill_nan=True))
    reg.set_alias("gpt2", "prod", v1)
    eng = Engine.from_registry(reg, "gpt2", "prod", max_batch=4, replicas=2,
                               slo_ms=600_000, max_wait_ms=1.0, device="cuda").load(
        input_shape=(MAX_LEN,))
    stop, errors, served = threading.Event(), [], []

    def traffic():
        while not stop.is_set():
            try:
                y = eng.output_async(rng.integers(0, VOCAB, (1, MAX_LEN)).astype(np.float32)
                                     ).result(timeout=120)
                served.append(bool(np.isfinite(y).all()))
            except Exception as e:
                errors.append(repr(e))
    threads = [threading.Thread(target=traffic) for _ in range(2)]
    steps = StepTimes(eng, ("_warm_version", "_swap_version", "_drain_and_release"))
    try:
        with GraphSpy() as spy, steps, CanaryWatch(eng) as watch:
            att.flash_forward_cuda.launches = 0
            for t in threads:
                t.start()
            t0 = time.perf_counter()
            good = reg.set_alias("gpt2", "prod", v2, canary=0.5, canary_window=4,
                                 canary_timeout_s=120)
            t1 = time.perf_counter()
            bad_rec = reg.set_alias("gpt2", "prod", v3, canary=0.5, canary_window=4,
                                    canary_timeout_s=120)
            t2 = time.perf_counter()
            stop.set()
            for t in threads:
                t.join(timeout=600)
            t3 = time.perf_counter()
            k1 = att.flash_forward_cuda.launches
        c = eng.metrics_snapshot()["counters"]
        rec = {"arm": "e_canary", "promoted_v2": good["promoted"],
               "v2_decision": good["decisions"][0], "promoted_v3": bad_rec["promoted"],
               "v3_decision": bad_rec["decisions"][0],
               "history": [(r["to"], r["promoted"]) for r in reg.canary_history("gpt2")],
               "current": eng.current_tag, "alias": reg.resolve("gpt2", "prod")[0],
               "watchdog_fired": watch.fired,
               "graphs": eng.compile_cache_size(), "captures": len(spy.captures),
               "served_captures": spy.served_captures(), "replays": spy.replays, "k1": k1,
               "unwarmed_serves": c["unwarmed_serves"], "requests": len(served),
               "all_finite": all(served), "errors": errors,
               "counters": {k: c[k] for k in ("canary_promotions", "canary_rollbacks",
                                              "canary_mirrored_batches", "swaps")},
               "seconds": {"canary_v2": t1 - t0, "canary_v3": t2 - t1, "traffic_join": t3 - t2,
                           **{k.strip("_"): v for k, v in steps.seconds.items()},
                           "captures": spy.capture_s, "replica_calls": spy.replays,
                           "replica_call_max": spy.call_s_max,
                           "replica_call_total": spy.call_s_total}}
    finally:
        stop.set()
        eng.shutdown()
    ok = (good["promoted"] and not bad_rec["promoted"] and rec["history"] == [(v2, True),
                                                                             (v3, False)]
          and rec["current"] == f"gpt2:v{v2}" and rec["alias"] == v2 and rec["graphs"] == 6
          and len(spy.captures) == 12 and spy.served_captures() == 0
          and c["unwarmed_serves"] == 0 and rec["all_finite"] and not errors
          and bad_rec["decisions"][0]["error_rate"] == 1.0
          and k1 == LAYERS * (spy.replays + 2 * len(spy.captures)))
    return rec, ([] if ok else [f"e: {rec}"])


def phase_predict_features(net):
    """The predict side's features on the card, arms (a)-(g) (the module
    docstring); every gate must hold."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import attention as att

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 90)
    tmp = tempfile.mkdtemp(prefix="chip_pf_")
    out, bad, k1 = {}, [], 0
    try:
        eng8, out["a"], b = pf_int8(net, rng)
        bad += b
        emit({"phase": "predict_features", **out["a"]})
        try:
            out["b"], b = pf_named(eng8, rng, tmp)
            bad += b
            emit({"phase": "predict_features", **out["b"]})
            eng_t, out["c"], b = pf_tenants(rng)
            bad += b
            emit({"phase": "predict_features", **out["c"]})
            try:
                out["g"], b = pf_metrics([eng8, eng_t])
                bad += b
                emit({"phase": "predict_features", **out["g"]})
            finally:
                eng_t.shutdown()
        finally:
            eng8.shutdown()
        k1 += out["a"]["k1"]
        gc.collect()
        torch.cuda.empty_cache()
        for key, arm in (("f", lambda: pf_bundle(net, rng, tmp)),
                         ("d", lambda: pf_autoscale(net, rng)),
                         ("e", lambda: pf_canary(net, rng))):
            att.flash_forward_cuda.launches = 0
            out[key], b = arm()
            k1 += att.flash_forward_cuda.launches if key == "f" else out[key]["k1"]
            bad += b
            emit({"phase": "predict_features", **out[key]})
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "predict_features", "seconds": time.perf_counter() - t0,
          "launches": {"flash_fwd": k1}, "failures": bad})
    if bad:
        raise AssertionError(f"predict_features phase failed: {bad}")
    return {**out, "launches": {"flash_fwd": k1}}


# -- http phase ----------------------------------------------------------------------

IRIS_ZIP = os.path.join("deeplearning4j_tpu", "models", "weights", "iris_mlp_iris.zip")
HTTP_PROMPT, HTTP_NEW = 32, 16


def http_call(url, payload=None, raw=None):
    """(status, parsed JSON body) of a GET (no payload) or a POST."""
    import urllib.error
    import urllib.request
    data = raw if raw is not None else (None if payload is None
                                        else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def iris_data(rows=150, seed=SEED + 7):
    """Iris-shaped data from a seed: 3 classes of 4 features around the
    Iris class means (cm), one-hot labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    means = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]],
                     np.float32)
    y = rng.integers(0, 3, rows)
    x = (means[y] + 0.35 * rng.standard_normal((rows, 4))).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[y]


def phase_http(net):
    """``UIServer`` on 127.0.0.1 at an ephemeral port with a predict
    ``Engine`` over the repository's Iris MLP checkpoint and a
    ``DecodeEngine`` over the full-width TransformerLM; then ``serve
    --smoke 8`` on the Iris checkpoint in a process of its own."""
    import threading

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.ops import kv_cache as kvc
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Engine
    from deeplearning4j_tpu_torch.ui import UIServer
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    iris = load_model(os.path.join(REPO, IRIS_ZIP), device="cuda")
    eng = Engine(iris, max_batch=4, replicas=2, slo_ms=60_000, max_wait_ms=200.0,
                 device="cuda").load()
    dec = DecodeEngine(TransformerDecodeAdapter(net), max_slots=4, page_size=16,
                       max_len=MAX_LEN, device="cuda").load()
    server = UIServer(port=0, host="127.0.0.1").attach_engine(eng)
    server.attach_decode_engine(dec).start()
    base = f"http://127.0.0.1:{server.port}"
    gates, codes = {}, {}
    try:
        x, _ = iris_data(3)
        code, r = http_call(base + "/predict", {"inputs": x.tolist()})
        codes["predict"] = code
        direct = eng.output(x)
        gates["predict_bitwise_direct"] = (code == 200 and np.array_equal(
            np.asarray(r["outputs"], np.float32), direct))

        # one NaN row among four concurrent requests: co-batched, it fails
        # alone with 422 while the others answer 200
        rows = [x[0], np.full(4, np.nan, np.float32), x[1], x[2]]
        got = [None] * 4

        def send(i):
            got[i] = http_call(base + "/predict",
                               raw=json.dumps({"inputs": [rows[i].tolist()]}).encode())

        log0 = len(eng.batch_log)
        threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        codes["poison_batch"] = [g[0] for g in got]
        poisoned = [b["n_requests"] for b in eng.batch_log[log0:] if b["poison"]]
        gates["poison_422_alone"] = (codes["poison_batch"] == [200, 422, 200, 200]
                                     and got[1][1]["error_class"] == "poison_input")
        # the poison request's own batch held others, so bisection ran
        gates["poison_co_batched"] = len(poisoned) == 1 and poisoned[0] >= 2
        gates["co_batched_rows_right"] = all(
            float(np.abs(np.asarray(got[i][1]["outputs"], np.float32)
                         - iris.output(rows[i][None]).cpu().numpy()).max()) <= 1e-6
            for i in (0, 2, 3) if got[i][0] == 200)

        code, r = http_call(base + "/predict", raw=b"{not json")
        codes["malformed"] = code
        gates["malformed_400"] = code == 400 and r["error_class"] == "bad_request"

        rng = np.random.default_rng(SEED + 8)
        prompt = rng.integers(0, VOCAB, HTTP_PROMPT).tolist()
        kvc.det_attention_cuda.launches = 0
        t0 = time.perf_counter()
        code, r = http_call(base + "/generate", {"prompt_ids": prompt,
                                                 "max_tokens": HTTP_NEW})
        gen_ms = (time.perf_counter() - t0) * 1e3
        d1 = kvc.det_attention_cuda.launches
        codes["generate"] = code
        want = dec.generate(prompt, max_new_tokens=HTTP_NEW)
        gates["generate_equals_direct"] = (code == 200 and r["tokens"] == want.tokens
                                           and len(want.tokens) == HTTP_NEW)

        code, h = http_call(base + "/healthz")
        codes["healthz"] = code
        gates["healthz_both_ready"] = (code == 200 and h["ready"]
                                       and h["engines"]["predict"]["ready"]
                                       and h["engines"]["decode"]["ready"])
        code, m = http_call(base + "/metrics")
        codes["metrics"] = code
        gates["metrics_both_engines"] = (
            code == 200 and len(m["serving"]) == 2
            and m["serving"][0]["counters"]["poison_isolated"] == 1
            and m["serving"][1]["counters"]["tokens_out"] >= HTTP_NEW)
        predict_snap = eng.metrics_snapshot()
    finally:
        server.stop()
        eng.shutdown()
        dec.shutdown()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    smoke = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
                            "--model", os.path.join(REPO, IRIS_ZIP), "--smoke", "8",
                            "--replicas", "1", "--max-batch", "4"],
                           cwd=REPO, capture_output=True, text=True, timeout=600)
    smoke_s = time.perf_counter() - t0
    smoke_snap = (json.loads(smoke.stdout.strip().splitlines()[-1])
                  if smoke.returncode == 0 else None)
    gates["serve_smoke_exit_0"] = (smoke.returncode == 0
                                   and smoke_snap["counters"]["requests"] == 8
                                   and smoke_snap["counters"]["unwarmed_serves"] == 0)
    iris_mixed = iris_mixed_arm(iris)
    gates.update({f"iris_mixed_{k}": v for k, v in iris_mixed["gates"].items()})
    rec = {"phase": "http", "codes": codes, "gates": gates,
           "launches": {"det_attention": d1}, "generate_ms": gen_ms,
           "poison_batch_requests": poisoned,
           "predict_counters": {k: predict_snap["counters"][k]
                                for k in ("requests", "poison_isolated", "unwarmed_serves")},
           "serve_smoke": {"rc": smoke.returncode, "seconds": smoke_s,
                           "stderr_tail": smoke.stderr[-400:] if smoke.returncode else ""},
           "iris_mixed": iris_mixed}
    emit(rec)
    bad = [k for k, v in gates.items() if not v]
    if bad:
        raise AssertionError(f"http phase failed its gates: {bad}")
    return rec


def iris_mixed_arm(iris):
    """The Iris MLP with float32 parameters computed in bfloat16: 20 steps
    of its checkpoint's Adam (lr 5e-3) on Iris-shaped data, K4 on, on the
    card and on the CPU from the same weights."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerConfiguration,
                                                        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    os.environ[uk.ENV_SWITCH] = "1"
    d = iris.conf.to_dict()
    d["compute_dtype"] = "bfloat16"
    x, y = iris_data()
    runs = {}
    for dev in ("cuda", "cpu"):
        n = MultiLayerNetwork(MultiLayerConfiguration.from_dict(d), device=dev)
        n.params = [{k: v.detach().to(dev) for k, v in p.items()} for p in iris.params]
        n.state = [{} for _ in iris.params]
        n.opt_state = n.init_opt_state(n.params)
        probe = DtypeProbe()
        uk.fused_update_cuda.launches = 0
        with probe:
            losses = [float(n.fit_batch(DataSet(x, y))) for _ in range(20)]
        runs[dev] = (n, losses, uk.fused_update_cuda.launches, probe.seen)
    (card, lc, k4, seen), (cpu, lp, _, _) = runs["cuda"], runs["cpu"]
    rel = max(float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
              for pa, pb in zip(card.params, cpu.params) for a, b in
              ((pa[k], pb[k]) for k in pa))
    out_dtype = str(card.output(x[:2]).dtype)
    gates = {"loss_falls": lc[-1] < lc[0] and all(math.isfinite(v) for v in lc),
             "params_f32": all(t.dtype == torch.float32 for p in card.params
                               for t in p.values()),
             "losses_match_cpu": all(bf16_close(a, b) for a, b in zip(lc, lp)),
             "params_match_cpu": rel <= MIXED_PARAM_REL_TOL,
             "k4_ran_f32": k4 == 20 * 3 and seen.get("fused_update") == ["torch.float32"]}
    return {"losses": lc, "cpu_losses": lp, "param_rel_diff": rel,
            "param_rel_tolerance": MIXED_PARAM_REL_TOL,
            "k4_launches": k4, "kernel_dtypes": seen, "output_dtype": out_dtype,
            "gates": gates}


# -- mixed float32-param / bfloat16-compute arms ----------------------------------------

#: card against CPU, same weights and data: a loss within two bfloat16
#: spacings of its size (the loss is computed from bfloat16 logits), and
#: every parameter tensor within 1e-2 of its norm (float32 parameters
#: stepped from gradients of bfloat16 sums taken in another order)
MIXED_LOSS_REL_TOL, MIXED_PARAM_REL_TOL = 2.0 ** -6, 1e-2


def bf16_close(a: float, b: float) -> bool:
    return abs(a - b) <= MIXED_LOSS_REL_TOL * max(1.0, abs(b))


class DtypeProbe:
    """Inside it, the entry points that launch the kernels a mixed-dtype
    arm can reach (``lstm_seq_fwd``, ``lstm_cell_bwd``, ``fused_update``,
    ``flash_forward``: each launches its kernel on CUDA tensors) record the
    dtype of the first tensor each is given, by kernel name.  The kernels'
    wrappers, and their launch counts, are not touched."""

    def __enter__(self):
        import torch

        from deeplearning4j_tpu_torch.ops import attention as att
        from deeplearning4j_tpu_torch.ops import lstm_kernel as lk
        from deeplearning4j_tpu_torch.ops import update_kernel as uk
        self.seen, self._saved = {}, []
        for mod, attr, name in ((lk, "lstm_seq_fwd", "lstm_seq_fwd"),
                                (lk, "lstm_cell_bwd", "lstm_cell_bwd"),
                                (uk, "fused_update", "fused_update"),
                                (att, "flash_forward", "flash_fwd")):
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                t = next(x for x in a if isinstance(x, torch.Tensor))
                if t.is_cuda:
                    got = self.seen.setdefault(_name, [])
                    if str(t.dtype) not in got:
                        got.append(str(t.dtype))
                return _fn(*a, **kw)

            setattr(mod, attr, wrapped)
            self._saved.append((mod, attr, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


def rnn_mixed_arm(ds_card, ds_cpu):
    """Bench config 4's char-RNN (``LSTM(256)`` layers, so K5a/K5b run)
    with float32 parameters computed in bfloat16: 5 ``fit_batch`` calls on
    the card and on the CPU from the same weights.  The ids are integers,
    so the LSTM's carry, and with it its gates, takes the compute dtype
    (the reference's ``recurrent.py:176``): K5a and K5b run in bfloat16."""
    import torch

    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    runs = {}
    for dev, ds in (("cuda", ds_card), ("cpu", ds_cpu)):
        net = build_rnn(dev, dtype=("float32", "bfloat16"))
        counters = (lk.lstm_seq_fwd_cuda, lk.lstm_cell_bwd_cuda, uk.fused_update_cuda)
        for c in counters:
            c.launches = 0
        losses, secs = [], []
        with DtypeProbe() as probe:
            for _ in range(5):
                t0 = time.perf_counter()
                losses.append(float(net.fit_batch(ds)))    # reading it syncs
                secs.append(time.perf_counter() - t0)
        runs[dev] = (net, losses, [c.launches for c in counters], probe.seen, secs)
    (card, lc, launches, seen, card_s), (cpu, lp, _, _, cpu_s) = runs["cuda"], runs["cpu"]
    rel = max(float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
              for pa, pb in zip(card.params, cpu.params) for a, b in
              ((pa[k], pb[k]) for k in pa))
    chunks = -(-RNN_T // RNN_TBPTT)
    gates = {"loss_falls": lc[-1] < lc[0] and all(math.isfinite(v) for v in lc),
             "params_f32": all(t.dtype == torch.float32 for p in card.params
                               for t in p.values()),
             "losses_match_cpu": all(bf16_close(a, b) for a, b in zip(lc, lp)),
             "params_match_cpu": rel <= MIXED_PARAM_REL_TOL,
             "launches": launches == [5 * 2 * chunks, 5 * 2 * RNN_T, 5 * 3 * chunks],
             "k5_ran_bf16": (seen.get("lstm_seq_fwd") == ["torch.bfloat16"]
                             and seen.get("lstm_cell_bwd") == ["torch.bfloat16"])}
    return {"losses": lc, "cpu_losses": lp, "param_rel_diff": rel,
            "param_rel_tolerance": MIXED_PARAM_REL_TOL,
            "loss_rel_tolerance": MIXED_LOSS_REL_TOL,
            "launches": dict(zip(("lstm_seq_fwd", "lstm_cell_bwd", "fused_update"), launches)),
            "kernel_dtypes": seen, "fit_batch_s": card_s,
            "median_fit_batch_ms": sorted(card_s)[2] * 1e3, "cpu_fit_batch_s": cpu_s,
            "output_dtype": str(card.output(ds_cpu.features[:1, :4]).dtype), "gates": gates}


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
    rec["fit_batches"] = lm_fit_batches_arm(net, ds, rng, med)
    rec["spans"] = lm_span_arm(net, ds)
    return rec


def lm_span_arm(net, ds) -> dict:
    """``fit_batch`` with tracing off and on, from the same state, in the
    order off, on, on, off (the first eager step after the graph arm pays
    for fresh allocations): each traced step's span tree is the
    reference's (train/step over train/h2d and train/dispatch, then
    train/device_sync on the loss's read), and every step's loss and
    parameters are bitwise the first's.  Prints the step times (wall, to
    the loss's read)."""
    import torch

    from deeplearning4j_tpu_torch.obs import trace as obs_trace

    def train_tree(tree):
        return [(n["name"], n["event"].get("args"), train_tree(n["children"]))
                for n in tree if n["event"].get("cat") == "train"]

    t_arm = time.perf_counter()
    start = (clone_trees(net.params), clone_trees(net.opt_state), net.iteration)
    want = [("train/step", {"iteration": start[2] + 1},
             [("train/h2d", None, []), ("train/dispatch", None, [])]),
            ("train/device_sync", None, [])]
    times = {"off": [], "on": []}
    losses, trees_ok, valid, bitwise, first = [], True, True, True, None
    for mode in ("off", "on", "on", "off"):
        net.params, net.opt_state, net.iteration = (clone_trees(start[0]),
                                                    clone_trees(start[1]), start[2])
        rec_ = obs_trace.enable_tracing() if mode == "on" else None
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(net.fit_batch(ds)))
            times[mode].append(time.perf_counter() - t0)
            events = rec_.export() if rec_ is not None else None
        finally:
            obs_trace.disable_tracing()
        if events is not None:
            trees_ok &= train_tree(obs_trace.span_tree(events)) == want
            valid &= obs_trace.validate_chrome_trace(events) == []
        if first is None:
            first = clone_trees(net.params)
        else:
            bitwise &= trees_equal(first, net.params)
    bitwise &= len(set(losses)) == 1
    del start, first
    out = {"phase": "train", "arm": "spans", "card": card_line(), "order": "off on on off",
           "step_s_untraced": times["off"], "step_s_traced": times["on"],
           "losses": losses, "span_tree": want, "span_tree_ok": trees_ok,
           "bitwise": bitwise, "trace_valid": valid,
           "seconds": time.perf_counter() - t_arm}
    emit(out)
    if not (trees_ok and bitwise and valid):
        raise AssertionError("traced training step differs from the reference's "
                             "spans or from the untraced step")
    return out


def clone_trees(trees):
    return [{k: (clone_trees([v])[0] if isinstance(v, dict) else v.clone())
             for k, v in t.items()} for t in trees]


def trees_equal(a, b) -> bool:
    """Two lists of per-layer trees, leaf for leaf, bitwise."""
    import torch

    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    return all(torch.equal(x, y) for p, q in zip(a, b)
               for x, y in zip(tree_leaves(p), tree_leaves(q)))


def busy_ms(spans) -> float:
    """Device-busy milliseconds: the union of kernel intervals (us)."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total / 1e3


def device_profile(fn, names=(), top: int = 0) -> dict:
    """One traced call of ``fn`` (ending in a synchronize): its wall time,
    the device's busy time and idle share, its kernel count, the count
    and device ms of kernels whose name holds each of ``names``, and the
    ``top`` kernel names by device time (name cut to 90 characters).  The
    call starts ``TRACE_PAUSE_S`` into the trace and ends as long before
    its end, as in ``traced_kernels``: the profiler can lose the records
    of kernels at a trace's ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAUSE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_PAUSE_S)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms([(a, b) for _, a, b in spans])
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall if wall else None,
            "kernels": len(spans),
            "named": {n: sum(n in k for k, _, _ in spans) for n in names},
            "named_ms": {n: sum(b - a for k, a, b in spans if n in k) / 1e3 for n in names},
            "classes_ms": kernel_class_ms(spans), "top_ms": _top_kernels(spans, top)}


#: kernel classes by name, first match wins (cuDNN's convolutions run as
#: implicit GEMMs, so they are matched before the GEMMs)
KERNEL_CLASSES = (("flash", ("flash_",)),
                  ("conv", ("fprop", "dgrad", "wgrad", "conv", "implicit")),
                  ("layout", ("nchwtonhwc", "nhwctonchw", "transpose")),
                  ("gemm", ("gemm", "gemv", "nvjet")), ("pool", ("pool",)),
                  ("fused_update", ("fused_update",)), ("reduce", ("reduce",)),
                  ("elementwise", ("elementwise", "vectorized")))


def kernel_class_ms(spans) -> dict:
    """Device ms by ``KERNEL_CLASSES`` class ("other" for the rest)."""
    out = {}
    for k, a, b in spans:
        low = k.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(x in low for x in keys)), "other")
        out[cls] = out.get(cls, 0.0) + (b - a) / 1e3
    return out


def _top_kernels(spans, top: int) -> list:
    """[name, launches, device ms] of the ``top`` kernels by device time."""
    by = {}
    for k, a, b in spans:
        n, ms = by.get(k[:90], (0, 0.0))
        by[k[:90]] = (n + 1, ms + (b - a) / 1e3)
    return [[k, n, ms] for k, (n, ms) in sorted(by.items(), key=lambda kv: -kv[1][1])[:top]]


LM_TRAIN_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                    "fused_update_kernel")


def lm_fit_batches_arm(net, ds, rng, eager_step_s):
    """``fit_batches(2)`` as one CUDA graph against 2 ``fit_batch`` calls
    from the same state (parameters, Adam moments, iteration): losses and
    every parameter bitwise; K1-K3 24 and K4 30 per replay by the
    wrappers' counters (a trace's counts reported beside them); the graph
    count 1 after a second call; ms per step eager and replayed."""
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    seq = rng.integers(0, VOCAB, (8, MAX_LEN + 1))
    dev = torch.device("cuda")
    batches = [ds, DataSet(torch.from_numpy(seq[:, :-1]).to(dev),
                           torch.from_numpy(seq[:, 1:]).to(dev))]
    start = (clone_trees(net.params), clone_trees(net.opt_state), net.iteration)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = [float(net.fit_batch(b)) for b in batches]
    eager_s = (time.perf_counter() - t0) / 2
    after_eager = clone_trees(net.params)
    net.params, net.opt_state, net.iteration = start
    counters = dict(zip(LM_TRAIN_KERNELS, (att.flash_forward_cuda, att.flash_bwd_dkdv_cuda,
                                           att.flash_bwd_dq_cuda, uk.fused_update_cuda)))
    counted = {n: c.launches for n, c in counters.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graphed = [float(x) for x in net.fit_batches(batches)]
    capture_s = time.perf_counter() - t0
    bitwise = eager == graphed and trees_equal(after_eager, net.params)
    del start, after_eager
    count_first = net.fit_graph_count
    replays = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit_batches(batches)
        torch.cuda.synchronize()
        replays.append((time.perf_counter() - t0) / 2)
    # the traced replay's launches by the wrappers' counters (a replay adds
    # the captured launches): the gate; the trace's counts are a report
    traced0 = {n: c.launches for n, c in counters.items()}
    prof = device_profile(lambda: net.fit_batches(batches), LM_TRAIN_KERNELS)
    per_replay = {n: c.launches - traced0[n] for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    counted = {n: c.launches - counted[n] for n, c in counters.items()}
    want = {"flash_fwd_kernel": 2 * LAYERS, "flash_bwd_dkdv_kernel": 2 * LAYERS,
            "flash_bwd_dq_kernel": 2 * LAYERS,
            "fused_update_kernel": 2 * sum(1 for p in net.params if p)}
    replay_s = sorted(replays)[1]
    rec = {"arm": "lm_fit_batches", "k": 2, "batch": [8, MAX_LEN], "losses_eager": eager,
           "losses_graph": graphed, "bitwise": bitwise, "graphs_after_first": count_first,
           "graphs_after_repeat": net.fit_graph_count, "capture_s": capture_s,
           "eager_ms_per_step_here": eager_s * 1e3,
           "eager_ms_per_step_median_of_5": eager_step_s * 1e3,
           "replay_ms_per_step": [r * 1e3 for r in replays],
           "replay_ms_per_step_median": replay_s * 1e3,
           "traced_replay": prof, "kernels_per_replay_expected": want,
           "kernels_per_replay_counted": per_replay, "launches": counted,
           "peak_memory_gib": peak / 2 ** 30}
    emit({"phase": "train", **rec})
    if not (bitwise and count_first == net.fit_graph_count == 1 and per_replay == want):
        raise AssertionError("train phase: the fit_batches graph arm failed")
    return rec


# -- mlp phase (bench config 1) ----------------------------------------------------

MLP_IN, MLP_CLASSES, MLP_BATCH, MLP_ROWS = 784, 10, 512, 4096


def mlp_conf(dropout=0.0, noise=False, dtype="float32"):
    """Bench config 1 (``bench.py:448-474``): Dense 512 relu → Dense 256
    relu → OutputLayer 10 softmax mcxent on 784 inputs, Nesterovs(0.1,
    0.9).  ``noise`` adds DropConnect(0.9) to the output layer, as arm (d)
    asks, and to the second hidden layer: in training the output layer's
    weight noise is inert (the reference's ``_loss`` applies weight noise
    to the layers before the head only), so the hidden layer carries it."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.regularizers import DropConnect
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

    wn = DropConnect(0.9) if noise else None
    return (NeuralNetConfiguration.builder().seed(SEED + 11)
            .updater(Nesterovs(lr=0.1, momentum=0.9))
            .layer(Dense(n_out=512, activation="relu", dropout=dropout))
            .layer(Dense(n_out=256, activation="relu", dropout=dropout, weight_noise=wn))
            .layer(OutputLayer(n_out=MLP_CLASSES, activation="softmax", loss="mcxent",
                               weight_noise=wn))
            .set_input_type(InputType.feed_forward(MLP_IN)).dtype(dtype, dtype).build())


def mlp_net(device, **kw):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(mlp_conf(**kw), device=device)
    net.init()
    return net


def mlp_data():
    """MNIST-shaped data from a numpy seed: the reference's synthetic MNIST
    surrogate (a class-dependent cell pattern plus noise, 28x28), flattened,
    with integer labels."""
    from deeplearning4j_tpu_torch.datasets import fetchers
    xs, ys = fetchers._synthetic_images(MLP_ROWS, 28, 28, 1, MLP_CLASSES, seed=SEED + 12)
    return xs.reshape(MLP_ROWS, MLP_IN), ys


def run_cli(args, tmp):
    """One ``python -m deeplearning4j_tpu_torch`` command → (rc, stdout)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DL4J_TPU_DATA_DIR=tmp)
    out = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch", *args],
                         capture_output=True, text=True, cwd=tmp, env=env, timeout=300)
    if out.returncode:
        print(out.stderr[-3000:], file=sys.stderr, flush=True)
    return out.returncode, out.stdout


def mlp_cli_arm(xs, ys):
    """(a) ``train``, ``evaluate`` and ``summary`` from the CLI; the same
    training in this process gives the trained network to hold the zip
    against."""
    import json as _json
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    with tempfile.TemporaryDirectory() as tmp:
        conf_path, data_path = os.path.join(tmp, "mlp.json"), os.path.join(tmp, "mnist.npz")
        out_zip = os.path.join(tmp, "mlp.zip")
        with open(conf_path, "w") as f:
            _json.dump(mlp_conf().to_dict(), f)
        np.savez(data_path, x=xs, y=ys)
        cmds = {"train": ["train", "--config", conf_path, "--data", data_path,
                          "--batch-size", str(MLP_BATCH), "--epochs", "1", "--seed", "7",
                          "--output", out_zip, "--device", "cuda"],
                "evaluate": ["evaluate", "--model", out_zip, "--data", data_path,
                             "--device", "cuda"],
                "summary": ["summary", "--model", out_zip, "--device", "cuda"]}
        rcs, outs, secs = {}, {}, {}

        def one(name):
            t0 = time.perf_counter()
            rcs[name], outs[name] = run_cli(cmds[name], tmp)
            secs[name] = time.perf_counter() - t0
        one("train")
        # evaluate and summary only read the zip: their processes run side
        # by side (a process takes ~10-20 s to start on the card's host)
        side = threading.Thread(target=one, args=("summary",))
        side.start()
        one("evaluate")
        side.join(timeout=400)
        saved = load_model(out_zip, device="cuda") if rcs["train"] == 0 else None
    # the CLI's training again, in this process: same config, seed and batches
    net = mlp_net("cuda")
    fresh = net.score(DataSet(xs, np.eye(MLP_CLASSES, dtype=np.float32)[ys]))
    cli_batches = DataSet(xs, np.eye(MLP_CLASSES, dtype=np.float32)[ys]).shuffle(7).batch_by(
        MLP_BATCH)
    net.fit(ListDataSetIterator(cli_batches))
    rows = torch.from_numpy(xs[:512]).cuda()
    diff = (float((saved.output(rows) - net.output(rows)).abs().max())
            if saved is not None else None)
    trained = saved.score(DataSet(xs, np.eye(MLP_CLASSES, dtype=np.float32)[ys])) \
        if saved is not None else None
    rec = {"arm": "cli", "rcs": rcs, "seconds": secs, "loss_fresh": fresh,
           "loss_trained": trained, "zip_output_max_abs_diff": diff, "tolerance": 1e-5,
           "evaluate": outs["evaluate"].strip().splitlines()[2:4],
           "summary": outs["summary"].strip().splitlines()[:1]}
    emit({"phase": "mlp", **rec})
    if not (all(v == 0 for v in rcs.values()) and trained < fresh and diff <= 1e-5):
        raise AssertionError("mlp phase (a): the CLI arm failed")
    return rec


def mlp_graph_arm(batches):
    """(b) ``fit_batches(8)`` as one graph against 8 ``fit_batch`` calls
    from the same start, then the two timed and traced."""
    import torch

    eager, graphed = mlp_net("cuda"), mlp_net("cuda")
    le = [float(eager.fit_batch(b)) for b in batches]
    lg = [float(x) for x in graphed.fit_batches(batches)]
    bitwise = le == lg and trees_equal(eager.params, graphed.params) and trees_equal(
        eager.opt_state, graphed.opt_state) and eager.iteration == graphed.iteration
    count_first = graphed.fit_graph_count
    graphed.fit_batches(batches)
    count_repeat = graphed.fit_graph_count

    def eager_round():
        for b in batches:
            eager.fit_batch(b)

    def graph_round():
        graphed.fit_batches(batches)
    times = {}
    for name, fn in (("eager", eager_round), ("graph", graph_round),
                     ("graph2", graph_round), ("eager2", eager_round)):
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / len(batches))
        times[name] = sorted(walls)[2]
    prof = {"eager": device_profile(eager_round), "graph": device_profile(graph_round)}
    k = len(batches)
    rec = {"arm": "fit_batches_graph", "k": k, "batch": MLP_BATCH, "bitwise": bitwise,
           "graphs_after_first": count_first, "graphs_after_repeat": count_repeat,
           "ms_per_step": times,
           "images_per_s": {n: MLP_BATCH / t * 1e3 for n, t in times.items()},
           "eager_busy_ms_per_step": prof["eager"]["busy_ms"] / k,
           "eager_idle_share": prof["eager"]["idle_share"],
           "eager_kernels_per_step": prof["eager"]["kernels"] / k,
           "graph_busy_ms_per_step": prof["graph"]["busy_ms"] / k,
           "graph_idle_share": prof["graph"]["idle_share"],
           "graph_kernels_per_step": prof["graph"]["kernels"] / k}
    emit({"phase": "mlp", **rec})
    if not (bitwise and count_first == count_repeat == 1):
        raise AssertionError("mlp phase (b): the fit_batches graph arm failed")
    return rec


def mlp_guard_arm(batches):
    """(c) The nan guard with a budget of 2 and a batch holding one NaN."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import DivergenceError

    net = mlp_net("cuda")
    net.set_nan_guard(2)
    good = batches[0]
    x = good.features.copy()
    x[17, 300] = float("nan")
    bad = DataSet(x, good.labels)
    net.fit_batch(good)
    unchanged = []
    for _ in range(2):
        p, o = clone_trees(net.params), clone_trees(net.opt_state)
        net.fit_batch(bad)
        unchanged.append(trees_equal(p, net.params) and trees_equal(o, net.opt_state))
    raised = False
    try:
        net.fit_batch(bad)
    except DivergenceError:
        raised = True
    net.fit_batch(bad)                       # a fresh budget after the raise
    before = net._bad_steps
    p = clone_trees(net.params)
    net.fit_batch(good)
    reset = before == 1 and net._bad_steps == 0 and not trees_equal(p, net.params)
    rec = {"arm": "nan_guard", "budget": 2, "skipped_bitwise": unchanged,
           "third_bad_raised": raised, "good_step_resets": reset}
    emit({"phase": "mlp", **rec})
    if not (all(unchanged) and raised and reset):
        raise AssertionError("mlp phase (c): the nan guard arm failed")
    return rec


def mlp_dropout_arm(batches):
    """(d) dropout 0.5 on both hidden layers and DropConnect(0.9): 20 steps
    eagerly and 20 through fit_batches(4), each twice from one seed."""
    kept = []

    def run(graph):
        net = mlp_net("cuda", dropout=0.5, noise=True)
        layer = net.conf.layers[0]
        plain = layer._maybe_dropout

        def spy(x, train, generator):
            y = plain(x, train, generator)
            if train and not graph and not kept:
                live = x != 0
                kept.append(float((y[live] != 0).float().mean()))
            return y
        layer._maybe_dropout = spy
        order = [batches[i % len(batches)] for i in range(20)]
        if graph:
            return [float(v) for i in range(0, 20, 4) for v in net.fit_batches(order[i:i + 4])]
        return [float(net.fit_batch(b)) for b in order]
    runs = {"eager": [run(False), run(False)], "graph": [run(True), run(True)]}
    rec = {"arm": "dropout", "losses": {k: v[0] for k, v in runs.items()},
           "repeat_bitwise": {k: v[0] == v[1] for k, v in runs.items()},
           "kept_fraction_layer0": kept[0] if kept else None}
    falling = all(sum(v[0][:4]) > sum(v[0][-4:]) for v in runs.values())
    emit({"phase": "mlp", **rec})
    if not (falling and all(rec["repeat_bitwise"].values()) and kept
            and abs(kept[0] - 0.5) <= 0.01):
        raise AssertionError("mlp phase (d): the dropout arm failed")
    return rec


def mlp_f64_arm(batches):
    """(e) The network in float64 on the card against the port on the CPU,
    5 steps from the same weights: float64 losses within 1e-10 and the
    first step's gradients within 1e-10; the parameters after the steps
    within 2^-23 of max(1, |w|), one float32 spacing (the updaters compute
    in float32, as the reference's do), with the largest difference
    printed."""
    nets = [mlp_net(d, dtype="float64") for d in ("cuda", "cpu")]
    (l0, g0, _), (l1, g1, _) = (n._loss_and_grads(batches[0]) for n in nets)
    grad_diff = max(float((a[k].cpu() - b[k]).abs().max()) for a, b in zip(g0, g1) for k in a)
    losses = [[float(n.fit_batch(b)) for b in batches[:5]] for n in nets]
    loss_diff = max(abs(a - b) for a, b in zip(*losses))
    param_diff, beyond = 0.0, 0
    for p, q in zip(nets[0].params, nets[1].params):
        for k in p:
            d = (p[k].cpu() - q[k]).abs()
            param_diff = max(param_diff, float(d.max()))
            beyond += int((d > 2.0 ** -23 * q[k].abs().clamp_min(1.0)).sum())
    dtypes = sorted({str(t.dtype) for p in nets[0].params for t in p.values()})
    rec = {"arm": "float64", "steps": 5, "dtypes": dtypes, "loss_max_abs_diff": loss_diff,
           "first_grad_max_abs_diff": grad_diff, "param_max_abs_diff": param_diff,
           "params_beyond_one_f32_spacing": beyond, "tolerance_loss_grad": 1e-10}
    emit({"phase": "mlp", **rec})
    if not (dtypes == ["torch.float64"] and abs(float(l0) - float(l1)) <= 1e-10
            and grad_diff <= 1e-10 and loss_diff <= 1e-10 and beyond == 0):
        raise AssertionError("mlp phase (e): the float64 arm failed")
    return rec


def phase_mlp():
    """Bench config 1 at full width: the CLI, the fit_batches graph, the
    nan guard, dropout and weight noise, and float64."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet

    xs, ys = mlp_data()
    onehot = np.eye(MLP_CLASSES, dtype=np.float32)[ys]
    batches = DataSet(xs, onehot).batch_by(MLP_BATCH)
    t0 = time.perf_counter()
    rec = {"cli": mlp_cli_arm(xs, ys), "graph": mlp_graph_arm(batches),
           "guard": mlp_guard_arm(batches), "dropout": mlp_dropout_arm(batches),
           "float64": mlp_f64_arm(batches)}
    rec["seconds"] = time.perf_counter() - t0
    emit({"phase": "mlp", "params": sum(int(t.numel()) for p in mlp_net("cpu").params
                                          for t in p.values()),
          "seconds": rec["seconds"]})
    return rec


# -- attention-layer arm -------------------------------------------------------------


def attention_conf():
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (EmbeddingSequence, LayerNorm,
                                                    RnnOutputLayer, SelfAttention)
    from deeplearning4j_tpu_torch.nn.multilayer import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    return (NeuralNetConfiguration.builder().seed(SEED + 13).updater(Adam(lr=3e-4))
            .layer(EmbeddingSequence(n_in=VOCAB, n_out=D_MODEL))
            .layer(SelfAttention(n_heads=HEADS, causal=True))
            .layer(LayerNorm())
            .layer(RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(VOCAB, MAX_LEN)).build())


def phase_attention_layers():
    """``SelfAttention`` as a layer at GPT-2-small's attention widths, with
    a 25% key mask, through K1-K3: 2 ``fit_batch`` steps and an ``output``
    on [4, 1024] (K1-K3 launched; the attention layer's rows where the
    mask is 0 exactly zero); the same 2 steps at a cut ([2, 256]) on the
    card and on the CPU from the same weights (outputs and parameters
    within 1e-4); ``LearnedSelfAttention(n_queries=3)`` forward on
    [4, 1024, 768] through K1 against its plain version (2e-5)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.layers import LearnedSelfAttention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import attention as att

    rng = np.random.default_rng(SEED + 14)

    def batch(b, t):
        ids = rng.integers(0, VOCAB, (b, t + 1))
        m = (rng.random((b, t)) >= 0.25).astype(np.float32)
        m[:, 0] = 1.0
        return DataSet(ids[:, :-1], ids[:, 1:], m, m)
    counters = (att.flash_forward_cuda, att.flash_bwd_dkdv_cuda, att.flash_bwd_dq_cuda)
    net = MultiLayerNetwork(attention_conf(), device="cuda")
    net.init()
    ds = batch(4, MAX_LEN)
    for c in counters:
        c.launches = 0
    losses = [float(net.fit_batch(ds)) for _ in range(2)]
    y = net.output(ds.features, ds.features_mask)
    launches = dict(zip(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"),
                        (c.launches for c in counters)))
    with torch.no_grad():
        m = torch.from_numpy(ds.features_mask).cuda()
        h = net._apply_layers(net.params, net.state, torch.from_numpy(ds.features).cuda(), m,
                              upto=2)[0]
    masked_rows_zero = bool((h[m == 0] == 0).all())
    finite = bool(torch.isfinite(y).all())
    del net, h, y
    # the same steps at a cut, card against CPU
    cut = batch(2, 256)
    pair = []
    for dev in ("cuda", "cpu"):
        n = MultiLayerNetwork(attention_conf(), device=dev)
        n.init()
        ls = [float(n.fit_batch(cut)) for _ in range(2)]
        pair.append((n, ls, n.output(cut.features, cut.features_mask).cpu()))
    (gn, gl, gy), (cn, cl, cy) = pair
    out_diff = float((gy - cy).abs().max())
    param_diff = max(float((p[k].cpu() - q[k]).abs().max())
                     for p, q in zip(gn.params, cn.params) for k in p)
    loss_diff = max(abs(a - b) for a, b in zip(gl, cl))
    del pair, gn, cn
    # LearnedSelfAttention: three learned queries over 1024 keys through K1
    layer = LearnedSelfAttention(n_in=D_MODEL, n_out=D_MODEL, n_heads=HEADS, n_queries=3)
    params = {k: v.cuda() for k, v in layer.init_params(
        torch.Generator().manual_seed(SEED + 15), None).items()}
    x = torch.from_numpy(rng.standard_normal((4, MAX_LEN, D_MODEL), dtype=np.float32)).cuda()
    before = att.flash_forward_cuda.launches
    with torch.no_grad():
        yk = layer.forward(params, {}, x).y
        learned_k1 = att.flash_forward_cuda.launches - before
        layer.kernel = "xla"
        yp = layer.forward(params, {}, x).y
    learned_diff = float((yk - yp).abs().max())
    rec = {"phase": "attention_layers", "batch": [4, MAX_LEN], "key_mask_drop": 0.25,
           "losses": losses, "launches": launches, "masked_rows_zero": masked_rows_zero,
           "output_finite": finite, "cpu_cut": [2, 256], "cpu_loss_max_abs_diff": loss_diff,
           "cpu_output_max_abs_diff": out_diff, "cpu_param_max_abs_diff": param_diff,
           "tolerance": 1e-4, "learned_shape": list(yk.shape), "learned_k1": learned_k1,
           "learned_max_abs_err": learned_diff, "learned_tolerance": 2e-5}
    emit(rec)
    want = {"flash_fwd": 3, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
    if not (launches == want and masked_rows_zero and finite and loss_diff <= 1e-4
            and out_diff <= 1e-4 and param_diff <= 1e-4 and learned_k1 == 1
            and list(yk.shape) == [4, 3, D_MODEL] and learned_diff <= 2e-5):
        raise AssertionError("attention-layer arm failed")
    return rec


# -- recurrent phase -------------------------------------------------------------------


def build_rnn(device, cell: str = "LSTM", dtype=None):
    """Bench config 4's char-RNN (``bench.py``: ``TextGenerationLSTM`` at
    vocab 96 with Adam lr 1e-3) with ``cell`` layers, weights drawn from
    the configuration's seed, so every build starts from the same ones;
    ``dtype`` a (param, compute) pair."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam, GradientNormalization

    conf = (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(lr=1e-3))
            .gradient_normalization(GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE, 1.0)
            .layer(getattr(L, cell)(n_out=RNN_HIDDEN)).layer(getattr(L, cell)(n_out=RNN_HIDDEN))
            .layer(L.RnnOutputLayer(n_out=RNN_VOCAB, activation="softmax", loss="mcxent"))
            .tbptt(RNN_TBPTT).set_input_type(InputType.recurrent(RNN_VOCAB)).build())
    if dtype is not None:
        conf.param_dtype, conf.compute_dtype = dtype
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
    # the mixed float32-param / bfloat16-compute arm, card against CPU
    mixed = rnn_mixed_arm(ds, DataSet(seq[:, :-1], seq[:, 1:]))
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
                     "greedy_is_stream_argmax": greedy == toks},
           "mixed": mixed}
    emit(rec)
    ok = (all(a["launches_ok"] and a["finite_and_falling"] for a in arms_rec.values())
          and arm_gap <= 1e-5 and abs(cpu_losses[0] - cpu_losses[1]) <= 1e-4 and rel <= 1e-4
          and len(toks) == 64 and k5a_serve == 2 + 2 * 64 and stream_err <= 1e-5
          and stream_plain_err <= 1e-5 and greedy == toks
          and all(mixed["gates"].values()))
    if not ok:
        raise AssertionError("recurrent phase failed")
    return rec


# -- conv phase (bench configs 3 and 2, and a recurrent ComputationGraph) ----------

CNN_B, CNN_HW, CNN_CLASSES = 128, 224, 1000
LENET_B, LENET_HW, LENET_CLASSES = 256, 32, 10


def graph_layers(trees):
    """A container's per-layer trees as a list (a graph's by vertex name)."""
    return list(trees.values()) if isinstance(trees, dict) else list(trees)


def snapshot(net):
    """Clones of a network's parameters, layer state, updater state and
    iteration, for ``restore``."""
    opt = graph_layers(net.opt_state)
    opt = clone_trees(opt)
    if isinstance(net.opt_state, dict):
        opt = dict(zip(net.opt_state, opt))
    return net.clone_params(), net.clone_state(), opt, net.iteration


def restore(net, snap):
    net.params, net.state, net.opt_state, net.iteration = snap[0], snap[1], snap[2], snap[3]


def same_trees(a, b) -> bool:
    return trees_equal(graph_layers(a), graph_layers(b))


def max_tree_diff(a, b) -> float:
    """Largest absolute difference, leaf for leaf, of two containers' trees
    (on any devices)."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    return max((float((x.detach().cpu().double() - y.detach().cpu().double()).abs().max())
                for p, q in zip(graph_layers(a), graph_layers(b))
                for x, y in zip(tree_leaves(p), tree_leaves(q))), default=0.0)


def resnet(device, hw=CNN_HW, classes=CNN_CLASSES, dtype="float32"):
    """Bench config 3 (``bench.py:496-543``): the zoo's ResNet-50 with
    Nesterovs(lr 0.1, momentum 0.9), weights from its seed."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

    net = ResNet50(hw, hw, 3, classes, updater=Nesterovs(lr=0.1, momentum=0.9), device=device)
    if dtype != "float32":
        net.conf.param_dtype = net.conf.compute_dtype = dtype
        net.init()
    return net


def images(n, hw, classes, seed, device="cuda"):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, hw, hw, 3), dtype=np.float32))
    y = torch.from_numpy(np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])
    return DataSet(x.to(device), y.to(device))


def timed_steps(net, ds, n=5):
    """``n`` fit_batch calls on one batch, each synced → (losses, walls ms)."""
    import torch
    losses, walls = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(net.fit_batch(ds)))
        walls.append((time.perf_counter() - t0) * 1e3)
    return losses, walls


def resnet_graph_arm(net):
    """(d): fit_batches(2) as one CUDA graph against 2 fit_batch calls from
    the same start under deterministic cuDNN: losses, parameters, momenta
    and BatchNorm statistics bitwise; a second call captures nothing new.
    The eager steps run once under torch.use_deterministic_algorithms
    (warn_only) to record the ops that have no deterministic algorithm."""
    import warnings

    import torch

    b = 32
    batches = [images(b, CNN_HW, CNN_CLASSES, SEED + 80 + i) for i in range(2)]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        net.conf.compute_dtype = "float32"
        start = snapshot(net)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for d in batches:
                    net.fit_batch(d)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        refusing = sorted({str(w.message).split(" does not have a deterministic")[0]
                           .split("\n")[0][:160] for w in caught
                           if "determinis" in str(w.message)})
        restore(net, start)
        start = snapshot(net)
        eager = [float(net.fit_batch(d)) for d in batches]
        after = snapshot(net)
        restore(net, start)
        t0 = time.perf_counter()
        graphed = [float(v) for v in net.fit_batches(batches)]
        capture_s = time.perf_counter() - t0
        bitwise = {"losses": eager == graphed,
                   "params": same_trees(after[0], net.params),
                   "state": same_trees(after[1], net.state),
                   "momenta": same_trees(after[2], net.opt_state),
                   "iteration": after[3] == net.iteration}
        diffs = {"params": max_tree_diff(after[0], net.params),
                 "state": max_tree_diff(after[1], net.state),
                 "momenta": max_tree_diff(after[2], net.opt_state)}
        count_first = net.fit_graph_count
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            net.fit_batches(batches)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3 / 2)
        count_repeat = net.fit_graph_count
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    net._fit_graphs.clear()
    rec = {"arm": "resnet50_fit_batches_graph", "k": 2, "batch": [b, CNN_HW, CNN_HW, 3],
           "losses_eager": eager, "losses_graph": graphed, "bitwise": bitwise,
           "max_abs_diff": diffs, "graphs_after_first": count_first,
           "graphs_after_repeat": count_repeat, "capture_s": capture_s,
           "replay_ms_per_step": walls, "images_per_s_replay": b / sorted(walls)[1] * 1e3,
           "deterministic_refusals": refusing}
    emit({"phase": "conv", **rec})
    return rec


def resnet_cpu_arm():
    """(e): ResNet-50 at 32x32 on the card against the port on the CPU from
    the same weights.  float32: output() within 1e-4.  The training step
    in float64 at batch 8: at batch 4 in float32 train-mode BatchNorm over
    stage 4's 1x1 activations (4 values a channel) multiplies rounding by
    up to 1/sqrt(eps) a layer, and cuDNN and the CPU round differently, so
    the gate reads the step where rounding is 1e-16."""
    import torch

    out = {}
    nets = [resnet(d, 32, 10) for d in ("cuda", "cpu")]
    x = images(4, 32, 10, SEED + 90, "cpu").features
    o = [n.output(x)[0].cpu() for n in nets]
    out["output_f32_max_abs_diff"] = float((o[0] - o[1]).abs().max())
    ds = images(4, 32, 10, SEED + 91, "cpu")
    lf = [float(n.fit_batch(ds)) for n in nets]
    out["step_f32_batch4"] = {"loss_abs_diff": abs(lf[0] - lf[1]),
                              "params_max_abs_diff": max_tree_diff(nets[0].params,
                                                                   nets[1].params),
                              "bn_state_max_abs_diff": max_tree_diff(nets[0].state,
                                                                     nets[1].state)}
    nets = [resnet(d, 32, 10, "float64") for d in ("cuda", "cpu")]
    ds = images(8, 32, 10, SEED + 92, "cpu")
    lf = [float(n.fit_batch(ds)) for n in nets]
    o = [n.output(ds.features)[0].cpu() for n in nets]
    out["step_f64_batch8"] = {"loss_abs_diff": abs(lf[0] - lf[1]),
                              "output_max_abs_diff": float((o[0] - o[1]).abs().max()),
                              "params_max_abs_diff": max_tree_diff(nets[0].params,
                                                                   nets[1].params),
                              "momenta_max_abs_diff": max_tree_diff(nets[0].opt_state,
                                                                    nets[1].opt_state),
                              "bn_state_max_abs_diff": max_tree_diff(nets[0].state,
                                                                     nets[1].state)}
    g = out["step_f64_batch8"]
    out["ok"] = (out["output_f32_max_abs_diff"] <= 1e-4
                 and all(v <= 1e-4 for v in g.values()))
    emit({"phase": "conv", "arm": "resnet50_card_vs_cpu", "tolerance": 1e-4, **out})
    return out


def lenet_arm():
    """(g): bench config 2, LeNet on [256, 32, 32, 3] with Nesterovs(0.01,
    0.9): eager fit_batch and fit_batches(8) as one graph, timed and
    traced; ``train --zoo lenet`` through the CLI; a predict Engine over it
    with buckets 1, 2, 4."""
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.serving import Engine

    net = LeNet(LENET_HW, LENET_HW, 3, LENET_CLASSES, updater=Nesterovs(lr=0.01, momentum=0.9),
                device="cuda")
    batches = [images(LENET_B, LENET_HW, LENET_CLASSES, SEED + 100 + i) for i in range(8)]
    net.fit_batch(batches[0])                       # warm-up
    losses_eager, walls = [], []
    for d in batches[:5]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses_eager.append(float(net.fit_batch(d)))
        walls.append((time.perf_counter() - t0) * 1e3)
    net.fit_batches(batches)                        # capture
    replays = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit_batches(batches)
        torch.cuda.synchronize()
        replays.append((time.perf_counter() - t0) * 1e3 / 8)

    def eager_round():
        for d in batches:
            net.fit_batch(d)
    prof = {"eager": device_profile(eager_round),
            "graph": device_profile(lambda: net.fit_batches(batches))}
    eager_ms, replay_ms = sorted(walls)[2], sorted(replays)[2]
    # the CLI, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(SEED + 110)
        np.savez(os.path.join(tmp, "img.npz"),
                 x=rng.standard_normal((1024, LENET_HW, LENET_HW, 3), dtype=np.float32),
                 y=rng.integers(0, LENET_CLASSES, 1024))
        kw = json.dumps(dict(height=LENET_HW, width=LENET_HW, channels=3,
                             num_classes=LENET_CLASSES))
        cli_rc, cli_out = run_cli(["train", "--zoo", "lenet", "--zoo-args", kw, "--data",
                                   "img.npz", "--batch-size", str(LENET_B), "--output",
                                   "lenet.zip"], tmp)
    # serving: every result bitwise the eager forward of its padded bucket
    eng = Engine(net, max_batch=4, replicas=1, slo_ms=600_000, device="cuda").load()
    try:
        graphs_before = eng.compile_cache_size()
        rng = np.random.default_rng(SEED + 111)
        xs = [rng.standard_normal((1 + i % 3, LENET_HW, LENET_HW, 3), dtype=np.float32)
              for i in range(12)]
        log0 = len(eng.batch_log)
        futs = [eng.output_async(x) for x in xs]
        outs = [f.result(timeout=300) for f in futs]
        index = {id(f): i for i, f in enumerate(futs)}
        bitwise = True
        for b in eng.batch_log[log0:]:
            members = [index[r] for r in b["request_ids"]]
            bucket = b["rows"] + b["padded"]
            x = np.concatenate([xs[i] for i in members])
            y = eager_bucket(net, x, bucket)
            ofs = 0
            for i in members:
                got = torch.from_numpy(outs[i]).to("cuda")
                bitwise = bitwise and torch.equal(got, y[ofs:ofs + xs[i].shape[0]])
                ofs += xs[i].shape[0]
        snap = eng.metrics_snapshot()
        graphs_after = eng.compile_cache_size()
    finally:
        eng.shutdown()
    rec = {"arm": "lenet", "batch": [LENET_B, LENET_HW, LENET_HW, 3],
           "losses_eager": losses_eager, "eager_ms_per_step": walls,
           "eager_median_ms": eager_ms, "eager_images_per_s": LENET_B / eager_ms * 1e3,
           "replay_ms_per_step": replays, "replay_median_ms": replay_ms,
           "replay_images_per_s": LENET_B / replay_ms * 1e3,
           "graphs": net.fit_graph_count,
           "eager_idle_share": prof["eager"]["idle_share"],
           "eager_kernels_per_step": prof["eager"]["kernels"] / 8,
           "graph_idle_share": prof["graph"]["idle_share"],
           "graph_kernels_per_step": prof["graph"]["kernels"] / 8,
           "cli_rc": cli_rc, "cli_tail": cli_out.strip().splitlines()[-2:],
           "serve": {"requests": len(xs), "bitwise_eager_bucket": bitwise,
                     "unwarmed_serves": snap["counters"]["unwarmed_serves"],
                     "graphs_before": graphs_before, "graphs_after": graphs_after}}
    rec["ok"] = (all(math.isfinite(v) for v in losses_eager) and net.fit_graph_count == 1
                 and cli_rc == 0 and bitwise and rec["serve"]["unwarmed_serves"] == 0
                 and graphs_before == graphs_after == 3)
    emit({"phase": "conv", **rec})
    return rec


def rnn_graph(device):
    """The recurrent ComputationGraph of arm (h): 2 x LSTM(256) in a
    GraphBuilder graph at the char-RNN's width (vocab 96), one softmax
    output per step and a second through LastTimeStepVertex →
    DuplicateToTimeSeriesVertex, Adam lr 1e-3, TBPTT 50."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                                   DuplicateToTimeSeriesVertex, GraphBuilder,
                                                   LastTimeStepVertex)
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (GraphBuilder().seed(SEED).updater(Adam(lr=1e-3))
            .add_inputs("x").set_input_types(x=InputType.recurrent(RNN_VOCAB))
            .add_layer("lstm1", L.LSTM(n_out=RNN_HIDDEN), "x")
            .add_layer("lstm2", L.LSTM(n_out=RNN_HIDDEN), "lstm1")
            .add_layer("out", L.RnnOutputLayer(n_out=RNN_VOCAB, activation="softmax",
                                               loss="mcxent"), "lstm2")
            .add_vertex("last", LastTimeStepVertex(), "lstm2")
            .add_vertex("dup", DuplicateToTimeSeriesVertex(), "last", "lstm2")
            .add_layer("out2", L.RnnOutputLayer(n_out=RNN_VOCAB, activation="softmax",
                                                loss="mcxent"), "dup")
            .set_outputs("out", "out2").tbptt(RNN_TBPTT).build())
    net = ComputationGraph(conf, device=device)
    net.init()
    return net


def rnn_graph_arm():
    """(h): 5 TBPTT fit_batch calls of the recurrent graph with Adam and the
    fused update on (K5a, K5b, K4 counted from 0 over the calls), 64
    streamed steps through rnn_time_step (K5a counted), and one call at a
    [4, 100] cut on the card against the CPU from the same weights."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    os.environ[uk.ENV_SWITCH] = "1"
    rng = np.random.default_rng(SEED + 120)
    ids = rng.integers(0, RNN_VOCAB, (RNN_B, RNN_T + 1))
    eye = np.eye(RNN_VOCAB, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    dev = torch.device("cuda")
    mds = MultiDataSet([torch.from_numpy(x).to(dev)],
                       [torch.from_numpy(y).to(dev), torch.from_numpy(y).to(dev)])
    counters = {"lstm_seq_fwd": lk.lstm_seq_fwd_cuda, "lstm_cell_bwd": lk.lstm_cell_bwd_cuda,
                "fused_update": uk.fused_update_cuda}
    net = rnn_graph("cuda")
    for c in counters.values():
        c.launches = 0
    losses, walls = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(net.fit_batch(mds)))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {k: c.launches for k, c in counters.items()}
    chunks = -(-RNN_T // RNN_TBPTT)
    want = {"lstm_seq_fwd": 5 * 2 * chunks, "lstm_cell_bwd": 5 * 2 * RNN_T,
            "fused_update": 5 * 4 * chunks}
    # streaming: one step a call, both outputs, K5a once per layer a step
    net.rnn_clear_previous_state()
    k5a0 = lk.lstm_seq_fwd_cuda.launches
    streamed = [net.rnn_time_step(x[:2, t])[0] for t in range(64)]
    stream_launches = lk.lstm_seq_fwd_cuda.launches - k5a0
    launches["lstm_seq_fwd"] += stream_launches
    full = net.output(x[:2, :64])[0]
    stream_err = float((torch.stack(streamed, 1) - full).abs().max())
    # card against CPU at [4, 100], same weights
    pair = [rnn_graph("cuda"), rnn_graph("cpu")]
    small = MultiDataSet([x[:4]], [y[:4], y[:4]])
    cl = [float(n.fit_batch(small)) for n in pair]
    cpu = {"loss_abs_diff": abs(cl[0] - cl[1]),
           "params_max_abs_diff": max_tree_diff(pair[0].params, pair[1].params),
           "output_max_abs_diff": float((pair[0].output(x[:4])[0].cpu()
                                         - pair[1].output(x[:4])[0]).abs().max())}
    rec = {"arm": "recurrent_graph", "config": {"vocab": RNN_VOCAB, "layers": [RNN_HIDDEN] * 2,
                                                "batch": [RNN_B, RNN_T], "tbptt": RNN_TBPTT,
                                                "outputs": ["out", "out2 (last step dup)"],
                                                "updater": "Adam(lr=1e-3), K4 on"},
           "losses": losses, "fit_batch_ms": walls,
           "chars_per_s": RNN_B * RNN_T / sorted(walls)[2] * 1e3,
           "launches_fit": {k: launches[k] - (stream_launches if k == "lstm_seq_fwd" else 0)
                            for k in launches}, "launches_expected_fit": want,
           "stream_steps": 64, "stream_k5a": stream_launches,
           "stream_vs_output_max_abs_diff": stream_err, "card_vs_cpu": cpu,
           "tolerance": 1e-4}
    rec["ok"] = (rec["launches_fit"] == want and stream_launches == 2 * 64
                 and stream_err <= 1e-5 and all(v <= 1e-4 for v in cpu.values())
                 and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0])
    emit({"phase": "conv", **rec})
    return rec, launches


def phase_conv():
    """The conv path and ComputationGraph: ResNet-50 (bench config 3) at
    full width trained in f32 and bf16 compute, inferred, as one
    fit_batches graph, card against CPU and through a checkpoint; LeNet
    (bench config 2) trained, through the CLI and served; a recurrent
    ComputationGraph through K5a/K5b/K4."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.utils.serializer import load_model

    t0 = time.perf_counter()
    net = resnet("cuda")
    ds = images(CNN_B, CNN_HW, CNN_CLASSES, SEED + 70)
    f32 = resnet_train_arm(net, ds, "float32", 8)
    bf16 = resnet_train_arm(net, ds, "bfloat16", 2)
    net.conf.compute_dtype = "float32"
    # the layout's price: every conv's HWIO weight copied to the
    # channels-last [O, I, kh, kw] that cuDNN takes, once a forward
    ws = [p["W"] for p in net.params.values() if p.get("W") is not None and p["W"].ndim == 4]
    wcopy = {"arm": "resnet50_weight_layout_copies", "weights": len(ws),
             "bytes": sum(w.numel() * w.element_size() for w in ws),
             "ms_all_weights": cuda_ms(lambda: [w.permute(3, 2, 0, 1).contiguous(
                 memory_format=torch.channels_last) for w in ws], 10)}
    emit({"phase": "conv", **wcopy})
    # (c) inference on the same batch: rows are distributions
    x = ds.features
    net.output(x)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        probs = net.output(x)[0]
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    sums = probs.sum(1)
    dist = bool(torch.isfinite(probs).all() and (probs >= 0).all()
                and (sums - 1).abs().max() < 1e-4)
    infer = {"arm": "resnet50_output_float32", "batch": [CNN_B, CNN_HW, CNN_HW, 3],
             "ms": walls, "median_ms": sorted(walls)[2],
             "images_per_s": CNN_B / sorted(walls)[2] * 1e3, "rows_are_distributions": dist}
    emit({"phase": "conv", **infer})
    graph = resnet_graph_arm(net)
    # (f) the checkpoint round trip: output() bitwise
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50.zip")
        t1 = time.perf_counter()
        net.save(path)
        save_s = time.perf_counter() - t1
        loaded = load_model(path, device="cuda")
        zip_mb = os.path.getsize(path) / 2 ** 20
    xs = x[:16]
    ckpt = {"arm": "resnet50_checkpoint", "zip_mib": zip_mb, "save_s": save_s,
            "output_bitwise": bool(torch.equal(net.output(xs)[0], loaded.output(xs)[0])),
            "iteration": [net.iteration, loaded.iteration]}
    emit({"phase": "conv", **ckpt})
    del net, loaded, ds, x, probs
    torch.cuda.empty_cache()
    cpu = resnet_cpu_arm()
    lenet = lenet_arm()
    rnn, rnn_launches = rnn_graph_arm()
    rec = {"phase": "conv", "seconds": time.perf_counter() - t0,
           "gates": {"f32_falling": f32["finite_and_falling"],
                     "bf16_falling": bf16["finite_and_falling"],
                     "output_distributions": dist,
                     "graph_bitwise": all(graph["bitwise"].values()),
                     "graph_count": graph["graphs_after_first"] == graph["graphs_after_repeat"] == 1,
                     "card_vs_cpu": cpu["ok"], "checkpoint_bitwise": ckpt["output_bitwise"],
                     "lenet": lenet["ok"], "recurrent_graph": rnn["ok"]}}
    emit(rec)
    if not all(rec["gates"].values()):
        raise AssertionError(f"conv phase failed: {rec['gates']}")
    return {"rnn_launches": rnn_launches, **rec}


# -- heads phase ----------------------------------------------------------------------

YOLO_B, YOLO_HW, YOLO_CLASSES = 64, 416, 20
IRV1_B, IRV1_HW, FACENET_B, FACENET_HW, FACE_CLASSES = 64, 160, 64, 96, 1000
HEADS_TRACE = ("fused_update",)


def yolo_labels(n, grid, seed, boxes=5, classes=YOLO_CLASSES, per_image=3):
    """The reference's YOLOv2 label dict from a seed: ``per_image`` objects
    an image at random cells and anchors, offsets in the cell, log-scale
    sizes around the anchors."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = (rng.standard_normal((n, grid, grid, boxes, 4)) * 0.3).astype(np.float32)
    b[..., :2] = rng.random((n, grid, grid, boxes, 2))
    obj = np.zeros((n, grid, grid, boxes), np.float32)
    cls = np.zeros((n, grid, grid, classes), np.float32)
    for i in range(n):
        for _ in range(per_image):
            r, c, k = (int(v) for v in rng.integers(0, (grid, grid, boxes)))
            obj[i, r, c, k] = 1
            cls[i, r, c] = 0
            cls[i, r, c, rng.integers(0, classes)] = 1
    return {"boxes": b, "obj": obj, "cls": cls}


def yolo_batch(n, hw, seed, device="cuda", dtype="float32"):
    """[n, hw, hw, 3] seeded images and their label dict, on ``device``."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(dtype)
    y = yolo_labels(n, hw // 32, seed + 1)
    return DataSet(torch.from_numpy(x).to(device),
                   {k: torch.from_numpy(v.astype(dtype)).to(device) for k, v in y.items()})


def face_batch(n, hw, classes, seed, device="cuda", dtype="float32"):
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(dtype)
    y = np.eye(classes, dtype=dtype)[rng.integers(0, classes, n)]
    return DataSet(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def train_arm(phase, arm, net, ds, compute, warmup, batch, gate_falling=True):
    """``warmup`` fit_batch steps, then 5 timed on the same batch: median
    ms and images/s, peak memory, and one traced step (idle share, kernels,
    top kernels by device time).  cuDNN runs with its defaults.  The first
    warm-up step's K4 calls, where the updater makes any, are held bitwise
    against K4's plain version (``k4_against_plain``); a difference
    raises."""
    import torch

    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    net.conf.compute_dtype = compute
    with recorded(uk, "fused_update_cuda") as calls:
        warm = [float(net.fit_batch(ds))]
    k4 = k4_against_plain(calls)
    del calls
    warm += [float(net.fit_batch(ds)) for _ in range(warmup - 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = timed_steps(net, ds)
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: net.fit_batch(ds), HEADS_TRACE, top=10)
    med = sorted(walls)[2]
    rec = {"arm": arm, "batch": batch, "compute_dtype": compute, "cudnn": "defaults",
           "warmup_losses": warm, "losses": losses, "ms_per_step": walls,
           "median_ms_per_step": med, "images_per_s": batch[0] / med * 1e3,
           "peak_memory_gib": peak / 2 ** 30, "traced_step": prof,
           "idle_share": prof["idle_share"], "kernels_per_step": prof["kernels"],
           "k4_vs_plain": k4,
           "finite_and_falling": all(math.isfinite(v) for v in losses)
           and (losses[-1] < losses[0] or not gate_falling)}
    emit({"phase": phase, **rec})
    if k4["calls"] and not k4["bitwise"]:
        raise AssertionError(f"{arm}: K4 differs from its plain version in a step")
    return rec


def resnet_train_arm(net, ds, compute, warmup):
    """(a)/(b): 5 fit_batch steps on one fixed batch after ``warmup`` ones,
    median ms and images/s, peak memory, and one traced step."""
    return train_arm("conv", f"resnet50_train_{compute}", net, ds, compute, warmup,
                     [CNN_B, CNN_HW, CNN_HW, 3])


def deterministic(fn):
    """``fn()`` under deterministic cuDNN (no benchmark), settings put back."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def graph_vs_eager(net, batches):
    """fit_batches(k) as one CUDA graph against k fit_batch calls from the
    same parameters, state, updater state, iteration and generator state:
    bitwise flags and largest differences; then 3 timed repeat calls (no
    new graph) and one traced replay.  Runs under deterministic cuDNN."""
    import torch

    def run():
        start, gen = snapshot(net), net._gen.get_state()
        eager = [float(net.fit_batch(d)) for d in batches]
        after = snapshot(net)
        restore(net, start)
        net._gen.set_state(gen)
        t0 = time.perf_counter()
        graphed = [float(v) for v in net.fit_batches(batches)]
        capture_s = time.perf_counter() - t0
        bitwise = {"losses": eager == graphed, "params": same_trees(after[0], net.params),
                   "state": same_trees(after[1], net.state),
                   "updater_state": same_trees(after[2], net.opt_state),
                   "iteration": after[3] == net.iteration}
        diffs = {"params": max_tree_diff(after[0], net.params),
                 "state": max_tree_diff(after[1], net.state)}
        count_first = net.fit_graph_count
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            net.fit_batches(batches)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3 / len(batches))
        prof = device_profile(lambda: net.fit_batches(batches))
        return {"k": len(batches), "losses_eager": eager, "losses_graph": graphed,
                "bitwise": bitwise, "max_abs_diff": diffs, "capture_s": capture_s,
                "graphs_after_first": count_first, "graphs_after_repeat": net.fit_graph_count,
                "replay_ms_per_step": walls,
                "replay_images_per_s": batches[0].num_examples() / sorted(walls)[1] * 1e3,
                "replay_idle_share": prof["idle_share"],
                "replay_kernels_per_step": prof["kernels"] / len(batches),
                "ok": all(bitwise.values()) and count_first == net.fit_graph_count == 1}
    rec = deterministic(run)
    net._fit_graphs.clear()
    return rec


def yolo_decode_check(net, x):
    """decode_predictions on output(): the reference's keys and shapes,
    confidences in [0, 1], class rows that are distributions."""
    import torch

    head = net.conf.layers[-1]
    d = head.decode_predictions(net.output(x))
    n, g, b = x.shape[0], YOLO_HW // 32, head.n_boxes
    shapes = {k: list(v.shape) for k, v in d.items()}
    want = {k: [n, g, g, b] for k in ("cx", "cy", "w", "h", "conf", "detect")}
    want["class_probs"] = [n, g, g, b, head.n_classes]
    sums = d["class_probs"].sum(-1)
    return {"shapes": shapes, "shapes_ok": shapes == want,
            "conf_in_0_1": bool(((d["conf"] >= 0) & (d["conf"] <= 1)).all()),
            "class_rows_are_distributions": bool((d["class_probs"] >= 0).all()
                                                 and (sums - 1).abs().max() < 1e-5),
            "detections": int(d["detect"].sum()), "finite": all(
                bool(torch.isfinite(v.float()).all()) for v in d.values())}


class NumpyDraws:
    """One numpy stream standing in for ``regularizers.bernoulli`` /
    ``.normal`` of every network it is armed for (tensors on the
    generator's device, or ``device``), so the card and the CPU draw the
    same dropout masks and VAE noise."""

    def __init__(self, seed, device=None):
        import numpy as np
        self.rng, self.device = np.random.default_rng(seed), device

    def _dev(self, gen):
        return self.device if gen is None else gen.device

    def bernoulli(self, gen, p, shape):
        import torch
        return torch.from_numpy(self.rng.random(tuple(shape)) < p).to(self._dev(gen))

    def normal(self, gen, shape):
        import numpy as np
        import torch
        return torch.from_numpy(self.rng.standard_normal(tuple(shape)).astype(np.float32)).to(
            self._dev(gen))


def with_draws(draws, fn):
    """``fn()`` with the port's two draw functions taken from ``draws``."""
    from deeplearning4j_tpu_torch.nn.conf import regularizers as R

    saved = R.bernoulli, R.normal
    R.bernoulli, R.normal = draws.bernoulli, draws.normal
    try:
        return fn()
    finally:
        R.bernoulli, R.normal = saved


def card_vs_cpu(make, data, seed):
    """A network built on the card and on the CPU from the same seed:
    ``output()`` in float32 (4 rows), then one training step in float64
    (8 rows), each device drawing from its own copy of one numpy stream.
    → largest differences (the centres and BatchNorm statistics are the
    state)."""
    out = {}
    nets = [make(d, "float32") for d in ("cuda", "cpu")]
    x, _ = data(4, "float32")
    o = []
    for n in nets:
        y = n.output(x)
        o.append((y[0] if isinstance(y, list) else y).cpu())
    out["output_f32_max_abs_diff"] = float((o[0] - o[1]).abs().max())
    nets = [make(d, "float64") for d in ("cuda", "cpu")]
    x, y = data(8, "float64")
    from deeplearning4j_tpu_torch.datasets import DataSet
    losses = [with_draws(NumpyDraws(seed), lambda n=n: float(n.fit_batch(DataSet(x, y))))
              for n in nets]
    out["step_f64"] = {"loss_abs_diff": abs(losses[0] - losses[1]),
                       "state_max_abs_diff": max_tree_diff(nets[0].state, nets[1].state),
                       "params_max_abs_diff": max_tree_diff(nets[0].params, nets[1].params)}
    out["ok"] = (out["output_f32_max_abs_diff"] <= 1e-4
                 and out["step_f64"]["loss_abs_diff"] <= 1e-10
                 and out["step_f64"]["state_max_abs_diff"] <= 1e-10
                 and out["step_f64"]["params_max_abs_diff"] <= 1e-6)
    return out


def heads_cuts():
    """(d): TinyYOLO at 64x64 and InceptionResNetV1 with 1/1/1 blocks at
    15x15 (the smallest input its stem takes), card against CPU."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import InceptionResNetV1, TinyYOLO

    def yolo(device, dtype):
        net = TinyYOLO(64, 64, 3, YOLO_CLASSES, device=device)
        if dtype != "float32":
            net.conf.param_dtype = net.conf.compute_dtype = dtype
            net.init()
        return net

    def yolo_data(n, dtype):
        rng = np.random.default_rng(SEED + 131)
        y = yolo_labels(n, 2, SEED + 132)
        return (rng.standard_normal((n, 64, 64, 3)).astype(dtype),
                {k: v.astype(dtype) for k, v in y.items()})

    def irv1(device, dtype):
        net = InceptionResNetV1(15, 15, 3, 10, a_blocks=1, b_blocks=1, c_blocks=1,
                                device=device)
        net.conf.param_dtype = net.conf.compute_dtype = dtype
        net.init()
        return net

    def irv1_data(n, dtype):
        rng = np.random.default_rng(SEED + 133)
        return (rng.standard_normal((n, 15, 15, 3)).astype(dtype),
                np.eye(10, dtype=dtype)[rng.integers(0, 10, n)])

    rec = {"arm": "heads_card_vs_cpu", "tolerance": {"output_f32": 1e-4, "loss_f64": 1e-10,
                                                     "state_f64": 1e-10, "params_f64": 1e-6},
           "tinyyolo_64": card_vs_cpu(yolo, yolo_data, SEED + 134),
           "inception_resnet_v1_111_15": card_vs_cpu(irv1, irv1_data, SEED + 135)}
    rec["ok"] = rec["tinyyolo_64"]["ok"] and rec["inception_resnet_v1_111_15"]["ok"]
    emit({"phase": "heads", **rec})
    return rec


def irv1_arm():
    """(e): InceptionResNetV1 at full depth on [64, 160, 160, 3]: eager
    fit_batch (median of 5, traced), then fit_batches(2) bitwise two eager
    steps (dropout from the same generator state), centres of the labelled
    classes moved, the rest still zero."""
    import torch

    from deeplearning4j_tpu_torch.models import InceptionResNetV1

    net = InceptionResNetV1(IRV1_HW, IRV1_HW, 3, FACE_CLASSES, device="cuda")
    net.init()
    ds = face_batch(IRV1_B, IRV1_HW, FACE_CLASSES, SEED + 140)
    eager = train_arm("heads", "inception_resnet_v1_train", net, ds, "float32", 1,
                      [IRV1_B, IRV1_HW, IRV1_HW, 3])
    batches = [face_batch(IRV1_B, IRV1_HW, FACE_CLASSES, SEED + 141 + i) for i in range(2)]
    graph = graph_vs_eager(net, batches)
    seen = torch.zeros(FACE_CLASSES, dtype=torch.bool, device="cuda")
    for d in [ds] + batches:
        seen |= d.labels.sum(0) > 0
    moved = net.state["out"]["centers"].abs().sum(1) > 0
    graph["centres_of_labelled_classes_moved"] = bool(torch.equal(moved, seen))
    graph["ok"] = graph["ok"] and graph["centres_of_labelled_classes_moved"]
    emit({"phase": "heads", "arm": "inception_resnet_v1_fit_batches_graph", **graph})
    return eager, graph


def vae_arm():
    """(g): VAE(784 → 32, encoder and decoder [256, 256], Bernoulli) →
    OutputLayer(10) on the MNIST surrogate (clipped to [0, 1], the
    Bernoulli targets' range) at batch 512: 5 pretrain_layer(0) steps with
    Adam (the ELBO falls), the IWAE log-probability with 5 samples on the
    card against the CPU from one noise stream, then 5 supervised steps
    (finite; they start from the pretraining's Adam moments, as the
    reference's do, so the first may rise), the first one's K4 calls held
    bitwise against K4's plain version."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer, VariationalAutoencoder
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.ops import update_kernel as uk
    from deeplearning4j_tpu_torch.utils.params import params_from_numpy, params_to_numpy

    def build(device):
        conf = (NeuralNetConfiguration.builder().seed(SEED + 150).updater(Adam(lr=1e-3))
                .layer(VariationalAutoencoder(n_out=32, encoder_layer_sizes=[256, 256],
                                              decoder_layer_sizes=[256, 256],
                                              reconstruction="bernoulli"))
                .layer(OutputLayer(n_out=MLP_CLASSES, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(MLP_IN)).build())
        net = MultiLayerNetwork(conf, device=device)
        net.init()
        return net

    xs, ys = mlp_data()
    xs = np.clip(xs[:MLP_BATCH], 0.0, 1.0)
    ds = DataSet(torch.from_numpy(xs).cuda(),
                 torch.from_numpy(np.eye(MLP_CLASSES, dtype=np.float32)[ys[:MLP_BATCH]]).cuda())
    net = build("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    elbo = [float(v) for v in net.pretrain_layer(0, [ds] * 5)]
    pre_ms = (time.perf_counter() - t0) * 1e3 / 5
    cpu = build("cpu")
    cpu.params = params_from_numpy(params_to_numpy(net.params), device="cpu")
    lps = [with_draws(NumpyDraws(SEED + 151, n.device),
                      lambda n=n: n.reconstruction_log_probability(xs[:64], num_samples=5).cpu())
           for n in (net, cpu)]
    lp_diff = float((lps[0] - lps[1]).abs().max())
    with recorded(uk, "fused_update_cuda") as calls:
        sup = [float(net.fit_batch(ds))]
    k4 = k4_against_plain(calls)
    del calls
    sup += [float(net.fit_batch(ds)) for _ in range(4)]
    rec = {"arm": "vae", "config": {"n_in": MLP_IN, "latent": 32, "encoder": [256, 256],
                                    "decoder": [256, 256], "reconstruction": "bernoulli",
                                    "batch": MLP_BATCH, "updater": "Adam(lr=1e-3), K4 on"},
           "pretrain_elbo": elbo, "pretrain_ms_per_step": pre_ms,
           "iwae_log_prob_5_samples_card_vs_cpu_max_abs_diff": lp_diff,
           "iwae_mean_log_prob": float(lps[0].mean()), "supervised_losses": sup,
           "tolerance": 1e-4, "k4_vs_plain": k4}
    rec["ok"] = (all(math.isfinite(v) for v in elbo + sup) and elbo[-1] < elbo[0]
                 and lp_diff <= 1e-4 and k4["bitwise"])
    emit({"phase": "heads", **rec})
    return rec


def iris_mlp(device, lr=0.1):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(SEED + 160).updater(Sgd(lr=lr))
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net


def transfer_arm():
    """(h): transfer learning on LeNet, featurize against fine-tuning, early
    stopping with a LocalFileModelSaver, and L-BFGS on the Iris MLP."""
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import load_iris
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn.transferlearning import (TransferLearning,
                                                              TransferLearningHelper)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.optimize.solvers import fit_solver

    rng = np.random.default_rng(SEED + 170)
    batches = [DataSet(torch.from_numpy(rng.standard_normal((64, 28, 28, 1), dtype=np.float32)
                                        ).cuda(),
                       torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(0, 5, 64)]
                                        ).cuda()) for _ in range(5)]

    def transferred():
        src = LeNet(device="cuda")
        return (TransferLearning(src).fine_tune_configuration(updater=Adam(lr=1e-3))
                .set_feature_extractor(3).n_out_replace(5, 5).build())
    net = transferred()
    frozen = [{k: v.clone() for k, v in net.params[i].items()} for i in (0, 2)]
    tl_losses = [float(net.fit_batch(d)) for d in batches]
    frozen_same = all(torch.equal(net.params[i][k], v)
                      for i, f in zip((0, 2), frozen) for k, v in f.items())
    a, b = transferred(), transferred()
    helper = TransferLearningHelper(a, 3)
    for d in batches[:3]:
        helper.fit_featurized(helper.featurize(d))
        b.fit_batch(d)
    feat_diff = max_tree_diff(a.params, b.params)
    # early stopping on Iris, best model restored from disk
    xs, ys = load_iris()
    x = ((xs - xs.mean(0)) / xs.std(0)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[ys]
    order = np.random.default_rng(SEED + 171).permutation(150)
    train, val = order[:100], order[100:]
    es_net = iris_mlp("cuda", lr=3.0)
    with tempfile.TemporaryDirectory() as tmp:
        saver = es.LocalFileModelSaver(tmp)
        cfg = es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(DataSet(x[val], y[val])),
            epoch_terminations=[es.MaxEpochsTerminationCondition(12),
                                es.ScoreImprovementEpochTerminationCondition(1)],
            iteration_terminations=[es.InvalidScoreIterationTerminationCondition()],
            model_saver=saver)
        res = es.EarlyStoppingTrainer(cfg, es_net, [DataSet(x[train[i:i + 25]], y[train[i:i + 25]])
                                                    for i in range(0, 100, 25)]).fit()
        best = type(es_net).load(saver.best_path, device="cuda")
        restored_bitwise = bool(torch.equal(best.output(x), es_net.output(x)))
    restored_score = es.DataSetLossCalculator(DataSet(x[val], y[val])).calculate_score(es_net)
    # L-BFGS, card against the CPU; the CPU again with inputs one float32
    # spacing up measures how far rounding alone moves the path
    runs = {}
    for name, dev, xx in (("card", "cuda", x), ("cpu", "cpu", x),
                          ("cpu_nudged", "cpu", np.nextafter(x, np.float32(np.inf)))):
        runs[name] = fit_solver(iris_mlp(dev), DataSet(xx, y), method="lbfgs",
                                max_iterations=20).losses
    wobble = abs(runs["cpu"][-1] - runs["cpu_nudged"][-1])
    final_diff = abs(runs["card"][-1] - runs["cpu"][-1])
    rec = {"arm": "transfer_earlystopping_lbfgs",
           "transfer": {"losses": tl_losses, "frozen_params_bitwise": frozen_same,
                        "featurized_vs_fine_tuned_max_abs_diff": feat_diff},
           "early_stopping": {"scores": res.score_vs_epoch, "best_epoch": res.best_model_epoch,
                              "total_epochs": res.total_epochs,
                              "reason": res.termination_reason,
                              "details": res.termination_details,
                              "restored_output_bitwise_best_zip": restored_bitwise,
                              "restored_score_minus_best": restored_score - res.best_model_score},
           "lbfgs": {"losses_card": runs["card"], "final_cpu": runs["cpu"][-1],
                     "final_abs_diff": final_diff, "cpu_rounding_wobble": wobble,
                     "bound": 1e-4 + 2 * wobble}}
    rec["ok"] = (frozen_same and feat_diff <= 1e-5 and all(math.isfinite(v) for v in tl_losses)
                 and restored_bitwise and abs(rec["early_stopping"]["restored_score_minus_best"])
                 <= 1e-6 and all(b2 <= a2 for a2, b2 in zip(runs["card"], runs["card"][1:]))
                 and final_diff <= 1e-4 + 2 * wobble)
    emit({"phase": "heads", **rec})
    return rec


def phase_heads():
    """TinyYOLO, InceptionResNetV1, FaceNetNN4Small2, the VAE, transfer
    learning, early stopping and L-BFGS on the card, with Adam's fused
    update (K4) switched on."""
    import torch

    from deeplearning4j_tpu_torch.models import FaceNetNN4Small2, TinyYOLO
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    t0 = time.perf_counter()
    os.environ[uk.ENV_SWITCH] = "1"
    uk.fused_update_cuda.launches = 0
    net = TinyYOLO(YOLO_HW, YOLO_HW, 3, YOLO_CLASSES, device="cuda")
    ds = yolo_batch(YOLO_B, YOLO_HW, SEED + 120)
    f32 = train_arm("heads", "tinyyolo_train_float32", net, ds, "float32", 2,
                    [YOLO_B, YOLO_HW, YOLO_HW, 3])
    bf16 = train_arm("heads", "tinyyolo_train_bfloat16", net, ds, "bfloat16", 1,
                     [YOLO_B, YOLO_HW, YOLO_HW, 3])
    net.conf.compute_dtype = "float32"
    graph = graph_vs_eager(net, [yolo_batch(32, YOLO_HW, SEED + 121 + i) for i in range(2)])
    graph["decode"] = yolo_decode_check(net, ds.features[:8])
    graph["ok"] = graph["ok"] and graph["decode"]["shapes_ok"] and \
        graph["decode"]["conf_in_0_1"] and graph["decode"]["class_rows_are_distributions"]
    emit({"phase": "heads", "arm": "tinyyolo_fit_batches_graph", **graph})
    del net, ds
    torch.cuda.empty_cache()
    cuts = heads_cuts()
    irv1, irv1_graph = irv1_arm()
    torch.cuda.empty_cache()
    face = FaceNetNN4Small2(FACENET_HW, FACENET_HW, 3, FACE_CLASSES, device="cuda")
    face.init()
    facenet = train_arm("heads", "facenet_nn4_small2_train", face,
                        face_batch(FACENET_B, FACENET_HW, FACE_CLASSES, SEED + 145), "float32",
                        1, [FACENET_B, FACENET_HW, FACENET_HW, 3])
    face_out = face.output(face_batch(8, FACENET_HW, FACE_CLASSES, SEED + 146).features)[0]
    facenet["output_rows_are_distributions"] = bool(
        (face_out.sum(1) - 1).abs().max() < 1e-4 and torch.isfinite(face_out).all())
    del face
    torch.cuda.empty_cache()
    vae = vae_arm()
    transfer = transfer_arm()
    k4 = uk.fused_update_cuda.launches
    rec = {"phase": "heads", "seconds": time.perf_counter() - t0,
           "launches": {"fused_update": k4},
           "gates": {"tinyyolo_f32_falling": f32["finite_and_falling"],
                     "tinyyolo_bf16_falling": bf16["finite_and_falling"],
                     "tinyyolo_graph_bitwise_and_decode": graph["ok"],
                     "card_vs_cpu_cuts": cuts["ok"],
                     "inception_resnet_v1_falling": irv1["finite_and_falling"],
                     "inception_resnet_v1_graph_bitwise": irv1_graph["ok"],
                     "facenet_falling": facenet["finite_and_falling"]
                     and facenet["output_rows_are_distributions"],
                     "vae": vae["ok"], "transfer_earlystopping_lbfgs": transfer["ok"],
                     "k4_launched": k4 > 0,
                     # train_arm raises on a difference; these say K4 ran
                     "k4_vs_plain_tinyyolo_irv1_facenet": all(
                         r["k4_vs_plain"]["bitwise"] for r in (f32, bf16, irv1, facenet))}}
    emit(rec)
    if not all(rec["gates"].values()):
        raise AssertionError(f"heads phase failed: {rec['gates']}")
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


YOLO_DP_ROWS, YOLO_DP_STEPS = 8, 2


def yolo_dp_net(device, dtype="float32"):
    """TinyYOLO at 416 with SGD, the data-parallel arm's network."""
    from deeplearning4j_tpu_torch.models import TinyYOLO
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    net = TinyYOLO(YOLO_HW, YOLO_HW, 3, YOLO_CLASSES, updater=Sgd(lr=1e-3), device=device)
    if dtype != "float32":
        net.conf.param_dtype = net.conf.compute_dtype = dtype
        net.init()
    return net


def max_rel_tree_diff(a, b) -> float:
    """Largest |a − b| over each leaf's largest |b|, leaf for leaf."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    out = 0.0
    for p, q in zip(graph_layers(a), graph_layers(b)):
        for x, y in zip(tree_leaves(p), tree_leaves(q)):
            x, y = x.detach().cpu().double(), y.detach().cpu().double()
            out = max(out, float((x - y).abs().max() / y.abs().max().clamp_min(1e-30)))
    return out


def norm_rel_tree_diff(a, b) -> float:
    """‖a − b‖ / ‖b‖ over every leaf of two containers' trees together."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    num = den = 0.0
    for p, q in zip(graph_layers(a), graph_layers(b)):
        for x, y in zip(tree_leaves(p), tree_leaves(q)):
            x, y = x.detach().cpu().double(), y.detach().cpu().double()
            num += float(((x - y) ** 2).sum())
            den += float((y ** 2).sum())
    return (num / den) ** 0.5 if den else 0.0


def local_state_mean(net, ds, ranks):
    """The mean over ``ranks`` of the layers' new state after a
    training-mode forward of each rank's rows alone (each rank's own
    BatchNorm moments), from the network's current parameters and state."""
    import torch

    per, states = ds.features.shape[0] // ranks, []
    for r in range(ranks):
        rows = slice(r * per, (r + 1) * per)
        so: list = []
        with torch.no_grad():
            net._loss(net.params, net.state, ds.features[rows],
                      {k: v[rows] for k, v in ds.labels.items()}, train=True,
                      generator=net._gen, state_out=so)
        states.append(so)
    return [{k: sum(s[i][k] for s in states) / ranks for k in states[0][i]}
            for i in range(len(states[0]))]


def k6_against_plain(comp, calls) -> dict:
    """Every K6 launch ``recorded`` in a step held bitwise against its
    plain version on the same gradient: messages and counts."""
    import torch

    bitwise, sizes = bool(calls), []
    for (g, sizes, ks, t, *_), (out, counts) in calls:
        want, want_counts = comp.threshold_encode_buckets_plain(g, sizes, ks, t)
        bitwise = (bitwise and bool(torch.equal(out[:sum(ks)], want))
                   and bool(torch.equal(counts, want_counts)))
    return {"calls": len(calls), "buckets": len(sizes), "bucket_sizes": sorted(set(sizes)),
            "bitwise": bitwise}


def yolo_dp_arm(rank: int, trainer_cls, mesh_fn, comp) -> dict:
    """Compressed-phase arm (e): TinyYOLO at 416 on two ranks, 8 rows each,
    SGD, 2 steps dense and 2 two-tier compressed at ``COMPRESS_T``: per step
    the loss, fingerprints of the parameters and of the BatchNorm
    statistics, and K6's launches; the compressed arm's first statistics
    against the mean of the two ranks' local updates, and its first K6
    launch (every bucket of the step, the last one ragged) against K6's
    plain version on the same gradient.  Then the dense arm again in
    float64, which rank 0 holds against one process stepping the 16-row
    global batch: at its initial weights TinyYOLO's float32 gradients move
    by up to 8% of a leaf's size when the same 16 rows are merely summed
    in another order (measured on the CPU; 6e-13 in float64), so only
    float64 can show that the two are the same step.  Each step's loss,
    BatchNorm statistics and parameters are read as the largest
    difference over a leaf's largest value, and the parameters also as
    ‖a − b‖ / ‖b‖ over all of them (the gates are in
    ``phase_compressed``)."""
    out = {}
    for name, dtype, kw in (("dense", "float32", {}),
                            ("compressed", "float32", {"grad_compression": "threshold",
                                                       "compression_threshold": COMPRESS_T}),
                            ("dense_f64", "float64", {})):
        ds = yolo_batch(2 * YOLO_DP_ROWS, YOLO_HW, SEED + 180, dtype=dtype)
        net = yolo_dp_net("cuda", dtype)
        trainer = trainer_cls(net, mesh_fn(), **kw)
        single = yolo_dp_net("cuda", dtype) if name == "dense_f64" and rank == 0 else None
        steps, against = [], []
        for i in range(YOLO_DP_STEPS):
            expect = local_state_mean(net, ds, 2) if name == "compressed" and i == 0 else None
            k6 = comp.threshold_encode_buckets_cuda.launches
            hold = name == "compressed" and i == 0
            with (recorded(comp, "threshold_encode_buckets_cuda") if hold
                  else contextlib.nullcontext([])) as calls:
                loss = float(trainer.fit_batch(ds))
            if hold:
                out["compressed_k6_vs_plain"] = k6_against_plain(comp, calls)
            del calls
            steps.append({"loss": loss, "params": fingerprint(net.params),
                          "state": fingerprint(net.state),
                          "k6": comp.threshold_encode_buckets_cuda.launches - k6})
            if expect is not None:
                out["compressed_state_vs_local_mean_max_abs_diff"] = max_tree_diff(
                    net.state, expect)
            if single is not None:
                ls = float(single.fit_batch(ds))
                against.append({"loss_rel_diff": abs(ls - loss) / abs(ls),
                                "params_norm_rel_diff": norm_rel_tree_diff(net.params,
                                                                           single.params),
                                "state_max_rel_diff": max_rel_tree_diff(net.state, single.state),
                                "params_leaf_max_rel_diff": max_rel_tree_diff(net.params,
                                                                              single.params)})
        out[name] = {"steps": steps, "n_buckets": trainer.bucketer.n_buckets}
        if single is not None:
            out["dense_vs_one_process_f64"] = against
        del trainer, net, single
    return out


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
    out["yolo"] = yolo_dp_arm(rank, ShardedTrainer,
                              lambda: build_two_tier_mesh(2, {"data": 1}), comp)
    shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_compressed():
    import statistics
    import tempfile

    from deeplearning4j_tpu_torch.ops import compression as comp

    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks("--compressed-rank", 2, work)

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
    # arm (e): TinyYOLO with BatchNorm on the two ranks
    y0, y1 = ranks[0]["yolo"], ranks[1]["yolo"]
    yolo = {"model": "TinyYOLO 416x416, 20 classes", "rows_per_rank": YOLO_DP_ROWS,
            "updater": "Sgd(lr=1e-3)", "steps": YOLO_DP_STEPS,
            "dense_losses": [s["loss"] for s in y0["dense"]["steps"]],
            "compressed_losses": [s["loss"] for s in y0["compressed"]["steps"]],
            "ranks_bitwise_equal": {a: all(p["params"] == q["params"] and p["state"] == q["state"]
                                           and p["loss"] == q["loss"]
                                           for p, q in zip(y0[a]["steps"], y1[a]["steps"]))
                                    for a in ("dense", "compressed", "dense_f64")},
            "dense_f64_losses": [s["loss"] for s in y0["dense_f64"]["steps"]],
            "dense_vs_one_process_f64": y0["dense_vs_one_process_f64"],
            "compressed_state_vs_local_mean_max_abs_diff":
                [y["compressed_state_vs_local_mean_max_abs_diff"] for y in (y0, y1)],
            "k6_launches_per_step": [[s["k6"] for s in y["compressed"]["steps"]]
                                     for y in (y0, y1)],
            "dense_k6_launches": sum(s["k6"] for y in (y0, y1) for a in ("dense", "dense_f64")
                                     for s in y[a]["steps"]),
            "n_buckets": y0["compressed"]["n_buckets"]}
    if not all(yolo["ranks_bitwise_equal"].values()):
        bad.append("e_yolo: ranks differ")
    # step 1 holds every parameter leaf tightly: a wrong backward of the
    # moments' all-reduce moves gradients by O(1).  Step 2 starts from
    # parameters the f32 updater has rounded, and its gradient at these
    # initial weights amplifies a flipped last bit in small leaves, so it
    # holds the norm over all of them.
    first, *later = yolo["dense_vs_one_process_f64"]
    if (any(step[k] > 1e-4 for step in [first] + later
            for k in ("loss_rel_diff", "state_max_rel_diff"))
            or first["params_leaf_max_rel_diff"] > 1e-6
            or any(step["params_norm_rel_diff"] > 1e-4 for step in later)):
        bad.append("e_yolo: dense arm against one process")
    yolo["compressed_k6_vs_plain"] = [y["compressed_k6_vs_plain"] for y in (y0, y1)]
    if not all(k["bitwise"] and k["buckets"] == yolo["n_buckets"]
               for k in yolo["compressed_k6_vs_plain"]):
        bad.append("e_yolo: K6 against its plain version")
    if any(v > 1e-6 for v in yolo["compressed_state_vs_local_mean_max_abs_diff"]):
        bad.append("e_yolo: compressed statistics against the local mean")
    if any(k != 1 for ks in yolo["k6_launches_per_step"] for k in ks) \
            or yolo["dense_k6_launches"]:
        bad.append("e_yolo: K6 launches")
    if not all(math.isfinite(v) for v in yolo["dense_losses"] + yolo["compressed_losses"]):
        bad.append("e_yolo: loss")
    arms["e_tinyyolo_batchnorm"] = yolo
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


# -- sharded phase (bench config 7, ShardedTransformerLM) --------------------------

#: arm (d)'s depth cut of GPT-2-small, and its meshes: name → (axes, LM
#: keyword arguments, compute dtype)
SHARDED_CUT_LAYERS, SHARDED_STEPS = 4, 2
SHARDED_ARMS = {
    "tp_sp_ring": ({"model": 2, "seq": 2}, {"seq_parallel": "ring"}, None),
    "tp_sp_ulysses": ({"model": 2, "seq": 2}, {"seq_parallel": "ulysses"}, None),
    "tp_pp_gpipe_m2": ({"model": 2, "pipe": 2}, {"schedule": "gpipe", "n_microbatches": 2}, None),
    "tp_pp_1f1b_m2": ({"model": 2, "pipe": 2}, {"schedule": "1f1b", "n_microbatches": 2}, None),
    "tp_pp_gpipe_m4": ({"model": 2, "pipe": 2}, {"schedule": "gpipe", "n_microbatches": 4}, None),
    "tp_pp_1f1b_m4": ({"model": 2, "pipe": 2}, {"schedule": "1f1b", "n_microbatches": 4}, None),
    "tp_sp_ulysses_bf16": ({"model": 2, "seq": 2}, {"seq_parallel": "ulysses"}, "bfloat16"),
    "tp_pp_gpipe_bf16": ({"model": 2, "pipe": 2}, {"schedule": "gpipe", "n_microbatches": 2},
                         "bfloat16"),
}
#: K1-K3's bf16 / f16 kernels, by kernel name in a trace: all three on the
#: warpgroup MMA (wgmma) of the tensor cores
FLASH_TC_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
                    "flash_bwd_dq_wgmma_kernel")
D1_KERNELS = ("det_attention_split", "det_attention_tiled")


def gpt2_tree(n_layers, seed=SEED + 200):
    """A ``ShardedTransformerLM`` parameter tree at GPT-2-small's widths
    (the reference's layout: blocks stacked on a leading layer axis),
    from a numpy seed with ``build_model``'s GPT-2 initialisation."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = lambda std, *shape: (std * rng.standard_normal(shape)).astype(np.float32)
    d, f = D_MODEL, D_FF
    res = 0.02 / math.sqrt(2 * LAYERS)
    blocks = {"ln1_g": np.ones((n_layers, d), np.float32), "ln1_b": np.zeros((n_layers, d), np.float32),
              "Wq": n(0.02, n_layers, d, d), "Wk": n(0.02, n_layers, d, d),
              "Wv": n(0.02, n_layers, d, d), "Wo": n(res, n_layers, d, d),
              "bo": np.zeros((n_layers, d), np.float32),
              "ln2_g": np.ones((n_layers, d), np.float32), "ln2_b": np.zeros((n_layers, d), np.float32),
              "W1": n(0.02, n_layers, d, f), "b1": np.zeros((n_layers, f), np.float32),
              "W2": n(res, n_layers, f, d), "b2": np.zeros((n_layers, d), np.float32)}
    return {"embed": n(0.02, VOCAB, d), "pos": n(0.01, MAX_LEN, d), "blocks": blocks,
            "lnf_g": np.ones(d, np.float32), "lnf_b": np.zeros(d, np.float32),
            "head": n(0.02, d, VOCAB)}


def sharded_lm(n_layers, device, mesh=None, tree=None, **kw):
    """A ``ShardedTransformerLM`` at GPT-2-small's widths cut to
    ``n_layers``, with ``gpt2_tree``'s weights."""
    from deeplearning4j_tpu_torch.parallel import ShardedTransformerLM, build_mesh

    lm = ShardedTransformerLM(vocab_size=VOCAB, n_layers=n_layers, d_model=D_MODEL,
                              n_heads=HEADS, d_ff=D_FF, max_len=MAX_LEN,
                              mesh=mesh or build_mesh({"data": 1}), device=device, **kw)
    lm.load_params(tree if tree is not None else gpt2_tree(n_layers))
    return lm


def lm_tokens(b, t, seed):
    """[b, t] ids from a seed and the targets rolled by one."""
    import numpy as np
    tok = np.random.default_rng(seed).integers(0, VOCAB, (b, t))
    return tok, np.roll(tok, -1, axis=1)


def flash_counters():
    """K1-K3's launch counters; ``flash_fwd``, ``flash_bwd_dkdv`` and
    ``flash_bwd_dq`` count every dtype, the ``_tc`` ones the bf16 and f16 launches
    (the tensor-core kernels)."""
    from deeplearning4j_tpu_torch.ops import attention as att
    return {"flash_fwd": att.flash_forward_cuda, "flash_fwd_tc": att.flash_forward_tc_cuda,
            "flash_bwd_dkdv": att.flash_bwd_dkdv_cuda,
            "flash_bwd_dkdv_tc": att.flash_bwd_dkdv_tc_cuda,
            "flash_bwd_dq": att.flash_bwd_dq_cuda,
            "flash_bwd_dq_tc": att.flash_bwd_dq_tc_cuda}


def sharded_config7():
    """Arms (a) and (b): bench config 7 at full width on one card."""
    import statistics

    import torch

    from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_map

    lm = sharded_lm(LAYERS, "cuda", n_microbatches=1, compute_dtype=torch.bfloat16,
                    updater=Adam(lr=3e-4, moment_dtype="bfloat16"))
    tok, tgt = lm_tokens(8, MAX_LEN, SEED + 210)
    counters = flash_counters()
    for c in counters.values():
        c.launches = 0
    losses = [float(lm.fit_batch(tok, tgt)) for _ in range(2)]          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(float(lm.fit_batch(tok, tgt)))
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the traced step's launches by the wrappers' counters (the gate); the
    # trace's kernel counts and device ms are a report (a profiler can
    # lose records at a trace's ends)
    before = {k: c.launches for k, c in counters.items()}
    prof = device_profile(lambda: float(lm.fit_batch(tok, tgt)), FLASH_TC_KERNELS, top=8)
    counted = {k: c.launches - before[k] for k, c in counters.items()}
    launches = {k: c.launches for k, c in counters.items()}
    med = statistics.median(times)
    flash_ms = sum(prof["named_ms"].values())
    a = {"model": "bench config 7: GPT-2-small, vocab 50304, 12 x 768, 12 heads, "
                  "bf16 compute, Adam(3e-4, bf16 moments)",
         "batch": [8, MAX_LEN], "losses": losses, "step_ms": times, "median_step_ms": med,
         "tokens_per_s": 8 * MAX_LEN / (med / 1e3), "peak_memory_gib": peak,
         "traced_step": prof, "k1_k3_share_of_busy": flash_ms / prof["busy_ms"],
         "k1_k3_device_ms": dict(zip(("K1", "K2", "K3"), prof["named_ms"].values())),
         "k1_k3_counted_per_step": counted,
         "k1_k3_traced_per_step": prof["named"], "launches": launches}
    emit({"phase": "sharded", "arm": "a_config7", **a})
    bad = []
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        bad.append("a: loss not finite and falling")
    # K1-K3 12 each a step, all three on the tensor cores (each _tc
    # counter as many as its kernel's own)
    if any(v != LAYERS for v in counted.values()):
        bad.append(f"a: K1-K3 in bf16 per step by the counters {counted}, "
                   f"want {LAYERS} each, all on the tensor cores")

    # (b) fit_batches(2) as one CUDA graph against 2 eager steps
    batches = [lm_tokens(8, MAX_LEN, SEED + 211), lm_tokens(8, MAX_LEN, SEED + 212)]
    clone = lambda t: tree_map(lambda x: x.clone(), t)
    start = (clone(lm.params), clone(lm.opt_state), lm.iteration)
    eager = [float(lm.fit_batch(x, y)) for x, y in batches]
    after = (clone(lm.params), clone(lm.opt_state))
    lm.params, lm.opt_state, lm.iteration = start
    before = {k: c.launches for k, c in counters.items()}
    stacked = [[x for x, _ in batches], [y for _, y in batches]]
    import numpy as np
    stacked = [np.stack(s) for s in stacked]
    graphed = [float(x) for x in lm.fit_batches(*stacked)]
    bitwise = eager == graphed and trees_equal(after, [lm.params, lm.opt_state])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.fit_batches(*stacked)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / 2
    for k, c in counters.items():
        launches[k] += c.launches - before[k]
    b = {"k": 2, "losses_eager": eager, "losses_graph": graphed, "bitwise": bitwise,
         "graphs": len(lm._fit_graphs), "replay_ms_per_step": replay_ms,
         "eager_ms_per_step": med}
    emit({"phase": "sharded", "arm": "b_fit_batches", **b})
    if not (bitwise and len(lm._fit_graphs) == 1):
        bad.append("b: the graph is not bitwise its eager steps, or captured again")
    return {"a": a, "b": b, "launches": launches}, bad


def sharded_card_vs_cpu():
    """Arm (c): a 2-layer cut at GPT-2 widths, f32, [2, 128], 2 SGD steps
    on the card and on the CPU from the same weights."""
    import numpy as np

    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    tree = gpt2_tree(2)
    tok, tgt = lm_tokens(2, 128, SEED + 220)
    runs = []
    for dev in ("cuda", "cpu"):
        lm = sharded_lm(2, dev, tree=tree, updater=Sgd(lr=0.1))
        losses = [float(lm.fit_batch(tok, tgt)) for _ in range(2)]
        runs.append((losses, lm.params_numpy()))
    (lg, pg), (lc, pc) = runs
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    diff = max(float(np.abs(a - b).max()) for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    c = {"cut": "2 layers at GPT-2 widths, f32, [2, 128], Sgd(0.1)", "losses_card": lg,
         "losses_cpu": lc, "loss_max_rel_diff": loss_rel, "params_max_abs_diff": diff,
         "tolerance": 1e-4}
    emit({"phase": "sharded", "arm": "c_card_vs_cpu", **c})
    return c, ([] if loss_rel <= 1e-4 and diff <= 1e-4 else ["c: card against CPU"])


def leaf_hashes(tree, prefix=""):
    """sha1 of each leaf's bytes (``prefix/key`` → hex)."""
    import hashlib
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaf_hashes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = hashlib.sha1(v.detach().contiguous().cpu().numpy().tobytes()
                                           ).hexdigest()
    return out


def sharded_rank(rank: int, work: str) -> None:
    """One of arm (d)'s four gloo ranks on cuda:0 (``--sharded-rank R
    DIR``): every mesh of ``SHARDED_ARMS`` in turn from ``gpt2_tree``'s
    weights, ``SHARDED_STEPS`` steps each; the gathered parameters held
    against the one-rank run's (DIR/reference.npz) on rank 0; writes
    DIR/rankR.json."""
    import gc
    import statistics

    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeplearning4j_tpu_torch.nn.updaters import Sgd, tree_leaves
    from deeplearning4j_tpu_torch.parallel import build_mesh, initialize, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=4,
               process_id=rank, backend="gloo", timeout_s=600)
    tree = gpt2_tree(SHARDED_CUT_LAYERS)
    tok, tgt = lm_tokens(8, MAX_LEN, SEED + 230)
    ref = dict(np.load(os.path.join(work, "reference.npz"))) if rank == 0 else None
    counters = flash_counters()
    out = {"rank": rank, "arms": {}}
    for name, (axes, kw, dtype) in SHARDED_ARMS.items():
        lm = sharded_lm(SHARDED_CUT_LAYERS, "cuda", mesh=build_mesh(axes), tree=tree,
                        updater=Sgd(lr=0.1), compute_dtype=dtype, **kw)
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(SHARDED_STEPS):
            t0 = time.perf_counter()
            losses.append(float(lm.fit_batch(tok, tgt)))
            times.append((time.perf_counter() - t0) * 1e3)
        rec = {"losses": losses, "step_ms": times, "median_step_ms": statistics.median(times),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": {k: c.launches for k, c in counters.items()},
               "coords": [lm.mesh.coords[a] for a in ("data", "model", "seq", "pipe")],
               "local": leaf_hashes(lm.params)}
        whole = lm.params_numpy()                                     # a collective
        if ref is not None and dtype is None:
            flat = {k: v for k, v in whole.items() if k != "blocks"}
            flat.update({f"blocks/{k}": v for k, v in whole["blocks"].items()})
            rec["params_max_abs_diff"] = max(float(np.abs(flat[k] - ref[k]).max()) for k in ref)
        out["arms"][name] = rec
        del lm, whole
        gc.collect()
        torch.cuda.empty_cache()
    shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_ranks(flag: str, n: int, work: str, limit_s: float = 900) -> list:
    """``n`` processes of this script with ``flag R work``, waited for (all
    killed past ``limit_s``); their DIR/rankR.json records."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r), work])
             for r in range(n)]
    try:
        deadline = time.monotonic() + limit_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise AssertionError(f"{flag}: a rank failed (exit codes {rcs})")
    out = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def sharded_meshes():
    """Arm (d): the meshes of ``SHARDED_ARMS`` on four gloo ranks on
    cuda:0 against a one-rank run of the same cut on the card."""
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    tok, tgt = lm_tokens(8, MAX_LEN, SEED + 230)
    ref = sharded_lm(SHARDED_CUT_LAYERS, "cuda", updater=Sgd(lr=0.1))
    ref_losses = [float(ref.fit_batch(tok, tgt)) for _ in range(SHARDED_STEPS)]
    whole = ref.params_numpy()
    del ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        np.savez(os.path.join(work, "reference.npz"),
                 **{k: v for k, v in whole.items() if k != "blocks"},
                 **{f"blocks/{k}": v for k, v in whole["blocks"].items()})
        del whole
        ranks = run_ranks("--sharded-rank", 4, work)
    bad, arms = [], {}
    for name, (axes, kw, dtype) in SHARDED_ARMS.items():
        recs = [r["arms"][name] for r in ranks]
        losses = recs[0]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        # leaves a line shares are bitwise alike along it: all across seq,
        # the replicated ones across model, the non-block ones across pipe
        shared_ok, pairs = True, 0
        for i in range(4):
            for j in range(i + 1, 4):
                diff = [a for a in range(4) if recs[i]["coords"][a] != recs[j]["coords"][a]]
                if len(diff) != 1:
                    continue
                ax = ("data", "model", "seq", "pipe")[diff[0]]
                for k, h in recs[i]["local"].items():
                    leaf = k.split("/")[-1]
                    split = ((ax == "model" and (k == "head" or leaf in
                                                 ("Wq", "Wk", "Wv", "W1", "b1", "Wo", "W2")))
                             or (ax == "pipe" and k.startswith("blocks/")))
                    if not split:
                        pairs += 1
                        shared_ok = shared_ok and h == recs[j]["local"][k]
        rec = {"mesh": axes, **kw, "compute_dtype": dtype or "float32", "losses": losses,
               "losses_one_rank": ref_losses, "loss_max_rel_diff": rel,
               "median_step_ms_per_rank": [r["median_step_ms"] for r in recs],
               "peak_memory_gib_per_rank": [r["peak_memory_gib"] for r in recs],
               "launches_rank0": recs[0]["launches"], "shared_leaves_bitwise": shared_ok,
               "shared_leaf_pairs": pairs,
               "ranks_same_losses": all(r["losses"] == losses for r in recs)}
        if dtype is None:
            rec["params_max_abs_diff"] = recs[0]["params_max_abs_diff"]
            if rel > 1e-4 or rec["params_max_abs_diff"] > 1e-4:
                bad.append(f"d/{name}: against the one-rank run")
        if name.startswith("tp_pp_1f1b"):
            # the value pass is GPipe's program at the same microbatch count
            rec["first_loss_bitwise_gpipe"] = (
                losses[0] == ranks[0]["arms"][name.replace("1f1b", "gpipe")]["losses"][0])
            if not rec["first_loss_bitwise_gpipe"]:
                bad.append(f"d/{name}: first loss not bitwise GPipe's")
        if not (shared_ok and pairs and rec["ranks_same_losses"]):
            bad.append(f"d/{name}: shared leaves or losses differ across ranks")
        if not all(math.isfinite(x) for x in losses):
            bad.append(f"d/{name}: loss")
        want_flash = SHARDED_STEPS * SHARDED_CUT_LAYERS * (1 if "ulysses" in name else 0)
        if name.startswith("tp_pp"):
            m = kw["n_microbatches"]
            want_flash = SHARDED_STEPS * (SHARDED_CUT_LAYERS // 2) * m
        if recs[0]["launches"]["flash_fwd"] < want_flash:
            bad.append(f"d/{name}: K1 launches {recs[0]['launches']}")
        arms[name] = rec
        emit({"phase": "sharded", "arm": f"d_{name}", **rec})
    launches = {k: sum(r["arms"][n]["launches"][k] for r in ranks for n in SHARDED_ARMS)
                for k in flash_counters()}
    return {"arms": arms, "depth_cut": f"{SHARDED_CUT_LAYERS} of {LAYERS} layers",
            "launches": launches}, bad


def sharded_decode():
    """Arm (e): an f32 ``ShardedTransformerLM`` at GPT-2 widths cut to
    ``SHARDED_CUT_LAYERS`` layers, behind ``DecodeEngine``: one-way and
    2-way tensor-parallel with both head shards on cuda:0."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import kv_cache as kvc
    from deeplearning4j_tpu_torch.parallel import build_mesh

    tree = gpt2_tree(SHARDED_CUT_LAYERS, SEED + 240)
    prompts, kws = serve_requests()
    out, bad = {}, []
    launches = 0
    for n in (1, 2):
        lm = sharded_lm(SHARDED_CUT_LAYERS, "cuda", mesh=build_mesh({"data": n}, world_size=n),
                        tree=tree)
        run = serve_run(lm, prompts, kws)
        results = run["outcomes"]
        failed = [r for r in results if isinstance(r, BaseException)]
        launches += run["launches"]["det_attention"]
        bitwise = not failed and all(
            np.array_equal(r.logits, reencode_rows(run["engine"], p, r.tokens))
            for p, r in zip(prompts, results))
        rec = {"tp": n, "shard_devices": "cuda:0 x 2" if n == 2 else "cuda:0",
               **run["metrics"], "launches": run["launches"],
               "pages_in_use_after": run["snap"]["pages_in_use"],
               "snapshot_tp": run["snap"].get("tp"), "logits_bitwise_reencode": bitwise}
        if n == 1 and not failed:
            err = 0.0
            for p, r in zip(prompts, results):
                with torch.inference_mode():
                    full = lm.logits(np.asarray([p + r.tokens[:-1]]))[0, len(p) - 1:].float()
                want = torch.log_softmax(full, -1).cpu().numpy()
                got = torch.log_softmax(torch.from_numpy(r.logits).float(), -1).numpy()
                err = max(err, float(np.abs(got - want).max()))
            rec["logprob_max_abs_diff_vs_logits"] = err
            if err > 1e-4:
                bad.append("e: one-way decode against logits()")
        # D1 launches of one step of all 4 slots, from a trace of the card
        prog = lm.decode_program(page_size=16, max_len=MAX_LEN)
        cache = kvc.alloc_cache(prog.n_layers, 1 + 4 * prog.pages_per_slot, 16, HEADS,
                                D_MODEL // HEADS, device="cuda",
                                shard_devices=prog.shard_devices if n > 1 else None)
        dev = torch.device("cuda")
        step = lambda: prog.step(lm.params, cache[0], cache[1],
                                 torch.zeros((4, prog.pages_per_slot), dtype=torch.long, device=dev),
                                 torch.zeros(4, dtype=torch.long, device=dev),
                                 torch.zeros(4, dtype=torch.long, device=dev),
                                 torch.zeros(4, dtype=torch.bool, device=dev))
        # D1 calls a step by the wrapper's counter (the gate) and by a
        # trace (a report); the step only measures, so the count is put back
        before = kvc.det_attention_cuda.launches
        rec["d1_traced_per_step"] = traced_kernels(step, D1_KERNELS)
        rec["d1_counted_per_step"] = kvc.det_attention_cuda.launches - before
        kvc.det_attention_cuda.launches = before
        if rec["d1_counted_per_step"] != SHARDED_CUT_LAYERS * n:
            bad.append(f"e/tp{n}: D1 per step {rec['d1_counted_per_step']}")
        if failed or not bitwise or rec["pages_in_use_after"] != 0 or rec["snapshot_tp"] != n:
            bad.append(f"e/tp{n}: failed requests, bits, pages or tp")
        emit({"phase": "sharded", "arm": f"e_decode_tp{n}", **rec})
        out[f"tp{n}"] = rec
        del lm, run, cache
        torch.cuda.empty_cache()
    return {**out, "launches": {"det_attention": launches}}, bad


def iris_adam_mlp(device):
    """The Iris MLP with Adam (lr 1e-2) and per-layer L2 clipping at 1.0,
    so the model axis's updater slices and summed norms both run."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam, GradientNormalization

    conf = (NeuralNetConfiguration.builder().seed(SEED + 250).updater(Adam(lr=1e-2))
            .gradient_normalization(GradientNormalization.CLIP_L2_PER_LAYER, 1.0)
            .layer(Dense(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net


MODEL_AXIS_STEPS = 5


def model_axis_rank(rank: int, work: str) -> None:
    """One of arm (g)'s two gloo ranks on cuda:0 (``--model-axis-rank R
    DIR``): the Iris MLP on ``{model 2}``, K4 on, 5 steps; its first
    step's K4 calls (on this rank's slices) held bitwise to K4's plain
    version; writes DIR/rankR.json."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    from deeplearning4j_tpu_torch.ops import update_kernel as uk
    from deeplearning4j_tpu_torch.parallel import (ShardedTrainer, build_mesh, initialize,
                                                   shutdown)

    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=300)
    os.environ[uk.ENV_SWITCH] = "1"
    x, y = iris_data()
    ds = DataSet(x, y)
    trainer = ShardedTrainer(iris_adam_mlp("cuda"), build_mesh({"model": 2}))
    uk.fused_update_cuda.launches = 0
    with recorded(uk, "fused_update_cuda") as calls:
        losses = [float(trainer.fit_batch(ds))]
    k4 = k4_against_plain(calls)
    losses += [float(trainer.fit_batch(ds)) for _ in range(MODEL_AXIS_STEPS - 1)]
    whole = trainer.gather_params()
    out = {"losses": losses, "k4": k4, "k4_launches": uk.fused_update_cuda.launches,
           "local_numel": [int(t.numel()) for p in trainer.net.params for t in tree_leaves(p)],
           "whole": [t.cpu().numpy().tolist() for p in whole for t in tree_leaves(p)]}
    shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sharded_model_axis():
    """Arm (g): ``ShardedTrainer``'s model axis on two gloo ranks against
    one process on the card."""
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    from deeplearning4j_tpu_torch.ops import update_kernel as uk

    os.environ[uk.ENV_SWITCH] = "1"
    net = iris_adam_mlp("cuda")
    x, y = iris_data()
    want = [float(net.fit_batch(DataSet(x, y))) for _ in range(MODEL_AXIS_STEPS)]
    whole = [t.cpu().numpy() for p in net.params for t in tree_leaves(p)]
    full_numel = [int(t.size) for t in whole]
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks("--model-axis-rank", 2, work, limit_s=300)
    diff = max(float(np.abs(np.asarray(a, np.float32) - b).max())
               for r in ranks for a, b in zip(r["whole"], whole))
    loss_diff = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], want))
    # sorted keys a layer: Dense W [4, 16] and b [16] split by columns,
    # the head's W [16, 3] by rows, its b [3] whole
    halves = all(r["local_numel"] == [n // 2 if n != 3 else n for n in full_numel]
                 for r in ranks)
    g = {"mesh": {"model": 2}, "model": "Iris MLP 4-16-3, Adam(1e-2), clip L2 per layer 1.0",
         "steps": MODEL_AXIS_STEPS, "losses": ranks[0]["losses"], "losses_one_process": want,
         "loss_max_abs_diff": loss_diff, "params_max_abs_diff": diff,
         "local_numel": ranks[0]["local_numel"], "full_numel": full_numel,
         "each_rank_holds_half": halves, "k4_on_shards": [r["k4"] for r in ranks],
         "k4_launches": sum(r["k4_launches"] for r in ranks)}
    emit({"phase": "sharded", "arm": "g_model_axis", **g})
    ok = (diff <= 1e-5 and loss_diff <= 1e-5 and halves
          and all(r["k4"]["bitwise"] for r in ranks))
    return g, ([] if ok else ["g: model axis against one process, halves or K4"])


def sharded_kernels():
    """Arm (f): K1-K3 in bf16 at the slice's new shapes, and D1 at a
    6-head shard, against their plain versions."""
    import torch

    fwd = [flash_case("bf16_tp2_pipe2_micro", torch.bfloat16, 0.0, B=4, H=6),
           flash_case("bf16_ulysses_tp2_sp2", torch.bfloat16, 0.0, B=8, H=3),
           flash_case("bf16_config7", torch.bfloat16, 0.0, B=8, H=HEADS)]
    bwd = [flash_bwd_case("bf16_tp2_pipe2_micro", torch.bfloat16, 0.0, B=4, H=6),
           flash_bwd_case("bf16_ulysses_tp2_sp2", torch.bfloat16, 0.0, B=8, H=3),
           flash_bwd_case("bf16_config7", torch.bfloat16, 0.0, B=8, H=HEADS)]
    det = [det_case("step_shard6", 4, 1, MAX_LEN, [[15], [300], [700], [MAX_LEN - 1]], True,
                    H=HEADS // 2),
           det_case("prefill_shard6", 1, 512, MAX_LEN, [list(range(512))], True, H=HEADS // 2)]
    bad = [r["case"] for r in fwd if not (r["max_abs_err"] <= 2e-2 and r["rel_err"] <= 1e-2)]
    bad += [f"{r['case']}/{k}" for r in bwd for k in ("flash_bwd_dkdv", "flash_bwd_dq")
            if not (r[k]["max_abs_err"] <= 2e-2 and r[k]["rel_err"] <= 1e-2
                    and r[k]["bitwise_repeat"])]
    bad += [r["case"] for r in det if r["max_abs_err"] > 2e-5]
    return {"flash_fwd": fwd, "flash_bwd": bwd, "det": det}, [f"f: {b}" for b in bad]


def phase_sharded():
    """The sharded phase, arms (a)-(g) (the module docstring)."""
    import gc

    import torch

    t0 = time.perf_counter()
    bad = []
    out = {}
    for name, arm in (("config7", sharded_config7), ("card_vs_cpu", sharded_card_vs_cpu),
                      ("kernels", sharded_kernels), ("decode", sharded_decode),
                      ("model_axis", sharded_model_axis), ("meshes", sharded_meshes)):
        out[name], b = arm()
        bad += b
        gc.collect()
        torch.cuda.empty_cache()
    launches = {
        **{k: out["config7"]["launches"][k] + out["meshes"]["launches"][k]
           for k in flash_counters()},
        "det_attention": out["decode"]["launches"]["det_attention"],
        "fused_update": out["model_axis"]["k4_launches"]}
    emit({"phase": "sharded", "seconds": time.perf_counter() - t0, "launches": launches,
          "failures": bad})
    if bad:
        raise AssertionError(f"sharded phase failed: {bad}")
    return {**out, "launches": launches}


# -- elastic phase -------------------------------------------------------------------

ELASTIC_LENET_STEPS = 30
#: the launched workers' command, the reference's own ``launch`` example:
#: its adaptive threshold encodes by top-k and launches no K6
LAUNCH_TRAIN = ["train", "--zoo", "lenet", "--data", "mnist", "--batch-size", "256",
                "--epochs", "3", "--mesh", "dcn=2,data=1,compress=threshold",
                "--checkpoint-every", "4", "--print-every", "1000"]
MOE_TOKENS, MOE_EXPERTS, MOE_K, MOE_CF = 8192, 8, 2, 1.0
ELASTIC_CNN_B, ELASTIC_CNN_STEPS = 16, 3


class _Plain:
    def __init__(self, net):
        self.net = net

    def fit_batch(self, ds):
        return self.net.fit_batch(ds)


def elastic_lenet(tmp):
    """(a): bench config 2's LeNet through a chaos soak under
    ``ElasticTrainer``; every gate of the module docstring."""
    import torch

    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.parallel import (ChaosInjector, CheckpointManager,
                                                   ElasticTrainer, FaultSchedule)

    def make():
        net = LeNet(LENET_HW, LENET_HW, 3, LENET_CLASSES,
                    updater=Nesterovs(lr=0.01, momentum=0.9), device="cuda")
        net.set_nan_guard(2)
        return net

    batches = [images(LENET_B, LENET_HW, LENET_CLASSES, SEED + 300 + i) for i in range(10)]
    epochs = ELASTIC_LENET_STEPS // len(batches)

    def run():
        plain = make()
        want = [float(plain.fit_batch(b)) for b in batches * epochs]
        net = make()
        off = ElasticTrainer(_Plain(net), os.path.join(tmp, "off"), checkpoint_every=5)
        got_off = [float(l) for l in off.fit(batches, epochs=epochs)]
        # injector call -> faults; a corruption shares its call with a
        # device loss so the restore meets the corrupt newest checkpoint
        sched = FaultSchedule.scripted({
            7: "device_loss", 12: "ckpt_write_crash", 21: "hung_step",
            27: ["ckpt_truncate", "device_loss"], 38: ["ckpt_bitflip", "device_loss"],
            50: "nan_grads"})
        net = make()
        inj = ChaosInjector(_Plain(net), sched, hang_seconds=2.0)
        d = os.path.join(tmp, "chaos")
        et = ElasticTrainer(inj, d, checkpoint_every=5, keep_last=3, max_restarts=4,
                            sync_every=1, step_timeout=1.5, backoff_base=0.05,
                            jitter_seed=0)
        inj.attach_checkpoints(et.ckpt)
        t0 = time.perf_counter()
        et.fit(batches, epochs=epochs)
        wall = time.perf_counter() - t0
        CheckpointManager(d)                           # a restart's manager
        return want, got_off, et, inj, sched, net, wall

    want, got_off, et, inj, sched, net, wall = deterministic(run)
    files = sorted(os.listdir(os.path.join(tmp, "chaos")))
    steps = [(s, float(l)) for s, l in et.step_losses]
    # the guarded NaN step skips its update: steps from it on leave the
    # fault-free trajectory; every step before it, replays included, is on it
    nan_at = next((s for s, l in steps if l != l), None)
    replays = len(steps) - len({s for s, _ in steps})
    bad = []
    if got_off != want:
        bad.append("a: chaos-off losses not bitwise the plain loop")
    if sched.pending() or len(inj.events) != 8:
        bad.append(f"a: faults not all injected ({inj.events})")
    if et.total_restarts != 5:
        bad.append(f"a: {et.total_restarts} recoveries, want 5")
    quarantined = [f for f in files if f.endswith(".corrupt")]
    if len(quarantined) != 2:
        bad.append(f"a: quarantined {quarantined}, want the truncated and the flipped")
    if any(f.endswith(".tmp") for f in files):
        bad.append(f"a: a stale .tmp is left ({files})")
    mismatched = [s for s, l in steps if (nan_at is None or s < nan_at) and l != want[s - 1]]
    if mismatched or nan_at is None or replays == 0:
        bad.append(f"a: steps {mismatched} not bitwise the fault-free run "
                   f"(nan step {nan_at}, {replays} replays)")
    if et.global_step != ELASTIC_LENET_STEPS or net._bad_steps > 1:
        bad.append(f"a: ended at step {et.global_step}")
    out = {"steps": ELASTIC_LENET_STEPS, "recoveries": et.total_restarts,
           "restored_steps": et.restored_steps, "replayed_steps": replays,
           "quarantined": quarantined, "faults": [(e["step"], e["kind"]) for e in inj.events],
           "backoff_s": et.backoff_sleeps, "recovery_s": et.recovery_seconds,
           "wall_s": wall, "nan_step": nan_at}
    return out, bad


def elastic_gpt2():
    """(b): GPT-2-small under ``ElasticTrainer(async_checkpoints=True)``, a
    device loss one step after a checkpoint; restore and replay.  A
    generator: it yields once the async checkpoint's write has started, so
    the phase runs its other arms while the write deflates on its
    background thread, and is resumed for the fault, the restore and the
    replay."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.ops import update_kernel as uk
    from deeplearning4j_tpu_torch.parallel import ChaosInjector, ElasticTrainer, FaultSchedule

    os.environ[uk.ENV_SWITCH] = "1"
    net = build_model()
    rng = np.random.default_rng(SEED + 400)
    dev = torch.device("cuda")
    batches = []
    for _ in range(3):
        seq = rng.integers(0, VOCAB, (8, MAX_LEN + 1))
        batches.append(DataSet(torch.from_numpy(seq[:, :-1]).to(dev),
                               torch.from_numpy(seq[:, 1:]).to(dev)))
    start = snapshot(net)

    def timed_step(b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(net.fit_batch(b))
        return loss, (time.perf_counter() - t) * 1e3

    want, base_ms, at2 = [], [], None
    for i, b in enumerate(batches):
        loss, ms = timed_step(b)
        want.append(loss)
        base_ms.append(ms)
        if i == 1:
            at2 = (net.clone_params(), clone_trees(net.opt_state))
    restore(net, snapshot_of(start))
    counters = {**flash_counters(), "fused_update": uk.fused_update_cuda}
    launches = dict.fromkeys(counters, 0)
    tmp = tempfile.mkdtemp(prefix="elastic_gpt2_")
    inj = ChaosInjector(_Plain(net), FaultSchedule.scripted({3: "device_loss"}))
    et = ElasticTrainer(inj, tmp, checkpoint_every=2, sync_every=1, async_checkpoints=True,
                        keep_last=2)
    stamps = {}
    real_async, real_restore = et.ckpt.save_async, et._restore

    def save_async(src, step):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fut = real_async(src, step)
        stamps.setdefault("snapshot_ms", []).append((time.perf_counter() - t) * 1e3)
        return fut

    def restore_():
        t = time.perf_counter()
        real_restore()
        stamps["restore_s"] = time.perf_counter() - t
        stamps["restored_bitwise"] = (trees_equal(net.params, at2[0])
                                      and trees_equal(net.opt_state, at2[1]))
    et.ckpt.save_async, et._restore = save_async, restore_
    step_ms = []
    real_fit = net.fit_batch

    def fit_timed(b):
        # this arm's steps' own launches: the arms that run while the
        # checkpoint deflates launch kernels too
        before = {n: c.launches for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_fit(b)
        float(out)
        step_ms.append((time.perf_counter() - t) * 1e3)
        for n, c in counters.items():
            launches[n] += c.launches - before[n]
        return out
    net.fit_batch = fit_timed
    try:
        # one deflated write (step 2), overlapped with the phase's other
        # arms; then the fault at call 3, whose retry replays step 3
        for b in batches[:2]:
            et.fit_batch(b)
        t_write = time.perf_counter()
        yield
        stamps["write_landed_before_restore"] = et.ckpt._pending.done()
        stamps["write_wall_s"] = time.perf_counter() - t_write
        et.fit_batch(batches[2])
    finally:
        del net.fit_batch
    steps = [(s, float(l)) for s, l in et.step_losses]
    ckpt_path = et.ckpt.latest()[0]
    bad = []
    if [s for s, _ in steps] != [1, 2, 3] or et.restored_steps != [2]:
        bad.append(f"b: steps {steps}, restored {et.restored_steps}")
    if any(l != want[s - 1] for s, l in steps):
        bad.append("b: losses after recovery not bitwise the fault-free run's")
    if not stamps.get("restored_bitwise"):
        bad.append("b: restored parameters / Adam moments not bitwise the checkpoint's")
    per_step = {"flash_fwd": 12, "flash_bwd_dkdv": 12, "flash_bwd_dq": 12,
                "fused_update": 15}
    if any(launches[n] != 3 * k for n, k in per_step.items()):
        bad.append(f"b: launches {launches}, want 3 steps of {per_step}")
    out = {"losses": [l for _, l in steps], "fault_free": want,
           "checkpoint_bytes": os.path.getsize(ckpt_path),
           "snapshot_ms": stamps.get("snapshot_ms"),
           "deflate_write_s": et.ckpt.last_save_seconds,
           "restore_s": stamps.get("restore_s"), "recovery_s": et.recovery_seconds,
           "write_landed_before_restore": stamps.get("write_landed_before_restore"),
           "other_arms_s_during_write": stamps.get("write_wall_s"),
           "step_ms_before": sorted(base_ms[1:])[len(base_ms[1:]) // 2],
           "step_ms_elastic": step_ms, "launches": launches}
    shutil.rmtree(tmp, ignore_errors=True)
    del net, start, at2
    return out, bad


def snapshot_of(snap):
    """Fresh clones of a ``snapshot`` (so it can be restored again)."""
    return (clone_trees(snap[0]), clone_trees(snap[1]), clone_trees(snap[2]), snap[3])


def launch_runs(tmp):
    """(c) and (d): three ``launch`` runs of two gloo ranks on cuda:0, in
    parallel: chaos-off, a ``proc_kill`` of worker 1, a preemption notice
    to worker 0 → {arm: (report, {(worker, incarnation): losses file})}."""
    arms = {"off": [], "kill": ["--chaos-worker", "1:proc_kill@8"],
            "preempt": ["--grace", "60", "--chaos-worker", "0:preempt_notice@10"]}
    procs = {}
    env = dict(os.environ, PYTHONPATH=REPO)
    for arm, extra in arms.items():
        d = os.path.join(tmp, arm)
        os.makedirs(d)
        cmd = ([sys.executable, "-m", "deeplearning4j_tpu_torch", "launch", "--nprocs", "2",
                "--bootstrap", "distributed", "--run-dir", os.path.join(d, "run"),
                "--report", os.path.join(d, "report.json"), "--deadline", "420",
                "--heartbeat-timeout", "60", "--connect-timeout", "180"] + extra
               + ["--"] + LAUNCH_TRAIN
               + ["--elastic-dir", os.path.join(d, "ck"),
                  "--losses-out", os.path.join(d, "losses_{process}_{incarnation}.json")])
        procs[arm] = subprocess.Popen(cmd, cwd=d, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT)
    logs = {}
    try:
        for arm, p in procs.items():
            logs[arm] = p.communicate(timeout=480)[0].decode(errors="replace")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for arm, p in procs.items():
        d = os.path.join(tmp, arm)
        if p.returncode != 0:
            raise AssertionError(f"launch {arm} exited {p.returncode}:\n{logs[arm][-3000:]}")
        with open(os.path.join(d, "report.json")) as f:
            rep = json.load(f)
        files = {}
        for fn in os.listdir(d):
            if fn.startswith("losses_"):
                w, inc = fn[len("losses_"):-len(".json")].split("_")
                with open(os.path.join(d, fn)) as f:
                    files[(int(w), int(inc))] = json.load(f)
        out[arm] = (rep, files)
    return out


def elastic_launch(tmp):
    """(c) and (d) gates; K6 bitwise its plain version on LeNet's buckets
    (at a fixed threshold: the launched workers' adaptive path has no K6)."""
    runs = launch_runs(tmp)
    bad = []
    rep_off, off = runs["off"]
    base = {s: l for s, l in off[(0, 0)]["steps"]}
    if [s for s, _ in off[(0, 0)]["steps"]] != list(range(1, 25)):
        bad.append("c: the chaos-off run did not take 24 steps")
    if off[(1, 0)]["steps"] != off[(0, 0)]["steps"]:
        bad.append("c: the chaos-off workers' losses differ")

    def on_baseline(files):
        return all(l == base.get(s) for f in files.values() for s, l in f["steps"])

    rep, kill = runs["kill"]
    leaves = [(e["worker"], e["cause"]) for e in rep["leaves"]]
    if not (rep["ok"] and rep["restarts"] == 1 and leaves == [(1, "crash")]
            and rep["completed"] == [0, 1] and rep["leaked_killed"] == 0):
        bad.append(f"c: report {({k: rep[k] for k in ('ok', 'restarts', 'completed')})}, "
                   f"leaves {leaves}")
    if rep["epoch"] <= rep_off["epoch"]:
        bad.append(f"c: membership epoch {rep['epoch']} did not move past {rep_off['epoch']}")
    resumed = kill.get((1, 1), {"steps": [[0, 0]]})["steps"][0][0] - 1
    restored0 = [s for s, _ in kill[(0, 0)]["steps"]]
    if sorted(kill) != [(0, 0), (1, 1)] or restored0.count(resumed + 1) != 2:
        bad.append(f"c: workers did not both resume at step {resumed}")
    if not on_baseline(kill):
        bad.append("c: a trajectory is not bitwise the chaos-off run")
    rep_p, pre = runs["preempt"]
    p_leaves = [(e["cause"], e["rc"]) for e in rep_p["leaves"]]
    notice = pre[(0, 0)].get("preempted", {})
    if not (rep_p["ok"] and rep_p["restarts"] == 0 and rep_p["planned_leaves"] >= 1
            and all(l == ("preempted", 75) for l in p_leaves)):
        bad.append(f"d: report restarts {rep_p['restarts']}, leaves {p_leaves}")
    if not notice or notice["seconds"] > 60 or notice["checkpoint"] is None:
        bad.append(f"d: emergency checkpoint {notice}")
    p_step = notice.get("step", -1)
    if [s for s, _ in pre.get((0, 1), {"steps": []})["steps"]][:1] != [p_step + 1]:
        bad.append("d: the relaunch did not resume at the preempted step")
    if not on_baseline(pre):
        bad.append("d: the preempted run's trajectory is not bitwise the chaos-off run")
    k6 = sum(f["launches"]["threshold_encode"] for r in ("kill", "preempt")
             for f in runs[r][1].values())
    out = {"kill": {"restarts": rep["restarts"], "epoch": rep["epoch"],
                    "epoch_chaos_off": rep_off["epoch"], "wall_s": rep["wall_seconds"],
                    "resumed_at": resumed, "events": [(e["kind"], e.get("worker"))
                                                      for e in rep["events"]]},
           "preempt": {"planned_leaves": rep_p["planned_leaves"], "step": p_step,
                       "grace_used_s": notice.get("seconds"), "stored": notice.get("stored"),
                       "wall_s": rep_p["wall_seconds"]},
           "chaos_off_wall_s": rep_off["wall_seconds"], "k6_launches": k6}
    k6b, b = lenet_k6_bitwise()
    out["k6_bitwise"] = k6b
    bad += b
    return out, bad


def lenet_k6_bitwise():
    """K6 on one compressed step of LeNet's buckets (a one-slice trainer
    at a fixed threshold, ``compression_threshold=1e-3``), bitwise its
    plain version."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import ZOO
    from deeplearning4j_tpu_torch.ops import compression as comp
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer, build_two_tier_mesh

    net = ZOO["lenet"](device="cuda")
    rng = np.random.default_rng(SEED + 500)
    ds = DataSet(torch.from_numpy(rng.random((128, 28, 28, 1), dtype=np.float32)).cuda(),
                 torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, 128)]).cuda())
    trainer = ShardedTrainer(net, build_two_tier_mesh(1), grad_compression="threshold",
                             compression_threshold=1e-3)
    with recorded(comp, "threshold_encode_buckets_cuda") as calls:
        trainer.fit_batch(ds)
    r = k6_against_plain(comp, calls)
    return r, ([] if r["bitwise"] and r["calls"] == 1 else [f"c: K6 not bitwise {r}"])


def elastic_rank(rank: int, work: str) -> None:
    """A rank of arms (e) and (f): MoE expert parallelism on {model 2},
    then the ResNet-50 graph on ``ShardedTrainer({model 2})``; rank 0 then
    runs both in one process as the reference."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import (ShardedTrainer, build_mesh, initialize,
                                                   shutdown)
    from deeplearning4j_tpu_torch.parallel.collectives import Axis, all_reduce
    from deeplearning4j_tpu_torch.parallel.moe import (dropped_tokens, init_moe_params_numpy,
                                                       moe_forward_dense, moe_forward_ep)
    from deeplearning4j_tpu_torch.utils.params import params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=300)
    mesh = build_mesh({"model": 2})
    p_np = init_moe_params_numpy(SEED + 600, D_MODEL, D_FF, MOE_EXPERTS)
    rng = np.random.default_rng(SEED + 601)
    x_np = rng.standard_normal((MOE_TOKENS, D_MODEL), dtype=np.float32)
    w_np = rng.standard_normal((MOE_TOKENS, D_MODEL), dtype=np.float32)

    def moe(fn):
        p = {k: torch.tensor(v, device="cuda", requires_grad=True) for k, v in p_np.items()}
        x = torch.tensor(x_np, device="cuda", requires_grad=True)
        y, aux = fn(p, x)
        (torch.sum(y * torch.from_numpy(w_np).cuda()) + aux).backward()
        return y.detach(), aux.detach(), {k: v.grad for k, v in p.items()}, x.grad

    ep = lambda p, x: moe_forward_ep(p, x, mesh, k=MOE_K, capacity_factor=MOE_CF)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    y, aux, gp, gx = moe(ep)
    ms = cuda_ms(lambda: moe(ep), iters=3, warmup=1)
    ax = Axis(mesh, "model")
    gp = {k: (g if k == "Wg" else all_reduce(g, ax)) for k, g in gp.items()}
    res = {"moe_ms": ms, "moe_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # the ResNet-50 graph, {model 2}
    torch.cuda.reset_peak_memory_stats()

    def resnet50():
        return ResNet50(CNN_HW, CNN_HW, 3, CNN_CLASSES, updater=Sgd(lr=0.01), device="cuda")
    batches = [images(ELASTIC_CNN_B, CNN_HW, CNN_CLASSES, SEED + 700 + i)
               for i in range(ELASTIC_CNN_STEPS)]
    net = resnet50()
    whole = [k for k, v in net.params.items() if v]
    trainer = ShardedTrainer(net, mesh)
    t0 = time.perf_counter()
    losses = [float(trainer.fit_batch(b)) for b in batches]
    torch.cuda.synchronize()
    res["cnn_step_ms"] = (time.perf_counter() - t0) / len(batches) * 1e3
    res["cnn_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["cnn_losses"] = losses
    res["split_leaves"] = sum(1 for k in whole for a in trainer.shardings[k].values()
                              if a is not None)
    full = trainer.gather_params()
    res["half_of_split"] = all(
        t.numel() * 2 == full[k][n].numel()
        for k, layer in net.params.items() for n, t in layer.items()
        if trainer.shardings[k][n] is not None)
    gathered = params_to_numpy(full)
    shutdown()
    if rank == 0:
        dense = moe(lambda p, x: moe_forward_dense(p, x, MOE_K))
        drops = dropped_tokens({k: torch.from_numpy(v).cuda() for k, v in p_np.items()},
                               torch.from_numpy(x_np).cuda(), MOE_K, MOE_CF)
        kept = ~drops.any(dim=1)
        # the reference EP semantics in one process: the same capacity drops
        one = moe(lambda p, x: moe_forward_ep(p, x, build_mesh({"model": 1}, world_size=1),
                                              k=MOE_K, capacity_factor=MOE_CF))

        def rel(a, b):
            return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))
        res["moe_fwd_err_vs_one"] = float((y - one[0]).abs().max())
        res["moe_fwd_err_vs_dense_kept"] = float((y[kept] - dense[0][kept]).abs().max())
        res["moe_grad_rel"] = max([rel(gp[k], one[2][k]) for k in gp] + [rel(gx, one[3])])
        res["moe_dropped"] = int(drops.sum())
        res["moe_dropped_same"] = bool(torch.equal(
            drops, _ep_drops(p_np, x_np)))
        ref = resnet50()
        want = [float(ref.fit_batch(b)) for b in batches]
        res["cnn_losses_one"] = want
        res["cnn_param_err"] = max(
            float(np.abs(a - b).max()) for k in gathered for n in gathered[k]
            for a, b in [(gathered[k][n], params_to_numpy(ref.params)[k][n])])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _ep_drops(p_np, x_np):
    """The (token, expert) routings past capacity counted from the gates
    in numpy (an independent count of ``dispatch``'s drops)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.parallel.moe import _router, capacity

    gates, _ = _router({"Wg": torch.from_numpy(p_np["Wg"]).cuda()},
                       torch.from_numpy(x_np).cuda(), MOE_K)
    routed = (gates > 0).cpu().numpy()
    pos = np.cumsum(routed, axis=0) - routed
    return torch.from_numpy(routed & (pos >= capacity(MOE_TOKENS, MOE_EXPERTS, MOE_K,
                                                      MOE_CF))).cuda()


def elastic_ranks(tmp):
    """(e) and (f): two gloo ranks on cuda:0."""
    work = os.path.join(tmp, "ranks")
    os.makedirs(work)
    r = run_ranks("--elastic-rank", 2, work, limit_s=600)
    bad = []
    r0 = r[0]
    if not (r0["moe_fwd_err_vs_one"] <= 1e-5 and r0["moe_fwd_err_vs_dense_kept"] <= 1e-5
            and r0["moe_grad_rel"] <= 1e-4):
        bad.append(f"e: MoE errors {r0['moe_fwd_err_vs_one']}, "
                   f"{r0['moe_fwd_err_vs_dense_kept']}, grad {r0['moe_grad_rel']}")
    if not (r0["moe_dropped_same"] and r0["moe_dropped"] > 0):
        bad.append("e: the dropped tokens differ")
    for k in range(2):
        if not r[k]["half_of_split"] or r[k]["split_leaves"] == 0:
            bad.append(f"f: rank {k} does not hold half of each split leaf")
        if max(abs(a - b) / abs(b) for a, b in zip(r[k]["cnn_losses"],
                                                    r0["cnn_losses_one"])) > 1e-4:
            bad.append(f"f: rank {k} losses {r[k]['cnn_losses']} vs {r0['cnn_losses_one']}")
    if r0["cnn_param_err"] > 1e-4:
        bad.append(f"f: gathered parameters {r0['cnn_param_err']} from one process")
    out = {"moe": {k: [x[k] for x in r] if k in ("moe_ms", "moe_peak_gib") else r0[k]
                   for k in ("moe_ms", "moe_peak_gib", "moe_fwd_err_vs_one",
                             "moe_fwd_err_vs_dense_kept", "moe_grad_rel", "moe_dropped")},
           "cnn": {"losses": r0["cnn_losses"], "one_process": r0["cnn_losses_one"],
                   "param_err": r0["cnn_param_err"], "split_leaves": r0["split_leaves"],
                   "step_ms": [x["cnn_step_ms"] for x in r],
                   "peak_gib": [x["cnn_peak_gib"] for x in r]}}
    return out, bad


def elastic_inference():
    """(g): ``ParallelInference`` over LeNet: results bitwise the eager
    forward of their bucket; ``shutdown`` fails a late request."""
    import numpy as np

    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = LeNet(LENET_HW, LENET_HW, 3, LENET_CLASSES, device="cuda")
    pi = ParallelInference(net, max_batch=4, bucket_sizes=[1, 2, 4])
    rng = np.random.default_rng(SEED + 800)
    xs = [rng.standard_normal((1 + i % 3, LENET_HW, LENET_HW, 3), dtype=np.float32)
          for i in range(8)]
    outs = [pi.output(x) for x in xs]
    bitwise = all(np.array_equal(o, eager_bucket(net, x, b)[:len(x)].cpu().numpy())
                  for x, o in zip(xs, outs) for b in [min(c for c in pi.buckets if c >= len(x))])
    pi.shutdown()
    late_failed = False
    try:
        pi.output_async(xs[0]).result(timeout=30)
    except RuntimeError:
        late_failed = True
    bad = [] if bitwise and late_failed else [f"g: bitwise {bitwise}, late failed {late_failed}"]
    return {"requests": len(xs), "bitwise_eager_bucket": bitwise,
            "late_request_failed": late_failed, "buckets": pi.buckets}, bad


def _finish(gen):
    """The return value of a generator run to its end."""
    try:
        next(gen)
    except StopIteration as stop:
        return stop.value
    raise AssertionError("the generator yielded twice")


def phase_elastic():
    """The elastic phase, arms (a)-(g) (the module docstring)."""
    import gc
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_elastic_")
    bad, out = [], {}
    try:
        t = time.perf_counter()
        gpt2 = elastic_gpt2()
        next(gpt2)                      # steps 1-2; the checkpoint deflates behind
        gpt2_s = time.perf_counter() - t
        for name, arm in (("launch", lambda: elastic_launch(tmp)),
                          ("lenet", lambda: elastic_lenet(tmp)),
                          ("inference", elastic_inference),
                          ("ranks", lambda: elastic_ranks(tmp)),
                          ("gpt2", lambda: _finish(gpt2))):
            t = time.perf_counter()
            out[name], b = arm()
            out[name]["seconds"] = time.perf_counter() - t + (gpt2_s if name == "gpt2" else 0)
            bad += b
            emit({"phase": "elastic", "arm": name, **out[name]})
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {**out["gpt2"]["launches"], "threshold_encode": out["launch"]["k6_launches"]}
    emit({"phase": "elastic", "seconds": time.perf_counter() - t0, "launches": launches,
          "failures": bad})
    if bad:
        raise AssertionError(f"elastic phase failed: {bad}")
    return {**out, "launches": launches}


# -- fleet phase ---------------------------------------------------------------------

#: the fleet phase's predict rows: [rows, 256] token ids (the 1024-long
#: rows' outputs are 206 MB a row, 4x the copy to the host for no more
#: model: the width is GPT-2-small's either way)
FLEET_T = 256
FLEET_REQUESTS, FLEET_CLIENTS, FLEET_KILL_AT = 32, 4, 12


class HostTap:
    """Records every attempt a ``FleetRouter`` sends one predict engine:
    (request index, the engine's future), and the attempts refused
    synchronously.  ``index`` maps ``id(x)`` of a request's array to its
    index (the router hands the engine the caller's array)."""

    def __init__(self, name, eng, index):
        self.name, self.eng, self.index = name, eng, index
        self.attempts, self.sync_failures = [], 0
        orig, tap = eng.output_async, self

        def call(x, *a, **kw):
            try:
                f = orig(x, *a, **kw)
            except Exception:
                tap.sync_failures += 1
                raise
            tap.attempts.append((tap.index.get(id(x)), f))
            return f
        eng.output_async = call

    def failed(self) -> int:
        return self.sync_failures + sum(1 for _, f in self.attempts
                                        if f.done() and f.exception() is not None)


def fleet_bitwise(taps, xs, outs, models):
    """Every delivered request bitwise the eager forward of the padded
    bucket it was served in, on the model its batch's tag names
    (``models``: tag → network), from each host's ``batch_log`` → (ok,
    requests checked, tags seen)."""
    import numpy as np
    import torch
    ok, n, tags = True, 0, {}
    for tap in taps:
        fid = {id(f): i for i, f in tap.attempts
               if i is not None and f.done() and f.exception() is None}
        for b in tap.eng.batch_log:
            members = [fid[r] for r in b["request_ids"] if r in fid]
            if not members:
                continue
            x = np.concatenate([xs[i] for i in members])
            y = eager_bucket(models[b["tag"]], x, b["rows"] + b["padded"])
            ofs = 0
            for i in members:
                got = torch.from_numpy(outs[i]).to("cuda")
                ok = ok and torch.equal(got, y[ofs:ofs + xs[i].shape[0]])
                ofs += xs[i].shape[0]
                n += 1
                tags[b["tag"]] = tags.get(b["tag"], 0) + 1
            del y
    return ok, n, tags


def fleet_predict(net):
    """(a) a ``FleetRouter`` over two in-process hosts, each
    ``Engine(replicas=1, max_batch=4)``: 32 requests of 1-3 rows from 4
    threads, ``FleetChaos`` killing host h1 at request 12; (b) a rolling
    swap v0 → v2 under traffic, then a swap to v3 whose second host dies
    mid-swap, rolling the survivor back to v0."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.parallel import FaultKind, FaultSchedule, FleetChaos
    from deeplearning4j_tpu_torch.serving import (Engine, FleetHost, FleetRouter,
                                                  ReplicaCrashError)
    from deeplearning4j_tpu_torch.serving.engine import _fail_safe

    bad = []
    load = lambda: Engine(net, max_batch=4, replicas=1, slo_ms=600_000,
                          device="cuda").load(input_shape=(FLEET_T,))
    engines = [load(), load()]
    rng = np.random.default_rng(SEED + 310)
    xs = [rng.integers(0, VOCAB, (1 + (5 * i) % 3, FLEET_T)).astype(np.float32)
          for i in range(FLEET_REQUESTS)]
    index = {id(x): i for i, x in enumerate(xs)}
    taps = [HostTap(f"h{i}", e, index) for i, e in enumerate(engines)]
    router = FleetRouter([FleetHost(f"h{i}", engine=e) for i, e in enumerate(engines)],
                         max_retries=2)
    programs = [dict(e._current.programs) for e in engines]
    chaos = FleetChaos(FaultSchedule.scripted({FLEET_KILL_AT: FaultKind.HOST_KILL}))
    lock = threading.Lock()
    futs, outs, errors = [None] * len(xs), [None] * len(xs), []
    killed_inflight = []

    def client(k):
        for i in range(k, len(xs), FLEET_CLIENTS):
            with lock:
                if FaultKind.HOST_KILL in chaos.pop_request():
                    # kill h1 while it holds work (up to 2 s for some to
                    # land): its unfinished attempts are lost, as a dead
                    # host's are, then its engine stops
                    h1 = router.host("h1")
                    deadline = time.monotonic() + 2.0
                    while h1.inflight == 0 and time.monotonic() < deadline:
                        time.sleep(0.001)
                    killed_inflight.append(h1.inflight)
                    for _, f in list(taps[1].attempts):
                        _fail_safe(f, ReplicaCrashError("host h1 killed"))
                    engines[1].shutdown()
                    router.mark_host_down("h1", reason="chaos host_kill")
                futs[i] = router.output_async(xs[i])
            try:
                outs[i] = futs[i].result(timeout=600)
            except Exception as e:   # gated: every future delivers
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        replays0 = sum(g.replays for p in programs for g in p.values())
        att.flash_forward_cuda.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        k1 = att.flash_forward_cuda.launches
        replays = sum(g.replays for p in programs for g in p.values()) - replays0
        counters = router.metrics_snapshot()["counters"]
        unwarmed = sum(e.metrics.counter_value("unwarmed_serves") for e in engines)
        bitwise, checked, _ = fleet_bitwise(taps, xs, outs, {"v0": net})
        failed_attempts = sum(t.failed() for t in taps)
        rec_a = {"hosts": 2, "requests": FLEET_REQUESTS, "clients": FLEET_CLIENTS,
                 "kill_at_request": FLEET_KILL_AT, "row_tokens": FLEET_T,
                 "h1_inflight_at_kill": killed_inflight,
                 "chaos_injected": chaos.injected(), "errors": errors,
                 "delivered": counters["delivered"], "retries": counters["retries"],
                 "failed_attempts": failed_attempts, "failed": counters["failed"],
                 "late_discards": counters["late_discards"],
                 "host_down": counters["host_down"], "graph_replays": replays,
                 "launches": {"flash_fwd": k1}, "k1_per_replay": k1 / max(replays, 1),
                 "unwarmed_serves": unwarmed, "bitwise_eager_bucket": bitwise,
                 "requests_checked": checked, "wall_s": wall,
                 "requests_per_s": FLEET_REQUESTS / wall,
                 "e2e_p50_ms": router.metrics_snapshot()["fleet_e2e_ms"]["p50_ms"],
                 "e2e_p99_ms": router.metrics_snapshot()["fleet_e2e_ms"]["p99_ms"]}
        emit({"phase": "fleet", "arm": "a_predict_fleet", **rec_a})
        if (errors or not all(o is not None for o in outs) or not bitwise
                or checked != FLEET_REQUESTS or counters["delivered"] != FLEET_REQUESTS
                or counters["failed"] or counters["late_discards"]
                or counters["retries"] != failed_attempts or failed_attempts < 1
                or chaos.injected() != 1
                or unwarmed or replays < 1 or k1 != LAYERS * replays):
            bad.append("a: predict fleet")
    finally:
        router.shutdown()
    del outs

    # (b) a rolling swap under traffic on h0 and a fresh h2
    engines = [engines[0], load()]
    v2, v3 = perturbed(net, seed=SEED + 311), perturbed(net, seed=SEED + 312)
    xs, index = [], {}
    taps = [HostTap(n, e, index) for n, e in zip(("h0", "h2"), engines)]
    for e in engines:
        e.batch_log.clear()
    router = FleetRouter([FleetHost(n, engine=e) for n, e in zip(("h0", "h2"), engines)],
                         max_retries=2)
    stop, sent, pump_errors = threading.Event(), [], []
    rng = np.random.default_rng(SEED + 313)

    def pump():
        while not stop.is_set():
            with lock:
                x = rng.integers(0, VOCAB, (1 + len(xs) % 3, FLEET_T)).astype(np.float32)
                index[id(x)] = len(xs)
                xs.append(x)
                fut = router.output_async(x)
                sent.append(fut)
            try:
                fut.result(timeout=600)
            except Exception as e:
                pump_errors.append(f"{type(e).__name__}: {e}")
    try:
        att.flash_forward_cuda.launches = 0
        with GraphSpy() as spy:
            pumps = [threading.Thread(target=pump) for _ in range(2)]
            for t in pumps:
                t.start()
            t0 = time.perf_counter()
            report = router.rolling_swap(v2, "v2", drain_timeout_s=300)
            swap_s = time.perf_counter() - t0
            time.sleep(0.5)
            stop.set()
            for t in pumps:
                t.join(timeout=600)
        k1_swap = att.flash_forward_cuda.launches
        outs = [None if f.exception() else f.result() for f in sent]
        bitwise, checked, tags = fleet_bitwise(taps, xs, outs, {"v0": net, "v2": v2})

        def die(*a, **kw):
            engines[1].shutdown()
            raise RuntimeError("host h2 killed mid-swap")
        engines[1].swap_model = die
        kill = router.rolling_swap(v3, "v3", rollback_model=net, rollback_tag="v0")
        after_tags = router.tags()
        x = np.random.default_rng(SEED + 314).integers(0, VOCAB, (2, FLEET_T)).astype(np.float32)
        back = torch.equal(torch.from_numpy(router.output(x)).to("cuda"),
                           eager_bucket(net, x, 2))
        rec_b = {"swap": report, "swap_s": swap_s, "launches": {"flash_fwd": k1_swap}, "requests": len(sent),
                 "errors": pump_errors, "bitwise_eager_bucket_of_tag": bitwise,
                 "requests_checked": checked, "by_tag": tags,
                 "captures": len(spy.captures),
                 "captures_on_replica_threads": spy.served_captures(),
                 "mid_swap_kill": {k: kill[k] for k in ("ok", "failed_host", "swapped",
                                                         "rolled_back")},
                 "tags_after": after_tags, "after_rollback_bitwise_v0": back}
        emit({"phase": "fleet", "arm": "b_rolling_swap", **rec_b})
        if (not report["ok"] or pump_errors or not bitwise or checked != len(sent)
                or set(tags) != {"v0", "v2"} or spy.served_captures()
                or len(spy.captures) != 2 * len(PREDICT_BUCKETS)
                or kill["ok"] or kill["failed_host"] != "h2" or not kill["rolled_back"]
                or after_tags != {"h0": "v0"} or not back):
            bad.append("b: rolling swap")
    finally:
        router.shutdown(shutdown_hosts=True)
        del v2, v3
        torch.cuda.empty_cache()
    return {"a": rec_a, "b": rec_b, "launches": {"flash_fwd": k1 + k1_swap}}, bad


def transfer_times(pool_kw, n_pages):
    """Milliseconds of each stage of moving ``n_pages`` pages (a 512-token
    prompt at page 16) from one pool to another through the wire, on the
    card: gather and copy to the host, pack, unpack, copy to the card and
    ``set_pages``."""
    import torch

    from deeplearning4j_tpu_torch.ops import kv_cache as kvc
    src = kvc.alloc_cache(**pool_kw)
    dst = kvc.alloc_cache(**pool_kw)
    for pool in src:
        for leaf in (pool if isinstance(pool, tuple) else (pool,)):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, device="cuda"))
            else:
                leaf.normal_()
    ids = torch.arange(1, 1 + n_pages, device="cuda")
    host = lambda p: (kvc.QuantPages(p.q.cpu().numpy(), p.scale.cpu().numpy())
                      if isinstance(p, kvc.QuantPages) else p.cpu().numpy())
    dev = lambda p: (kvc.QuantPages(*(torch.from_numpy(a.copy()).to("cuda") for a in p))
                     if isinstance(p, kvc.QuantPages) else torch.from_numpy(p.copy()).to("cuda"))
    out = {}
    for _ in range(2):          # the second pass is the one kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k, v = host(kvc.gather_pages(src[0], ids)), host(kvc.gather_pages(src[1], ids))
        t1 = time.perf_counter()
        data = kvc.pack_transfer(kvc.PageTransfer(n_pages, k, v))
        t2 = time.perf_counter()
        t = kvc.unpack_transfer(data)
        t3 = time.perf_counter()
        kvc.set_pages(dst[0], ids, dev(t.k))
        kvc.set_pages(dst[1], ids, dev(t.v))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        out = {"gather_to_host_ms": (t1 - t0) * 1e3, "pack_ms": (t2 - t1) * 1e3,
               "unpack_ms": (t3 - t2) * 1e3, "to_card_set_pages_ms": (t4 - t3) * 1e3,
               "total_ms": (t4 - t0) * 1e3, "bytes": len(data),
               "payload_bytes": kvc.transfer_nbytes(t)}
    # every leaf of the pages: an int8 pool's q and its f32 scale
    leaves = lambda p: tuple(p) if isinstance(p, kvc.QuantPages) else (p,)
    same = all(torch.equal(x, y) for a, b in zip(src, dst)
               for x, y in zip(leaves(kvc.gather_pages(a, ids)),
                               leaves(kvc.gather_pages(b, ids))))
    return {**out, "bitwise": same}


def decode_trio_run(adapter, sink_model=None, kv_dtype=None, **kw):
    """A unified engine and a prefill → decode pair behind a router, each
    answering the serve phase's 8 requests with echoed logits → (unified
    results, pair results, snapshots, D1 launches of the pair, the
    engines)."""
    import numpy as np

    from deeplearning4j_tpu_torch.ops import kv_cache as kvc
    from deeplearning4j_tpu_torch.serving import DecodeEngine, FleetHost, FleetRouter

    ekw = dict(max_slots=4, page_size=16, max_len=MAX_LEN, device="cuda", kv_dtype=kv_dtype)
    uni = DecodeEngine(adapter, **ekw).load()
    pre = DecodeEngine(adapter, role="prefill", **ekw).load()
    dec = DecodeEngine(sink_model or adapter, role="decode", **ekw).load()
    prompts, kws = serve_requests()
    send = lambda eng, p, k: eng.generate_async(p, max_new_tokens=SERVE_NEW,
                                                echo_logits=True, **k)
    ref = [f.result(timeout=600) for f in [send(uni, p, k) for p, k in zip(prompts, kws)]]
    # the prefill host's TTFT per request: its submit to the handoff
    ttft_pre, orig = [], pre.generate_async

    def timed(*a, **k):
        t0 = time.perf_counter()
        f = orig(*a, **k)
        f.add_done_callback(lambda _: ttft_pre.append((time.perf_counter() - t0) * 1e3))
        return f
    pre.generate_async = timed
    router = FleetRouter([FleetHost("pre0", decode=pre), FleetHost("dec0", decode=dec)],
                         max_retries=1)
    try:
        kvc.det_attention_cuda.launches = 0
        t0 = time.perf_counter()
        got = [f.exception(timeout=600) or f.result()
               for f in [send(router, p, k) for p, k in zip(prompts, kws)]]
        wall = time.perf_counter() - t0
        d1 = kvc.det_attention_cuda.launches
        rsnap = router.metrics_snapshot()
    finally:
        router.shutdown()
        del pre.generate_async
    deadline = time.monotonic() + 5
    while (max(e.metrics.gauge("pages_in_use") for e in (uni, pre, dec)) > 0
           and time.monotonic() < deadline):
        time.sleep(0.01)
    snaps = {n: e.metrics_snapshot() for n, e in (("unified", uni), ("prefill", pre),
                                                   ("decode", dec))}
    med = lambda xs: float(np.median([x for x in xs if x is not None])) if xs else None
    ok = [r for r in got if not isinstance(r, BaseException)]
    exact = {"unified_ttft_p50_ms": med([r.ttft_ms for r in ref]),
             "unified_tpot_p50_ms": med([r.tpot_ms for r in ref]),
             "prefill_host_ttft_p50_ms": med(ttft_pre),
             "decode_host_tpot_p50_ms": med([r.tpot_ms for r in ok])}
    return {"ref": ref, "got": got, "snaps": snaps, "router": rsnap, "d1": d1,
            "wall": wall, "engines": (uni, pre, dec), "prompts": prompts, "kws": kws,
            "exact": exact}


def fleet_decode(net):
    """(c) disaggregated decode of GPT-2-small: a prefill host and a
    decode host behind the router against a unified engine (f32 and int8
    pages), and a one-way prefill host of the f32 ``ShardedTransformerLM``
    into a two-head-shard decode sink; (d) sessions on the ring, an
    ``HttpHost`` and a prefill host's /generate; (e) a decode warm bundle
    and the kernel-build cache."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
    from deeplearning4j_tpu_torch.ops import kv_cache as kvc
    from deeplearning4j_tpu_torch.parallel import build_mesh
    from deeplearning4j_tpu_torch.serving import (DecodeEngine, Engine, FleetHost,
                                                  FleetRouter, HttpHost)
    from deeplearning4j_tpu_torch.ui import UIServer
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    bad, recs = [], {}
    adapter = TransformerDecodeAdapter(net)
    d1_total = 0
    sizes = {}
    for kv in (None, "int8"):
        run = decode_trio_run(adapter, kv_dtype=kv)
        uni, pre, dec = run["engines"]
        d1_total += run["d1"]
        failed = [r for r in run["got"] if isinstance(r, BaseException)]
        toks, bits = same_as(run["got"], run["ref"]) if not failed else (False, False)
        # the handoffs themselves, for their bytes (prefills only: no decode)
        hs = [pre.generate(p, max_new_tokens=SERVE_NEW, **k)
              for p, k in zip(run["prompts"], run["kws"])]
        name = kv or "float32"
        s = run["snaps"]
        rec = {"kv_dtype": name, "tokens_equal": toks, "logits_bitwise": bits,
               "errors": [repr(r) for r in failed],
               "pages_in_use_after": {n: v["pages_in_use"] for n, v in s.items()},
               "handoff_bytes": [len(h.pages) for h in hs],
               "payload_bytes": [kvc.transfer_nbytes(kvc.unpack_transfer(h.pages))
                                 for h in hs],
               "prompt_tokens": [len(p) for p in run["prompts"]],
               "router": {k: run["router"]["counters"][k]
                          for k in ("disagg_requests", "page_transfers", "transfer_bytes",
                                    "retries", "failed")},
               "launches": {"det_attention": run["d1"]},
               **run["exact"],
               "decode_host_attach_p50_ms": s["decode"]["ttft_ms"]["p50_ms"],
               "router_e2e_p50_ms": run["router"]["fleet_e2e_ms"]["p50_ms"],
               "pair_wall_s": run["wall"],
               "compile_cache_size": {n: v["compile_cache_size"] for n, v in s.items()}}
        sizes[name] = sum(rec["payload_bytes"])
        emit({"phase": "fleet", "arm": f"c_disagg_{name}", **rec})
        if (failed or not toks or not bits or any(rec["pages_in_use_after"].values())
                or run["d1"] < 1 or rec["router"]["disagg_requests"] != len(hs)):
            bad.append(f"c: disaggregated decode {name}")
        recs[f"c_{name}"] = rec
        if kv is None:
            keep = (uni, pre, dec, {n: v["compile_cache_size"] for n, v in s.items()})
        else:
            for e in (uni, pre, dec):
                e.shutdown()
    uni, pre, dec, cache_sizes = keep
    times = {kv or "float32": transfer_times(
        dict(n_layers=LAYERS, n_pages=33, page_size=16, n_heads=HEADS,
             d_head=D_MODEL // HEADS, device="cuda", kv_dtype=kv), 32)
        for kv in (None, "int8")}
    emit({"phase": "fleet", "arm": "c_transfer_512", "times": times,
          "payload_bytes_ratio_f32_over_int8": sizes["float32"] / sizes["int8"]})
    if not all(t["bitwise"] for t in times.values()) or sizes["float32"] < 3.5 * sizes["int8"]:
        bad.append("c: page transfer")

    # the same pair into a sink of two head shards
    tree = gpt2_tree(LAYERS, SEED + 240)
    one = sharded_lm(LAYERS, "cuda", tree=tree)
    two = sharded_lm(LAYERS, "cuda", mesh=build_mesh({"data": 2}, world_size=2), tree=tree)
    run = decode_trio_run(one, sink_model=two)
    for e in run["engines"]:
        e.shutdown()
    d1_total += run["d1"]
    failed = [r for r in run["got"] if isinstance(r, BaseException)]
    agree, first_equal, max_diff = 0, True, 0.0
    for r, g in zip(run["ref"], run["got"]):
        if isinstance(g, BaseException):
            continue
        first_equal = first_equal and r.tokens[0] == g.tokens[0]
        n = next((j for j, (a, b) in enumerate(zip(r.tokens, g.tokens)) if a != b),
                 len(r.tokens))
        agree += n
        upto = min(n + 1, len(r.tokens))
        max_diff = max(max_diff, float(np.abs(r.logits[:upto] - g.logits[:upto]).max()))
    s = run["snaps"]
    rec = {"sink_tp": s["decode"]["tp"], "errors": [repr(r) for r in failed],
           "first_tokens_equal": first_equal,
           "tokens_agreeing_before_first_divergence": agree,
           "tokens": sum(len(r.tokens) for r in run["ref"]),
           "max_abs_logit_diff_to_divergence": max_diff,
           "pages_in_use_after": {n: v["pages_in_use"] for n, v in s.items()},
           "launches": {"det_attention": run["d1"]}, **run["exact"]}
    emit({"phase": "fleet", "arm": "c_disagg_tp2_sink", **rec})
    # every token as the one-way unified engine's, and the echoed logits
    # within 1e-5 (the head-sharded sink sums its heads' halves in
    # another order; on an H100 it read 2.98e-6 and 256 of 256 tokens)
    if (failed or not first_equal or agree != rec["tokens"] or max_diff > 1e-5
            or rec["sink_tp"] != 2 or any(rec["pages_in_use_after"].values())):
        bad.append("c: two-shard sink")
    del one, two, run
    torch.cuda.empty_cache()

    # (d) sessions on the ring, over two unified hosts
    uni_b = DecodeEngine(adapter, max_slots=4, page_size=16, max_len=MAX_LEN,
                         device="cuda").load()
    served = {}

    def tap(name, eng):
        orig = eng.generate_async

        def recorded(prompt_ids=None, **kw):
            served.setdefault(tuple(prompt_ids), []).append(name)
            return orig(prompt_ids, **kw)
        eng.generate_async = recorded
    tap("u0", uni)
    tap("u1", uni_b)
    router = FleetRouter([FleetHost("u0", decode=uni), FleetHost("u1", decode=uni_b)])
    rng = np.random.default_rng(SEED + 320)
    try:
        sessions = [f"user-{k}" for k in range(8)]
        prompts = {}
        for rnd in range(2):
            futs = []
            for k, sess in enumerate(sessions):
                p = rng.integers(0, VOCAB, 16).tolist()
                prompts[(rnd, sess)] = p
                futs.append(router.generate_async(p, max_new_tokens=4, session=sess))
            for f in futs:
                f.result(timeout=600)
        homes = {}
        for (rnd, sess), p in prompts.items():
            homes.setdefault(sess, set()).update(served[tuple(p)])
        with router._lock:
            ring = {s: router._ring_lookup_locked(s, "decode", set()).host_id
                    for s in sessions}
        sticky = all(len(h) == 1 and ring[s] in h for s, h in homes.items())
        affinity = router.metrics_snapshot()["counters"]["affinity_routed"]
    finally:
        router.shutdown()
        del uni.generate_async, uni_b.generate_async
        uni_b.shutdown()
    # an HttpHost over a loopback UIServer, and a prefill host's /generate
    iris = load_model(os.path.join(REPO, IRIS_ZIP), device="cuda")
    ie = Engine(iris, max_batch=4, replicas=1, slo_ms=60_000, device="cuda").load()
    srv = UIServer(port=0, host="127.0.0.1").attach_engine(ie).start()
    srv_pre = UIServer(port=0, host="127.0.0.1").attach_decode_engine(pre).start()
    router = FleetRouter([FleetHost("remote", engine=HttpHost(f"127.0.0.1:{srv.port}",
                                                              timeout_s=60.0))],
                         start_watchdog=False)
    try:
        x, _ = iris_data(5)
        http_bitwise = np.array_equal(np.asarray(router.output(x), np.float32), ie.output(x))
        code, body = http_call(f"http://127.0.0.1:{srv_pre.port}/generate",
                               {"prompt_ids": [1, 2, 3], "max_tokens": 4})
    finally:
        router.shutdown()
        srv.stop()
        srv_pre.stop()
        ie.shutdown()
    rec = {"sessions": len(sessions), "requests": 2 * len(sessions),
           "sticky_on_ring_host": sticky,
           "hosts_used": sorted({h for hs in homes.values() for h in hs}),
           "affinity_routed": affinity, "http_host_bitwise": http_bitwise,
           "prefill_generate_status": code, "prefill_generate_error_class":
               body.get("error_class")}
    emit({"phase": "fleet", "arm": "d_sessions_http", **rec})
    if (not sticky or affinity != 2 * len(sessions) or not http_bitwise or code != 409
            or body.get("error_class") != "prefill_role"):
        bad.append("d: sessions and HTTP")

    # (e) a decode warm bundle naming the captured graph, the build cache
    import tempfile

    from deeplearning4j_tpu_torch.serving import warmcache
    from deeplearning4j_tpu_torch.utils import cuda_build
    tmp = tempfile.mkdtemp(prefix="fleet_phase_")
    try:
        cold = DecodeEngine(adapter, max_slots=4, page_size=16, max_len=MAX_LEN,
                            decode_horizon=2, device="cuda").load()
        prompt = [(7 * j) % VOCAB for j in range(MAX_LEN // 16)]
        want = cold.generate(prompt, max_new_tokens=8, echo_logits=True)
        n = cold.compile_cache_size()
        path = cold.save_warmup_bundle(os.path.join(tmp, "gpt2.warm"))
        keys = set(cold._prepared)
        cold.shutdown()
        t0 = time.perf_counter()
        warm = DecodeEngine(adapter, max_slots=4, page_size=16, max_len=MAX_LEN,
                            decode_horizon=2, device="cuda").load(warm_bundle=path)
        warm_load_s = time.perf_counter() - t0
        got = warm.generate(prompt, max_new_tokens=8, echo_logits=True)
        same = got.tokens == want.tokens and np.array_equal(got.logits, want.logits)
        rec_e = {"prepared": n, "bundle_hits": warm.metrics.counter_value("bundle_hits"),
                 "bundle_misses": warm.metrics.counter_value("bundle_misses"),
                 "same_programs": set(warm._prepared) == keys,
                 "graph_captured": warm.step_multi_graph is not None,
                 "warm_load_s": warm_load_s, "bitwise": same,
                 "compile_cache_size_flat": {
                     "unified": uni.compile_cache_size() == cache_sizes["unified"],
                     "prefill": pre.compile_cache_size() == cache_sizes["prefill"],
                     "decode": dec.compile_cache_size() == cache_sizes["decode"],
                     "warm": warm.compile_cache_size() == n}}
        warm.shutdown()
        for e in (uni, pre, dec):
            e.shutdown()
        old_dir, old_env = cuda_build.BUILD_DIR, os.environ.get(warmcache.ENV_VAR)
        try:
            cache = warmcache.enable_compile_cache(os.path.join(tmp, "kernels"))
            names = ["det_attention", "flash_fwd"]
            before = list(cuda_build.compiled)
            t0 = time.perf_counter()
            cuda_build.build(names)
            build_s = time.perf_counter() - t0
            built_here = cuda_build.compiled[len(before):]
            code = ("import json, time\n"
                    "from deeplearning4j_tpu_torch.utils import cuda_build as c\n"
                    f"t = time.perf_counter()\nfor n in {names!r}: c.load(n)\n"
                    "print(json.dumps({'dir': str(c.BUILD_DIR), 'compiled': c.compiled,"
                    " 'load_s': time.perf_counter() - t}))\n")
            p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                               text=True, timeout=300,
                               env=dict(os.environ, PYTHONPATH=REPO))
            child = json.loads(p.stdout.strip().splitlines()[-1]) if p.returncode == 0 else {}
        finally:
            cuda_build.BUILD_DIR = old_dir
            warmcache._enabled_dir = None
            if old_env is None:
                os.environ.pop(warmcache.ENV_VAR, None)
            else:
                os.environ[warmcache.ENV_VAR] = old_env
        rec_e["compile_cache"] = {"dir": cache, "nvcc_here": built_here, "build_s": build_s,
                                  "child": child, "child_rc": p.returncode,
                                  "child_stderr": p.stderr[-2000:] if p.returncode else ""}
        emit({"phase": "fleet", "arm": "e_bundle_cache", **rec_e})
        if (n != 1 or rec_e["bundle_misses"] or rec_e["bundle_hits"] != n
                or not rec_e["same_programs"]
                or not rec_e["graph_captured"] or not same
                or not all(rec_e["compile_cache_size_flat"].values())
                or built_here != names or p.returncode != 0
                or child.get("compiled") != [] or child.get("dir") != cache):
            bad.append("e: warm bundle and build cache")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return {**recs, "launches": {"det_attention": d1_total}}, bad


def fleet_kernels():
    """K1 at the fleet's predict shapes [1 | 2 | 4, 12, FLEET_T, 64] f32
    against its plain version, with the kernel phase's f32 tolerances
    (the fleet rows are held bitwise to the eager bucket, which runs K1
    too) → (records, failures)."""
    import torch
    recs = [flash_case(f"f32_fleet_b{b}", torch.float32, 0.0, B=b, T=FLEET_T)
            for b in (1, 2, 4)]
    bad = [r["case"] for r in recs
           if not (r["max_abs_err"] <= 2e-5 and r["rel_err"] <= 1e-5
                   and r["lse_max_abs_err"] <= 2e-5)]
    return recs, [f"K1 at the fleet's shapes: {bad}"] if bad else []


def phase_fleet(net):
    """The fleet phase: K1 at its predict shapes (``fleet_kernels``),
    ``fleet_predict`` (a, b) and ``fleet_decode`` (c, d, e).  Returns the
    launches of K1 and D1 it made on its path."""
    t0 = time.perf_counter()
    _, bad = fleet_kernels()
    pred, bad_a = fleet_predict(net)
    bad += bad_a
    dec, bad2 = fleet_decode(net)
    bad += bad2
    rec = {"phase": "fleet", "seconds": time.perf_counter() - t0, "failed": bad,
           "launches": {**pred["launches"], **dec["launches"]}}
    emit(rec)
    if bad:
        raise AssertionError(f"fleet phase failed: {bad}")
    return rec


# -- the flywheel phase: serving/lifecycle.py, the CLI's flywheel, the input
# -- pipeline (datasets/device_prefetch.py, normalizers, native loader)

#: what the reference's CLI prints for ``flywheel --generations 5 --chaos
#: nan,regression,host_kill,crash --hosts 2`` on the CPU: per generation
#: (outcome, version, rolled_back_to, parent_version), and the final stats
FW_ARGS = ["flywheel", "--generations", "5", "--chaos", "nan,regression,host_kill,crash",
           "--hosts", "2"]
FW_EXPECTED = [("PROMOTED", 1, None, None), ("ROLLED_BACK", 2, 1, None),
               ("PROMOTED", 3, None, 1), ("ROLLED_BACK", 4, 3, None),
               ("PROMOTED", 5, None, 3)]
FW_EXPECTED_STATS = {"promoted": 3, "rolled_back": 2, "resumes": 1, "alias": 5}
#: the reference's CLI on the CPU rejects gen 3's canary at this ceiling
#: (its prediction divergence 0.1644 > 0.1; 0.2 promotes it)
FW_MAX_DIVERGENCE = 0.1
FW_LENET_GENERATIONS = 3
PIPE_B, PIPE_ROWS, PIPE_SEED = 128, 768, 3
NATIVE_SEED = 7


def flywheel_cli_run(workdir: str) -> None:
    """``--flywheel-cli WORKDIR ARGS...``: the port's CLI ``main(ARGS)``
    with a ``GraphSpy`` watching its captures and every
    ``FleetRouter.output`` call counted; prints the CLI's lines, then one
    ``{"spy": ...}`` line."""
    import gc
    import io

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.serving import engine, fleet

    argv = sys.argv[sys.argv.index(workdir) + 1:]
    calls = {"calls": 0, "returned": 0, "raised": 0}
    lock = threading.Lock()
    real = fleet.FleetRouter.output
    decisions, gc_start, gc_pauses = [], [0.0], []
    real_canary = engine.Engine.run_canary

    def canary(self, *a, **kw):
        d = real_canary(self, *a, **kw)
        decisions.append({k: d.get(k) for k in ("candidate", "promote", "reasons",
                                                "canary_p99_ms", "incumbent_p99_ms",
                                                "mean_divergence")})
        return d
    engine.Engine.run_canary = canary

    def gc_timer(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"], (time.perf_counter() - gc_start[0]) * 1e3))
    gc.callbacks.append(gc_timer)

    def counted(self, *a, **kw):
        with lock:
            calls["calls"] += 1
        try:
            out = real(self, *a, **kw)
        except Exception:
            with lock:
                calls["raised"] += 1
            raise
        with lock:
            calls["returned"] += 1
        return out
    fleet.FleetRouter.output = counted
    buf = io.StringIO()
    t0 = time.perf_counter()
    with GraphSpy() as spy, contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--workdir", workdir])
    print(buf.getvalue(), end="", flush=True)
    emit({"spy": {"rc": rc, "seconds": time.perf_counter() - t0,
                  "captures": len(spy.captures), "served_captures": spy.served_captures(),
                  "capture_threads": sorted(set(spy.captures)), **calls,
                  "canary_decisions": decisions,
                  "gc_max_pause_ms": {g: max((ms for gg, ms in gc_pauses if gg == g), default=0.0)
                                      for g in (0, 1, 2)}}})


def flywheel_cli(tmp):
    """(a) the CLI's ``flywheel`` as users run it, twice at once: the
    reference's flags, then with ``--max-divergence FW_MAX_DIVERGENCE`` →
    (record, failures)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = {"chaos": FW_ARGS, "divergence": FW_ARGS + ["--max-divergence",
                                                       str(FW_MAX_DIVERGENCE)]}
    procs = {}
    for name, argv in runs.items():
        wd = os.path.join(tmp, f"fw_{name}")
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--flywheel-cli", wd, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)
    rec, bad = {}, []
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
        gens = [l for l in lines if "gen" in l]
        final = next((l for l in lines if "stats" in l), {})
        spy = next((l["spy"] for l in lines if "spy" in l), {})
        rec[name] = {"rc": p.returncode, "generations": [
            {k: g.get(k) for k in ("gen", "outcome", "version", "rolled_back_to",
                                   "parent_version", "eval_score")}
            | {"reason": (g.get("reason") or "")[:120]} for g in gens],
            "stats": final.get("stats"), "alias": final.get("alias"),
            "traffic_dropped": final.get("traffic_dropped"), "spy": spy,
            "seconds_per_generation": spy.get("seconds", float("nan")) / max(len(gens), 1)}
        if p.returncode:
            print(err[-3000:], file=sys.stderr, flush=True)
            bad.append(f"flywheel CLI ({name}) exited {p.returncode}")
        if spy.get("served_captures", 1) != 0:
            bad.append(f"flywheel CLI ({name}): a graph captured on a replica thread")
        if spy.get("calls") != spy.get("returned", 0) + spy.get("raised", 0) \
                or spy.get("raised") != final.get("traffic_dropped"):
            bad.append(f"flywheel CLI ({name}): a traffic future neither delivered "
                       f"nor counted ({spy} vs dropped {final.get('traffic_dropped')})")
    got = [(g["outcome"], g["version"], g["rolled_back_to"], g["parent_version"])
           for g in rec["chaos"]["generations"]]
    if got != FW_EXPECTED:
        bad.append(f"flywheel CLI: generations {got} != the reference's {FW_EXPECTED}")
    st = rec["chaos"]["stats"] or {}
    if {k: st.get(k) for k in ("promoted", "rolled_back", "resumes")} | \
            {"alias": rec["chaos"]["alias"]} != FW_EXPECTED_STATS:
        bad.append(f"flywheel CLI: stats {st} alias {rec['chaos']['alias']}")
    div = rec["divergence"]["generations"]
    g3 = div[2] if len(div) > 2 else {}
    rec["divergence"]["max_divergence"] = FW_MAX_DIVERGENCE
    if not (g3.get("outcome") == "ROLLED_BACK" and "canary rejected" in g3.get("reason", "")):
        bad.append(f"flywheel CLI: gen 3 not rejected at --max-divergence "
                   f"{FW_MAX_DIVERGENCE}: {g3}")
    return rec, bad


def clone_snapshot(snap):
    """Fresh clones of a ``snapshot`` of a layer stack or a graph."""
    import torch

    def c(tree):
        if isinstance(tree, dict):
            return {k: c(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(c(v) for v in tree)
        return tree.clone() if isinstance(tree, torch.Tensor) else tree
    return tuple(c(s) for s in snap)


def _lenet(seed=123):
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    return LeNet(LENET_HW, LENET_HW, 3, LENET_CLASSES, seed=seed,
                 updater=Nesterovs(lr=0.01, momentum=0.9), device="cuda")


def flywheel_pipeline(tmp):
    """(b) ``PromotionPipeline`` over LeNet at bench config 2 for
    ``FW_LENET_GENERATIONS`` generations, TRAIN through the prefetch ring,
    a fleet of two LeNet hosts under live traffic → (record, failures)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import (DataSet, DevicePrefetchIterator,
                                                    ImagePreProcessingScaler)
    from deeplearning4j_tpu_torch.datasets.fetchers import (Cifar10DataSetIterator,
                                                             load_cifar10)
    from deeplearning4j_tpu_torch.earlystopping import DataSetLossCalculator
    from deeplearning4j_tpu_torch.evaluation import EvaluationCalibration, ROCMultiClass
    from deeplearning4j_tpu_torch.parallel import ElasticTrainer
    from deeplearning4j_tpu_torch.serving import (Engine, EvalGate, FleetRouter,
                                                   ModelRegistry, PromotionPipeline)
    from deeplearning4j_tpu_torch.utils.serializer import load_model

    bad = []
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    scaler = ImagePreProcessingScaler()
    xs_eval, ys_eval = load_cifar10(train=False)
    eval_ds = scaler.pre_process(DataSet(xs_eval, np.eye(LENET_CLASSES,
                                                         dtype=np.float32)[ys_eval]))
    eval_batches = eval_ds.batch_by(LENET_B)
    base = _lenet()
    init = snapshot(base)

    def batches(gen):
        return Cifar10DataSetIterator(LENET_B, seed=SEED + gen)

    # the same generation synchronously: each batch to the card, the same
    # device transform, fit_batch
    sync_net = _lenet()
    restore(sync_net, clone_snapshot(init))
    to_dev = scaler.device_transform()
    sync_losses = [float(sync_net.fit_batch(to_dev(DataSet(
        torch.as_tensor(d.features).cuda(), torch.as_tensor(d.labels).cuda()))))
        for d in batches(1)]
    del sync_net

    reg = ModelRegistry(device="cuda")
    router = FleetRouter(max_retries=3)
    trained = {}

    def train_fn(gen):
        if gen == 1:
            net = _lenet()
            restore(net, clone_snapshot(init))
        else:
            net = load_model(reg.checkpoint_path("lenet", "prod"), device="cuda")
        it = DevicePrefetchIterator(batches(gen), depth=2, device="cuda",
                                    transform=ImagePreProcessingScaler())
        tr = ElasticTrainer(net, checkpoint_dir=os.path.join(tmp, f"lenet_g{gen}"),
                            checkpoint_every=4, run_id=f"lenet-g{gen}")
        t = time.perf_counter()
        tr.fit(it, epochs=1)
        trained[gen] = {"losses": [float(l) for _, l in tr.step_losses],
                        "seconds": time.perf_counter() - t, "stall": it.stall_stats()}
        it.close()
        return tr

    kw = dict(max_batch=4, replicas=1, slo_ms=600_000.0, device="cuda")
    pipe = PromotionPipeline(reg, router, "lenet", train_fn,
                             EvalGate(DataSetLossCalculator(eval_batches), threshold=5.0),
                             journal_path=os.path.join(tmp, "lenet.jsonl"),
                             canary_frac=1.0, canary_window=4, canary_timeout_s=120.0,
                             bundle_engine_kwargs=kw)
    xs, outs, futs, index, errors = [], [], [], {}, []
    taps, stop, traffic = [], threading.Event(), None
    rng = np.random.default_rng(SEED + 300)
    reports, gen_s = [], []
    with GraphSpy() as spy:
        try:
            for g in range(FW_LENET_GENERATIONS):
                t = time.perf_counter()
                reports.append(pipe.run_generation())
                gen_s.append(time.perf_counter() - t)
                if reports[-1]["outcome"] != "PROMOTED":
                    raise AssertionError(f"pipeline: generation {g + 1}: {reports[-1]}")
                if g == 0:
                    h0 = Engine.from_registry(reg, "lenet", "prod", **kw).load()
                    v, model = reg.resolve("lenet", "prod")
                    h1 = Engine(model, **kw)
                    h1.swap_model(model, tag=f"lenet:v{v}")
                    h1.load()
                    for name, eng in (("h0", h0), ("h1", h1)):
                        taps.append(HostTap(name, eng, index))
                        router.add_host(name, engine=eng)

                    def loop():
                        i = 0
                        while not stop.is_set():
                            x = rng.standard_normal((1 + i % 3, LENET_HW, LENET_HW, 3),
                                                    dtype=np.float32)
                            index[id(x)] = len(xs)
                            xs.append(x)
                            outs.append(None)
                            try:
                                outs[-1] = router.output(x, slo_ms=600_000.0)
                            except Exception as e:   # gated: none
                                errors.append(f"{type(e).__name__}: {e}")
                            i += 1
                            time.sleep(0.004)
                    traffic = threading.Thread(target=loop, daemon=True)
                    traffic.start()
        finally:
            stop.set()
            if traffic is not None:
                traffic.join(timeout=60)
        models = {f"lenet:v{v}": reg.resolve("lenet", v)[1] for v in reg.versions("lenet")}
        bitwise, checked, tags = fleet_bitwise(taps, xs, outs, models)
        snaps = {t.name: t.eng.metrics_snapshot()["counters"] for t in taps}
        served_captures = spy.served_captures()
    router.shutdown(shutdown_hosts=True)
    replay = PromotionPipeline(reg, None, "lenet", train_fn,
                               EvalGate(DataSetLossCalculator(eval_batches), threshold=5.0),
                               journal_path=os.path.join(tmp, "lenet.jsonl"))
    replay.resume()
    same_journal = replay.completed == pipe.completed
    v, prod = reg.resolve("lenet", "prod")
    roc = prod.evaluate(eval_batches, ROCMultiClass())
    cal = prod.evaluate(eval_batches, EvaluationCalibration())
    rec = {"generations": [{k: r.get(k) for k in ("gen", "outcome", "version",
                                                   "eval_score", "parent_version",
                                                   "rolled_back_to")} for r in reports],
           "seconds_per_generation": gen_s, "train": trained,
           "prefetch_vs_sync_bitwise": trained.get(1, {}).get("losses") == sync_losses,
           "sync_losses": sync_losses, "requests": len(xs), "errors": errors[:3],
           "bitwise_checked": checked, "tags_served": tags, "bitwise": bitwise,
           "unwarmed_serves": sum(s.get("unwarmed_serves", 0) for s in snaps.values()),
           "bundle_hits": sum(s.get("bundle_hits", 0) for s in snaps.values()),
           "bundle_misses": sum(s.get("bundle_misses", 0) for s in snaps.values()),
           "captures": len(spy.captures), "served_captures": served_captures,
           "journal_replays_same": same_journal, "prod_version": v,
           "roc_average_auc": roc.calculate_average_auc(),
           "roc_auc": [roc.calculate_auc(c) for c in range(LENET_CLASSES)],
           "calibration_ece": [cal.expected_calibration_error(c)
                               for c in range(LENET_CLASSES)]}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    if any(r["outcome"] != "PROMOTED" for r in reports):
        bad.append(f"pipeline: a generation was not promoted: {rec['generations']}")
    for k in ("prefetch_vs_sync_bitwise", "bitwise", "journal_replays_same"):
        if not rec[k]:
            bad.append(f"pipeline: {k}")
    if errors or not checked:
        bad.append(f"pipeline: {len(errors)} traffic errors, {checked} rows checked")
    if rec["unwarmed_serves"] or rec["bundle_misses"] or not rec["bundle_hits"] \
            or served_captures:
        bad.append(f"pipeline: unwarmed {rec['unwarmed_serves']}, bundle hits "
                   f"{rec['bundle_hits']} misses {rec['bundle_misses']}, captures on a "
                   f"replica thread {served_captures}")
    return rec, bad


def pixel_data(n=PIPE_ROWS, hw=CNN_HW, classes=CNN_CLASSES, seed=SEED + PIPE_SEED):
    """[n, hw, hw, 3] uint8 pixels and one-hot labels from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def h2d_overlap(fn) -> dict:
    """One traced call of ``fn``: the host-to-device copies (count, their
    streams, pinned or not), the kernels' streams, and the copy time that
    overlaps a kernel on another stream."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev if "HtoD" in e.name]
    kernels = [e for e in dev if "Memcpy" not in e.name and "Memset" not in e.name]
    k_streams = {e.device_resource_id for e in kernels}
    over = 0.0
    for c in copies:
        a, b = c.time_range.start, c.time_range.end
        spans = sorted((max(a, k.time_range.start), min(b, k.time_range.end))
                       for k in kernels if k.device_resource_id != c.device_resource_id
                       and k.time_range.end > a and k.time_range.start < b)
        over += busy_ms(spans) * 1e3
    return {"copies": len(copies), "copy_names": sorted({c.name for c in copies}),
            "copy_streams": sorted({c.device_resource_id for c in copies}),
            "kernel_streams": sorted(k_streams),
            "copy_ms": sum(c.time_range.end - c.time_range.start for c in copies) / 1e3,
            "copy_ms_overlapping_kernels": over / 1e3}


def pipeline_arms():
    """(c) ResNet-50 at bench config 3 on [128, 224, 224, 3] uint8 pixel
    batches, three arms from one start (synchronous scaled on the host,
    synchronous with the device transform, the prefetch ring with it), a
    ``fit_batches(2)`` capture with a producer alive, and (d) the native
    loader as the ring's base → (record, failures)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import (DataSet, DataSetIterator,
                                                    DevicePrefetchIterator,
                                                    ImagePreProcessingScaler,
                                                    ListDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.native_loader import (NativeDataSetIterator,
                                                                  load_native_lib, plain_order)

    bad = []
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    x, y = pixel_data()
    order = plain_order(PIPE_ROWS, NATIVE_SEED)
    host = [DataSet(x[order[i:i + PIPE_B]], y[order[i:i + PIPE_B]])
            for i in range(0, PIPE_ROWS, PIPE_B)]
    scaler = ImagePreProcessingScaler()
    to_dev = scaler.device_transform()
    net = resnet("cuda")
    net.fit_batch(DataSet(scaler.transform(host[0].features), host[0].labels))  # warm-up
    torch.cuda.synchronize()
    start = snapshot(net)

    def arm_host():
        for d in host:
            yield scaler.pre_process(d)

    def arm_device():
        for d in host:
            yield to_dev(DataSet(torch.as_tensor(d.features).cuda(),
                                 torch.as_tensor(d.labels).cuda()))

    def drain(it):
        """The ring's batches as they come (no ``reset``: the producer
        started at construction)."""
        while it.has_next():
            yield it.next()

    def run(source, it=None):
        """Six steps from ``start`` over ``source`` (or the ring ``it``)."""
        restore(net, clone_snapshot(start))
        losses, walls = [], []
        src = iter(source) if it is None else drain(it)
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ds = next(src, None)
            if ds is None:
                break
            losses.append(float(net.fit_batch(ds)))
            walls.append((time.perf_counter() - t0) * 1e3)
        out = {"losses": losses, "step_ms": walls, "median_ms": sorted(walls)[len(walls) // 2],
               "stall": it.stall_stats() if it is not None else None,
               "params": snapshot(net)}
        return out

    def ring(base):
        return DevicePrefetchIterator(base, depth=2, device="cuda",
                                      transform=ImagePreProcessingScaler())

    arms = {"host": run(arm_host()), "device": run(arm_device())}
    it = ring(ListDataSetIterator(host))
    arms["prefetch"] = run(None, it)
    it.close()
    inputs_equal = all(torch.equal(torch.from_numpy(scaler.transform(d.features)),
                                   to_dev(DataSet(torch.as_tensor(d.features).cuda(), None))
                                   .features.cpu()) for d in host)
    # (d) the native loader as the ring's base, the same rows in its order
    lib = load_native_lib()
    native = {"library_loaded": lib is not None}
    if lib is not None:
        feats = x.astype(np.float32)
        nat = NativeDataSetIterator(feats, y, PIPE_B, seed=NATIVE_SEED)
        got = []
        while nat.has_next():
            got.append(nat.next())
        native["batches_bitwise_plain_order"] = len(got) == len(host) and all(
            np.array_equal(g.features, feats[order[i * PIPE_B:(i + 1) * PIPE_B]])
            and np.array_equal(g.labels, y[order[i * PIPE_B:(i + 1) * PIPE_B]])
            for i, g in enumerate(got))
        nat2 = NativeDataSetIterator(feats, y, PIPE_B, seed=NATIVE_SEED)

        class FirstPass(DataSetIterator):
            """The native loader's first pass (its ``reset`` reshuffles)."""

            def __init__(self, loader):
                self.loader, self.batch_size = loader, PIPE_B

            def reset(self):
                pass

            def has_next(self):
                return self.loader.has_next()

            def next(self):
                return self.loader.next()
        it = ring(FirstPass(nat2))
        arms["native"] = run(None, it)
        it.close()
        nat.close()
        nat2.close()
        del feats
    # one traced step of each arm, and where the ring's copies ran
    prof = {}
    for name, make in (("host", lambda: next(arm_host())),
                       ("device", lambda: next(arm_device()))):
        prof[name] = device_profile(lambda m=make: net.fit_batch(m()))
    it = ring(ListDataSetIterator(host * 2))
    net.fit_batch(it.next())
    prof["prefetch"] = device_profile(lambda: net.fit_batch(it.next()))
    overlap = h2d_overlap(lambda: [net.fit_batch(it.next()) for _ in range(6)])
    it.close()
    # a fit_batches(2) capture with a producer alive, at batch 32
    small = [DataSet(d.features[:32], d.labels[:32]) for d in host]
    restore(net, clone_snapshot(start))
    it = ring(ListDataSetIterator(small))
    capture = {}

    def cap():
        t = time.perf_counter()
        ls = net.fit_batches([it.next(), it.next()])
        capture["losses"] = [float(v) for v in ls]
        ls = net.fit_batches([it.next(), it.next()])
        capture["replay_losses"] = [float(v) for v in ls]
        capture["seconds"] = time.perf_counter() - t
    th = threading.Thread(target=cap, daemon=True)
    th.start()
    th.join(timeout=300)
    if th.is_alive():
        print("chip_smoke: fit_batches capture with a live producer hung", file=sys.stderr,
              flush=True)
        os._exit(3)
    capture["graphs"] = net.fit_graph_count
    capture["stall"] = it.stall_stats()
    it.close()
    torch.backends.cudnn.deterministic = False
    rec = {"batch": [PIPE_B, CNN_HW, CNN_HW, 3], "dtype": "uint8", "batches": len(host),
           "arms": {k: {kk: vv for kk, vv in a.items() if kk != "params"}
                    for k, a in arms.items()},
           "idle_share": {k: p["idle_share"] for k, p in prof.items()},
           "traced_wall_ms": {k: p["wall_ms"] for k, p in prof.items()},
           "ring_copies": overlap, "inputs_bitwise": inputs_equal, "native": native,
           "capture": capture}
    a_h, a_d, a_p = arms["host"], arms["device"], arms["prefetch"]
    rec["device_vs_host_rel"] = max(abs(p - q) / abs(q) for p, q in zip(a_d["losses"],
                                                                          a_h["losses"]))
    rec["prefetch_bitwise_device"] = (a_p["losses"] == a_d["losses"]
                                      and same_trees(a_p["params"][0], a_d["params"][0]))
    if not rec["prefetch_bitwise_device"]:
        bad.append("input pipeline: the prefetch arm is not bitwise the device arm")
    if not inputs_equal or rec["device_vs_host_rel"] > 1e-6:
        bad.append(f"input pipeline: device transform vs host: inputs bitwise "
                   f"{inputs_equal}, losses {rec['device_vs_host_rel']:.3g} relative")
    if not all(math.isfinite(v) for a in arms.values() for v in a["losses"]):
        bad.append("input pipeline: a non-finite loss")
    if not native["library_loaded"]:
        bad.append("native loader: the library did not load")
    elif not (native["batches_bitwise_plain_order"] and arms["native"]["losses"]
              == a_d["losses"] and same_trees(arms["native"]["params"][0],
                                               a_d["params"][0])):
        bad.append("native loader: batches or training not bitwise the plain order's")
    if not (len(capture.get("losses", [])) == 2 and capture["graphs"] == 1
            and all(math.isfinite(v) for v in capture["losses"] + capture["replay_losses"])):
        bad.append(f"input pipeline: fit_batches capture with a live producer: {capture}")
    return rec, bad


def flywheel_train_cli(tmp):
    """(e) ``train --zoo lenet --data cifar10 --prefetch 2`` in a process of
    its own → (record, failures)."""
    kw = json.dumps(dict(height=LENET_HW, width=LENET_HW, channels=3,
                         num_classes=LENET_CLASSES))
    t = time.perf_counter()
    rc, out = run_cli(["train", "--zoo", "lenet", "--zoo-args", kw, "--data", "cifar10",
                       "--batch-size", str(LENET_B), "--prefetch", "2"], tmp)
    stall = [l for l in out.splitlines() if "stall fraction" in l]
    rec = {"rc": rc, "seconds": time.perf_counter() - t, "stall_line": stall[-1:],
           "prefetch_line": [l for l in out.splitlines() if l.startswith("prefetch: depth")]}
    return rec, ([] if rc == 0 and stall else [f"train --prefetch 2: rc {rc}, stall {stall}"])


def phase_flywheel():
    """The flywheel phase, (a)-(e) (the module docstring)."""
    import gc
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.nn.train_graph import TRAIN_COUNTERS

    t0 = time.perf_counter()
    before = {n: c.launches for n, c in TRAIN_COUNTERS.items()}
    tmp = tempfile.mkdtemp(prefix="chip_flywheel_")
    bad, out = [], {}
    try:
        for name, arm in (("cli", lambda: flywheel_cli(tmp)),
                          ("pipeline", lambda: flywheel_pipeline(tmp)),
                          ("input_pipeline", pipeline_arms),
                          ("train_cli", lambda: flywheel_train_cli(tmp))):
            t = time.perf_counter()
            out[name], b = arm()
            out[name]["seconds"] = time.perf_counter() - t
            bad += b
            emit({"phase": "flywheel", "arm": name, **out[name]})
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: c.launches - before[n] for n, c in TRAIN_COUNTERS.items()}
    rec = {"phase": "flywheel", "seconds": time.perf_counter() - t0, "failed": bad,
           "launches": launches}
    emit(rec)
    if bad:
        raise AssertionError(f"flywheel phase failed: {bad}")
    return rec


# -- learning phase -------------------------------------------------------------

#: bench config 4's Word2Vec (``bench.py:560-568``): 48,000 sentences of 20
#: words over a 2,000-word vocabulary from numpy seed 0
W2V_SENTENCES, W2V_WORDS, W2V_VOCAB = 48_000, 20, 2000
W2V_KW = dict(layer_size=128, window=5, min_word_frequency=1, epochs=1, batch_size=4096,
              subsampling=0)
W2V_CUT = 2000          # (a)'s card-against-CPU and stacking gates
DIST_CUT = 8000         # (c)'s sentences
WIDE_SENTENCES, WIDE_IDS, WIDE_ZIPF = 100_000, 100_000, 1.1
WIDE_TRACE_START, WIDE_TRACE_CALLS = 25, 2   # (a2)'s traced dispatches: batches 400-431
TOPIC_DOCS = 20_000
PV_REF_DOCS = 120         # tests/test_nlp_vectors.py's ParagraphVectors recipe
PV_DBOW_DOCS = 1000      # 20 epochs of DBOW micro-chunks: ~9 ms a document on the card
#: the reference package's PV fits with that recipe on the CPU
#: (scripts/torch_pv_recipe_scale.py): (mode, documents) -> (within, across)
PV_REFERENCE = {("dbow", 1000): (0.991126340396456, -0.930465441991098)}
ANIMALS = ["cat", "dog", "pet", "fur", "paw", "tail", "meow", "bark"]
TECH = ["cpu", "ram", "disk", "code", "byte", "chip", "core", "cache"]
DW_COMMUNITIES, DW_SIZE = 10, 500
KNN_POINTS, KNN_DIM, KNN_QUERIES, KNN_K, KNN_ORACLE = 1_000_000, 128, 8192, 10, 256
KM_POINTS, KM_K = 200_000, 256
TSNE_EXACT, TSNE_CHUNKED = 5000, 200_000
PUBSUB_BATCHES = 200


def bench4_corpus(n: int = W2V_SENTENCES) -> list:
    """The bench's corpus, sentence for sentence (the same draws as its
    ``rng.choice(vocab, size=20)``; the first n of them)."""
    import numpy as np

    rng = np.random.default_rng(0)
    vocab = np.asarray([f"w{i}" for i in range(W2V_VOCAB)])
    return [" ".join(vocab[rng.choice(W2V_VOCAB, size=W2V_WORDS)]) for _ in range(n)]


def all_launch_counters() -> dict:
    """Every hand kernel's launch counter (K1-K6 and D1)."""
    from deeplearning4j_tpu_torch.nn.train_graph import TRAIN_COUNTERS
    from deeplearning4j_tpu_torch.ops import compression as comp
    from deeplearning4j_tpu_torch.ops import kv_cache as kv

    return {**TRAIN_COUNTERS, "det_attention": kv.det_attention_cuda,
            "threshold_encode": comp.threshold_encode_cuda,
            "threshold_encode_buckets": comp.threshold_encode_buckets_cuda}


class BatchWindow:
    """A torch.profiler trace of calls [start, start + n) of a fit: the
    attribute ``name`` of ``mod`` (a module's step function, or a class's
    method) is wrapped so the trace starts before call ``start`` and stops
    after call ``start + n - 1``, with a synchronize at each end;
    ``result()`` gives the window's wall ms, the device's busy ms and its
    busy share."""

    def __init__(self, mod, name: str, start: int, n: int):
        self.mod, self.name, self.real = mod, name, getattr(mod, name)
        self.start, self.n, self.calls = start, n, 0
        self.prof = self.t0 = self.t1 = None

    def __enter__(self):
        def call(*a):                # a plain function: a method binds it
            return self._call(*a)
        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)
        if self.prof is not None and self.t1 is None:
            self.prof.stop()

    def _call(self, *a):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.calls == self.start:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        out = self.real(*a)
        self.calls += 1
        if self.calls == self.start + self.n:
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.stop()
        return out

    def result(self) -> dict:
        import torch

        if self.t1 is None:
            raise AssertionError(f"the fit ran {self.calls} batches, fewer than the window")
        spans = [(e.time_range.start, e.time_range.end) for e in self.prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        wall = (self.t1 - self.t0) * 1e3
        busy = busy_ms(spans)
        return {"calls": self.n, "wall_ms": wall, "busy_ms": busy,
                "device_share": busy / wall, "kernels": len(spans)}


def learning_w2v_bench():
    """(a) bench config 4's Word2Vec at full width on the card."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp._native_windows import load_window_lib

    bad = []
    native = load_window_lib() is not None
    sentences = bench4_corpus()
    n_words = sum(len(s.split()) for s in sentences)
    warm = Word2Vec(device="cuda", **W2V_KW)
    warm.fit(sentences)
    warm.word_vector("w0")
    fits = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = Word2Vec(device="cuda", **W2V_KW)
        m.fit(sentences)
        m.word_vector("w0")                    # the bench's end-to-end window
        fits.append(time.perf_counter() - t0)
    finite = bool(np.isfinite(m.syn0).all() and np.isfinite(m.syn1).all())
    cut = sentences[:W2V_CUT]
    card = Word2Vec(device="cuda", **W2V_KW).fit(cut)
    cpu = Word2Vec(device="cpu", **W2V_KW).fit(cut)
    one = Word2Vec(device="cuda", **W2V_KW)
    one._device_batches = 1
    one.fit(cut)
    again = Word2Vec(device="cuda", **W2V_KW).fit(cut)
    eager = Word2Vec(device="cuda", **W2V_KW)
    eager._graphs = False
    eager.fit(cut)
    gap = float(np.max(np.abs(card.syn0 - cpu.syn0)))
    close = bool(np.allclose(card.syn0, cpu.syn0, rtol=1e-4, atol=1e-5))
    stacked = bool(np.array_equal(card.syn0, one.syn0) and np.array_equal(card.syn1, one.syn1))
    repeat = bool(np.array_equal(card.syn0, again.syn0) and np.array_equal(card.syn1, again.syn1))
    replays = bool(np.array_equal(card.syn0, eager.syn0) and np.array_equal(card.syn1, eager.syn1))
    rec = {"sentences": len(sentences), "words": n_words, "vocab": len(m.vocab),
           "fit_s": fits, "words_per_s": n_words / min(fits), "native_windows": native,
           "finite": finite, "cut_sentences": W2V_CUT, "card_vs_cpu_max_abs": gap,
           "card_vs_cpu_within_1e-4_1e-5": close,
           "card_vs_cpu_bitwise": bool(np.array_equal(card.syn0, cpu.syn0)),
           "stacked_16_bitwise_1": stacked, "repeat_bitwise": repeat,
           "graph_replays_bitwise_eager": replays}
    for name, ok in (("native windows library", native), ("finite tables", finite),
                     ("card vs CPU", close), ("16 stacked vs 1", stacked),
                     ("repeat", repeat), ("graph replays vs eager", replays)):
        if not ok:
            bad.append(f"w2v_bench: {name}")
    return rec, bad


def learning_w2v_wide():
    """(a2) Word2Vec at the published 300-wide embedding, Zipf ids."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp import sequencevectors as sv

    rng = np.random.default_rng(SEED + 90)
    p = 1.0 / np.arange(1, WIDE_IDS + 1) ** WIDE_ZIPF
    seqs = rng.choice(WIDE_IDS, size=(WIDE_SENTENCES, W2V_WORDS), p=p / p.sum()).tolist()
    m = Word2Vec(device="cuda", **dict(W2V_KW, layer_size=300))
    with BatchWindow(sv._Replays, "__call__", WIDE_TRACE_START, WIDE_TRACE_CALLS) as win:
        t0 = time.perf_counter()
        m.fit_sequences(seqs)
        m.word_vector(0)
        fit_s = time.perf_counter() - t0
    window = {**win.result(), "batches": WIDE_TRACE_CALLS * m._device_batches}
    table_mb = 2 * len(m.vocab) * 300 * 4 / 1e6
    finite = bool(np.isfinite(m.syn0).all())
    rec = {"sentences": WIDE_SENTENCES, "words": WIDE_SENTENCES * W2V_WORDS,
           "vocab": len(m.vocab), "layer_size": 300, "tables_mb": table_mb, "fit_s": fit_s,
           "words_per_s": WIDE_SENTENCES * W2V_WORDS / fit_s, "traced_window": window,
           "finite": finite}
    return rec, ([] if finite else ["w2v_wide: tables not finite"])


def topic_sentences(n, seed=0, words=8):
    """The reference tests' two-topic corpus (``tests/test_nlp.py``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    topics = [ANIMALS, TECH]
    return [" ".join(rng.choice(topics[int(rng.integers(0, 2))], size=words))
            for _ in range(n)]


def topic_docs(n, seed=0, words=20):
    """The reference tests' topic documents (``tests/test_nlp_vectors.py``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    docs, topics = [], []
    for _ in range(n):
        t = int(rng.integers(0, 2))
        docs.append(" ".join(rng.choice(ANIMALS if t == 0 else TECH, size=words)))
        topics.append(t)
    return docs, np.asarray(topics)


def within_across(vecs, groups):
    """Mean cosine similarity of distinct same-group pairs and of
    cross-group pairs, from per-group sums of the unit vectors."""
    import numpy as np

    u = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)
    ids = np.unique(groups)
    sums = np.stack([u[groups == g].sum(0) for g in ids]).astype(np.float64)
    counts = np.asarray([(groups == g).sum() for g in ids], np.float64)
    within = (np.sum(sums * sums) - counts.sum()) / np.sum(counts * (counts - 1))
    tot = sums.sum(0)
    across = (tot @ tot - np.sum(sums * sums)) / (counts.sum() ** 2 - np.sum(counts ** 2))
    return float(within), float(across)


def pv_fit(dm: bool, n_docs: int):
    """ParagraphVectors on ``n_docs`` topic documents with the reference
    test's recipe (20 epochs): the documents' within/across-topic cosines,
    held to the test's gate (within > across + 0.15), and to the
    reference package's reading where ``PV_REFERENCE`` has one (within
    1e-3 each); then ``infer`` on 100 unseen documents and their share of
    their own topic among their 10 nearest trained documents (at least
    0.8)."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp import ParagraphVectors

    mode = "dm" if dm else "dbow"
    name = f"pv_{mode}_{n_docs}"
    docs, topics = topic_docs(n_docs)
    t0 = time.perf_counter()
    pv = ParagraphVectors(dm=dm, layer_size=24, window=3, epochs=20, batch_size=128,
                          seed=1, learning_rate=0.05, device="cuda")
    pv.fit(docs)
    fit_s = time.perf_counter() - t0
    vecs = np.stack([pv.doc_vector(f"DOC_{i}") for i in range(len(docs))])
    within, across = within_across(vecs, topics)
    finite = bool(np.isfinite(vecs).all())
    rec = {"documents": n_docs, "epochs": 20, "seconds": fit_s, "within": within,
           "across": across, "finite": finite}
    bad = [] if finite else [f"{name}: not finite"]
    if not within > across + 0.15:
        bad.append(f"{name}: within {within:.3f} across {across:.3f}")
    ref = PV_REFERENCE.get((mode, n_docs))
    if ref is not None:
        rec["reference"] = ref
        if not (abs(within - ref[0]) <= 1e-3 and abs(across - ref[1]) <= 1e-3):
            bad.append(f"{name}: within {within} across {across}, the reference's {ref}")
    unseen, unseen_topics = topic_docs(100, seed=1)
    t1 = time.perf_counter()
    inferred = np.stack([pv.infer(d) for d in unseen])
    rec["infer_ms_per_doc"] = (time.perf_counter() - t1) * 1e3 / len(unseen)
    u = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)
    q = inferred / np.maximum(np.linalg.norm(inferred, axis=1, keepdims=True), 1e-9)
    near = np.argsort(-(q @ u.T), axis=1)[:, :10]
    hits = rec["infer_top10_same_topic"] = float(np.mean(topics[near]
                                                         == unseen_topics[:, None]))
    if not (np.isfinite(inferred).all() and hits >= 0.8):
        bad.append(f"{name}: inferred docs' top-10 same-topic share {hits:.3f}")
    return name, rec, bad


def learning_modes():
    """(b) CBOW, SG-HS, ParagraphVectors DM and DBOW with inference, and
    GloVe on (a)'s corpus."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.nlp import Glove, Word2Vec
    from deeplearning4j_tpu_torch.nlp import glove as gl

    bad, out = [], {}
    sents = topic_sentences(TOPIC_DOCS)
    for mode in ("cbow", "sg_hs"):
        t0 = time.perf_counter()
        w = Word2Vec(layer_size=32, window=3, min_word_frequency=2, negative=5, epochs=1,
                     batch_size=128, seed=1, learning_rate=0.05, subsampling=0,
                     cbow=mode == "cbow", hierarchic_softmax=mode == "sg_hs", device="cuda")
        w.fit(sents)
        within, across = w.similarity("cat", "dog"), w.similarity("cat", "cpu")
        out[mode] = {"sentences": TOPIC_DOCS, "seconds": time.perf_counter() - t0,
                     "within": within, "across": across}
        if not within > across + 0.2:
            bad.append(f"{mode}: within {within:.3f} across {across:.3f}")
    # in both packages the recipe separates DM's topics at the test's 120
    # documents only, DBOW's at 120-5,000, neither at 20,000
    # (scripts/torch_pv_recipe_scale.py holds the 20,000-document fits)
    for dm, n_docs in ((True, PV_REF_DOCS), (False, PV_REF_DOCS), (False, PV_DBOW_DOCS)):
        name, out[name], b = pv_fit(dm, n_docs)
        bad += b
    calls, first = [], []
    real = gl._glove_step

    def counted(*a):
        if not first:
            first.append(time.perf_counter())
        calls.append(1)
        return real(*a)
    gl._glove_step = counted
    try:
        t0 = time.perf_counter()
        g = Glove(layer_size=128, epochs=2, batch_size=4096, device="cuda")
        g.fit(bench4_corpus())                 # the epoch losses are read: synced
        t_end = time.perf_counter()
    finally:
        gl._glove_step = real
    falls = all(b < a for a, b in zip(g.losses, g.losses[1:]))
    out["glove"] = {"seconds": t_end - t0, "count_and_setup_s": first[0] - t0,
                    "batches": len(calls), "ms_per_batch": (t_end - first[0]) * 1e3 / len(calls),
                    "epoch_losses": g.losses, "loss_falls_every_epoch": falls,
                    "finite": bool(np.isfinite(g.syn0).all())}
    if not (falls and np.isfinite(g.syn0).all()):
        bad.append(f"glove: losses {g.losses}")
    torch.cuda.empty_cache()
    return out, bad


def learning_rank(rank: int, work: str) -> None:
    """One rank of (c) (``--learning-rank R DIR``): DistributedWord2Vec over
    a two-rank ``data`` mesh on cuda:0 (gloo); writes DIR/rankR.json and
    DIR/rankR.npy (syn0)."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from deeplearning4j_tpu_torch.nlp import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel import build_mesh, initialize, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(init_method="file://" + os.path.join(work, "rendezvous"), num_processes=2,
               process_id=rank, backend="gloo", timeout_s=600)
    corpus = bench4_corpus(DIST_CUT)
    t0 = time.perf_counter()
    m = DistributedWord2Vec(mesh=build_mesh({"data": 2}), device="cuda", **W2V_KW)
    m.fit(corpus)
    syn0 = m.syn0
    seconds = time.perf_counter() - t0
    shutdown()
    np.save(os.path.join(work, f"rank{rank}.npy"), syn0)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "seconds": seconds,
                   "gathered_bytes_per_batch": m._dp_step.last_gathered_bytes}, f)


def learning_distributed():
    """(c) DistributedWord2Vec on two gloo ranks against one-rank Word2Vec."""
    import shutil
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch.nlp import Word2Vec

    work = tempfile.mkdtemp(prefix="chip_dw2v_")
    try:
        ranks = run_ranks("--learning-rank", 2, work, limit_s=300)
        syn0 = [np.load(os.path.join(work, f"rank{r}.npy")) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    one = Word2Vec(device="cuda", **W2V_KW).fit(bench4_corpus(DIST_CUT))
    one_s = time.perf_counter() - t0
    same = bool(np.array_equal(syn0[0], syn0[1]))
    close = bool(np.allclose(syn0[0], one.syn0, rtol=1e-4, atol=1e-5))
    rec = {"sentences": DIST_CUT, "ranks": 2, "seconds_per_rank": [r["seconds"] for r in ranks],
           "one_rank_s": one_s,
           "gathered_bytes_per_batch": ranks[0]["gathered_bytes_per_batch"],
           "ranks_bitwise_equal": same,
           "max_abs_vs_one_rank": float(np.max(np.abs(syn0[0] - one.syn0))),
           "within_1e-4_1e-5_of_one_rank": close}
    bad = [] if same and close else [f"distributed: ranks equal {same}, close {close}"]
    return rec, bad


def planted_graph(seed=SEED + 91):
    """10 communities of 500 vertices: 8 random edges a vertex inside its
    community, and one edge to another community for every fifth vertex."""
    import numpy as np

    from deeplearning4j_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    n = DW_COMMUNITIES * DW_SIZE
    comm = np.arange(n) // DW_SIZE
    a = np.repeat(np.arange(n), 8)
    b = comm[a] * DW_SIZE + rng.integers(0, DW_SIZE, len(a))
    keep = a != b
    cross = np.arange(0, n, 5)
    other = (comm[cross] + rng.integers(1, DW_COMMUNITIES, len(cross))) % DW_COMMUNITIES
    g = Graph(n)
    g.add_edges(zip(a[keep].tolist(), b[keep].tolist()))
    g.add_edges(zip(cross.tolist(), (other * DW_SIZE + rng.integers(0, DW_SIZE, len(cross))
                                     ).tolist()))
    return g, comm


def learning_deepwalk():
    """(d) DeepWalk on the planted graph, hierarchical softmax and negative
    sampling."""
    import numpy as np

    from deeplearning4j_tpu_torch.graph import DeepWalk, RandomWalkIterator

    g, comm = planted_graph()
    t0 = time.perf_counter()
    walks = list(RandomWalkIterator(g, 40, 10, seed=12345))
    walk_s = time.perf_counter() - t0
    out, bad = {"vertices": g.n, "walks": len(walks), "walk_s": walk_s}, []
    for hs in (True, False):
        name = "hs" if hs else "neg"
        t0 = time.perf_counter()
        dw = DeepWalk(walk_length=40, walks_per_vertex=10, hierarchic_softmax=hs,
                      learning_rate=0.05, device="cuda").fit(g, walks=walks)
        fit_s = time.perf_counter() - t0
        vecs = np.stack([dw.vertex_vector(v) for v in range(g.n)])
        within, across = within_across(vecs, comm)
        out[name] = {"seconds": fit_s, "within": within, "across": across}
        if not within > across + 0.2:
            bad.append(f"deepwalk {name}: within {within:.3f} across {across:.3f}")
    return out, bad


def learning_knn():
    """(e) NearestNeighbors over 1M x 128 points and its REST server."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.clustering import (NearestNeighbors, NearestNeighborsClient,
                                                     NearestNeighborsServer)

    rng = np.random.default_rng(SEED + 92)
    pts = rng.standard_normal((KNN_POINTS, KNN_DIM), dtype=np.float32)
    queries = rng.standard_normal((KNN_QUERIES, KNN_DIM), dtype=np.float32)
    out, bad = {"points": KNN_POINTS, "dim": KNN_DIM, "queries": KNN_QUERIES, "k": KNN_K}, []
    p64 = torch.from_numpy(pts).cuda().double()
    for metric in ("euclidean", "cosine"):
        nn = NearestNeighbors(pts, metric=metric, device="cuda")
        q = torch.from_numpy(queries).cuda()
        nn.knn_device(q[:64], KNN_K)                 # warm-up
        blocks = []
        for s in range(0, KNN_QUERIES, nn.query_block):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, i = nn.knn_device(q[s:s + nn.query_block], KNN_K)
            torch.cuda.synchronize()
            blocks.append((time.perf_counter() - t0) * 1e3)
            if s == 0:
                first_i = i[:KNN_ORACLE]
        q64 = q[:KNN_ORACLE].double()
        if metric == "euclidean":
            d64 = (q64 * q64).sum(1, keepdim=True) + (p64 * p64).sum(1)[None] - 2 * q64 @ p64.T
        else:
            qn = q64 / q64.norm(dim=1, keepdim=True)
            pn = p64 / p64.norm(dim=1, keepdim=True)
            d64 = 1 - qn @ pn.T
        want = torch.topk(d64, KNN_K, dim=1, largest=False).values
        got = torch.gather(d64, 1, first_i)
        scale = torch.clamp(want.abs(), min=1e-30)
        tied_ok = bool(((got - want).abs() <= 1e-6 * scale).all())
        oracle_i = torch.topk(d64, KNN_K, dim=1, largest=False).indices
        differ = int((oracle_i != first_i).sum())
        del d64
        flops = 2 * nn.query_block * KNN_POINTS * KNN_DIM
        out[metric] = {"ms_per_block": blocks, "query_block": nn.query_block,
                       "bound_ms_per_block": max(flops / PEAK_FLOPS["float32"],
                                                 KNN_POINTS * KNN_DIM * 4 / PEAK_BYTES) * 1e3,
                       "oracle_rows": KNN_ORACLE, "oracle_agrees": tied_ok,
                       "index_differences_at_ties": differ}
        if not tied_ok:
            bad.append(f"knn {metric}: indices off the float64 oracle beyond ties")
        del nn
        torch.cuda.empty_cache()
    del p64
    srv = NearestNeighborsServer(pts, device="cuda").start()
    try:
        client = NearestNeighborsClient(srv.url)
        lat, mismatch = [], 0
        for r in range(64):
            t0 = time.perf_counter()
            if r % 2:
                got = client.knn_new(queries[r], KNN_K)
                d, i = srv.index.knn(queries[r], KNN_K)
            else:
                pid = (r * 15_485_863) % KNN_POINTS
                got = client.knn(pid, KNN_K)
                d, i = srv.index.knn(srv.index.points[pid][None, :], KNN_K + 1)
                keep = i[0] != pid
                d, i = d[0][keep][:KNN_K], i[0][keep][:KNN_K]
            lat.append((time.perf_counter() - t0) * 1e3)
            if [x["index"] for x in got] != [int(v) for v in i] or \
                    [x["distance"] for x in got] != [float(v) for v in d]:
                mismatch += 1
    finally:
        srv.stop()
    lat.sort()
    out["server"] = {"requests": 64, "p50_ms": lat[31], "p99_ms": lat[63],
                     "answers_not_the_direct_knn": mismatch}
    if mismatch:
        bad.append(f"knn server: {mismatch} answers differ from direct knn")
    torch.cuda.empty_cache()
    return out, bad


def learning_kmeans():
    """(f) KMeansClustering, k = 256 on 200,000 x 128 points; the fit's
    first Lloyd step held against the same step on the CPU."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering import kmeans as km_mod

    rng = np.random.default_rng(SEED + 93)
    centers = rng.normal(0, 3, (KM_K, 128))
    x = (centers[rng.integers(0, KM_K, KM_POINTS)]
         + rng.standard_normal((KM_POINTS, 128))).astype(np.float32)
    real, steps, inertias, first = km_mod._lloyd_step, [], [], []

    def timed_step(xs, c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(xs, c)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        inertias.append(float(res[2]))
        if not first:
            first.append((c, res))
        return res
    km_mod._lloyd_step = timed_step
    try:
        t0 = time.perf_counter()
        km = KMeansClustering(KM_K, device="cuda")
        assign = km.apply_to(x)
        fit_s = time.perf_counter() - t0
    finally:
        km_mod._lloyd_step = real
    same = bool(np.array_equal(km.predict(x), assign))
    never_rises = all(b <= a * (1 + 1e-6) for a, b in zip(inertias, inertias[1:]))
    step = lloyd_step_against_cpu(x, *first[0])
    rec = {"points": KM_POINTS, "k": KM_K, "iterations": km.n_iter_, "fit_s": fit_s,
           "lloyd_ms": steps, "median_lloyd_ms": sorted(steps)[len(steps) // 2],
           "seeding_and_host_s": fit_s - sum(steps) / 1e3, "inertia_first": inertias[0],
           "inertia_last": km.inertia_, "predict_equals_assignment": same,
           "inertia_never_rises": never_rises, "first_step_vs_cpu": step}
    bad = [] if same and never_rises else [f"kmeans: predict {same}, monotone {never_rises}"]
    if not step["ok"]:
        bad.append(f"kmeans: first Lloyd step against the CPU {step}")
    return rec, bad


def lloyd_step_against_cpu(x, c, card):
    """The card's Lloyd step ``card`` = (centroids, assignment, inertia)
    from centroids ``c`` against ``_lloyd_step`` on the CPU from the same
    inputs: assignments equal but where a point's two centroids lie within
    1e-5 relative on the CPU's distances; the centroids of clusters whose
    members agree within 1e-5 x (1 + |c|); the inertia within 1e-5
    relative."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.clustering import kmeans as km_mod
    from deeplearning4j_tpu_torch.clustering.knn import _dist_block

    xc, cc = torch.from_numpy(x), c.cpu()
    new_c, a, inertia = (t.cpu().numpy() for t in km_mod._lloyd_step(xc, cc))
    got_c, got_a, got_in = (t.cpu().numpy() for t in card)
    moved = np.flatnonzero(got_a != a)
    d = _dist_block(xc[moved], cc, "euclidean").numpy() if len(moved) else np.zeros((0, 1))
    r = np.arange(len(moved))
    ties = bool(np.all(np.abs(d[r, got_a[moved]] - d[r, a[moved]])
                       <= 1e-5 * d[r, a[moved]]))
    touched = np.zeros(len(new_c), bool)
    touched[got_a[moved]] = touched[a[moved]] = True
    gap = np.abs(got_c - new_c)[~touched]
    c_ok = bool(np.all(gap <= 1e-5 * (1 + np.abs(new_c[~touched]))))
    in_rel = float(abs(got_in - inertia) / inertia)
    return {"assignments_differ": int(len(moved)), "differ_only_at_ties": ties,
            "centroid_max_abs": float(gap.max()), "centroids_within_1e-5": c_ok,
            "inertia_rel": in_rel, "ok": ties and c_ok and in_rel <= 1e-5}


def tsne_blobs(n, centers, d, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    c = rng.normal(0, 4.0, (centers, d))
    return (c[rng.integers(0, centers, n)] + rng.normal(0, 0.5, (n, d))).astype(np.float32)


def learning_tsne():
    """(g) exact t-SNE at 5,000 points, chunked at 200,000."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.plot import tsne as ts

    out, bad = {}, []
    real_step, kls = ts._tsne_step, []

    def step(*a):
        res = real_step(*a)
        kls.append(res[3])
        return res
    ts._tsne_step = step
    try:
        t0 = time.perf_counter()
        t = Tsne(method="exact", max_iter=300, device="cuda")
        y = t.fit_transform(tsne_blobs(TSNE_EXACT, 10, 50, SEED + 94))
        fit_s = time.perf_counter() - t0
    finally:
        ts._tsne_step = real_step
    kl = torch.stack(kls).cpu().numpy()
    first_true = kl[t.stop_lying_iteration]
    ok = bool(np.isfinite(kl).all() and np.isfinite(y).all() and kl[-1] < first_true)
    out["exact"] = {"points": TSNE_EXACT, "iterations": len(kl), "seconds": fit_s,
                    "kl_first_unexaggerated": float(first_true), "kl_last": float(kl[-1]),
                    "finite_and_falls": ok}
    if not ok:
        bad.append(f"tsne exact: kl {first_true} -> {kl[-1]}")
    out["chunked"], b = tsne_chunked(TSNE_CHUNKED)
    return out, bad + b


def tsne_chunked(n: int):
    """The chunked t-SNE on ``n`` points of the reference's large demo (10
    blobs, d = 16, perplexity 30, 3 iterations, block 1,024): seconds for
    the kNN and each gradient iteration, peak device memory against a
    dense [N, N] f32 buffer."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.plot import tsne as ts

    real_knn, real_chunk, times = ts._knn_blocked, ts._chunked_tsne_step, {"iter_s": []}

    def knn(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_knn(*a, **k)
        torch.cuda.synchronize()
        times["knn_s"] = time.perf_counter() - t0
        return res

    def chunk(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_chunk(*a)
        torch.cuda.synchronize()
        times["iter_s"].append(time.perf_counter() - t0)
        times["last"] = (a, res)
        return res
    x = tsne_blobs(n, 10, 16, SEED + 95)
    ts._knn_blocked, ts._chunked_tsne_step = knn, chunk
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        y = Tsne(method="chunked", perplexity=30.0, max_iter=3, stop_lying_iteration=2,
                 block_size=1024, device="cuda").fit_transform(x)
        fit_s = time.perf_counter() - t0
    finally:
        ts._knn_blocked, ts._chunked_tsne_step = real_knn, real_chunk
    peak = torch.cuda.max_memory_allocated() - base
    dense = 4 * n ** 2
    finite = bool(np.isfinite(y).all())
    step = tsne_step_against_float64(times["last"])
    del times["last"]
    rec = {"points": n, "d": 16, "perplexity": 30.0, "block_size": 1024,
           "seconds": fit_s, "knn_s": times["knn_s"], "iteration_s": times["iter_s"],
           "peak_bytes": peak, "dense_nn_bytes": dense, "peak_share_of_dense": peak / dense,
           "finite": finite, "last_iteration_vs_float64": step}
    torch.cuda.empty_cache()
    ok = finite and peak < dense / 10 and step["ok"]
    return rec, ([] if ok else [f"tsne chunked: finite {finite}, peak {peak}, step {step}"])


def tsne_step_against_float64(call, rows: int = 2048):
    """One chunked gradient iteration on the card, ``call`` = (inputs,
    outputs) of ``_chunked_tsne_step``, against the same iteration in
    float64 on the card written out from its formula: every pair's
    1/(1 + |y_i - y_j|^2) by row blocks for Z, the repulsion of ``rows``
    seeded rows over all N points, the attraction of every kNN edge on
    both its ends.  The new velocity of those rows within 1e-4 of the
    float64 one in norm, the KL within 1e-5 relative."""
    import numpy as np
    import torch

    (idx, p_cond, p_sym, y, vel, gains, momentum, lr, _), (_, got_v, _, got_kl) = call
    y, vel, gains = y.double(), vel.double(), gains.double()
    n, d = y.shape
    z = torch.zeros((), dtype=torch.float64, device=y.device)
    for r0 in range(0, n, 1024):
        yr = y[r0:r0 + 1024]
        num = 1.0 / (1.0 + sum((yr[:, k, None] - y[None, :, k]) ** 2 for k in range(d)))
        num[torch.arange(len(yr)), torch.arange(r0, r0 + len(yr))] = 0.0
        z += num.sum()
        del num
    sel = torch.from_numpy(np.sort(np.random.default_rng(SEED + 96).choice(n, rows, False))
                           ).to(y.device)
    ys = y[sel]
    num = 1.0 / (1.0 + sum((ys[:, k, None] - y[None, :, k]) ** 2 for k in range(d)))
    num[torch.arange(rows), sel] = 0.0
    rep = (num.square().sum(1)[:, None] * ys - num.square() @ y) / z
    del num
    dif = y[:, None, :] - y[idx]
    num_k = 1.0 / (1.0 + (dif * dif).sum(2))
    f = (p_cond.double() / (2.0 * n) * num_k)[:, :, None] * dif
    attr = f.sum(1) - torch.zeros_like(y).index_add_(0, idx.reshape(-1), f.reshape(-1, d))
    grad = 4.0 * (attr[sel] - rep)
    g = torch.clamp(torch.where((grad > 0) == (vel[sel] > 0), gains[sel] * 0.8,
                                gains[sel] + 0.2), min=0.01)
    want_v = float(momentum) * vel[sel] - float(lr) * g * grad
    ps = p_sym.double()
    want_kl = torch.sum(torch.where(ps > 0, ps * torch.log(
        torch.clamp(ps, min=1e-12) / torch.clamp(num_k / z, min=1e-12)), 0.0))
    v_rel = float(torch.linalg.norm(got_v[sel].double() - want_v) / torch.linalg.norm(want_v))
    kl_rel = float(abs(float(got_kl) - float(want_kl)) / abs(float(want_kl)))
    return {"rows": rows, "velocity_norm_rel": v_rel, "kl_rel": kl_rel,
            "ok": v_rel <= 1e-4 and kl_rel <= 1e-5}


def learning_pubsub():
    """(h) a TensorBroker on loopback feeding bench config 1's MLP."""
    import numpy as np

    from deeplearning4j_tpu_torch.streaming import (NDArrayPublisher, StreamingDataSetIterator,
                                                    TensorBroker)

    xs, ys = mlp_data()
    rng = np.random.default_rng(SEED + 96)
    picks = [rng.choice(MLP_ROWS, MLP_BATCH, replace=False) for _ in range(PUBSUB_BATCHES)]
    eye = np.eye(MLP_CLASSES, dtype=np.float32)
    batches = [(xs[p], eye[ys[p]]) for p in picks]
    net = mlp_net("cuda")
    broker = TensorBroker().start()
    try:
        it = StreamingDataSetIterator(broker.address, max_batches=PUBSUB_BATCHES, timeout=60)
        time.sleep(0.1)
        fpub = NDArrayPublisher(broker.address, "features").connect()
        lpub = NDArrayPublisher(broker.address, "labels").connect()

        def publish():
            for x, y in batches:
                fpub.publish(x)
                lpub.publish(y)
        th = threading.Thread(target=publish, daemon=True)
        t0 = time.perf_counter()
        th.start()
        losses, mismatched, nbytes = [], 0, 0
        for k, ds in enumerate(it):
            x, y = batches[k]
            if not (np.array_equal(ds.features, x) and np.array_equal(ds.labels, y)):
                mismatched += 1
            nbytes += ds.features.nbytes + ds.labels.nbytes
            losses.append(net.fit_batch(ds))
        losses = [float(v) for v in losses]
        wall = time.perf_counter() - t0
        th.join(timeout=60)
        it.close()
        fpub.close()
        lpub.close()
    finally:
        broker.stop()
    falls = float(np.mean(losses[-10:])) < float(np.mean(losses[:10]))
    rec = {"batches": len(losses), "batch": [MLP_BATCH, MLP_IN], "bytes": nbytes,
           "seconds": wall, "mb_per_s": nbytes / 1e6 / wall, "mismatched_batches": mismatched,
           "loss_first10": float(np.mean(losses[:10])), "loss_last10": float(np.mean(losses[-10:]))}
    ok = len(losses) == PUBSUB_BATCHES and mismatched == 0 and falls
    return rec, ([] if ok else [f"pubsub: {len(losses)} batches, {mismatched} mismatched, "
                                f"falls {falls}"])


def phase_learning():
    """The learning phase, (a)-(h) (the module docstring)."""
    import gc

    import torch

    t0 = time.perf_counter()
    counters = all_launch_counters()
    before = {n: c.launches for n, c in counters.items()}
    bad, out = [], {}
    for name, arm in (("w2v_bench", learning_w2v_bench), ("w2v_wide", learning_w2v_wide),
                      ("modes", learning_modes), ("distributed", learning_distributed),
                      ("deepwalk", learning_deepwalk), ("knn", learning_knn),
                      ("kmeans", learning_kmeans), ("tsne", learning_tsne),
                      ("pubsub", learning_pubsub)):
        t = time.perf_counter()
        out[name], b = arm()
        out[name]["seconds_arm"] = time.perf_counter() - t
        bad += b
        emit({"phase": "learning", "arm": name, **out[name]})
        gc.collect()
        torch.cuda.empty_cache()
    launches = {n: c.launches - before[n] for n, c in counters.items()}
    rec = {"phase": "learning", "seconds": time.perf_counter() - t0, "failed": bad,
           "launches": launches}
    emit(rec)
    if bad:
        raise AssertionError(f"learning phase failed: {bad}")
    if any(launches.values()):
        raise AssertionError(f"the learning phase launched a kernel: {launches}")
    return rec


# -- ui phase ----------------------------------------------------------------------


class KerasFile:
    """A Keras 2 full-model file held in memory: the ``model_config`` and
    ``training_config`` attributes and each layer's weight arrays under
    ``model_weights``.  It has the ``Hdf5Archive`` read methods the
    importer's stages after the read call, so they take it where ``h5py``
    is not installed; ``write(path)`` saves the same file with ``h5py``."""

    def __init__(self, model_config, weights, training_config=None):
        self.attrs = {"model_config": json.dumps(model_config)}
        if training_config is not None:
            self.attrs["training_config"] = json.dumps(training_config)
        self.weights = weights

    def has_attr(self, name, group=None) -> bool:
        return group is None and name in self.attrs

    def read_attr_as_json(self, name, group=None):
        return json.loads(self.attrs[name])

    def has_group(self, path) -> bool:
        return path == "model_weights"

    def layer_weights(self, root, layer_name) -> dict:
        return dict(self.weights.get(layer_name, {}))

    def write(self, path) -> None:
        """The same model as a Keras 2 ``.h5`` file (h5py)."""
        import h5py
        import numpy as np

        with h5py.File(path, "w") as f:
            for k, v in self.attrs.items():
                f.attrs[k] = v
            mw = f.create_group("model_weights")
            mw.attrs["layer_names"] = np.array([n.encode() for n in self.weights], dtype="S64")
            for lname, ws in self.weights.items():
                g = mw.create_group(lname)
                g.attrs["weight_names"] = np.array(
                    [f"{lname}/{wn}:0".encode() for wn in ws], dtype="S128")
                for wn, arr in ws.items():
                    g.create_dataset(f"{lname}/{wn}:0", data=arr)

    def n_weights(self) -> int:
        """Every weight's element count, the BN moving statistics included
        (Keras's "Total params")."""
        return sum(int(a.size) for ws in self.weights.values() for a in ws.values())


class _KerasLayers:
    """Layer configs and He-scaled weights from a numpy generator, the way
    ``keras.applications`` names and shapes them."""

    def __init__(self, rng, functional: bool):
        self.rng, self.functional = rng, functional
        self.layers, self.weights = [], {}

    def add(self, cls, name, inputs=(), **cfg):
        cfg = {"name": name, **cfg}
        ld = {"class_name": cls, "config": cfg}
        if self.functional:
            ld["name"] = name
            ld["inbound_nodes"] = [[[i, 0, 0, {}] for i in inputs]] if inputs else []
        self.layers.append(ld)
        return name

    def conv(self, name, cin, cout, k, stride=1, padding="valid", activation="linear",
             inputs=()):
        import numpy as np
        self.weights[name] = {
            "kernel": (self.rng.standard_normal((k, k, cin, cout), dtype=np.float32)
                       * np.float32(math.sqrt(2.0 / (k * k * cin)))),
            "bias": self.rng.standard_normal(cout, dtype=np.float32) * np.float32(0.01)}
        return self.add("Conv2D", name, inputs, filters=cout, kernel_size=[k, k],
                        strides=[stride, stride], padding=padding, activation=activation,
                        use_bias=True, data_format="channels_last", dilation_rate=[1, 1])

    def bn(self, name, c, inputs=(), gamma=1.0):
        import numpy as np
        r = self.rng
        self.weights[name] = {
            "gamma": (gamma * (1 + 0.1 * r.standard_normal(c))).astype(np.float32),
            "beta": (0.1 * r.standard_normal(c)).astype(np.float32),
            "moving_mean": (0.1 * r.standard_normal(c)).astype(np.float32),
            "moving_variance": r.uniform(0.5, 1.5, c).astype(np.float32)}
        return self.add("BatchNormalization", name, inputs, axis=3, momentum=0.99,
                        epsilon=1.001e-5, center=True, scale=True)

    def dense(self, name, cin, cout, activation, inputs=()):
        import numpy as np
        scale = math.sqrt((1.0 if activation == "softmax" else 2.0) / cin)
        self.weights[name] = {
            "kernel": self.rng.standard_normal((cin, cout), dtype=np.float32) * np.float32(scale),
            "bias": np.zeros(cout, np.float32)}
        return self.add("Dense", name, inputs, units=cout, activation=activation,
                        use_bias=True)


def keras_vgg16(seed, hw=224, classes=1000, widths=(64, 128, 256, 512, 512), fc=4096):
    """``keras.applications.VGG16`` as a Keras 2 ``Sequential`` model
    (its layers, names and shapes: 13 3x3 convolutions in five blocks,
    each closed by a 2x2 max pool, then fc1, fc2, predictions), with a
    categorical cross-entropy training config: 138,357,544 weights at the
    published widths."""
    import numpy as np
    k = _KerasLayers(np.random.default_rng(seed), functional=False)
    cin, first = 3, True
    for b, (w, n) in enumerate(zip(widths, (2, 2, 3, 3, 3)), start=1):
        for i in range(1, n + 1):
            k.conv(f"block{b}_conv{i}", cin, w, 3, padding="same", activation="relu")
            if first:
                k.layers[-1]["config"]["batch_input_shape"] = [None, hw, hw, 3]
                first = False
            cin = w
        k.add("MaxPooling2D", f"block{b}_pool", pool_size=[2, 2], strides=[2, 2],
              padding="valid", data_format="channels_last")
    k.add("Flatten", "flatten")
    side = hw // 32
    k.dense("fc1", side * side * cin, fc, "relu")
    k.dense("fc2", fc, fc, "relu")
    k.dense("predictions", fc, classes, "softmax")
    return KerasFile({"class_name": "Sequential", "config": {"name": "vgg16",
                                                             "layers": k.layers}},
                     k.weights, {"loss": "categorical_crossentropy"})


RESNET50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def keras_resnet50(seed, hw=224, classes=1000, stem=64, stages=RESNET50_STAGES):
    """``keras.applications.ResNet50`` as a Keras 2 functional ``Model``
    the way it builds one: ZeroPadding2D 3 and a 7x7/2 convolution,
    BatchNormalization (epsilon 1.001e-5), ZeroPadding2D 1 and a 3x3/2 max
    pool, then per stage (filters, blocks, stride) bottleneck blocks
    ``convS_blockB_{0,1,2,3}_{conv,bn}`` (a projection shortcut in the
    first block, the stride on its 1x1 convolutions) closed by ``Add`` and
    a ReLU, then GlobalAveragePooling2D and the softmax head: 25,636,712
    weights at the published widths.  The last BN of each block starts at
    a small scale so random activations stay finite through 16 blocks."""
    import numpy as np
    k = _KerasLayers(np.random.default_rng(seed), functional=True)
    x = k.add("InputLayer", "input_1", batch_input_shape=[None, hw, hw, 3],
              dtype="float32", sparse=False)
    x = k.add("ZeroPadding2D", "conv1_pad", [x], padding=[[3, 3], [3, 3]],
              data_format="channels_last")
    x = k.conv("conv1_conv", 3, stem, 7, stride=2, inputs=[x])
    x = k.bn("conv1_bn", stem, [x])
    x = k.add("Activation", "conv1_relu", [x], activation="relu")
    x = k.add("ZeroPadding2D", "pool1_pad", [x], padding=[[1, 1], [1, 1]],
              data_format="channels_last")
    x = k.add("MaxPooling2D", "pool1_pool", [x], pool_size=[3, 3], strides=[2, 2],
              padding="valid", data_format="channels_last")
    cin = stem
    for s, (filters, blocks, stride) in enumerate(stages, start=2):
        for b in range(1, blocks + 1):
            name = f"conv{s}_block{b}"
            st = stride if b == 1 else 1
            if b == 1:
                sc = k.conv(f"{name}_0_conv", cin, 4 * filters, 1, stride=st, inputs=[x])
                sc = k.bn(f"{name}_0_bn", 4 * filters, [sc])
            else:
                sc = x
            y = k.conv(f"{name}_1_conv", cin, filters, 1, stride=st, inputs=[x])
            y = k.bn(f"{name}_1_bn", filters, [y])
            y = k.add("Activation", f"{name}_1_relu", [y], activation="relu")
            y = k.conv(f"{name}_2_conv", filters, filters, 3, padding="same", inputs=[y])
            y = k.bn(f"{name}_2_bn", filters, [y])
            y = k.add("Activation", f"{name}_2_relu", [y], activation="relu")
            y = k.conv(f"{name}_3_conv", filters, 4 * filters, 1, inputs=[y])
            y = k.bn(f"{name}_3_bn", 4 * filters, [y], gamma=0.2)
            y = k.add("Add", f"{name}_add", [sc, y])
            x = k.add("Activation", f"{name}_out", [y], activation="relu")
            cin = 4 * filters
    x = k.add("GlobalAveragePooling2D", "avg_pool", [x], data_format="channels_last")
    k.dense("predictions", cin, classes, "softmax", inputs=[x])
    return KerasFile({"class_name": "Functional", "config": {
        "name": "resnet50", "layers": k.layers, "input_layers": [["input_1", 0, 0]],
        "output_layers": [["predictions", 0, 0]]}}, k.weights,
        {"loss": "categorical_crossentropy"})


UI_STEPS = 6                 # (a)'s fit_batch calls per arm
UI_HOST_STEPS = 3            # the yardstick arm's (~6 s a record on the host)
UI_BINS = 20
UI_RESNET_ROWS = 512         # (b): 4 steps of bench config 3's batch
UI_LENET_STEPS = 4
UI_KERAS_ROWS = 4


def host_leaf_stats(arr, bins: int, with_histogram: bool = True) -> dict:
    """(a)'s yardstick: a copy of the reference's numpy ``_leaf_stats``
    (``deeplearning4j_tpu/ui/stats.py``)."""
    import numpy as np
    a = np.asarray(arr, np.float32).ravel()
    if a.size == 0:
        return {}
    out = {
        "mean": float(a.mean()), "std": float(a.std()),
        "min": float(a.min()), "max": float(a.max()),
        "mean_magnitude": float(np.abs(a).mean()),
    }
    if with_histogram:
        hist, edges = np.histogram(a, bins=bins)
        out["histogram"] = hist.tolist()
        out["histogram_edges"] = [float(edges[0]), float(edges[-1])]
    return out


def host_stats_listener(storage, **kw):
    """(a)'s yardstick: the port's ``StatsListener`` with the reference's
    host route put back: every leaf copied to the host (``.cpu()``) on
    every recorded iteration, the previous parameters kept there, and
    numpy's statistics of each leaf and delta."""
    from deeplearning4j_tpu_torch.ui import StatsListener

    class HostStatsListener(StatsListener):
        def iteration_done(self, model, iteration, loss):
            if iteration % self.update_frequency != 0:
                return
            now = self.clock()
            record = {"iteration": int(iteration), "timestamp": now,
                      "relative_time": now - self._start_time, "score": float(loss)}
            if self._last_time is not None:
                record["iterations_per_sec"] = self.update_frequency / max(
                    now - self._last_time, 1e-9)
            self._last_time = now
            params_np, param_stats, update_stats, ratios = {}, {}, {}, {}
            device = None
            for name, key, v in self._param_items(model):
                pid = f"{name}/{key}"
                device = v.device
                arr = v.detach().cpu().numpy()
                params_np[pid] = arr
                param_stats[pid] = host_leaf_stats(arr, self.histogram_bins,
                                                   self.collect_histograms)
                if self._last_params is not None and pid in self._last_params:
                    ustats = host_leaf_stats(arr - self._last_params[pid],
                                             self.histogram_bins, self.collect_histograms)
                    update_stats[pid] = ustats
                    pm = param_stats[pid].get("mean_magnitude", 0.0)
                    um = ustats.get("mean_magnitude", 0.0)
                    ratios[pid] = (um / pm / self.update_frequency) if pm > 0 else 0.0
            self._last_params = params_np
            record["parameters"] = param_stats
            if update_stats:
                record["updates"] = update_stats
                record["update_ratios"] = ratios
            mem = self._memory(device)
            if mem:
                record["memory"] = mem
            self.storage.put_update(self.session_id, record)

    return HostStatsListener(storage, **kw)


class TimedListener:
    """A listener timed alone: the step's work is synced out first, so each
    entry of ``ms`` is the listener's own time for one recorded iteration."""

    requires_model_state = True

    def __init__(self, inner):
        self.inner, self.ms = inner, []

    def iteration_done(self, model, iteration, loss):
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.inner.iteration_done(model, iteration, loss)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t) * 1e3)

    def epoch_done(self, model, epoch):
        pass


def records_agree(dev_recs, host_recs) -> list:
    """(a)'s gate: the device route's records against the yardstick's on
    the same parameters → the failures.  Histogram counts and edges equal,
    min and max bitwise, std, mean magnitude and update ratios within rtol
    1e-5, the mean within 1e-5 x the mean magnitude, ``memory`` present and
    nonzero."""
    bad = []
    if len(dev_recs) != len(host_recs) or not dev_recs:
        return [f"{len(dev_recs)} device records against {len(host_recs)}"]
    for d, h in zip(dev_recs, host_recs):
        it = h["iteration"]
        if d.keys() != h.keys():
            bad.append(f"@{it}: keys {sorted(d)} against {sorted(h)}")
            continue
        mem = d.get("memory", {})
        if not mem.get("bytes_in_use") or not mem.get("peak_bytes_in_use"):
            bad.append(f"@{it}: memory {mem}")
        for section in ("parameters", "updates"):
            for pid, want in h.get(section, {}).items():
                got = d[section][pid]
                if (got["histogram"] != want["histogram"]
                        or got["histogram_edges"] != want["histogram_edges"]
                        or (got["min"], got["max"]) != (want["min"], want["max"])):
                    bad.append(f"@{it} {section} {pid}: histogram/edges/min/max")
                for k in ("std", "mean_magnitude"):
                    if abs(got[k] - want[k]) > 1e-5 * abs(want[k]):
                        bad.append(f"@{it} {section} {pid} {k}: {got[k]} vs {want[k]}")
                if abs(got["mean"] - want["mean"]) > 1e-5 * want["mean_magnitude"]:
                    bad.append(f"@{it} {section} {pid} mean: {got['mean']} vs {want['mean']}")
        for pid, want in h.get("update_ratios", {}).items():
            if abs(d["update_ratios"][pid] - want) > 1e-5 * abs(want):
                bad.append(f"@{it} ratio {pid}: {d['update_ratios'][pid]} vs {want}")
    return bad


def ui_gpt2(tmp):
    """(a) GPT-2-small with and without the listener, and (d) the profiler
    around two of its steps → (record, failures)."""
    import gc

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.obs import trace as obs_trace
    from deeplearning4j_tpu_torch.ops import update_kernel as uk
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener, profile_trace

    os.environ[uk.ENV_SWITCH] = "1"
    net = build_model()
    rng = np.random.default_rng(SEED + 400)
    seq = rng.integers(0, VOCAB, (8, MAX_LEN + 1))
    dev = torch.device("cuda")
    ds = DataSet(torch.from_numpy(seq[:, :-1]).to(dev), torch.from_numpy(seq[:, 1:]).to(dev))
    net.fit_batch(ds)                                   # warm-up, no listener
    n_leaves = sum(len(p) for p in net.params)
    clocks = [iter(range(10 ** 6)), iter(range(10 ** 6))]

    def device(s, **kw):
        return StatsListener(s, session_id="gpt2", **kw)

    def host(s):
        # the yardstick, and beside it the device route on the same
        # parameters (timed apart) for the gate
        return (host_stats_listener(s, session_id="gpt2", histogram_bins=UI_BINS,
                                    clock=lambda: float(next(clocks[0]))),
                device(InMemoryStatsStorage(), histogram_bins=UI_BINS,
                       clock=lambda: float(next(clocks[1]))))
    arms = (("a_none", lambda s: ()),
            ("b_device_histograms", lambda s: (device(s, histogram_bins=UI_BINS),)),
            ("c_device_no_histograms", lambda s: (device(s, collect_histograms=False),)),
            ("d_host_yardstick", host))
    out, bad = {"leaves": n_leaves, "arms": {}}, []
    for name, make in arms:
        storage = InMemoryStatsStorage()
        timed = [TimedListener(lst) for lst in make(storage)]
        steps = UI_HOST_STEPS if name == "d_host_yardstick" else UI_STEPS
        net.set_listeners(*timed)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            net.fit_batch(ds)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        recs = storage.get_updates("gpt2")
        arm = {"step_ms": walls, "median_step_ms": sorted(walls)[steps // 2],
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "records": len(recs)}
        if timed:
            ms = timed[0].ms
            arm["listener_ms"] = ms
            arm["median_listener_ms"] = sorted(ms)[len(ms) // 2]
            later = sorted(ms[1:])               # the records with deltas
            arm["median_listener_ms_with_deltas"] = later[len(later) // 2]
            if len(recs) != steps:
                bad.append(f"(a) {name}: {len(recs)} records of {steps} steps")
        if len(timed) == 2:
            # the gate: both routes' records on the same parameters
            rider = timed[1].ms
            arm["device_rider_ms"] = rider
            arm["median_step_ms_less_rider"] = sorted(
                w - r for w, r in zip(walls, rider))[steps // 2]
            fails = records_agree(timed[1].inner.storage.get_updates("gpt2"), recs)
            out["agreement"] = {"records": len(recs), "failures": fails[:20],
                                "n_failures": len(fails)}
            bad += [f"(a) {f}" for f in fails[:5]]
        out["arms"][name] = arm
        emit({"phase": "ui", "arm": "gpt2", "case": name, **arm})
    emit({"phase": "ui", "arm": "gpt2_agreement", **out["agreement"]})
    # (d) the profiler around two steps
    net.set_listeners()
    obs_trace.enable_tracing()
    logdir = os.path.join(tmp, "profile")
    try:
        with profile_trace(logdir):
            for _ in range(2):
                net.fit_batch(ds)
            torch.cuda.synchronize()
        spans = [e for e in obs_trace.get_recorder().export()["traceEvents"]
                 if e["name"].startswith("profiler/")]
    finally:
        obs_trace.disable_tracing()
    files = sorted(os.listdir(logdir)) if os.path.isdir(logdir) else []
    names = set()
    for f in files:
        with open(os.path.join(logdir, f)) as fh:
            names |= {e.get("name", "") for e in json.load(fh).get("traceEvents", [])
                      if e.get("cat") == "kernel"}
    kernels = {k: sorted(n for n in names if k in n) for k in ("flash_fwd", "fused_update")}
    prof = {"spans": [(e["name"], e.get("args", {}).get("backend_started")) for e in spans],
            "files": files, "kernel_names": len(names), "port_kernels": kernels,
            "bytes": sum(os.path.getsize(os.path.join(logdir, f)) for f in files)}
    emit({"phase": "ui", "arm": "profiler", **prof})
    if prof["spans"] != [("profiler/trace", True)] or not all(kernels.values()):
        bad.append(f"(d) profiler: spans {prof['spans']}, kernels {kernels}")
    out["profiler"] = prof
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out, bad


def ui_resnet_cli(tmp):
    """(b) ``train --zoo resnet50 --data <npz> --prefetch 2 --dashboard`` in
    this process on [512, 224, 224, 3] uint8 pixels: 4 steps of bench
    config 3's batch; the stats storage the CLI makes is kept to read its
    records → (record, failures)."""
    import numpy as np

    from deeplearning4j_tpu_torch import cli, ui

    x, y = pixel_data(UI_RESNET_ROWS, CNN_HW, CNN_CLASSES, SEED + 401)
    data = os.path.join(tmp, "pixels.npz")
    np.savez(data, x=x, y=np.argmax(y, axis=1))
    kept = []

    class KeptStorage(ui.InMemoryStatsStorage):
        def __init__(self):
            super().__init__()
            kept.append(self)

    html_path = os.path.join(tmp, "resnet50.html")
    made = ui.InMemoryStatsStorage
    ui.InMemoryStatsStorage = KeptStorage
    t = time.perf_counter()
    try:
        rc = cli.main(["train", "--zoo", "resnet50", "--zoo-args", json.dumps(
            dict(height=CNN_HW, width=CNN_HW, channels=3, num_classes=CNN_CLASSES)),
            "--data", data, "--batch-size", str(CNN_B), "--epochs", "1", "--prefetch", "2",
            "--dashboard", html_path])
    finally:
        ui.InMemoryStatsStorage = made
    seconds = time.perf_counter() - t
    recs = [r for s in kept for r in s.get_updates("cli_train") if "score" in r]
    page = open(html_path).read() if os.path.exists(html_path) else ""
    stalls = [r.get("input_pipeline", [{}])[-1].get("stall_fraction") for r in recs]
    rec = {"rc": rc, "seconds": seconds, "records": len(recs),
           "html_bytes": len(page), "names_cli_train": "cli_train" in page,
           "stall_fractions": stalls, "scores": [r["score"] for r in recs],
           "memory_gib": [r.get("memory", {}).get("bytes_in_use", 0) / 2 ** 30 for r in recs]}
    ok = (rc == 0 and rec["names_cli_train"] and len(recs) == UI_RESNET_ROWS // CNN_B
          and all(s is not None for s in stalls))
    return rec, ([] if ok else [f"(b) train --dashboard: {rec}"])


def ui_http():
    """(c) LeNet (bench config 2) posting its records through a
    ``RemoteStatsRouter`` to a ``UIServer`` in this process, beside a local
    storage fed by a listener on the same pinned clock → (record,
    failures)."""
    import urllib.request

    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.obs import trace as obs_trace
    from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage, RemoteStatsRouter,
                                             StatsListener, UIServer)

    obs_trace.enable_tracing()
    storage = InMemoryStatsStorage()
    server = UIServer(port=0).attach(storage).enable_remote_listener().start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        net = LeNet(LENET_HW, LENET_HW, 3, LENET_CLASSES,
                    updater=Nesterovs(lr=0.01, momentum=0.9), device="cuda")
        router = RemoteStatsRouter(base)
        local = InMemoryStatsStorage()
        clocks = [iter(range(10 ** 6)), iter(range(10 ** 6))]
        net.set_listeners(
            StatsListener(router, session_id="lenet", clock=lambda: float(next(clocks[0]))),
            StatsListener(local, session_id="lenet", clock=lambda: float(next(clocks[1]))))
        t = time.perf_counter()
        with obs_trace.span("ui/lenet_fit", cat="ui", steps=UI_LENET_STEPS):
            for i in range(UI_LENET_STEPS):
                net.fit_batch(images(LENET_B, LENET_HW, LENET_CLASSES, SEED + 402 + i))
        router.close()
        seconds = time.perf_counter() - t

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.status, r.read()
        _, metrics = get("/metrics")
        _, trace = get("/trace")
        page_status, page = get("/train/0/lenet")
    finally:
        server.stop()
        obs_trace.disable_tracing()
    trace = json.loads(trace)
    sessions = json.loads(metrics)["sessions"]
    stored, want = storage.get_updates("lenet"), json.loads(json.dumps(local.get_updates("lenet")))

    def bare(recs):
        # each listener holds its own device copy of the parameters, so
        # the allocator's bytes differ between the two streams
        return [{k: v for k, v in r.items() if k != "memory"} for r in recs]
    rec = {"seconds": seconds, "stored": len(stored), "local": len(want),
           "equal": bare(stored) == bare(want),
           "memory_in_both": all("memory" in r for r in stored + want),
           "sessions": sessions, "dropped": router.dropped,
           "trace_events": len(trace["traceEvents"]),
           "trace_has_span": any(e.get("name") == "ui/lenet_fit" for e in trace["traceEvents"]),
           "trace_problems": obs_trace.validate_chrome_trace(trace)[:5],
           "page_status": page_status, "page_bytes": len(page)}
    ok = (rec["equal"] and rec["memory_in_both"] and len(stored) == UI_LENET_STEPS
          and sessions.get("lenet", {}).get("updates") == len(want)
          and not rec["trace_problems"] and rec["trace_has_span"] and page_status == 200
          and b"Score vs iteration" in page and router.dropped == 0)
    return rec, ([] if ok else [f"(c) records over HTTP: {rec}"])


def _tree_count(tree) -> int:
    parts = tree.values() if isinstance(tree, dict) else tree
    return sum(int(v.numel()) for p in parts for v in (p or {}).values())


def ui_keras():
    """(e) Keras VGG16 and ResNet50 through the importer's in-memory seam
    at the published widths, on the card and on the CPU; the wrappers on
    bench config 1's MLP → (record, failures)."""
    import gc

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.modelimport import keras as tkeras
    from deeplearning4j_tpu_torch.wrappers import NeuralNetClassifier

    rng = np.random.default_rng(SEED + 403)
    x = rng.standard_normal((UI_KERAS_ROWS, CNN_HW, CNN_HW, 3), dtype=np.float32)
    out, bad = {}, []
    for name, make, published in (("vgg16", keras_vgg16, 138_357_544),
                                  ("resnet50", keras_resnet50, 25_636_712)):
        t = time.perf_counter()
        kf = make(SEED + 300)
        card = tkeras._import_archive(kf, device="cuda")
        import_s = time.perf_counter() - t
        counts = {"keras": kf.n_weights(),
                  "card": _tree_count(card.params) + _tree_count(card.state)}
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = card.output(x)
        got = (got[0] if isinstance(got, list) else got).cpu().numpy()
        output_ms = (time.perf_counter() - t) * 1e3
        cpu = tkeras._import_archive(kf, device="cpu")
        want = cpu.output(x)
        want = (want[0] if isinstance(want, list) else want).numpy()
        del cpu
        rec = {"weights": counts, "published": published, "import_s": import_s,
               "output_ms": output_ms, "output_shape": list(got.shape),
               "max_abs_diff_vs_cpu": float(np.abs(got - want).max()),
               "rows_sum_to_1": bool(np.allclose(got.sum(-1), 1, atol=1e-4))}
        if isinstance(card.params, list):
            # a Sequential with a training config: its loss head trains
            y = np.eye(CNN_CLASSES, dtype=np.float32)[rng.integers(0, CNN_CLASSES,
                                                                   UI_KERAS_ROWS)]
            rec["fit_batch_loss"] = float(card.fit_batch(DataSet(
                torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())))
            if not math.isfinite(rec["fit_batch_loss"]):
                bad.append(f"(e) {name}: fit_batch loss {rec['fit_batch_loss']}")
        out[name] = rec
        emit({"phase": "ui", "arm": "keras", "model": name, **rec})
        if counts["keras"] != published or counts["card"] != published:
            bad.append(f"(e) {name}: weights {counts}, published {published}")
        if rec["max_abs_diff_vs_cpu"] > 1e-4 or not rec["rows_sum_to_1"]:
            bad.append(f"(e) {name}: card vs CPU {rec['max_abs_diff_vs_cpu']}")
        del card, kf
        gc.collect()
        torch.cuda.empty_cache()
    xs, ys = mlp_data()
    t = time.perf_counter()
    clf = NeuralNetClassifier(mlp_conf, epochs=1, batch_size=MLP_BATCH, device="cuda").fit(xs, ys)
    fit_s = time.perf_counter() - t
    pred = clf.predict(xs)
    argmax = clf.classes_[np.argmax(clf.net_.output(xs).cpu().numpy(), axis=-1)]
    rec = {"fit_s": fit_s, "steps": len(clf.losses_), "device": str(clf.net_.device),
           "accuracy": clf.score(xs, ys), "predict_is_argmax": bool(np.array_equal(pred, argmax)),
           "last_loss": float(clf.losses_[-1])}
    out["wrapper"] = rec
    emit({"phase": "ui", "arm": "wrapper", **rec})
    if not (rec["predict_is_argmax"] and rec["device"].startswith("cuda")
            and rec["steps"] == MLP_ROWS // MLP_BATCH and math.isfinite(rec["last_loss"])):
        bad.append(f"(e) wrapper: {rec}")
    return out, bad


def phase_ui():
    """The ui phase, (a)-(e) (the module docstring)."""
    import gc
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.nn.train_graph import TRAIN_COUNTERS

    t0 = time.perf_counter()
    before = {n: c.launches for n, c in TRAIN_COUNTERS.items()}
    tmp = tempfile.mkdtemp(prefix="chip_ui_")
    bad, out = [], {}
    try:
        for name, arm in (("gpt2", lambda: ui_gpt2(tmp)), ("resnet_cli", lambda: ui_resnet_cli(tmp)),
                          ("http", ui_http), ("keras", ui_keras)):
            t = time.perf_counter()
            out[name], b = arm()
            bad += b
            emit({"phase": "ui", "arm": name, "seconds": time.perf_counter() - t,
                  "failed": b})
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: c.launches - before[n] for n, c in TRAIN_COUNTERS.items()}
    rec = {"phase": "ui", "seconds": time.perf_counter() - t0, "failed": bad,
           "launches": launches}
    emit(rec)
    if bad:
        raise AssertionError(f"ui phase failed: {bad}")
    return rec


# -- wide_heads phase: GPT-J-6B's attention widths ------------------------------------

#: GPT-J-6B's widths (its published config: d_model 4096, 16 heads of 256,
#: d_ff 16384, vocab 50,400, 2,048 positions) on the repository's block
#: (learned positions, the sequential pre-LN block), not GPT-J's rotary,
#: parallel one; depth cut from 28 layers to ``GPTJ_LAYERS``
GPTJ = dict(vocab_size=50400, d_model=4096, n_heads=16, d_ff=16384, max_len=2048)
GPTJ_LAYERS = 4
WIDE_B, WIDE_T = 4, 2048
#: Adam's rate for (a) and (b): its first steps move every weight by about
#: the rate, so a unit's input moves by about rate x d_model; the train
#: phase's 3e-4 at GPT-2's 768, scaled to 4096, moves it as much (at 3e-4
#: the wide model's bf16 loss rose, 13.1 -> 16.5 -> 28.1, on an H100)
WIDE_LR = 3e-4 * D_MODEL / GPTJ["d_model"]


@contextlib.contextmanager
def card_draws(seed):
    """While open, the port's weight initializers draw on the card from a
    CUDA generator seeded with ``seed``: a GPT-J-width network's 1.2 G
    draws take ~10 s on the host, a few milliseconds here."""
    import torch

    from deeplearning4j_tpu_torch.ops import initializers as ini

    gen = torch.Generator(device="cuda").manual_seed(seed)
    real = ini.draw_normal, ini.draw_uniform
    ini.draw_normal = lambda shape, std, generator: (
        torch.randn(shape, generator=gen, device="cuda") * std)
    ini.draw_uniform = lambda shape, limit, generator: (
        torch.rand(shape, generator=gen, device="cuda") * (2 * limit) - limit)
    try:
        yield
    finally:
        ini.draw_normal, ini.draw_uniform = real


def wide_lm(n_layers, device, tree=None, dtype="float32", updater=None, seed=SEED + 500):
    """The repository's TransformerLM at GPT-J's widths cut to ``n_layers``
    on ``device``, every leaf in ``dtype`` (parameters and compute: the
    blocks compute in their input's dtype, and the embedding gathers
    parameter rows), with the weights of ``tree`` (a list of per-layer
    f32 tensors) or, without one, its own initialisation drawn on the
    card from ``seed`` → (network, f32 copies of its weights)."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    with card_draws(seed):
        net = TransformerLM(n_layers=n_layers, **GPTJ, dtype=dtype, updater=updater,
                            device=device)
    if tree is None:
        tree = [{k: v.detach().float().clone() for k, v in p.items()} for p in net.params]
    else:
        dt = getattr(torch, dtype)
        net.params = [{k: a.to(device, dt, copy=True) for k, a in layer.items()}
                      for layer in tree]
    return net, tree


#: each flash wrapper's and D1's counter of launches by instance
def instance_counters():
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.ops import kv_cache as kvc
    return {"flash_fwd": att.flash_forward_cuda, "flash_bwd_dkdv": att.flash_bwd_dkdv_cuda,
            "flash_bwd_dq": att.flash_bwd_dq_cuda, "det_attention": kvc.det_attention_cuda}


def zero_instances():
    for c in instance_counters().values():
        c.instances.clear()


def read_instances() -> dict:
    return {n: dict(c.instances) for n, c in instance_counters().items()}


def wide_train_arm(name, tree, dtype, tok, tgt, falling):
    """(a) / (b): 3 ``fit_batch`` steps on [WIDE_B, WIDE_T] with every leaf
    in ``dtype``, Adam at ``WIDE_LR``, K1-K3 counted by instance →
    (record, failures)."""
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    t_arm = time.perf_counter()
    net, _ = wide_lm(GPTJ_LAYERS, "cuda", tree, dtype, updater=Adam(lr=WIDE_LR))
    dev = torch.device("cuda")
    ds = DataSet(torch.from_numpy(tok).to(dev), torch.from_numpy(tgt).to(dev))
    key = f"{dtype}_d256"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_instances()
    losses, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        losses.append(float(net.fit_batch(ds)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    inst = read_instances()
    peak = torch.cuda.max_memory_allocated()
    per_kernel = {k: inst[k].get(key, 0) for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    rec = {"phase": "wide_heads", "arm": name, "dtype": dtype, "batch": [WIDE_B, WIDE_T],
           "layers": GPTJ_LAYERS, "lr": WIDE_LR, "losses": losses, "step_s": times,
           "step_ms": [t * 1e3 for t in times],
           "tokens_per_s_last": WIDE_B * WIDE_T / times[-1], "peak_memory_gib": peak / 2 ** 30,
           "instances": inst, "launches_at_d256": per_kernel,
           "arm_s": time.perf_counter() - t_arm}
    emit(rec)
    del net
    torch.cuda.empty_cache()
    ok = (all(math.isfinite(x) for x in losses)
          and (all(b < a for a, b in zip(losses, losses[1:])) if falling
               else losses[-1] < losses[0])
          and per_kernel == {k: 3 * GPTJ_LAYERS for k in per_kernel}
          and all(set(v) <= {key} for v in inst.values()))
    return rec, ([] if ok else [f"({name}) {dtype} training: {rec}"])


def wide_output_arm(net, tokens):
    """(c): f32 ``output()`` on [WIDE_B, WIDE_T] through K1's DP 256
    instance → (record, failures)."""
    import torch

    t_arm = time.perf_counter()
    net.output(tokens[:1, :64])
    torch.cuda.synchronize()
    zero_instances()
    t0 = time.perf_counter()
    y = net.output(tokens)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    inst = read_instances()
    ok = (tuple(y.shape) == (WIDE_B, WIDE_T, GPTJ["vocab_size"])
          and bool(torch.isfinite(y).all()))
    row_sum_err = float((y.sum(-1) - 1).abs().max())
    del y
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec = {"phase": "wide_heads", "arm": "c_output", "batch": [WIDE_B, WIDE_T],
           "first_call_s": first, "call_s": times, "tokens_per_s": WIDE_B * WIDE_T / min(times),
           "row_sum_max_err": row_sum_err, "instances": inst,
           "arm_s": time.perf_counter() - t_arm}
    emit(rec)
    ok = ok and row_sum_err <= 1e-3 and inst["flash_fwd"] == {"float32_d256": GPTJ_LAYERS}
    return rec, ([] if ok else [f"(c) output: {rec}"])


def wide_decode_arm(net):
    """(d): ``DecodeEngine`` over the f32 network, the serve phase's 8
    requests (prompts 16-512, 32 new tokens): decode logits bitwise the
    re-encode's, D1 at d 256, the pool drained → (record, failures)."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter

    t_arm = time.perf_counter()
    prompts, kws = serve_requests()
    zero_instances()
    run = serve_run(TransformerDecodeAdapter(net), prompts, kws)
    inst = read_instances()
    eng, results = run["engine"], run["outcomes"]
    failed = [r for r in results if isinstance(r, BaseException)]
    bitwise, greedy = not failed, not failed
    if not failed:
        for p, kw, r in zip(prompts, kws, results):
            ref = reencode_rows(eng, p, r.tokens)
            bitwise = bitwise and bool(np.array_equal(ref, r.logits))
            if kw["temperature"] == 0.0:
                greedy = greedy and ref.argmax(-1).tolist() == r.tokens
    d1 = inst["det_attention"]
    rec = {"phase": "wide_heads", "arm": "d_decode", "requests": len(results),
           "failed": [repr(e) for e in failed], "decode_vs_reencode_bitwise": bitwise,
           "greedy_equals_reencode_argmax": greedy, "d1_instances": d1,
           "pages_in_use_after": run["snap"]["pages_in_use"], **run["metrics"],
           "arm_s": time.perf_counter() - t_arm}
    emit(rec)
    ok = (bitwise and greedy and rec["pages_in_use_after"] == 0 and d1.get("d256", 0) > 0
          and set(d1) == {"d256"}
          and all(len(r.tokens) == SERVE_NEW for r in results if not failed))
    return rec, ([] if ok else [f"(d) decode: {rec}"])


def wide_card_vs_cpu(tree):
    """(e): a 2-layer cut of the network ``tree`` holds (its embedding,
    positions, first two blocks and head), f32, [2, 128], 2 SGD steps on
    the card and on the CPU from the same weights → (record, failures)."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    t_arm = time.perf_counter()
    rng = np.random.default_rng(SEED + 510)
    tok = rng.integers(0, GPTJ["vocab_size"], (2, 129))
    ds = DataSet(tok[:, :-1], tok[:, 1:])
    tree, runs = tree[:4] + tree[-1:], []
    zero_instances()
    for dev in ("cuda", "cpu"):
        net, _ = wide_lm(2, dev, tree, updater=Sgd(lr=0.1))
        losses = [float(net.fit_batch(ds)) for _ in range(2)]
        runs.append((losses, [{k: v.float().cpu().numpy() for k, v in p.items()}
                              for p in net.params]))
        if dev == "cuda":
            inst = read_instances()
        del net
    (lg, pg), (lc, pc) = runs
    diff = max(float(np.abs(pg[i][k] - pc[i][k]).max()) for i in range(len(pg)) for k in pg[i])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    rec = {"phase": "wide_heads", "arm": "e_card_vs_cpu",
           "cut": "2 layers at GPT-J widths, f32, [2, 128], Sgd(0.1), 2 steps",
           "losses_card": lg, "losses_cpu": lc, "loss_max_rel_diff": loss_rel,
           "params_max_abs_diff": diff, "tolerance": 1e-4, "instances": inst,
           "arm_s": time.perf_counter() - t_arm}
    emit(rec)
    ok = (loss_rel <= 1e-4 and diff <= 1e-4
          and all(inst[k] == {"float32_d256": 4} for k in ("flash_fwd", "flash_bwd_dkdv",
                                                            "flash_bwd_dq")))
    return rec, ([] if ok else [f"(e) card vs CPU: {rec}"])


def phase_wide_heads():
    """The repository's TransformerLM at GPT-J-6B's attention widths (head
    width 256: K1-K3's and D1's DP 256 instances), arms (a)-(e) (the module
    docstring)."""
    import gc

    import numpy as np
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 501)
    tok = rng.integers(0, GPTJ["vocab_size"], (WIDE_B, WIDE_T + 1))
    arms, bad = {}, []
    # (c), (d): the f32 network
    net, tree = wide_lm(GPTJ_LAYERS, "cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(int(v.numel()) for p in net.params for v in p.values())
    arms["c"], b = wide_output_arm(net, tok[:, :-1])
    bad += b
    arms["d"], b = wide_decode_arm(net)
    bad += b
    del net
    gc.collect()
    torch.cuda.empty_cache()
    # (a), (b): bf16 and f16 training (every leaf in the dtype)
    arms["a"], b = wide_train_arm("a_train_bf16", tree, "bfloat16", tok[:, :-1], tok[:, 1:],
                                  falling=True)
    bad += b
    arms["b"], b = wide_train_arm("b_train_f16", tree, "float16", tok[:, :-1], tok[:, 1:],
                                  falling=False)
    bad += b
    # (e): card against CPU at a 2-layer cut
    arms["e"], b = wide_card_vs_cpu(tree)
    bad += b
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    launches = {n: sum(arms[a]["instances"][n].get(f"{dt}_d256", 0)
                       for a in ("a", "b", "c", "e") for dt in ("float32", "bfloat16", "float16"))
                for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    by_instance = {f"{n}/{k}": sum(arms[a]["instances"][n].get(k, 0) for a in "abce")
                   for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
                   for k in ("float32_d256", "bfloat16_d256", "float16_d256")}
    by_instance["det_attention/d256"] = arms["d"]["d1_instances"].get("d256", 0)
    rec = {"phase": "wide_heads", "parameters": n_params, "init_s": init_s,
           "seconds": time.perf_counter() - t0, "failed": bad, "launches": launches,
           "launches_by_instance": by_instance}
    emit(rec)
    if bad:
        raise AssertionError(f"wide_heads phase failed: {bad}")
    return rec


def trace_probe(n: int) -> None:
    """``--trace-probe N``: the serve and predict phases, each traced
    replay taken N times hard against the trace's ends (pause 0) and N
    times with ``TRACE_PAUSE_S``; prints each replay's kernel counts."""
    import collections

    from deeplearning4j_tpu_torch.utils import cuda_build

    cuda_build.build(cuda_build.sources())
    net = build_model()
    real = traced_kernels

    def probe(replay, names, pause=TRACE_PAUSE_S):
        counts = {f"pause_{p}": collections.Counter(real(replay, names, p) for _ in range(n))
                  for p in (0.0, pause)}
        emit({"phase": "trace_probe", "names": list(names), "traces_each": n,
              "counts": {k: dict(c) for k, c in counts.items()}})
        return real(replay, names, pause)
    globals()["traced_kernels"] = probe
    phase_serve(net)
    phase_predict(net)
    print(card_line(), flush=True)


def canary_probe(n: int) -> None:
    """``--canary-probe N``: predict_features arm (e) alone, N times over
    one model, each run's record (its walls, the engine's warm, swap and
    drain steps, each capture and the replica calls timed) printed."""
    import gc

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.utils import cuda_build

    cuda_build.build(cuda_build.sources())
    net = build_model()
    rng = np.random.default_rng(SEED + 90)
    bad = []
    for i in range(n):
        t = time.perf_counter()
        rec, b = pf_canary(net, rng)
        bad += b
        emit({"phase": "canary_probe", "run": i, "wall_s": time.perf_counter() - t,
              "ok": not b, **rec})
        gc.collect()
        torch.cuda.empty_cache()
    print(card_line(), flush=True)
    if bad:
        raise AssertionError(f"canary probe: {bad}")


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
    if sys.argv[1:2] == ["--trace-probe"]:
        trace_probe(int(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--canary-probe"]:
        canary_probe(int(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--phase"] and sys.argv[2:3] in (["kernel"], ["sharded"], ["elastic"],
                                                          ["predict_features"], ["fleet"],
                                                          ["flywheel"], ["learning"], ["ui"],
                                                          ["train"], ["wide_heads"]):
        card = card_line()
        emit({"torch": torch.__version__, "device": torch.cuda.get_device_name(0),
              "card": card})
        cuda_build.build(cuda_build.sources())
        {"kernel": phase_kernel, "sharded": phase_sharded, "elastic": phase_elastic,
         "predict_features": lambda: phase_predict_features(build_model()),
         "fleet": lambda: phase_fleet(build_model()),
         "flywheel": phase_flywheel, "learning": phase_learning,
         "ui": phase_ui, "train": lambda: phase_train(build_model()),
         "wide_heads": phase_wide_heads}[sys.argv[2]]()
        print(card, flush=True)
        return 0
    card = card_line()
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})

    t0 = time.perf_counter()
    built = cuda_build.build(cuda_build.sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(str(v), REPO) for k, v in built.items()}})

    k1, bwd, det, k1_tc, bwd_tc, wide = run_phase("kernel", phase_kernel)
    k5 = run_phase("kernel_lstm", phase_kernel_lstm)
    net = run_phase("build_model", build_model)
    score = run_phase("score", phase_score, net)
    serve = run_phase("serve", phase_serve, net)
    predict = run_phase("predict", phase_predict, net)
    features = run_phase("predict_features", phase_predict_features, net)
    http = run_phase("http", phase_http, net)
    fleet = run_phase("fleet", phase_fleet, net)["launches"]
    train = run_phase("train", phase_train, net)
    k4 = run_phase("fused_update_case", fused_update_case, net)
    from deeplearning4j_tpu_torch.ops.compression import GradBucketer
    if GradBucketer(net.params).bucket_sizes() != DP_BUCKET_SIZES:
        raise AssertionError("DP_BUCKET_SIZES is not the model's bucket layout")
    del net
    torch.cuda.empty_cache()
    rnn = run_phase("recurrent", phase_recurrent)
    k5_launches = rnn["arms"]["k5"]["launches_per_call"][0]
    run_phase("mlp", phase_mlp)
    attn = run_phase("attention_layers", phase_attention_layers)
    conv = run_phase("conv", phase_conv)
    heads = run_phase("heads", phase_heads)
    _, k6 = run_phase("kernel_encode", phase_kernel_encode, DP_BUCKET_SIZES)
    compressed = run_phase("compressed", phase_compressed)
    sharded = run_phase("sharded", phase_sharded)["launches"]
    elastic = run_phase("elastic", phase_elastic)["launches"]
    flywheel = run_phase("flywheel", phase_flywheel)["launches"]
    if any(flywheel.values()):
        raise AssertionError(f"the flywheel phase launched a kernel: {flywheel}")
    run_phase("learning", phase_learning)     # launches none of K1-K6 or D1 (gated)
    ui = run_phase("ui", phase_ui)["launches"]
    wide_lbi = run_phase("wide_heads", phase_wide_heads)["launches_by_instance"]
    emit({"script_s": time.perf_counter() - T_START})

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
    # the training launches: the eager train steps, the fit_batches graph
    # arm (its capture's warm-up and every replay) and the attention arm
    graph_n = train["fit_batches"]["launches"]

    def trained(name, kernel):
        return (train["launches"][name] + graph_n[kernel] + attn["launches"].get(name, 0)
                + conv["rnn_launches"].get(name, 0) + heads["launches"].get(name, 0)
                + sharded.get(name, 0) + elastic.get(name, 0) + ui.get(name, 0))
    # bf16 attention runs in the sharded phase alone: its K1-K3 launches
    # there went to the tensor-core kernels (their own counters), the rest
    # of K1's, K2's and K3's counts to the SIMT kernels
    tc = {k: sharded[k + "_tc"] for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    # the DP 256 instances (head widths 129-256) in each dtype, launched by
    # the wide_heads phase; times at its attention, [4, 16, 2048, 256]
    wide_entries = []
    for tag, dname, fsrc, bsrc, suffix in (
            ("f32", "float32", "flash_fwd.cu", "flash_bwd.cu", ""),
            ("bf16", "bfloat16", "flash_fwd_tc.cu", "flash_bwd_tc.cu", "_tc"),
            ("f16", "float16", "flash_fwd_tc.cu", "flash_bwd_tc.cu", "_tc_f16")):
        wf, wb = wide["fwd"][f"{tag}_d256"], wide["bwd"][f"{tag}_d256"]
        wide_entries += [
            entry(f"flash_fwd{suffix}_d256", fsrc, "deeplearning4j_tpu/ops/attention.py:138",
                  wide_lbi[f"flash_fwd/{dname}_d256"], wf),
            entry(f"flash_bwd_dkdv{suffix}_d256", bsrc, "deeplearning4j_tpu/ops/attention.py:329",
                  wide_lbi[f"flash_bwd_dkdv/{dname}_d256"],
                  {**wb["flash_bwd_dkdv"], "library_ms": wb["library_ms"]}),
            entry(f"flash_bwd_dq{suffix}_d256", bsrc, "deeplearning4j_tpu/ops/attention.py:366",
                  wide_lbi[f"flash_bwd_dq/{dname}_d256"],
                  {**wb["flash_bwd_dq"], "library_ms": wb["library_ms"]})]
    wide_entries.append(entry("det_attention_d256", "det_attention.cu",
                              "deeplearning4j_tpu/ops/kv_cache.py:362",
                              wide_lbi["det_attention/d256"], wide["det"]["step"]))
    emit({"kernels": [
        entry("flash_fwd", "flash_fwd.cu", "deeplearning4j_tpu/ops/attention.py:138",
              score["launches"]["flash_fwd"] + predict["launches"]["flash_fwd"]
              + features["launches"]["flash_fwd"] + fleet["flash_fwd"]
              + graph_n["flash_fwd_kernel"]
              + attn["launches"]["flash_fwd"] + sharded["flash_fwd"] + elastic["flash_fwd"]
              + ui["flash_fwd"] - tc["flash_fwd"], k1),
        entry("flash_fwd_tc", "flash_fwd_tc.cu", "deeplearning4j_tpu/ops/attention.py:138",
              tc["flash_fwd"], k1_tc),
        entry("flash_bwd_dkdv", "flash_bwd.cu", "deeplearning4j_tpu/ops/attention.py:329",
              trained("flash_bwd_dkdv", "flash_bwd_dkdv_kernel") - tc["flash_bwd_dkdv"],
              {**bwd["flash_bwd_dkdv"], **bwd_lib}),
        entry("flash_bwd_dkdv_tc", "flash_bwd_tc.cu", "deeplearning4j_tpu/ops/attention.py:329",
              tc["flash_bwd_dkdv"],
              {**bwd_tc["flash_bwd_dkdv"], "library_ms": bwd_tc["library_ms"]}),
        entry("flash_bwd_dq", "flash_bwd.cu", "deeplearning4j_tpu/ops/attention.py:366",
              trained("flash_bwd_dq", "flash_bwd_dq_kernel") - tc["flash_bwd_dq"],
              {**bwd["flash_bwd_dq"], **bwd_lib}),
        entry("flash_bwd_dq_tc", "flash_bwd_tc.cu", "deeplearning4j_tpu/ops/attention.py:366",
              tc["flash_bwd_dq"],
              {**bwd_tc["flash_bwd_dq"], "library_ms": bwd_tc["library_ms"]}),
        entry("fused_update", "fused_update.cu", "deeplearning4j_tpu/ops/update_kernel.py:84",
              trained("fused_update", "fused_update_kernel"), k4),
        entry("det_attention", "det_attention.cu",
              "deeplearning4j_tpu/ops/kv_cache.py:362",
              serve["launches"]["det_attention"] + http["launches"]["det_attention"]
              + fleet["det_attention"] + sharded["det_attention"], det),
        entry("lstm_seq_fwd", "lstm_cell.cu", "deeplearning4j_tpu/ops/lstm_kernel.py:81",
              k5_launches["lstm_seq_fwd"] + conv["rnn_launches"]["lstm_seq_fwd"],
              k5["lstm_seq_fwd"]),
        entry("lstm_cell_bwd", "lstm_cell.cu", "deeplearning4j_tpu/ops/lstm_kernel.py:87",
              k5_launches["lstm_cell_bwd"] + conv["rnn_launches"]["lstm_cell_bwd"],
              k5["lstm_cell_bwd"]),
        entry("threshold_encode", "threshold_encode.cu",
              "deeplearning4j_tpu/ops/compression.py:128",
              compressed["arms"]["a_one_pass"]["k6_launches"]
              + sum(compressed["arms"]["e_tinyyolo_batchnorm"]["k6_launches_per_step"][0])
              + elastic["threshold_encode"], k6),
    ] + wide_entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    ranks = {"--compressed-rank": "compressed_rank", "--sharded-rank": "sharded_rank",
             "--model-axis-rank": "model_axis_rank", "--elastic-rank": "elastic_rank",
             "--learning-rank": "learning_rank"}
    if sys.argv[1:2] and sys.argv[1] in ranks:
        globals()[ranks[sys.argv[1]]](int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--flywheel-cli"]:
        sys.path.insert(0, REPO)
        flywheel_cli_run(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
