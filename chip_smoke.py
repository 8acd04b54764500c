#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
GPU — the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py [--seed N]

Phases, in order; each raises on failure and the script then exits
non-zero (no phase is wrapped in a ``try`` that carries on):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: every ``paddle_tpu_torch/csrc/*.cu`` by ``nvcc`` for
   ``sm_90a`` (one process per source, in parallel), timed;
3. each kernel against its plain PyTorch version on the card, within
   ORACLE_TOL, then its time, the plain version's, one PyTorch library
   call's (a yardstick the port never calls) and the bound:
   a. paged attention at the serving path's shapes (decode S=32 W=1,
      prefill S=1 W=1, and W=4), bf16 and f32, on both kernel families
      (split, which the rule picks there, and simple, forced by a patch of
      the rule in this script), each against the plain block scan and the
      split one also against the plain split-and-merge spelling, and the
      same bits twice; timed at the decode shape in bf16, both families in
      turns (simple, split, split, simple; the split kernels must win and
      must not be slower than the library call: ``scaled_dot_product_
      attention`` on the gathered view; bound: bytes over 3.35 TB/s); a+.
      the same at phase 5c's verify shape (S=32, W=6, h=8, dh=32), f32 and
      bf16, timed in f32;
   b. flash attention forward (``o``, ``lse``) and fused backward
      (``dq, dk, dv``, with and without ``dlse``) at the training path's
      shape (b=8, t=4096, h=6, d=128, bf16, causal), plus f32, d=64,
      non-causal and ragged lengths, and d_head 192 and 256 in bf16 and
      f32 (past the sm90 family's 128: the simple family's 32-key tiles),
      on the kernel family the rule picks
      (sm90 for bf16 that TMA can address: ``csrc/flash_fwd_sm90.cu`` and
      the fused kernel of ``csrc/flash_bwd_sm90.cu`` behind its delta
      pre-pass; simple for f32) and, where that is sm90, on the simple one
      (``csrc/flash_attention.cu``) forced by a patch of the rule in this
      script; the plain version materialises ``[b, h, t, t]`` scores, so
      it runs over the batch two rows at a time; at the path shape the
      fused sm90 route's dk and dv equal the split sm90 route's bit for
      bit; timed there, both families in turns (simple, sm90, sm90,
      simple; each sm90 kernel must beat the simple one; library: SDPA
      forward, and forward plus backward; bound: causal flops over 989
      TFLOP/s, or bytes);
      b+. the split backward (delta pre-pass, dq kernel, dk/dv kernel)
      with the route forced in this script, on both kernel families: the
      one the rule picks (sm90 for bf16, ``csrc/flash_bwd_sm90.cu``;
      simple for f32) and the simple one (``csrc/flash_attention.cu``)
      forced by a patch of the rule in this script: at b=8 t=4096 and the
      small cases against the plain version, with and without ``dlse``,
      bit-identical run to run, against the fused kernel of the same
      family (dk and dv its exact bits: one k-major body; dq within
      rounding); at phase 8's shape (b=8, t=16384)
      against the fused kernel and, on batch row 0 one head at a time,
      the plain version; timed there, both families in turns (simple,
      sm90, sm90, simple; each sm90 kernel must beat the simple one), the
      pre-pass and the whole split route (library: SDPA's backward for
      the pair; bound: three and four causal products, the pre-pass's
      bytes); and the forward there: both families in turns (the sm90 one
      must win), on batch row 0 one head at a time against the plain
      version, beside SDPA's forward and its bound (two causal products);
   c. the fused cross-entropy head's forward (``loss``, ``lse``), dx and
      dW kernels at the training path's shape (N = 32768 rows, d=768,
      V=32768, bf16), at phase 6's f32 shape (N=512), at a ragged shape
      (N=1000, d=200, V=5000, bf16 and f32) and past the sm90 family's
      d <= 768 (d=1024, V=32768 and the reference's own d=2048, V=50,000
      in bf16, d=1024 in f32: the simple family's d-chunks), with labels
      -1 and V in some rows and a loss cotangent with zeros; all three on
      the family the rule picks (sm90 for the bf16 cases up to d=768: the
      forward and dx in ``csrc/fused_ce_fwd_dx_sm90.cu``, dW in
      ``csrc/fused_ce_sm90.cu``; simple, ``csrc/fused_ce.cu``, for f32 and
      the wider heads), each the same bits twice;
      timed at the path shape, each kernel on both families in turns
      (simple, sm90, sm90, simple; the simple one forced by a patch of the
      rule; each sm90 kernel must win) (library: ``torch.matmul`` +
      ``F.cross_entropy`` forward, and that composition's backward by
      autograd for x alone and for w alone — no single PyTorch call
      computes the head; bound: 2 N d V flops a product over 989
      TFLOP/s); c+. the forward and dx at phase 8's N = 131072 against
      their plain versions over row chunks, and the three kernels' times
      there on both families in turns;
   d. ``decode_gather`` against its plain version with ``torch.equal``
      (bit-exact) at the decode shape (S=32, NB=16, B=32, h=6, dh=128)
      in bf16 and f32, a prefill shape (S=1) and ragged blocks whose byte
      count is no multiple of 16 (B=5, h=3, dh=21, at two pool base
      offsets), tables with repeated and trash (0) entries; timed at the
      decode shape in bf16 (library: ``index_select``; bound: bytes);
   e. the fused ResNet bottleneck (B9) on the family the rule picks:
      sm90 (``csrc/bottleneck_sm90.cu``) at the script's shape (N=128,
      56x56, 256 -> 64 -> 256, bf16, 2e-2 max-relative), a small batch
      whose images split into strips, W=64 at Cin 192 and H=W=1, each
      also against the simple family forced; simple
      (``csrc/bottleneck.cu``) at a small f32 shape (2e-4), a height no
      band divides (H=13, Cm=72, bf16 and f32) and channel counts that
      are no multiple of 8 (bf16 on the FMA spelling); every case the same
      bits twice; timed at the script's shape on both families in turns
      (simple, sm90, sm90, simple; the sm90 kernel must win every turn)
      (library: the three convolutions on cuDNN in channels_last with the
      same epilogues; bound: x read and out written once over 3.35 TB/s);
      then its path, the reference experiment through
      ``python -m paddle_tpu_torch.benchmarks.bottleneck``'s ``main``,
      with every count zeroed before it: every launch on sm90;
4. serving correctness at full width in f32: the 12-layer d768 h6 v32768
   GPT with seeded random weights serves 8 shared-prefix requests through
   the engine's background thread, each compared with the port's
   single-stream ``generate``; they must agree token for token except
   where ``generate``'s top-2 logit gap is below 1e-4 * max|logit| (a
   genuine near-tie that reassociating the f32 softmax can flip); every
   paged-attention call on the split family (the family counters, zeroed
   before the pass, as in 4b, 5 and 5c);
   b. the same eight requests and references through (a) an engine built
   under ``PADDLE_TPU_PAGED_ATTN=0`` (decode_gather and a dense softmax),
   (b) a speculative engine (a 2-layer ``depth_draft`` of the same
   weights, ``spec_k=4``) and (c) the same under ``=0``; each pass's
   launches follow its switch, and (b) ran speculative rounds;
5. serving at full width in bf16 (a main path): the 64-request
   shared-prefix load of ``benchmarks/serving.py`` (32 slots, decode chunk
   16, min bucket 16, 32-token blocks), submitted at once after a warm
   pass, run until idle; every request must be served in full, and every
   attention call of the pass must have gone through the CUDA kernel
   (launch count == layers x (decode steps + prefill steps), all counts
   zeroed just before the pass); then a few steady decode chunks traced
   with ``torch.profiler``;
   b. the same pass on an engine built under ``PADDLE_TPU_PAGED_ATTN=0``
   (a main path: the kill switch), its timed load the first 16 of the 64
   requests (``GATHER_LOAD``): every request served in full,
   ``decode_gather`` launched 2 x layers x (decode steps + prefill steps)
   times and ``paged_attention`` never; tok/s, decode-chunk p50 and peak
   memory beside phase 5's pass over the same 16 requests (run just
   before it, held as phase 5's, not profiled), and its decode chunks
   profiled as phase 5's;
   c. speculative decoding at the reference's own speculative
   configuration (``benchmarks/serving.py:421-423``: vocab 2048, 10
   layers, 8 heads, d_model 256, f32, deep layers softened x0.005; the
   same engine geometry and 64-request load; a 1-layer ``depth_draft``,
   ``spec_k=5``): the plain and the speculative engine over the same
   work, the first 8 requests of each held to ``generate`` as in phase
   4, all served in full, no block leaked after idle, and
   ``paged_attention`` launches equal to draft layers x (k+1) per round
   + 10 per verify + prefill steps x 10 (target) and x 1 (draft); the
   accept rate, both engines' tok/s and their ratio;
6. training correctness at full width in f32: the same 12-layer model
   (t=256, b=2) takes two Adam steps through ``Program`` -> ``Executor``
   four times from one startup state: unfused head with attention in the
   CUDA kernels, the same with attention routed to the plain versions (a
   switch that lives in this script only), the fused head through the
   CE kernels, and the unfused head with the backward forced onto the
   split route; losses must agree within 1e-3 relative and every
   parameter's step-1 gradient within the flash (kernels vs plain, split
   vs fused route) and the fused_ce (fused vs unfused head) grad
   tolerance;
7. training at full width in bf16 (a main path, ``bench.py``'s
   flagship): ``transformer.build(vocab 32768, 12 layers, 6 heads,
   d_model 768, max_len 4096, dropout 0, bf16, fused_head=True)``, batch
   8, synthetic next = tok + 1 tokens on a 512-token cycle from
   ``--seed``, five Adam steps on the card: the loss must be finite and
   fall from about ln(32768), the parameters must change, and every
   attention and head call must have gone through the kernels (12 flash
   forward, 12 delta pre-pass, 12 fused flash backward and one launch of
   each CE kernel a step, every flash kernel and the three CE kernels
   on the sm90 family by the family counters, all counts zeroed just
   before the steps); prints
   step wall, tokens/s and peak memory, then where one more step's
   device time goes (``torch.profiler``'s CUDA activity over three
   steps, the middle one counted, by kernel family: it must show as
   many device events as the steps before and after it, and its
   hand-written kernels must be the launches the counters count in it,
   or the profile lost events and the phase fails saying so; then it must
   list ``flash_fwd_sm90_kernel`` and ``flash_bwd_sm90_fused_kernel`` 12
   times each, ``ce_fwd_sm90_kernel``, ``ce_dx_sm90_kernel`` and
   ``ce_dw_sm90_kernel`` once each and no simple CE kernel; CUDA events
   by op type);
   b. the same five steps with ``fused_head=False`` (full depth), for the
   unfused head's peak memory: the fused step's peak must lie at least
   10 GB below it; c. one step of phase 7's program from one startup
   state and batch on each kernel family (sm90 by the rules, simple
   forced: the flash kernels and all three CE kernels): losses within
   1e-3 relative, every parameter's gradient within 1e-2 (max |a - b| /
   max |b|);
8. training at long context (a main path, ``bench.py``'s
   ``BENCH_GPT_TUNE=1`` sequence): the same model at max_len 16384, batch
   8, with ``memory_optimize(policy="selective")``; the memory reckoned
   before the run, then a warm step and three counted Adam steps: the
   same loss and parameter checks, and 12 flash forward, 12 delta
   pre-pass, 12 split dq, 12 split dk/dv (every split kernel on the sm90
   family, by the family counter), 0 fused backward and one launch of
   each CE kernel a step, the forward and the three CE kernels on the
   sm90 family too; step wall, tokens/s, peak memory and the profiled
   step (one launch of each sm90 CE kernel, as in phase 7);
   b. the same path for two steps with no remat and with ``compact``:
   peak memory and step wall beside phase 8's, compact's and selective's
   peaks below no remat's, the three loss trajectories equal to bf16
   rounding; c. one step of phase 8's program from one startup state
   and batch on each kernel family (sm90 by the rules, simple forced,
   the flash forward and the three CE kernels included): the losses
   within 1e-2 relative, every parameter's gradient within the flash
   bf16 grad tolerance;
9. ResNet-50 training (a main path, ``bench.py``'s headline model,
   ``bench_resnet``): ``resnet.build(depth=50, class_dim=1000,
   image_shape=(3, 224, 224), dtype="bfloat16")`` at batch 128 on a
   synthetic batch made on the card from ``--seed``, a warm step and five
   counted Momentum steps: the loss finite, parameters and BN running
   statistics moved, no hand-written kernel launched (every op is
   ATen/cuDNN); img/s, step wall, peak memory beside the activation
   memory reckoned from the program's shapes, one profiled step;
   b. the same model with ``is_test=True`` on the trained state, one
   forward (img/s); then B9 on the NHWC activations entering the second
   stage-1 bottleneck block (sm90) and the second stage-2 block (512 ->
   128 -> 512 at 28x28: the simple family), each with its batch norm
   folded from the trained parameters and running statistics, against
   the port's own forward of that block (2e-2 max-relative), counts
   zeroed before: one launch of each family;
10. phase 7's training through the training loop (a main path, the
   public entry point): ``Trainer(...).train`` over a resumable
   ``reader.batch`` of phase 7's synthetic stream through ``DataFeeder``,
   prefetched two batches ahead, with async step checkpoints every 2
   steps (2 kept) and ``MetricsReporter``'s JSONL, 6 steps at full width
   and depth: the losses finite and falling, 12 flash forwards, 12 delta
   pre-passes, 12 fused backwards and one of each CE kernel a step, all
   sm90 (counts zeroed before the phase; a check beside phases 7 and 8,
   not a source of the kernels line), 6 step records with an ``mfu``, the
   step_6 checkpoint on disk in the JAX package's format (every CRC,
   bf16 under ``'<V2'``, ``__done0__``, the sidecar's torch RNG state);
   prints the Trainer's step wall beside phase 7's ``Executor.run``,
   ``checkpoint.snapshot_ms`` (what ``save()``'s synchronous copy
   blocks), ``checkpoint.save_ms`` and ``checkpoint.bytes`` beside the
   bytes reckoned from the program, and the loop interval after a
   checkpointed step beside the others; a+. ``save()``'s copy once the
   pinned blocks of 10a's saves are back in the host cache; b. the op
   that keeps two runs apart, found by running it twice from one state:
   the flash backward
   at the path shape (the fused kernel's dq atomics) and one whole step
   from the step_4 checkpoint, on the rules' routes and under
   ``torch.use_deterministic_algorithms`` (there it must be the same
   bits); then what determinism costs with no checkpoint write in
   flight, three modes (the rules' fused route, the split route forced
   alone, deterministic algorithms): the flash backward's device time at
   the path shape in turns, and 8 rounds of one ``Executor.run`` step a
   mode (each round's step walls and their differences);
   c. under deterministic algorithms (the flash backward on its split
   route), the same 6 steps; d. a fresh scope and a second Trainer
   with ``resume=True`` from its step_4 checkpoint: steps 5 and 6's
   losses and every parameter after step 6 bit-equal to c's; e. 2 steps
   with ``steps_per_call=2`` from the same start: c's first 2 losses bit
   for bit;
11. the training recipes at full width (main paths: ``Trainer.train``
   and the memory engine's ``offload``):
   a. phase 10's ``Trainer.train`` for 6 steps of phase 7's program with
   ``Adam(learning_rate=polynomial_decay(3e-4, 6, 3e-5),
   regularization=L2Decay(1e-4),
   global_clip=GradientClipByGlobalNorm(1.0))`` and a
   ``ModelAverage(0.999)`` built after ``minimize``: the losses finite
   and falling; 12 flash forwards, 12 pre-passes, 12 fused backwards and
   one of each CE kernel a step, all sm90 (counts zeroed before; a check
   beside phase 7, not a source of the kernels line); the step counter at
   6 and the fetched rate of every step the schedule's closed form; the
   fetched clip factor ``1 / max(@GRAD_NORM@, 1)`` within ORACLE_TOL bf16
   (``@GRAD_NORM@`` is the executor's norm of the gradients before the
   clip, as the reference's); then under ``ModelAverage.apply()`` one
   forward of ``clone(for_test=True)`` on a held-out batch (12 flash
   forwards and one CE forward, no training op), after which every
   parameter is the same tensor with the same bits and the averages and
   the counter are unchanged; the step wall beside phase 10a's plain
   Adam, and the kernels a profiled step of the recipe adds to one of
   phase 7's program;
   a+. every other optimizer (SGD with L1Decay and GradientClipByValue
   on every parameter, Momentum with Nesterov, L1Decay and
   GradientClipByNorm, Adagrad, Adamax, DecayedAdagrad, Adadelta,
   RMSProp with momentum, Ftrl with l1 and l2): its update op on the
   card against the same op on the CPU over the 8 distinct shapes of the
   flagship's 197 parameters (bf16 parameters and a gradient from
   ``--seed``, f32 state),
   max-relative within ORACLE_TOL bf16, then 2 ``Trainer.train`` steps of
   phase 7's program with it, the losses finite;
   b. phase 9's ResNet-50 for 4 steps with ``Momentum(0.9,
   exponential_decay(0.1, 2, 0.1, staircase=True),
   regularization=L2Decay(1e-4))``: the rates read back 0.1, 0.01, 0.01,
   0.001 (the counter advances before the rate is read, as in the
   reference), the losses finite, no hand-written kernel launched;
   c. phase 8's program (t=16384) under deterministic algorithms, 3
   steps of ``selective``, of ``offload`` and of ``offload`` under
   ``PADDLE_TPU_OFFLOAD=0`` from one state and the same batches: the
   losses and every parameter bit-equal, 12 split dq and 12 dk/dv
   launches a step, modes ``off``, ``host``, ``off``; offload's
   ``max_memory_allocated`` strictly below selective's and the kill
   switch's within 64 MiB of it, printed with the bytes sent to the host
   beside the bytes reckoned; then step walls of both policies in
   alternated rounds;
12. the recurrent path (main paths: ``StaticRNN``'s ``scan_block`` and
   the LSTM/GRU and sequence ops, through ``DataFeeder`` and
   ``Executor.run``), f32, Adam at ``build``'s rate, 6 steps on one
   batch, ragged (lengths from t/5 to t) and then full length, from
   fresh startup states: a. ``text_classification`` at the reference's
   ``lstm`` row (``benchmarks/run.py:39-40``: bs64, t=100, hid 512, dict
   10,000, emb 128, two stacked LSTMs); b. ``seq2seq`` at its
   ``seq2seq`` row (``:44-45``: bs64, t=32, dicts 30,000, word 256, hid
   512): the losses finite and the last below the first, no
   hand-written kernel launched (the path reaches none of the table's),
   the median step wall, seq/s, tok/s, ``step_flops``' TFLOP/s, the peak
   memory, and for the full-length run the kernels and busy share of a
   profiled step, each beside the card's name and power limit; c. each
   model at t=16 and hidden 128, batch 16, ragged, one step from one
   startup state on the card and on the port's CPU path (TF32 off): the
   loss within ORACLE_TOL f32 (2e-4) and every parameter's gradient
   within 1e-3 of its largest entry;
13. the rest of the reference's benchmark rows (main paths: the CTC and
   CRF recursions, ``row_conv``, ``lrn``, the decoders, the BiGRU and LSTM
   ops, cuDNN convolutions), each through ``DataFeeder`` and
   ``Executor.run`` from a fresh startup state, 6 steps on one batch made
   from ``--seed`` (DeepSpeech2 4): the losses finite, no hand-written
   kernel launched
   (no TPU kernel lies on these paths), the median step wall, items/s,
   ``step_flops``' TFLOP/s and the peak memory, then the kernels and busy
   share of a profiled step, each beside the card's name and power
   limit: a. DeepSpeech2 at ``benchmarks/run.py``'s ``ds2`` row
   (``:47-49``, BASELINE config 4: b=32, 256 frames of 161 features, 3
   BiGRU layers of 256, vocab 29, labels of width 64 and length 40, f32,
   Adam 5e-4), full length as run.py feeds it, then ragged (128-256
   frames, 20-40 labels): the losses falling, frames/s, the greedy
   decode's mean edit distance to the transcript; a+. the port's
   ``warpctc`` forward and backward timed beside ``F.ctc_loss`` (a
   yardstick not on the path) at that shape, the losses within 2e-4;
   b. run.py's image rows at its bf16 and their builds' Momentum 0.9
   (``smallnet`` b64 32x32, ``alexnet`` b128 227x227, ``googlenet`` b128
   224x224 with its aux heads, ``vgg`` 19 b64 224x224) and LeNet
   (BASELINE config 1: b64 28x28, f32, Adam), with their own dropout:
   img/s; c. the CRF tagger at ``label_semantic_roles.build``'s defaults,
   b=64, lengths 13-64, SGD 0.01: the losses falling, tokens/s, the
   Viterbi token accuracy; d. each of the seven models at the CPU tests'
   size, one step from one startup state with the ``dropout_prob`` attrs
   set to 0, and ``warpctc``, ``row_conv``, ``linear_chain_crf``,
   ``crf_decoding``, ``lrn`` (f32 and bf16), ``ctc_align`` and
   ``edit_distance`` alone at the path shapes, on the card against the
   port's CPU path (TF32 off): losses and outputs within 2e-4, gradients
   within 1e-3 of their largest entry (``lrn`` in bf16: 2e-2, 5e-2),
   decodes equal or a near-tie within 1e-5 (printed);
14. the seq2seq beam decode and the book's small models (main paths:
   ``While`` and its ``while`` op, the tensor arrays, ``beam_search``,
   ``one_hot`` + ``matmul``'s beam regroup; ``cos_sim``, ``sparse_fc``,
   ``auc``), each through ``Executor.run`` from a startup state made from
   ``--seed``, no hand-written kernel launched (no TPU kernel lies on
   these paths): a. ``seq2seq.build_decode`` at ``benchmarks/run.py``'s
   ``seq2seq`` row (``:44-45``: b=64 ragged sources of 4-32 tokens,
   dicts 30,000, word 256, hidden 512, f32) with its own beam 4 and
   ``max_out_len`` 16: the decode wall (device-synced), sentences/s,
   trips, kernels and host syncs a trip (against a decode whose end_id
   bias ends it after one trip), the busy share and the peak memory,
   beside the card's name and power limit; then the card's ids, parents
   and steps against the port's CPU run of the same program and weights:
   equal, scores within 2e-4, or at the first trip that differs, in
   each sample that differs, the k-th and (k+1)-th best totals within
   1e-5 (a near-tie) and the card's k best within 1e-5 of the CPU's rank
   by rank (both printed);
   b. ``fit_a_line``, ``word2vec``, ``recommender``, ``ctr_dnn.build``
   and ``build_sparse_slots`` at the CPU tests' size, one step card vs
   CPU (losses and ``auc`` within 2e-4, gradients within 1e-3 of their
   largest entry), then five steps each at full size on one batch of 256
   (``build``'s defaults; word2vec at imikolov's 2,000-word dictionary;
   ``ctr_dnn`` 100,000 x 8 and 1,000,000 x 4 tables): the last loss
   below the first, step walls, samples/s, peak memory;
15. the SSD detector and the op long tail (a main path: ``prior_box``,
   ``multibox_loss``, ``detection_output`` and the tensor ops; no TPU
   kernel lies on it, so no hand-written kernel launches): a.
   ``ssd.build`` at SSD300's 300x300 input and VOC's 21 classes (27,976
   priors), batch 32 of ``synthetic_batch``, f32: ten Momentum steps
   (losses finite and falling), the step's wall, device time, kernels
   and busy share by a profiled step, the peak memory; the ``is_test``
   program's detections on the trained weights (``[32, 20, 6]``): the
   inference wall, a profiled inference, the NMS loop's launches and
   device time; the host syncs of a step and of an inference by site,
   none inside the detection ops; each number beside the card's name and
   power limit; b. ``ssd.build``'s defaults at the reference test's
   batch 16, one step card vs CPU from one state: the loss within 2e-4,
   gradients within 1e-3 of their largest entry, the detections' labels
   equal (or a swap of scores within 1e-5, printed) and their values
   within 2e-4; c. the slice's 41 op types alone card vs CPU (the
   detection ops at 15a's shapes, each activation with its kinks):
   outputs within 2e-4, gradients within 1e-3;
16. BASELINE config 5, CTR-DNN over the parameter servers (a main path:
   ``distributed``'s RPC, servers and transpiler, ``native``'s recordio,
   the master, ``cloud_reader`` and ``python -m paddle_tpu_torch``; no TPU
   kernel lies on it, so no hand-written kernel launches), at
   ``benchmarks/ctr_pserver.py:28``'s size (tables 4 x 100,000 x 16,
   ``ctr_dnn.build``'s tower, Adam 1e-3), batch 256 of seeded rows, the
   tables on the sparse path: a. 20 steps through four in-process
   loopback servers, serial, then through four ``pserver`` subprocesses
   over TCP found through a FileStore, pipelined: step wall p50 and
   spread, samples/s, bytes a step, kernels a step and the busy share (a
   profiled step), host syncs a step by site, beside the card's name and
   power limit; the losses finite and falling, every table and parameter
   kept in its storage, every scope tensor on the card, syncs only at the
   gradient fetch and the row and parameter installs; b. the loopback run
   against the same run with the trainer on the CPU: losses within 2e-4,
   every parameter within 1e-3 of its largest entry (TF32 off); c. 2,048
   seeded rows to recordio through ``dataset.common.convert``, served by
   a ``master`` subprocess; ``train`` on the card from ``cloud_reader``
   (one pass: exit 0, finite costs, every record once), ``train
   --job=checkgrad`` on a small config (PASSED), ``version`` (the card,
   ``native: available``);
17. sharded training over a device mesh (a main path: ``parallel``, the
   Executor's mesh path, ``Trainer(mesh=...)``, ``distributed.launch``,
   the sharded checkpoints' layout and the comm contracts), as four
   processes that share the card, joined by gloo through a file store
   (NCCL refuses two ranks on one device): a. the flagship at full width
   and 4 of its 12 layers (``MESH_17A_LAYERS``; d768, 6 heads of 128,
   vocab 32,768, t=4096, global batch 8, the fused head, bf16, Adam)
   through ``Trainer(mesh=
   ...)`` with prefetch on dp2 x tp2 (ZeRO-1 over dp; the flash kernels
   on 3 of 6 heads a rank, the CE kernels on 16,384-column vocab shards)
   and on dp2 x fsdp2 (FSDP, ZeRO-3's reduce-scatter), three steps from
   one imported state against the single-process unsharded Trainer on
   the card: losses within ORACLE_TOL bf16 ``fwd`` (2e-2), each
   parameter's update within MESH_UPDATE_TOL of the norm of the
   unsharded run's update (Adam turns bf16-rounding-level gradients into
   ±lr steps of either sign, so entries are not held one by one), with
   three controls that must fail that limit (no update, the last step
   missing, the last step on half the rows); every rank that holds a
   block of a parameter holds it bit for bit alike; every rank's
   ``training_step_contract`` holds on its collective log; the flash
   forward, fused backward and three CE kernels launch on every rank
   (the tp run on the sm90 family); step walls, comm bytes a step by
   kind as they ran, peak memory per rank, beside the card's name and
   power limit; b. two layers of the same widths in
   f32 (TF32 off, the simple kernel families) on dp4, dp2 x tp2 and dp2
   x fsdp2: losses within 2e-4, parameters within 1e-3 of their largest
   entry (a tensor that starts at zero, of the model's); c. phase 10's
   flagship through ``Trainer(mesh=make_mesh({"dp": 1}))`` on a one-rank
   NCCL group equals the mesh-less Trainer bit for bit (deterministic
   algorithms), both step walls printed; b+. 17b's dp4 run with
   ``PADDLE_TPU_COMM_OVERLAP`` on and ``0``, both under deterministic
   algorithms: every parameter block and loss bit for bit alike, and
   the overlapped run started its boundary reductions during the
   backward; d. ``ring_attention(impl=
   "flash")`` on sp=4 at the flagship's attention and the long sequence
   (b=2, t=16384: 4096 a rank, 6 heads of 128, bf16, causal), forward
   and backward: rank r launches the flash forward r + 1 times (the
   future steps skipped), the output and dq, dk, dv held against one
   ``flash_attention`` over the whole sequence on rank 0 within
   ORACLE_TOL bf16, and a small f32 ring against ``impl="dense"``; e.
   ``pipeline_lm`` on pp=4: the flagship's 12 blocks at full width (3 a
   stage, each a pre-LN block on the flash kernels) with its embedding
   and the fused CE head, t=4096, batch 8 in 8 microbatches, bf16, one
   step: the loss and every gradient against the same functions run in
   order on rank 0, and the interleaved schedule (``virtual_stages=3``,
   one block a stage) against GPipe; f. ``moe_ffn`` on ep=4 (8 experts,
   d 768, hidden 3072, 4096 tokens a rank, bf16) forward and backward at
   ``capacity_factor=2.0`` (finite, ``aux`` equal on every rank) and at a
   capacity that drops no token against a dense top-2 on each rank's
   shard;
18. the autotuner on the card (``paddle_tpu_torch.tune``), every cache
   write under a temporary ``PADDLE_TPU_TUNE_CACHE``, never the default
   path: a. ``tune_paged_attention`` at phase 5's decode shape (S=32,
   W=1, h=6, dh=128, B=32, NB=16) in bf16 and in f32, search mode: each
   candidate split count (1, the powers of two up to NB, the rule's)
   held against ``paged_attention_split_ref`` at that count within
   ORACLE_TOL and timed with CUDA events over 50 queued calls (median of
   7), the winner
   persisted under the call's (slots, window, block_tokens); then phase
   4's f32 engine in cached mode takes the f32 winner (``tune.cache_hits``
   > 0, its decode call launched at that count alone, its prefill at the
   rule's) and its tokens on phase 4's eight requests equal an untuned
   engine's, or differ only where ``generate``'s top-2 logit gap is below
   1e-5 (printed); a speculative engine at k=8 with the entry present
   serves two of them (its draft chunk at the winner, its 9-token verify
   window on the simple family) with the tuned engine's tokens; b. ``tune_gpt_step`` at the flagship (t=4096,
   b=8, fused head, bf16) over policies none / selective / compact / full
   x ``block_k`` 1024 (fused backward) and 256 (split), at most 6
   measured, 2 steps x 2 repeats after a warm-up: each candidate's median,
   verdict, route and ``max_memory_allocated`` beside
   ``estimate_gpt_step_hbm``; a winner from at least two measured; c.
   cached mode: ``memory_optimize(policy="auto")`` on a fresh flagship
   applies the winner's policy and blocks, and one ``Trainer`` step
   equals the same program's with the policy spelled out, bit for bit
   under deterministic algorithms; ``PADDLE_TPU_TUNE=0`` resolves ``auto``
   to ``selective``; d. ``python -m paddle_tpu_torch --tune-selftest``
   and ``--spec-selftest`` on the card, exit 0 (run beside 19d's, at the
   end of phase 19); the walls of the phase and its parts;
19. the analysis and attribution layer at the flagship's full width
   (``tune/search.py: flagship_dims``, t=4096, b=8, fused head, bf16):
   a. every run inside ``timed_run()``: the attribution table and the
   lints the Executor folds into the step's first run (zero findings,
   both kernel ops on sm90; the hook's share of that run) beside
   ``attribute_profile`` of a middle step, class by class (ms and
   share): the table's product flops within 1% of ``step_flops``, the
   classes accounting for >= 95% of the profiled step's kernel time,
   each hand-written kernel the steps launched under its own pallas
   family, ``reconcile``'s error against the measured step wall; b.
   ``analysis.lint`` under none / selective / compact / offload, every
   level (the hlo level runs one step for ``max_memory_allocated``):
   zero findings; a budget below the measured peak makes
   ``hlo.hbm-preflight`` fire and strict mode raise; c. a corpus of
   19a's measured steps and phase 18b's tune cache fitted by
   ``tune.fit_and_save``: the card's coefficients, ``hbm_scale`` and
   holdout error; a step lowered after the fit reports the fitted cost
   model; d. ``python -m paddle_tpu_torch --attribution-selftest`` and
   ``--memory-selftest`` on the card, side by side with 18d's two, each
   exit 0;
20. the v1 layer DSL (``paddle_tpu_torch.compat.v1``) and temperature
   sampling: a. run.py's smallnet (b64, 3x32x32, 10 classes, Momentum
   with L2) and lstm rows (b64, t=100, hidden 512, dict 10000, 2
   classes, Adam) written in v1 names, 5 steps each on the card in f32
   (TF32 off) from the card's startup state: the first step's loss
   within 2e-4 and each parameter's update (its norm of the difference)
   within 2e-4 of the port's CPU step from the same state and batch, the
   losses falling, no hand-written kernel launched; then
   ``v1_ext.vgg_16_network`` at run.py's vgg row (b64, 3x224x224, 1000
   classes, bf16), 3 steps: finite losses, the last below the first, its
   ms a step beside phase 13b's VGG-19 row; b. ``v1_ext.
   multi_head_attention`` at the flagship's attention (b=8, t=4096,
   d_model 768, 6 heads, bf16), forward and backward: the flash forward
   and fused backward (rows 4 and 5) launched on the sm90 family, by the
   counters and in a profiled step, and the output and every parameter
   gradient within ORACLE_TOL bf16 of ``layers.multi_head_attention``
   on the same weights; c. the 27 op types the DSL added, each alone on
   the card against the CPU at mid sizes (ints equal, floats within
   2e-4, gradients within 1e-3; ``nce`` on the card's negatives, which
   must also be uniform; ``sampling_id``'s 4096 draws against the row's
   distribution; ``print`` through a Program), one line an op; the
   evaluators ``Accuracy``, ``ChunkEvaluator``, ``EditDistance``,
   ``Auc`` and ``DetectionMAP`` over 10 batches, card against CPU; d.
   ``models.transformer.generate`` at the flagship's width (the LM head
   x6), 8 x 16 prompts, 64 new tokens at temperature 0.8: the same seed
   twice the same tokens; 4096 draws of the first sampled token within
   total variation 0.08 (and a six-sigma chi-square bound) of
   ``softmax(logits / 0.8)`` over its 31 likeliest tokens and the rest;
   temperature 1e-4 the greedy tokens but at near-ties; the walls of
   the phase and its parts;
21. the kernel registry on the card (``kernels/registry.py``) and its
   ``triton`` backend (``kernels/triton_attention.py``): a. auto resolves
   ``cuda`` for all four op classes on CUDA tensors, and the precedence
   and strictness checks pass (``kernels.selftest.check_registry``); b.
   the four Triton kernels alone: the flash forward, dq and dk/dv at the
   training path's shape (b=8, t=4096, h=6, d=128, bf16, causal) against
   the plain versions, and paged attention at phase 5's decode shape
   (bf16) and 5c's verify window (f32) against the plain block scan, all
   within ORACLE_TOL; each timed (CUDA events, median of queued calls
   after a warm-up) beside the cuda backend's kernel for the same work,
   the plain version and SDPA, with rows 1, 4, 6 and 7's bounds; c. three
   flagship steps with ``PADDLE_TPU_KERNEL_BACKEND_FLASH_ATTENTION=
   triton`` from the state and batches of three steps on auto: losses
   within ORACLE_TOL bf16, the step's ``kernel_backends`` naming triton,
   12 launches a step of each Triton flash kernel (counts zeroed before);
   d. (run right after 4b) phase 4's f32 engine with
   ``PADDLE_TPU_KERNEL_BACKEND_PAGED_ATTENTION=triton`` on its eight
   requests: every paged call on the Triton kernel (counts zeroed
   before), the tokens of phase 4's cuda engine or a difference only where
   ``generate``'s top-2 gap is below 1e-5 (printed); e. ``python -m
   paddle_tpu_torch --kernels-selftest`` on the card (a subprocess beside
   4b and 21d), exit 0;
22. one JSON line ``{"kernels": [...]}`` with each of the sixteen kernels'
   launches on its main path (phase 3e, 5, 5b, 7, 8, 9b, 21c or 21d),
   error, times and bound; the paged attention, flash forward, fused
   backward, the three CE rows and the sm90 bottleneck add the simple
   family's time (``simple_ms``), the forward's row its t=16384 entry
   (``t16384``, launches from phase 8), the four Triton rows the cuda
   backend's time at the same shape (``cuda_ms``) and the paged one its
   verify-window entry (``verify``);
23. the last line: ``{"ok": true, "device": {...}}``.

Without a CUDA device, or run from a directory that holds only this
file, it exits non-zero and prints no result.  The weights, the tokens
and the traffic are made from ``--seed``; nothing is read from the
network.
"""

import argparse
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

# the full-width configuration: benchmarks/serving.py's load config
VOCAB, N_LAYER, N_HEAD, D_MODEL, MAX_LEN = 32768, 12, 6, 768, 512
SLOTS, CHUNK, MIN_BUCKET, BLOCK_TOKENS, PREFIX_LEN = 32, 16, 16, 32, 64
CLASSES = [(16, 96), (32, 192), (64, 256), (24, 320)]
REQUESTS = 64
# 5b's timed load: the first 16 of the 64 requests (4 of each class); the
# kill switch's decode is ~2x phase 5's, so the whole load cost ~2 min
GATHER_LOAD = 16
D_HEAD = D_MODEL // N_HEAD
# phase 5c: the reference's own speculative configuration
# (benchmarks/serving.py:421-423): the same engine geometry and load on a
# 10-layer d256 model with 8 heads, f32, its deep layers softened x0.005,
# and a 1-layer depth-pruned draft proposing 5 tokens a round
SPEC_VOCAB, SPEC_LAYERS, SPEC_HEADS, SPEC_D = 2048, 10, 8, 256
SPEC_DRAFT_LAYERS, SPEC_K, SPEC_SCALE = 1, 5, 0.005
# phase 4b: the flagship's draft and window
CHECK_DRAFT_LAYERS, CHECK_SPEC_K = 2, 4
# the training path: tune/search.py flagship_dims at bench.py's sequence
TRAIN_T, TRAIN_B, TRAIN_STEPS, TRAIN_LR = 4096, 8, 5, 1e-3
CHECK_T, CHECK_B = 256, 2          # phase 6's short f32 comparison
# the long-context path: bench.py's BENCH_GPT_TUNE=1 sequence (bench.py:249)
LONG_T, LONG_STEPS = 16384, 3
# phase 7's peak as measured on an NVIDIA H100 80GB HBM3 at 700 W (fused
# head, t=4096, b=8), the base of phase 8's memory reckoning
T4096_FUSED_PEAK = 13.86e9
PATTERN = 512                      # the synthetic tokens cycle through 0..511
# phases 9 and 9b: bench.py's headline model (bench_resnet: ResNet-50,
# 224x224, batch 128, bf16, Momentum)
RESNET_DEPTH, RESNET_CLASSES, RESNET_HW, RESNET_BATCH = 50, 1000, 224, 128
RESNET_STEPS = 5

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg):
    print(msg, flush=True)


def make_params(rng, vocab=VOCAB, n_layer=N_LAYER, d_model=D_MODEL):
    """Seeded random weights at full width, under the JAX package's
    names and [in, out] layout: matrices and embeddings N(0, 0.02),
    LayerNorm scales 1, every bias 0."""
    import numpy as np

    def normal(*shape):
        return (0.02 * rng.standard_normal(shape, dtype=np.float32))

    d, f = d_model, 4 * d_model
    p = {"tok_emb.w": normal(vocab, d), "pos_emb.w.w": normal(MAX_LEN, d)}
    for i in range(n_layer):
        b = f"block{i}_"
        for ln in ("ln1", "ln2"):
            p[b + ln + ".scale"] = np.ones(d, np.float32)
            p[b + ln + ".bias"] = np.zeros(d, np.float32)
        for nm in ("att_q", "att_k", "att_v", "att_out"):
            p[b + nm + ".w"] = normal(d, d)
            p[b + nm + ".b"] = np.zeros(d, np.float32)
        p[b + "ffn1.w"] = normal(d, f)
        p[b + "ffn1.b"] = np.zeros(f, np.float32)
        p[b + "ffn2.w"] = normal(f, d)
        p[b + "ffn2.b"] = np.zeros(d, np.float32)
    p["ln_f.scale"] = np.ones(d, np.float32)
    p["ln_f.bias"] = np.zeros(d, np.float32)
    p["lm_head.w"] = normal(d, vocab)
    return p


def soften_deep_layers(params, draft_layers, scale):
    """``benchmarks/serving.py: soften_deep_layers``: scale the residual
    branch outputs (``att_out`` / ``ffn2``) of every block at depth >=
    ``draft_layers`` toward identity, so a depth-pruned draft of random
    weights approximates its target as a deployed draft does."""
    out = dict(params)
    for k, v in params.items():
        m = re.match(r"block(\d+)_(att_out|ffn2)\.(w|b)$", k)
        if m and int(m.group(1)) >= draft_layers:
            out[k] = v * scale
    return out


@contextlib.contextmanager
def paged_switch(value):
    """``PADDLE_TPU_PAGED_ATTN`` set to ``value`` for the engines built
    inside (the step-callable factories read it once per callable)."""
    old = os.environ.get("PADDLE_TPU_PAGED_ATTN")
    os.environ["PADDLE_TPU_PAGED_ATTN"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["PADDLE_TPU_PAGED_ATTN"]
        else:
            os.environ["PADDLE_TPU_PAGED_ATTN"] = old


def make_workload(rng, n, classes, vocab, prefix_len):
    """n requests cycling through traffic classes; every class shares ONE
    ``prefix_len``-token system prompt ahead of a per-request unique tail
    (``benchmarks/serving.py: make_workload``).  Classes are
    ``(tail_len, max_new)``."""
    import numpy as np

    prefixes = [rng.integers(1, vocab, (prefix_len,)).astype(np.int32)
                for _ in classes]
    work = []
    for i in range(n):
        c = i % len(classes)
        tail, max_new = classes[c]
        prompt = np.concatenate(
            [prefixes[c], rng.integers(1, vocab, (tail,)).astype(np.int32)])
        work.append((prompt, max_new))
    return work


# -- phase 3: the kernel against its plain version ---------------------------

def paged_case(torch, gen, S, W, dtype, nb=16, num_blocks=545, h=N_HEAD,
               dh=D_HEAD):
    """Decode-geometry inputs on the card: distinct random blocks per
    chain, ``pos`` random in [0, 511], chain entries past ``pos`` naming
    the trash block 0, which holds large random garbage."""
    dev = "cuda"
    shape = (num_blocks, BLOCK_TOKENS, h, dh)
    pk = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pv = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pk[0] = 100 * torch.randn(shape[1:], generator=gen, device=dev)
    pv[0] = 100 * torch.randn(shape[1:], generator=gen, device=dev)
    q = torch.randn((S, W, h, dh), generator=gen, device=dev).to(dtype)
    base = torch.randint(0, MAX_LEN - W + 1, (S, 1), generator=gen,
                         device=dev)
    pos = (base + torch.arange(W, device=dev)).to(torch.int32)
    perm = torch.randperm(num_blocks - 1, generator=gen, device=dev) + 1
    table = perm[: S * nb].reshape(S, nb).to(torch.int32)
    live = pos.max(dim=1).values // BLOCK_TOKENS              # last entry
    table[torch.arange(nb, device=dev)[None, :] > live[:, None]] = 0
    return q, pk, pv, table.contiguous(), pos.contiguous()


def rel_err(torch, got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def device_ms(torch, fn, n, reps=3):
    """Device time of ``n`` queued calls of ``fn(i)``, per call, median of
    ``reps``: a long sleep kernel holds the stream while the host
    enqueues, so the events bracket device execution, not Python."""
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000_000)
        e0.record()
        for i in range(n):
            fn(i)
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    return sorted(out)[len(out) // 2]


def paged_check(torch, pa, args, label, dname, family):
    """One call of the wrapper on ``args``: it must take ``family``, give
    finite values and agree with the plain block scan and, for the split
    family, the plain split-and-merge spelling, within ORACLE_TOL; a second
    call must give the same bits.  Returns the max abs error against the
    block scan."""
    before = dict(pa.PAGED_FAMILY_CALLS)
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    torch.cuda.synchronize()
    calls = {f: pa.PAGED_FAMILY_CALLS[f] - before[f] for f in before}
    if calls[family] != 2 or sum(calls.values()) != 2:
        raise AssertionError(f"paged_attention at {label} {dname} ran the "
                             f"families {calls}, expected {family}")
    if not torch.equal(got, again):
        raise AssertionError(f"paged_attention ({family}) at {label} {dname} "
                             f"differs from run to run")
    tol = pa.oracle_tol(args[0].dtype)
    ab, rel = rel_err(torch, got, pa.paged_attention_ref(*args))
    refs = [("block scan", rel)]
    if family == "split":
        S, _, h, _ = args[0].shape
        splits, _ = pa.paged_splits(S, h, args[3].shape[1])
        _, srel = rel_err(torch, got,
                          pa.paged_attention_split_ref(*args, splits))
        refs.append(("split spelling", srel))
    ok = bool(torch.isfinite(got.float()).all()) and all(
        r <= tol for _, r in refs)
    log(f"kernel paged_attention {label:7s} {family:6s} {dname:8s} max_abs_err "
        f"{ab:.3e} rel " + ", ".join(f"{r:.3e} ({n})" for n, r in refs)
        + f" (tol {tol:g}), bit-identical twice {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(
            f"paged_attention ({family}) disagrees with its plain version "
            f"at {label} {dname}: {refs} > {tol}")
    return ab


def paged_turns(torch, pa, fn, n):
    """Device ms of ``n`` calls of ``fn(i)`` on both paged families in
    turns (simple, split, split, simple): ``{family: [ms, ms]}``."""
    times = {}
    for family in ("simple", "split", "split", "simple"):
        with forced_rule(pa, "paged_family", family):
            times.setdefault(family, []).append(device_ms(torch, fn, n))
    if not max(times["split"]) < min(times["simple"]):
        raise AssertionError(f"the split paged kernels ({times['split']} ms) "
                             f"are not faster than the simple one "
                             f"({times['simple']} ms)")
    return times


def kernel_phase(torch, pa):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for label, S, W in (("decode", 32, 1), ("prefill", 1, 1),
                            ("window", 32, 4)):
            args = paged_case(torch, gen, S, W, dtype)
            errs[(label, dname)] = paged_check(torch, pa, args, label, dname,
                                               "split")
            # the simple family, forced, on the same inputs
            with forced_rule(pa, "paged_family", "simple"):
                paged_check(torch, pa, args, label, dname, "simple")

    # timing at the decode shape, bf16: one pool pair per layer, so each
    # call finds its K/V cold in L2 as the 12-layer decode step does
    dtype = torch.bfloat16
    q, _, _, table, pos = paged_case(torch, gen, 32, 1, dtype)
    layers = []
    for _ in range(N_LAYER):
        _, pk, pv, _, _ = paged_case(torch, gen, 32, 1, dtype)
        layers.append((pk, pv))
    reps = 8
    n = reps * N_LAYER
    times = paged_turns(torch, pa, lambda i: pa.paged_attention(
        q, *layers[i % N_LAYER], table, pos), n)
    kernel_ms, simple_ms = min(times["split"]), min(times["simple"])
    plain_ms = device_ms(torch, lambda i: pa.paged_attention_ref(
        q, *layers[i % N_LAYER], table, pos), N_LAYER)
    # the yardstick: one SDPA call over each slot's gathered [S, T, h, dh]
    # view with the j <= pos mask (the gather is set-up, not timed)
    S, NB = table.shape
    T = NB * BLOCK_TOKENS
    idx = table.long()
    gathered = [(pk[idx].reshape(S, T, N_HEAD, D_HEAD).transpose(1, 2),
                 pv[idx].reshape(S, T, N_HEAD, D_HEAD).transpose(1, 2))
                for pk, pv in layers]
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos[:, :1].long())[:, None, None, :]             # [S,1,1,T]
    q4 = q.transpose(1, 2)                                      # [S,h,1,dh]
    lib_out = F.scaled_dot_product_attention(q4, *gathered[0],
                                             attn_mask=mask)
    _, lib_rel = rel_err(torch, lib_out.transpose(1, 2),
                         pa.paged_attention_ref(q, *layers[0], table, pos))
    library_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, *gathered[i % N_LAYER], attn_mask=mask), n)
    # the bound: live K/V read once, q read once, ctx written once, the
    # chain entries and positions read once; 4 flops per live element
    live = int((pos.long() + 1).sum().item())
    esize = q.element_size()
    entries = int((pos.max(dim=1).values // BLOCK_TOKENS + 1).sum().item())
    nbytes = (2 * live * N_HEAD * D_HEAD * esize + 2 * q.numel() * esize
              + 4 * entries + 4 * pos.numel())
    flops = 4 * live * N_HEAD * D_HEAD
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    splits, per = pa.paged_splits(32, N_HEAD, NB)
    log(f"paged_attention decode bf16 (S=32 W=1 h=6 dh=128 B=32 NB=16, "
        f"{live} live tokens, {nbytes} bytes; split family: {splits} splits "
        f"of {per} entries + the merge), in turns simple/split/split/simple "
        + "/".join(f"{x:.4f}" for x in times["simple"][:1] + times["split"]
                   + times["simple"][1:])
        + f" ms: kernel {kernel_ms:.4f} ms ({nbytes / kernel_ms / 1e6:.1f} "
        f"GB/s, {bound_ms / kernel_ms:.3f} of the bound), simple family "
        f"{simple_ms:.4f} ms ({simple_ms / kernel_ms:.2f}x), plain "
        f"{plain_ms:.4f} ms, library (sdpa, rel err {lib_rel:.2e}) "
        f"{library_ms:.4f} ms ({kernel_ms / library_ms:.2f}x), bound "
        f"{bound_ms:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    if not kernel_ms <= library_ms:
        raise AssertionError(
            f"the split paged kernels ({kernel_ms:.4f} ms) are slower than "
            f"SDPA on the gathered view ({library_ms:.4f} ms)")
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:238",
            "max_abs_err": errs[("decode", "bfloat16")],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "simple_ms": simple_ms}


# -- phase 3a+: paged attention at the speculative verify window ------------

def verify_kernel_phase(torch, pa):
    """The kernels at phase 5c's verify shape (S=32, W=k+1=6, h=8, dh=32,
    B=32, NB=16), f32 and bf16, both families, against the plain versions;
    timed in f32, the spec configuration's dtype, both families in turns.
    Returns (ms, plain ms, bound ms, simple ms)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    S, W, h, dh = SLOTS, SPEC_K + 1, SPEC_HEADS, SPEC_D // SPEC_HEADS
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        args = paged_case(torch, gen, S, W, dtype, h=h, dh=dh)
        paged_check(torch, pa, args, "verify", dname, "split")
        with forced_rule(pa, "paged_family", "simple"):
            paged_check(torch, pa, args, "verify", dname, "simple")
    layers = [paged_case(torch, gen, S, W, torch.float32, h=h, dh=dh)
              for _ in range(SPEC_LAYERS)]
    times = paged_turns(torch, pa, lambda i: pa.paged_attention(
        *layers[i % SPEC_LAYERS]), 8 * SPEC_LAYERS)
    ms, simple_ms = min(times["split"]), min(times["simple"])
    plain_ms = device_ms(torch, lambda i: pa.paged_attention_ref(
        *layers[i % SPEC_LAYERS]), SPEC_LAYERS)
    q, _, _, table, pos = layers[0]
    # keys 0..max(pos) of each row's slot are read once per slot (the
    # window's W rows share them), q read and ctx written once
    live = int((pos.long().max(dim=1).values + 1).sum().item())
    nbytes = 2 * live * h * dh * 4 + 2 * q.numel() * 4 + 4 * table.numel()
    flops = 4 * int((pos.long() + 1).sum().item()) * h * dh
    bound_ms = max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["float32"]) * 1e3
    log(f"paged_attention verify f32 (S={S} W={W} h={h} dh={dh} B=32 "
        f"NB=16, {nbytes} bytes), in turns simple/split/split/simple "
        + "/".join(f"{x:.4f}" for x in times["simple"][:1] + times["split"]
                   + times["simple"][1:])
        + f" ms: kernel {ms:.4f} ms ({bound_ms / ms:.3f} of the bound), "
        f"simple family {simple_ms:.4f} ms ({simple_ms / ms:.2f}x), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms")
    return ms, plain_ms, bound_ms, simple_ms


# -- phase 3d: decode_gather against its plain version (bit-exact) -----------

def gather_case(torch, gen, S, NB, B, h, dh, dtype, num_blocks, offset=0):
    """A pool of random blocks (the first ``offset`` blocks cut off the
    front, so the pool's base address moves by a block's bytes) and a
    table of random entries: repeats and the trash block 0 included."""
    pool = torch.randn((num_blocks + offset, B, h, dh), generator=gen,
                       device="cuda").to(dtype)[offset:]
    table = torch.randint(0, num_blocks, (S, NB), generator=gen,
                          device="cuda", dtype=torch.int32)
    table[:, -1] = 0
    table[S // 2:, 0] = int(table[0, 0])
    return pool, table


def gather_phase(torch, dg):
    """The kernel against ``decode_gather_ref`` with ``torch.equal`` at
    the decode shape (bf16, f32), a prefill shape (S=1), ragged blocks
    whose byte count is no multiple of 16 (B=5, h=3, dh=21, at two pool
    base offsets), then its time at the decode shape beside the
    plain version, ``index_select`` and the bound."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    cases = [("decode", SLOTS, 16, BLOCK_TOKENS, N_HEAD, D_HEAD, 545, 0),
             ("prefill", 1, 16, BLOCK_TOKENS, N_HEAD, D_HEAD, 545, 0),
             ("ragged", 7, 9, 5, 3, 21, 40, 0),
             ("ragged+1", 7, 9, 5, 3, 21, 40, 1)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for label, S, NB, B, h, dh, nblk, off in cases:
            pool, table = gather_case(torch, gen, S, NB, B, h, dh, dtype,
                                      nblk, off)
            got = dg.decode_gather(pool, table)
            torch.cuda.synchronize()
            ok = torch.equal(got, dg.decode_gather_ref(pool, table))
            log(f"kernel decode_gather {label:8s} S={S:2d} NB={NB:2d} B={B:2d} "
                f"h={h} dh={dh:3d} {dname:8s} ({B * h * dh * pool.element_size()}"
                f" B a block, pool at +{pool.data_ptr() % 16} mod 16) "
                f"{'bit-exact' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"decode_gather kernel is not bit-exact at {label} "
                    f"{dname}")
    # timing at the decode shape, bf16: distinct chains, one pool per
    # layer so each call finds its blocks cold in L2
    dtype = torch.bfloat16
    layers = []
    for _ in range(N_LAYER):
        pool = torch.randn((545, BLOCK_TOKENS, N_HEAD, D_HEAD),
                           generator=gen, device="cuda").to(dtype)
        perm = torch.randperm(544, generator=gen, device="cuda") + 1
        layers.append((pool, perm[: SLOTS * 16].reshape(SLOTS, 16)
                       .to(torch.int32).contiguous()))
    n = 8 * N_LAYER
    ms = device_ms(torch, lambda i: dg.decode_gather(*layers[i % N_LAYER]), n)
    plain_ms = device_ms(torch, lambda i: dg.decode_gather_ref(
        *layers[i % N_LAYER]), n)

    def library(pool, table):
        S, NB = table.shape
        return torch.index_select(pool, 0, table.flatten()).view(
            S, NB * BLOCK_TOKENS, N_HEAD, D_HEAD)

    if not torch.equal(library(*layers[0]), dg.decode_gather_ref(*layers[0])):
        raise AssertionError("index_select yardstick disagrees")
    library_ms = device_ms(torch, lambda i: library(*layers[i % N_LAYER]), n)
    pool, table = layers[0]
    out_bytes = table.numel() * BLOCK_TOKENS * N_HEAD * D_HEAD * 2
    read_bytes = (int(torch.unique(table).numel()) * BLOCK_TOKENS * N_HEAD
                  * D_HEAD * 2)
    nbytes = read_bytes + out_bytes + 4 * table.numel()
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    log(f"decode_gather decode bf16 (S={SLOTS} NB=16 B=32 h=6 dh=128, "
        f"{out_bytes} B out, {nbytes} B moved): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (index_select) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (bytes)")
    return {"name": "decode_gather", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_gather.cu",
            "replaces": "paddle_tpu/kernels/pallas_gather.py:51",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


# -- phase 3b: the flash kernels against their plain versions ----------------

def _chunked(fn, args, rows=2):
    """The plain version over the batch ``rows`` at a time (it
    materialises [b, h, t, t] scores); same function, same inputs.
    Outputs are batch-major ([b, ...] or [b*h, t]), so they concatenate."""
    import torch

    b = args[0].shape[0]
    outs = [fn(*[a[i:i + rows] for a in args]) for i in range(0, b, rows)]
    return tuple(torch.cat(o) for o in zip(*outs))


def flash_inputs(torch, gen, b, t, h, d, dtype):
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return mk(b, t, h, d), mk(b, t, h, d), mk(b, t, h, d), mk(b, t, h, d)


def plain_bwd(fa, q, k, v, o, lse, do, dlse, causal):
    """The plain backward two batch rows at a time: dq, dk, dv."""
    b, t, h, _ = q.shape
    if dlse is None:
        return _chunked(
            lambda a, b_, c, o_, l_, d_: fa.flash_attention_bwd_ref(
                a, b_, c, o_, l_.reshape(-1, t), d_, None, causal),
            (q, k, v, o, lse.reshape(b, h, t), do))
    return _chunked(
        lambda a, b_, c, o_, l_, d_, dl: fa.flash_attention_bwd_ref(
            a, b_, c, o_, l_.reshape(-1, t), d_, dl.reshape(-1, t), causal),
        (q, k, v, o, lse.reshape(b, h, t), do, dlse.reshape(b, h, t)))


def flash_plain(torch, fa, q, k, v, do, dlse, causal):
    """Plain forward and backward, two batch rows at a time: o, lse
    [b*h, t], dq, dk, dv (and the same with the lse cotangent)."""
    o, lse = _chunked(
        lambda a, b_, c: fa.flash_attention_ref(a, b_, c, causal), (q, k, v))
    return (o, lse, plain_bwd(fa, q, k, v, o, lse, do, None, causal),
            plain_bwd(fa, q, k, v, o, lse, do, dlse, causal))


def flash_rule(fa, dtype, d):
    """The family the rule must give these cases (all with 16-byte aligned
    rows): sm90 for bf16 up to its widest head, else simple."""
    import torch
    return ("sm90" if dtype == torch.bfloat16 and d <= fa.SM90_MAX_D
            else "simple")


def wide_heads():
    """Phases 3b and 3b+'s cases past the sm90 family's d_head 128: the
    simple family at d_head 192 and 256, bf16 and f32."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    return [("d192", 1, 1024, 2, 192, bf16, True),
            ("d256", 2, 1024, 2, 256, bf16, True),
            ("d256 f32 ragged", 1, 333, 2, 256, f32, False),
            ("d192 f32", 1, 512, 2, 192, f32, True)]


def flash_phase(torch, fa):
    """Phase 3b: the forward and the fused backward against their plain
    versions at every case, on the family the rule picks and, where that
    is sm90 (bf16 that TMA can address), on the simple family forced too;
    the fused sm90 route's dk and dv equal to the split sm90 route's at
    the path shape; then both families timed at the path shape in turns
    (simple, sm90, sm90, simple), each sm90 kernel faster than the simple
    one.  Returns the two kernel rows."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("path", TRAIN_B, TRAIN_T, N_HEAD, D_HEAD, bf16, True),
             ("f32", 1, 1024, N_HEAD, D_HEAD, f32, True),
             ("d64", 2, 1024, 4, 64, bf16, True),
             ("non-causal", 1, 1024, N_HEAD, D_HEAD, bf16, False),
             ("ragged", 1, 1000, N_HEAD, D_HEAD, bf16, True),
             ("ragged f32 d64", 1, 333, 2, 64, f32, False)] + wide_heads()
    counts = lambda: (dict(fa.FWD_FAMILY_CALLS), dict(fa.FUSED_FAMILY_CALLS),  # noqa: E731
                      fa.flash_bwd_delta.launches)
    errs = {}
    for label, b, t, h, d, dtype, causal in cases:
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = flash_inputs(torch, gen, b, t, h, d, dtype)
        dlse = torch.randn((b * h, t), generator=gen, device="cuda")
        rule = fa._family(q, k, v, q)
        if rule != flash_rule(fa, dtype, d):
            raise AssertionError(f"the family rule gave {rule} at {label}")
        ro, rlse, rg, rgl = flash_plain(torch, fa, q, k, v, do, dlse, causal)
        worst = {}
        for family in dict.fromkeys((rule, "simple")):
            c0 = counts()
            forced = (forced_family(fa, family) if family != rule
                      else contextlib.nullcontext())
            with forced:
                o, lse = fa.flash_fwd(q, k, v, causal)
                dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, None, causal)
                dq2, dk2, dv2 = fa.flash_bwd(q, k, v, o, lse, do, dlse,
                                             causal)
            torch.cuda.synchronize()
            c1 = counts()
            pre = 2 if family == "sm90" else 0
            got = (c1[0][family] - c0[0][family],
                   c1[1][family] - c0[1][family], c1[2] - c0[2])
            if got != (1, 2, pre) or sum(c1[0].values()) - sum(
                    c0[0].values()) != 1:
                raise AssertionError(
                    f"{family} at {label} launched {got} (forward, fused "
                    f"backward, pre-pass) on its family")
            pairs = [("o", o, ro, "fwd"), ("lse", lse, rlse, "fwd"),
                     ("dq", dq, rg[0], "grad"), ("dk", dk, rg[1], "grad"),
                     ("dv", dv, rg[2], "grad"),
                     ("dq+dlse", dq2, rgl[0], "grad"),
                     ("dk+dlse", dk2, rgl[1], "grad"),
                     ("dv+dlse", dv2, rgl[2], "grad")]
            w = {"fwd": (0.0, 0.0), "grad": (0.0, 0.0)}
            for name, got_, ref, kind in pairs:
                tol = fa.oracle_tol(dtype, kind)
                ab, rel = rel_err(torch, got_, ref)
                if not (bool(torch.isfinite(got_.float()).all())
                        and rel <= tol):
                    raise AssertionError(
                        f"flash attention {name} ({family}) disagrees with "
                        f"its plain version at {label} {dname}: rel "
                        f"{rel:.3e} > {tol}")
                if rel >= w[kind][1]:
                    w[kind] = (ab, rel)
            worst[family] = w
            if family == "sm90" and label == "path":
                # one k-major body: the fused route's dk, dv are the split
                # route's bits
                with forced_route(fa, "split"):
                    split = fa.flash_bwd(q, k, v, o, lse, do, None, causal)
                torch.cuda.synchronize()
                if not (torch.equal(split[1], dk) and torch.equal(split[2], dv)):
                    raise AssertionError("the fused sm90 route's dk, dv "
                                         "differ from the split sm90 route's")
                log(f"kernel flash_attention {label}: the fused sm90 route's "
                    f"dk and dv equal the split sm90 route's bit for bit")
                del split
            del o, lse, dq, dk, dv, dq2, dk2, dv2
        log(f"kernel flash_attention {label:14s} b={b} t={t} h={h} d={d} "
            f"{dname:8s} {'causal' if causal else 'full  '}, with and without "
            f"dlse: " + "; ".join(
                f"{fam} fwd rel {w['fwd'][1]:.3e} grad rel "
                f"{w['grad'][1]:.3e}" for fam, w in worst.items())
            + f" (tol {fa.oracle_tol(dtype, 'fwd'):g} / "
            f"{fa.oracle_tol(dtype, 'grad'):g}; rule: {rule}) ok")
        errs[label] = (worst[rule]["fwd"][0], worst[rule]["grad"][0])
        del q, k, v, do, dlse, ro, rlse, rg, rgl
        torch.cuda.empty_cache()

    # timing at the training path's shape: both families in turns
    b, t, h, d = TRAIN_B, TRAIN_T, N_HEAD, D_HEAD
    q, k, v, do = flash_inputs(torch, gen, b, t, h, d, bf16)
    o, lse = fa.flash_fwd(q, k, v, True)
    times = {}
    for family, n in (("simple", 2), ("sm90", 8), ("sm90", 8), ("simple", 2)):
        with forced_family(fa, family):
            times.setdefault(("fwd", family), []).append(device_ms(
                torch, lambda i: fa.flash_fwd(q, k, v, True), n))
            times.setdefault(("bwd", family), []).append(device_ms(
                torch, lambda i: fa.flash_bwd(q, k, v, o, lse, do, None,
                                              True), n))
    for which in ("fwd", "bwd"):
        if not max(times[(which, "sm90")]) < min(times[(which, "simple")]):
            raise AssertionError(
                f"the sm90 {which} ({times[(which, 'sm90')]} ms) is not "
                f"faster than the simple one ({times[(which, 'simple')]} ms)")
    fwd_ms, bwd_ms = (min(times[(w, "sm90")]) for w in ("fwd", "bwd"))
    plain_fwd_ms = device_ms(torch, lambda i: _chunked(
        lambda a, b_, c: fa.flash_attention_ref(a, b_, c, True),
        (q, k, v)), 1)
    plain_bwd_ms = device_ms(torch, lambda i: plain_bwd(
        fa, q, k, v, o, lse, do, None, True), 1)
    # the yardstick: SDPA on the [b, h, t, d] views of the same tensors
    q4, k4, v4 = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.transpose(1, 2)
    lib_o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    _, lib_rel = rel_err(torch, lib_o.transpose(1, 2), o)

    def lib_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def lib_both(i):
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        torch.autograd.grad(out, (q4, k4, v4), do4)

    lib_fwd_ms = device_ms(torch, lib_fwd, 4)
    lib_bwd_ms = device_ms(torch, lib_both, 4) - lib_fwd_ms
    # bounds: the causal score entries are t (t + 1) / 2 a head; forward
    # q.k^T and p.v (4 d flops an entry), backward five products (10 d)
    entries = b * h * t * (t + 1) // 2
    es = q.element_size()
    fwd_flops, bwd_flops = 4 * d * entries, 10 * d * entries
    fwd_bytes = 4 * q.numel() * es + 4 * lse.numel()
    bwd_bytes = 8 * q.numel() * es + 4 * lse.numel()
    log(f"flash_attention t={t} b={b} bf16 causal, in turns simple/sm90/"
        f"sm90/simple: forward "
        + "/".join(f"{x:.4f}" for x in times[("fwd", "simple")][:1]
                   + times[("fwd", "sm90")] + times[("fwd", "simple")][1:])
        + " ms; fused backward (the sm90 one with its delta pre-pass) "
        + "/".join(f"{x:.4f}" for x in times[("bwd", "simple")][:1]
                   + times[("bwd", "sm90")] + times[("bwd", "simple")][1:])
        + " ms")
    rows = []
    for name, line, src, ms, plain, lib, flops, nbytes, err in (
            ("flash_attention_fwd", 363, "flash_fwd_sm90.cu", fwd_ms,
             plain_fwd_ms, lib_fwd_ms, fwd_flops, fwd_bytes,
             errs["path"][0]),
            ("flash_attention_bwd", 843, "flash_bwd_sm90.cu", bwd_ms,
             plain_bwd_ms, lib_bwd_ms, bwd_flops, bwd_bytes,
             errs["path"][1])):
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        simple = min(times[(name.rsplit("_", 1)[1], "simple")])
        log(f"{name} bf16 causal (b={b} t={t} h={h} d={d}, "
            f"{flops / 1e12:.4f} TFLOP, {nbytes} bytes): kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
            f"bound), simple family {simple:.4f} ms ({simple / ms:.2f}x), "
            f"plain {plain:.4f} ms, library (sdpa, fwd rel err "
            f"{lib_rel:.2e}) {lib:.4f} ms ({ms / lib:.2f}x), bound "
            f"{bound_ms:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/{src}",
                     "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "library_ms": lib, "simple_ms": simple})
    return rows


# -- phase 3b+: the split backward kernels against their plain version -------

@contextlib.contextmanager
def forced_route(fa, route):
    """The backward route forced for a comparison: the budget constant is
    patched here, in this script only (the port reads it at call time)."""
    old = fa.FUSED_BWD_PARTIAL_BYTES
    fa.FUSED_BWD_PARTIAL_BYTES = 0 if route == "split" else 1 << 62
    try:
        yield
    finally:
        fa.FUSED_BWD_PARTIAL_BYTES = old


@contextlib.contextmanager
def forced_rule(mod, rule, family):
    """The kernel family a wrapper of ``mod`` launches, forced for a
    comparison: its static rule (``rule``, looked up by name at each call)
    is patched here, in this script only."""
    real = getattr(mod, rule)
    setattr(mod, rule, lambda *a, **kw: family)
    try:
        yield
    finally:
        setattr(mod, rule, real)


def forced_family(fa, family):
    """The kernel family of every flash launch (forward, fused backward,
    split pair) forced for a comparison."""
    return forced_rule(fa, "bwd_family", family)


def split_vs_fused(torch, fa, split, fused, dtype, family, what):
    """The split route against the fused kernel of the same family: each
    family's fused and dk/dv kernels share one k-major body, so dk and dv
    must be the fused bits; dq, summed in another order, within rounding of
    the input dtype (2**-7 in bf16, 1e-5 of max |dq| in f32).  Returns dq's
    relative difference."""
    limit = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for name, a, b_ in (("dk", split[1], fused[1]), ("dv", split[2], fused[2])):
        if not torch.equal(a, b_):
            raise AssertionError(f"split {name} ({family}) differs from "
                                 f"the fused kernel's at {what}")
    _, rel = rel_err(torch, split[0], fused[0])
    if not rel <= limit:
        raise AssertionError(f"split dq ({family}) vs fused dq rel {rel:.3e} "
                             f"> {limit} at {what}")
    return rel


def split_phase(torch, fa):
    """The split route (delta pre-pass, dq kernel, dk/dv kernel) on both
    kernel families — the one the rule picks and the simple one forced —
    against the plain version at the t=4096 path shape with the route
    forced, and at the small cases; at the t=16384 path shape against the
    fused kernel and, on batch row 0 one head at a time, the plain version;
    then both families' times at t=16384, in turns.  Returns the three
    kernel rows (delta, dq, dk/dv) and the forward's entry at t=16384
    (both families in turns, the plain version, SDPA's forward, the
    bound)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("path t=4096", TRAIN_B, TRAIN_T, N_HEAD, D_HEAD, bf16, True),
             ("f32", 1, 1024, N_HEAD, D_HEAD, f32, True),
             ("d64", 2, 1024, 4, 64, bf16, True),
             ("non-causal", 1, 1024, N_HEAD, D_HEAD, bf16, False),
             ("ragged", 1, 1000, N_HEAD, D_HEAD, bf16, True),
             ("ragged f32 d64", 1, 333, 2, 64, f32, False)] + wide_heads()
    names = ("dq", "dk", "dv")
    counts = lambda: (fa.flash_bwd.launches, fa.flash_bwd_delta.launches,  # noqa: E731
                      fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
                      dict(fa.BWD_FAMILY_CALLS))
    for label, b, t, h, d, dtype, causal in cases:
        dname = str(dtype).replace("torch.", "")
        tol = fa.oracle_tol(dtype, "grad")
        q, k, v, do = flash_inputs(torch, gen, b, t, h, d, dtype)
        dlse = torch.randn((b * h, t), generator=gen, device="cuda")
        o, lse = fa.flash_fwd(q, k, v, causal)
        rule = fa._family(q, k, v, o, do)
        if rule != flash_rule(fa, dtype, d):
            raise AssertionError(f"the family rule gave {rule} at {label}")
        worst, vs_fused = {}, {}
        for dl in (None, dlse):
            ref = plain_bwd(fa, q, k, v, o, lse, do, dl, causal)
            for family in dict.fromkeys((rule, "simple")):
                with forced_route(fa, "fused"), forced_family(fa, family):
                    fused = fa.flash_bwd(q, k, v, o, lse, do, dl, causal)
                c0 = counts()
                with forced_route(fa, "split"), forced_family(fa, family):
                    split = fa.flash_bwd(q, k, v, o, lse, do, dl, causal)
                    again = fa.flash_bwd(q, k, v, o, lse, do, dl, causal)
                c1 = counts()
                torch.cuda.synchronize()
                pre = 2 if family == "sm90" else 0
                got = (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2],
                       c1[3] - c0[3], c1[4][family] - c0[4][family])
                if got != (0, pre, 2, 2, 4):
                    raise AssertionError(
                        f"the forced split route ({family}) launched "
                        f"{got} (fused, delta, dq, dkv, family calls)")
                if not all(torch.equal(a, b_) for a, b_ in zip(split, again)):
                    raise AssertionError(f"split ({family}) gradients differ "
                                         f"from run to run at {label}")
                for name, g_, want in zip(names, split, ref):
                    _, rel = rel_err(torch, g_, want)
                    if not (bool(torch.isfinite(g_.float()).all())
                            and rel <= tol):
                        raise AssertionError(
                            f"split {name} ({family}) disagrees with its "
                            f"plain version at {label} {dname}"
                            f"{' +dlse' if dl is not None else ''}: rel "
                            f"{rel:.3e} > {tol}")
                    worst[family] = max(worst.get(family, 0.0), rel)
                vs_fused[family] = max(vs_fused.get(family, 0.0), split_vs_fused(
                    torch, fa, split, fused, dtype, family, label))
                del split, again, fused
        log(f"kernel flash_attention split {label:14s} b={b} t={t} h={h} "
            f"d={d} {dname:8s} {'causal' if causal else 'full  '}, with and "
            f"without dlse, bit-identical run to run: "
            + "; ".join(f"{fam} grad rel {worst[fam]:.3e} (tol {tol:g}), dk "
                        f"dv the fused {fam} kernel's bits, dq vs fused "
                        f"{vs_fused[fam]:.2e}" for fam in worst)
            + f" (rule: {rule}) ok")
        del q, k, v, do, dlse, o, lse, ref
        torch.cuda.empty_cache()

    # the t=16384 path shape: kernel against kernel, then the plain version
    # on batch row 0, one head at a time ([t, t] f32 scores: 1 GiB a head)
    b, t, h, d = TRAIN_B, LONG_T, N_HEAD, D_HEAD
    if fa.bwd_route((b, t, h, d), t, 2) != "split":
        raise AssertionError("the t=16384 path shape does not route split")
    q, k, v, do = flash_inputs(torch, gen, b, t, h, d, bf16)
    o, lse = fa.flash_fwd(q, k, v, True)
    if fa._family(q, k, v, o, do) != "sm90":
        raise AssertionError("the t=16384 path shape does not take sm90")
    delta = fa.flash_bwd_delta(o, do, None)
    dq = fa.flash_bwd_dq(q, k, v, o, lse, do, None, True, None, delta)
    dk, dv = fa.flash_bwd_dkv(q, k, v, o, lse, do, None, True, None, delta)
    again = (fa.flash_bwd_dq(q, k, v, o, lse, do, None, True, None, delta),
             *fa.flash_bwd_dkv(q, k, v, o, lse, do, None, True, None, delta))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip((dq, dk, dv), again)):
        raise AssertionError("sm90 split gradients differ from run to run "
                             "at t=16384")
    del again
    with forced_route(fa, "fused"):
        fused = fa.flash_bwd(q, k, v, o, lse, do, None, True)
    torch.cuda.synchronize()
    fused_rel = split_vs_fused(torch, fa, (dq, dk, dv), fused, bf16, "sm90",
                               f"t={t} b={b}")
    del fused
    torch.cuda.empty_cache()
    tol = fa.oracle_tol(bf16, "grad")
    errs = {"dq": (0.0, 0.0), "dk": (0.0, 0.0), "dv": (0.0, 0.0)}

    def head(x, bb, hh):
        return x[bb:bb + 1, :, hh:hh + 1].contiguous()

    def plain_head(bb, hh):
        return fa.flash_attention_bwd_ref(
            head(q, bb, hh), head(k, bb, hh), head(v, bb, hh),
            head(o, bb, hh), lse[bb * h + hh:bb * h + hh + 1],
            head(do, bb, hh), None, True)

    for hh in range(h):
        for name, got, want in zip(names, (dq, dk, dv), plain_head(0, hh)):
            ab, rel = rel_err(torch, head(got, 0, hh), want)
            if not (bool(torch.isfinite(got.float()).all()) and rel <= tol):
                raise AssertionError(
                    f"split {name} at t={t} head {hh} disagrees with its "
                    f"plain version: rel {rel:.3e} > {tol}")
            if rel >= errs[name][1]:
                errs[name] = (ab, rel)
    delta_ref = fa.flash_bwd_delta_ref(o, do, None)
    delta_err, delta_rel = rel_err(torch, delta, delta_ref)
    if not delta_rel <= 1e-5:
        raise AssertionError(f"delta pre-pass vs its plain version rel "
                             f"{delta_rel:.3e} > 1e-5")
    log(f"kernel flash_attention split path t={t} b={b} h={h} d={d} bf16 "
        f"causal (sm90): bit-identical run to run; dk, dv the fused sm90 "
        f"kernel's bits, dq vs its dq rel {fused_rel:.2e} (limit 2**-7); "
        f"delta vs plain rel {delta_rel:.2e}; "
        f"batch row 0, every head, against the plain version: "
        + ", ".join(f"{n} rel {errs[n][1]:.3e}" for n in names)
        + f" (tol {tol:g}) ok")

    # times at the t=16384 path shape: both families in turns (simple, sm90,
    # sm90, simple), the pre-pass, and the whole split route
    def launch(family, which):
        with forced_family(fa, family):
            if which == "dq":
                return fa.flash_bwd_dq(q, k, v, o, lse, do, None, True, None,
                                       delta)
            return fa.flash_bwd_dkv(q, k, v, o, lse, do, None, True, None,
                                    delta)

    times = {}
    for family, n in (("simple", 1), ("sm90", 3), ("sm90", 3), ("simple", 1)):
        for which in ("dq", "dkv"):
            ms = device_ms(torch, lambda i: launch(family, which), n)
            times.setdefault((family, which), []).append(ms)
    delta_ms = device_ms(torch, lambda i: fa.flash_bwd_delta(o, do, None), 20)
    plain_delta_ms = device_ms(
        torch, lambda i: fa.flash_bwd_delta_ref(o, do, None), 3)
    route_ms = device_ms(torch, lambda i: fa.flash_bwd(
        q, k, v, o, lse, do, None, True), 3)
    with forced_route(fa, "fused"):
        fused_ms = device_ms(torch, lambda i: fa.flash_bwd(
            q, k, v, o, lse, do, None, True), 1)
    # the forward at t=16384 (phase 8's): both families in turns, held to
    # the plain version on batch row 0, one head at a time
    for family, n in (("simple", 1), ("sm90", 3), ("sm90", 3), ("simple", 1)):
        with forced_family(fa, family):
            times.setdefault((family, "fwd"), []).append(device_ms(
                torch, lambda i: fa.flash_fwd(q, k, v, True), n))
    fwd_ms, fwd_simple = (min(times[(f, "fwd")]) for f in ("sm90", "simple"))
    if not max(times[("sm90", "fwd")]) < fwd_simple:
        raise AssertionError(f"the sm90 forward at t={t} is not faster than "
                             f"the simple one: {times}")
    fwd_errs = {"o": (0.0, 0.0), "lse": (0.0, 0.0)}
    ftol = fa.oracle_tol(bf16, "fwd")
    for hh in range(h):
        ro, rl = fa.flash_attention_ref(head(q, 0, hh), head(k, 0, hh),
                                        head(v, 0, hh), True)
        for name, got, want in (("o", head(o, 0, hh), ro),
                                ("lse", lse[hh:hh + 1], rl)):
            ab, rel = rel_err(torch, got, want)
            if not (bool(torch.isfinite(got.float()).all()) and rel <= ftol):
                raise AssertionError(f"the sm90 forward's {name} at t={t} "
                                     f"head {hh}: rel {rel:.3e} > {ftol}")
            if rel >= fwd_errs[name][1]:
                fwd_errs[name] = (ab, rel)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for bb in range(b):
        for hh in range(h):
            fa.flash_attention_ref(head(q, bb, hh), head(k, bb, hh),
                                   head(v, bb, hh), True)
    e1.record()
    e1.synchronize()
    plain_fwd_ms = e0.elapsed_time(e1)
    torch.cuda.empty_cache()
    # the plain backward, head-chunked: one sweep over every (row, head)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for bb in range(b):
        for hh in range(h):
            plain_head(bb, hh)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    torch.cuda.empty_cache()
    # the yardstick for the pair: SDPA's backward (forward and backward,
    # minus forward) on the [b, h, t, d] views of the same tensors
    q4, k4, v4 = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.transpose(1, 2)

    def lib_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def lib_both(i):
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        torch.autograd.grad(out, (q4, k4, v4), do4)

    lib_fwd_ms = device_ms(torch, lib_fwd, 2)
    lib_bwd_ms = device_ms(torch, lib_both, 2) - lib_fwd_ms
    # bounds: t (t + 1) / 2 causal score entries a head, 2 d flops an
    # entry a product; dq does three products (s, dp, ds.k), dk/dv four
    # (s, dp, p^T.do, ds^T.q); each input read once, each output written.
    # The sm90 kernels read delta [b*h, t] f32 where the simple ones read o;
    # the pre-pass reads o and do and writes delta.
    entries = b * h * t * (t + 1) // 2
    n, es = q.numel(), q.element_size()
    stat = 4 * b * h * t
    sm90 = {w: sorted(times[("sm90", w)])[0] for w in ("dq", "dkv")}
    simple = {w: sorted(times[("simple", w)])[0] for w in ("dq", "dkv")}
    for w in ("dq", "dkv"):
        if not sm90[w] < min(times[("simple", w)]):
            raise AssertionError(
                f"the sm90 {w} kernel ({times[('sm90', w)]} ms) is not faster "
                f"than the simple one ({times[('simple', w)]} ms)")
    fwd_flops = 4 * d * entries
    fwd_bound = fwd_flops / PEAK_FLOPS["bfloat16"] * 1e3
    fwd16k = {"t": t, "ms": fwd_ms, "simple_ms": fwd_simple,
              "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound,
              "bound_by": "operations", "library_ms": lib_fwd_ms,
              "max_abs_err": max(fwd_errs["o"][0], fwd_errs["lse"][0])}
    log(f"flash_attention_fwd t={t} b={b} h={h} d={d} bf16 causal "
        f"({fwd_flops / 1e12:.4f} TFLOP), in turns simple/sm90/sm90/simple: "
        + "/".join(f"{x:.3f}" for x in times[("simple", "fwd")][:1]
                   + times[("sm90", "fwd")] + times[("simple", "fwd")][1:])
        + f" ms; sm90 {fwd_ms:.4f} ms ({fwd_flops / fwd_ms / 1e9:.1f} "
        f"TFLOP/s, {fwd_bound / fwd_ms:.3f} of the bound), simple "
        f"{fwd_simple:.4f} ms ({fwd_simple / fwd_ms:.2f}x), plain (all heads, "
        f"one at a time) {plain_fwd_ms:.3f} ms, library (sdpa forward) "
        f"{lib_fwd_ms:.4f} ms ({fwd_ms / lib_fwd_ms:.2f}x), bound "
        f"{fwd_bound:.4f} ms (operations); batch row 0, every head, against "
        f"the plain version: o rel {fwd_errs['o'][1]:.3e}, lse rel "
        f"{fwd_errs['lse'][1]:.3e} (tol {ftol:g}) ok")
    log(f"flash_attention t={t} b={b} bf16 causal: forward {fwd_ms:.3f} ms, "
        f"fused backward {fused_ms:.3f} ms (the route not taken); split, in "
        f"turns simple/sm90/sm90/simple: dq "
        + "/".join(f"{x:.3f}" for x in times[("simple", "dq")][:1]
                   + times[("sm90", "dq")] + times[("simple", "dq")][1:])
        + " ms, dk/dv "
        + "/".join(f"{x:.3f}" for x in times[("simple", "dkv")][:1]
                   + times[("sm90", "dkv")] + times[("simple", "dkv")][1:])
        + f" ms; delta pre-pass {delta_ms:.4f} ms (plain {plain_delta_ms:.3f}"
        f" ms); the whole split route (pre-pass + sm90 dq + dk/dv) "
        f"{route_ms:.3f} ms against the simple pair's "
        f"{simple['dq'] + simple['dkv']:.3f} ms; plain backward (all heads, "
        f"one at a time) {plain_ms:.3f} ms; library (sdpa) forward "
        f"{lib_fwd_ms:.3f} ms, backward {lib_bwd_ms:.3f} ms (route / sdpa "
        f"backward {route_ms / lib_bwd_ms:.2f}x)")
    rows = []
    for name, line, ms, flops, nbytes, err, plain, lib in (
            ("flash_attention_bwd_delta", 418, delta_ms, 2 * n,
             2 * n * es + stat, delta_err, plain_delta_ms, None),
            ("flash_attention_bwd_dq", 900, sm90["dq"], 6 * d * entries,
             5 * n * es + 2 * stat, errs["dq"][0], plain_ms, lib_bwd_ms),
            ("flash_attention_bwd_dkv", 921, sm90["dkv"], 8 * d * entries,
             6 * n * es + 2 * stat, max(errs["dk"][0], errs["dv"][0]),
             plain_ms, lib_bwd_ms)):
        # the pre-pass's multiply-adds run on the CUDA cores in f32
        peak = PEAK_FLOPS["float32" if name.endswith("delta") else "bfloat16"]
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        old = simple.get(name.rsplit("_", 1)[1])
        log(f"{name} bf16 causal (b={b} t={t} h={h} d={d}, "
            f"{flops / 1e12:.4f} TFLOP, {nbytes} bytes): kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
            f"bound)" + (f", simple family {old:.4f} ms ({old / ms:.2f}x)"
                         if old else "")
            + f", plain {plain:.4f} ms"
            + (f", library (sdpa backward, for the pair) {lib:.4f} ms"
               if lib else ", library none")
            + f", bound {bound_ms:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/flash_bwd_sm90.cu",
                     "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "library_ms": lib})
    del q, k, v, do, o, lse, delta, delta_ref, dq, dk, dv, q4, k4, v4, do4
    torch.cuda.empty_cache()
    return rows, fwd16k


# -- phase 3c: the fused cross-entropy kernels against their plain versions --

def ce_inputs(torch, gen, n, d, v, dtype, out_of_range=True):
    """Seeded inputs on the card: logits of unit scale; labels -1 and V in
    some rows (out of range: loss = lse, no onehot term), or only -1 (the
    training path's padding, which the library's ``ignore_index`` takes);
    a loss cotangent with zeros, as masked rows give."""
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d, v), generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    y[1::7] = -1
    if out_of_range:
        y[3::11] = v
    g = torch.randn((n,), generator=gen, device="cuda")
    g[2::5] = 0.0
    return x, w, y, g


def ce_phase(torch, ce):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5678)
    bf16, f32 = torch.bfloat16, torch.float32
    tokens = TRAIN_B * TRAIN_T
    # d = 1024 and the reference's own d = 2048, V = 50,000
    # (tests/test_fused_ce.py) past the sm90 family's d <= 768: the simple
    # family's d-chunks
    cases = [("path", tokens, D_MODEL, VOCAB, bf16),
             ("f32", CHECK_B * CHECK_T, D_MODEL, VOCAB, f32),
             ("ragged", 1000, 200, 5000, bf16),
             ("ragged f32", 1000, 200, 5000, f32),
             ("d1024", 4096, 1024, VOCAB, bf16),
             ("d2048", 2048, 2048, 50000, bf16),
             ("d1024 f32", 512, 1024, 5000, f32)]
    errs = {}
    tables = {"forward": ce.CE_FWD_FAMILY_CALLS, "dx": ce.CE_DX_FAMILY_CALLS,
              "dW": ce.CE_DW_FAMILY_CALLS}
    for label, n, d, v, dtype in cases:
        dname = str(dtype).replace("torch.", "")
        x, w, y, g = ce_inputs(torch, gen, n, d, v, dtype)
        before = {k: dict(t) for k, t in tables.items()}
        loss, lse = ce.ce_fwd(x, w, y)
        loss2, lse2 = ce.ce_fwd(x, w, y)
        dx = ce.ce_dx(x, w, y, lse, g)
        dx2 = ce.ce_dx(x, w, y, lse, g)
        dw = ce.ce_dw(x, w, y, lse, g)
        dw2 = ce.ce_dw(x, w, y, lse, g)
        torch.cuda.synchronize()
        family = ("sm90" if dtype == bf16 and d <= ce.SM90_MAX_D
                  else "simple")
        calls = {k: {f: t[f] - before[k][f] for f in t}
                 for k, t in tables.items()}
        want = {k: {"sm90": 0, "simple": 0, family: 2} for k in tables}
        if calls != want:
            raise AssertionError(f"fused CE at {label} {dname} ran the "
                                 f"families {calls}, expected {family}")
        for name, a, b_ in (("loss", loss, loss2), ("lse", lse, lse2),
                            ("dx", dx, dx2), ("dW", dw, dw2)):
            if not torch.equal(a, b_):
                raise AssertionError(f"fused CE {name} ({family}) at {label} "
                                     f"{dname} differs from run to run")
        del loss2, lse2, dx2, dw2
        rloss, rlse = ce.fused_ce_ref(x, w, y)
        rdx, rdw = ce.fused_ce_bwd_ref(x, w, y, rlse, g)
        worst = {"fwd": (0.0, 0.0), "grad": (0.0, 0.0)}
        for name, got, ref, kind in (("loss", loss, rloss, "fwd"),
                                     ("lse", lse, rlse, "fwd"),
                                     ("dx", dx, rdx, "grad"),
                                     ("dW", dw, rdw, "grad")):
            tol = ce.oracle_tol(dtype, kind)
            ab, rel = rel_err(torch, got, ref)
            if not (bool(torch.isfinite(got.float()).all()) and rel <= tol):
                raise AssertionError(
                    f"fused CE {name} disagrees with its plain version at "
                    f"{label} {dname}: rel {rel:.3e} > {tol}")
            if rel >= worst[kind][1]:
                worst[kind] = (ab, rel)
        out = (y < 0) | (y >= v)
        if not torch.equal(loss[out], lse[out]):
            raise AssertionError("an out-of-range label changed the loss")
        log(f"kernel fused_ce {label:10s} N={n} d={d} V={v} {dname:8s} "
            f"fwd rel {worst['fwd'][1]:.3e} (tol {ce.oracle_tol(dtype):g}) "
            f"grad rel {worst['grad'][1]:.3e} (tol "
            f"{ce.oracle_tol(dtype, 'grad'):g}); forward, dx and dW on the "
            f"{family} family, each bit-identical twice ok")
        errs[label] = (worst["fwd"][0], worst["grad"][0])
        del x, w, y, g, loss, lse, dx, dw, rloss, rlse, rdx, rdw
        torch.cuda.empty_cache()

    # timing at the training path's shape, labels in range but for the
    # -1 padding (the library call's ignore_index)
    n, d, v = tokens, D_MODEL, VOCAB
    x, w, y, g = ce_inputs(torch, gen, n, d, v, bf16, out_of_range=False)
    loss, lse = ce.ce_fwd(x, w, y)
    times = {"forward": ce_turns(torch, ce, lambda i: ce.ce_fwd(x, w, y),
                                 "forward"),
             "dx": ce_turns(torch, ce, lambda i: ce.ce_dx(x, w, y, lse, g),
                            "dx"),
             "dW": ce_turns(torch, ce, lambda i: ce.ce_dw(x, w, y, lse, g),
                            "dW")}
    best = {k: (min(t["sm90"]), min(t["simple"])) for k, t in times.items()}
    plain_fwd_ms = device_ms(torch, lambda i: ce.fused_ce_ref(x, w, y), 1)
    plain_dx_ms = device_ms(
        torch, lambda i: ce.fused_ce_dx_ref(x, w, y, lse, g), 1)
    plain_dw_ms = device_ms(
        torch, lambda i: ce.fused_ce_dw_ref(x, w, y, lse, g), 1)
    torch.cuda.empty_cache()
    # the yardstick: torch.matmul (bf16 logits) + F.cross_entropy on the
    # f32 logits, reduction "none"; its backward by autograd, for x alone
    # (dx) and for w alone (dW).  No single PyTorch call computes the head.
    yl = y.long()

    def lib_loss(a, b):
        return F.cross_entropy(torch.matmul(a, b).float(), yl,
                               reduction="none", ignore_index=-1)

    with torch.no_grad():
        lib_out = lib_loss(x, w)
    keep = yl >= 0
    _, lib_rel = rel_err(torch, lib_out[keep], loss[keep])
    del lib_out

    def lib_fwd(i):
        with torch.no_grad():
            lib_loss(x, w)

    lib_fwd_ms = device_ms(torch, lib_fwd, 3)
    lib_bwd = []
    for which in (0, 1):
        xr = x.detach().requires_grad_(which == 0)
        wr = w.detach().requires_grad_(which == 1)
        out = lib_loss(xr, wr)
        wrt = xr if which == 0 else wr
        lib_bwd.append(device_ms(torch, lambda i: torch.autograd.grad(
            out, wrt, g, retain_graph=True), 3))
        del out, xr, wr, wrt
        torch.cuda.empty_cache()
    # bounds: 2 N d V flops a product (one forward, two in dx and dW);
    # each input read once, each output written once
    prod = 2 * n * d * v
    es = x.element_size()
    io = x.numel() * es + w.numel() * es + 4 * n        # x, w, y
    lib_of = {"forward": lib_fwd_ms, "dx": lib_bwd[0], "dW": lib_bwd[1]}
    for kind, t in times.items():
        log(f"fused_ce {kind} bf16 path, in turns simple/sm90/sm90/simple "
            + "/".join(f"{v_:.4f}" for v_ in t["simple"][:1] + t["sm90"]
                       + t["simple"][1:])
            + f" ms: sm90 {best[kind][0]:.4f} ms, "
            f"{best[kind][1] / best[kind][0]:.2f}x the simple family, "
            f"{best[kind][0] / lib_of[kind]:.3f}x the library call "
            f"({lib_of[kind]:.4f} ms)")
    rows = []
    for kind, name, line, src, plain, flops, nbytes, err in (
            ("forward", "fused_ce_fwd", 153, "fused_ce_fwd_dx_sm90.cu",
             plain_fwd_ms, prod, io + 8 * n, errs["path"][0]),
            ("dx", "fused_ce_dx", 198, "fused_ce_fwd_dx_sm90.cu",
             plain_dx_ms, 2 * prod, io + 8 * n + x.numel() * es,
             errs["path"][1]),
            ("dW", "fused_ce_dw", 211, "fused_ce_sm90.cu", plain_dw_ms,
             2 * prod, io + 8 * n + w.numel() * es, errs["path"][1])):
        ms, simple_ms = best[kind]
        lib = lib_of[kind]
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"{name} bf16 (N={n} d={d} V={v}, {flops / 1e12:.4f} TFLOP, "
            f"{nbytes} bytes): kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
            f"bound), simple family {simple_ms:.4f} ms, plain {plain:.4f} "
            f"ms, library (matmul + cross_entropy"
            f"{'' if line == 153 else ' backward'}, loss rel err "
            f"{lib_rel:.2e}) {lib:.4f} ms, bound {bound_ms:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        rows.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/{src}",
                     "replaces": f"paddle_tpu/ops/pallas_ce.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "library_ms": lib, "simple_ms": simple_ms})
    return rows


def ce_turns(torch, ce, fn, kind, n=2):
    """Device ms of ``n`` calls of ``fn(i)`` (one CE kernel's wrapper) on
    both families in turns (simple, sm90, sm90, simple; the simple one
    forced by a patch of the rule): ``{family: [ms, ms]}``; the sm90
    kernel must win."""
    times = {}
    for family in ("simple", "sm90", "sm90", "simple"):
        with forced_rule(ce, "ce_family", family):
            times.setdefault(family, []).append(device_ms(torch, fn, n))
    if not max(times["sm90"]) < min(times["simple"]):
        raise AssertionError(f"the sm90 CE {kind} ({times['sm90']} ms) is "
                             f"not faster than the simple one "
                             f"({times['simple']} ms)")
    return times


def ce_long_phase(torch, ce):
    """The CE kernels at phase 8's row count (N = b * 16384 = 131072, d=768,
    V=32768, bf16), the first time they see that many rows: the forward and
    dx against their plain versions run over 16384-row chunks, and the
    three kernels' times on both families in turns."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8765)
    n, d, v = TRAIN_B * LONG_T, D_MODEL, VOCAB
    x, w, y, g = ce_inputs(torch, gen, n, d, v, torch.bfloat16,
                           out_of_range=False)
    loss, lse = ce.ce_fwd(x, w, y)
    dx = ce.ce_dx(x, w, y, lse, g)
    torch.cuda.synchronize()
    chunk = 16384
    refs = {"loss": [], "lse": [], "dx": []}
    for i in range(0, n, chunk):
        rl, rs = ce.fused_ce_ref(x[i:i + chunk], w, y[i:i + chunk])
        refs["loss"].append(rl)
        refs["lse"].append(rs)
        refs["dx"].append(ce.fused_ce_dx_ref(
            x[i:i + chunk], w, y[i:i + chunk], lse[i:i + chunk],
            g[i:i + chunk]))
    refs = {k: torch.cat(v_) for k, v_ in refs.items()}
    errs = {}
    for name, got, kind in (("loss", loss, "fwd"), ("lse", lse, "fwd"),
                            ("dx", dx, "grad")):
        tol = ce.oracle_tol(torch.bfloat16, kind)
        _, rel = rel_err(torch, got, refs[name])
        if not (bool(torch.isfinite(got.float()).all()) and rel <= tol):
            raise AssertionError(f"fused CE {name} at N={n} disagrees with "
                                 f"its plain version: rel {rel:.3e} > {tol}")
        errs[name] = rel
    del refs, dx
    torch.cuda.empty_cache()
    times = {"forward": ce_turns(torch, ce, lambda i: ce.ce_fwd(x, w, y),
                                 "forward"),
             "dx": ce_turns(torch, ce, lambda i: ce.ce_dx(x, w, y, lse, g),
                            "dx"),
             "dW": ce_turns(torch, ce, lambda i: ce.ce_dw(x, w, y, lse, g),
                            "dW")}
    prod = 2 * n * d * v
    log(f"kernel fused_ce path N={n} d={d} V={v} bfloat16: loss rel "
        f"{errs['loss']:.3e}, lse rel {errs['lse']:.3e}, dx rel "
        f"{errs['dx']:.3e} (plain over {chunk}-row chunks) ok; bounds "
        f"{prod / PEAK_FLOPS['bfloat16'] * 1e3:.4f} (forward) / "
        f"{2 * prod / PEAK_FLOPS['bfloat16'] * 1e3:.4f} ms (operations)")
    for kind, t in times.items():
        flops = prod if kind == "forward" else 2 * prod
        ms, simple = min(t["sm90"]), min(t["simple"])
        log(f"  fused_ce {kind} N={n}: in turns simple/sm90/sm90/simple "
            + "/".join(f"{v_:.4f}" for v_ in t["simple"][:1] + t["sm90"]
                       + t["simple"][1:])
            + f" ms: sm90 {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"{simple / ms:.2f}x the simple family")
    del x, w, y, g, loss, lse
    torch.cuda.empty_cache()


# -- phase 3e: the fused bottleneck against its plain version ----------------

def bottleneck_turns(torch, bn, args, n=2):
    """Device ms of the bottleneck at ``args`` on each family in turns
    (simple, sm90, sm90, simple), ``n`` calls a turn: ``{family:
    [ms, ms]}``."""
    times = {"sm90": [], "simple": []}
    for family in ("simple", "sm90", "sm90", "simple"):
        times[family].append(device_ms(
            torch, lambda i: bn.bottleneck(*args, family=family), n))
    return times


def bottleneck_phase(torch, kernels, bn, bench):
    """B9: every case on the family the rule picks (sm90 for bf16 with
    Cm = 64, Cin = Cout a multiple of 64 up to 256, W <= 64: the script's
    shape N=128, 56x56, 256 -> 64 -> 256, a small batch whose images split
    into strips with an odd last one, W = 64 at Cin 192, H = W = 1; simple
    for a small f32 shape, a height no band divides at Cm=72 in bf16 and
    f32, and channel counts no multiple of 8), each against
    ``bottleneck_ref`` and the same bits twice; the sm90 cases also against
    the simple family forced; the two families' times at the script's shape
    in turns (simple, sm90, sm90, simple; the sm90 kernel must win every
    turn) beside the plain version, the cuDNN composition and the bound;
    then the path — the script's experiment through its entry point,
    ``paddle_tpu_torch.benchmarks.bottleneck.main`` — with every count
    zeroed just before it and read just after: every launch on sm90.
    Returns the simple family's row and the sm90 family's."""
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("script shape", bench.H, bench.W, bench.CIN, bench.CM, 128,
              bf16),
             ("strips", 13, 13, 128, 64, 6, bf16),
             ("W64 C192", 9, 64, 192, 64, 3, bf16),
             ("H1 W1", 1, 1, 64, 64, 5, bf16),
             ("small", 16, 16, 32, 8, 4, f32),
             ("ragged H", 13, 11, 48, 72, 3, bf16),
             ("ragged H", 13, 11, 48, 72, 3, f32),
             ("odd C", 9, 7, 36, 12, 2, bf16)]
    path_err = {}
    for label, h, w, cin, cm, n, dtype in cases:
        args = bench.make_inputs(n, "cuda", dtype=dtype, h=h, w=w, cin=cin,
                                 cm=cm)
        before = dict(bn.BOTTLENECK_FAMILY_CALLS)
        got = bn.bottleneck(*args)
        again = bn.bottleneck(*args)
        torch.cuda.synchronize()
        family = bn.bottleneck_family(dtype, h, w, cin, cm, [
            t.data_ptr() for t in args[:4] + (got,)])
        want_family = ("sm90" if dtype == bf16 and cm == 64 and cin % 64 == 0
                       else "simple")
        calls = {f: bn.BOTTLENECK_FAMILY_CALLS[f] - before[f]
                 for f in before}
        if family != want_family or calls[family] != 2 or sum(
                calls.values()) != 2:
            raise AssertionError(f"bottleneck {label}: the rule gave "
                                 f"{family}, the launches {calls}")
        if not torch.equal(got, again):
            raise AssertionError(f"bottleneck {label} ({family}) differs "
                                 f"from run to run")
        want = bn.bottleneck_ref(*args)
        d, rel = rel_err(torch, got, want)
        tol = bn.oracle_tol(dtype)
        if family == "sm90":
            how = f"strips of {bn.strip_rows(n, h)} rows"
            _, vs_simple = rel_err(torch, got,
                                   bn.bottleneck(*args, family="simple"))
            how += f", {vs_simple:.3e} from the simple family"
        else:
            tc = bn.uses_tensor_cores(*args[:4], got)
            band = bn.band_rows(h, w, cm, dtype, tc)
            how = (f"{'tensor cores' if tc else 'FMA'}, band {band} rows, "
                   f"{-(-h // band)} bands")
        log(f"kernel bottleneck {label:12s} N={n:3d} H={h} W={w} C={cin} "
            f"Cm={cm} {str(dtype)[6:]:8s} {family} ({how}), the same bits "
            f"twice: max abs err {d:.3e}, rel {rel:.3e} (tol {tol:g})")
        if not (rel <= tol and torch.isfinite(got.float()).all()):
            raise AssertionError(f"bottleneck kernel disagrees at {label} "
                                 f"{dtype}: rel {rel:.3e}")
        if family == "sm90" and vs_simple > tol:
            raise AssertionError(f"the bottleneck families disagree at "
                                 f"{label}: rel {vs_simple:.3e}")
        path_err.setdefault(family, d)
        del args, got, again, want
    # timing at the script's shape: both families in turns
    args = bench.make_inputs(128, "cuda")
    x = args[0]
    times = bottleneck_turns(torch, bn, args, 5)
    if not max(times["sm90"]) < min(times["simple"]):
        raise AssertionError(f"the sm90 bottleneck lost a turn to the "
                             f"simple family: {times}")
    ms, simple_ms = min(times["sm90"]), min(times["simple"])
    plain_ms = device_ms(torch, lambda i: bn.bottleneck_ref(*args), 3)

    # the yardstick the port never calls: the three convolutions on cuDNN
    # in bf16, channels_last (x's NHWC memory as an NCHW view), with the
    # same epilogues in bf16
    x_cl = x.permute(0, 3, 1, 2)
    w1, w2, w3 = args[1:4]
    f1 = w1.t()[:, :, None, None].contiguous(
        memory_format=torch.channels_last)
    f2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    f3 = w3.t()[:, :, None, None].contiguous(
        memory_format=torch.channels_last)
    s1, b1, s2, b2, s3, b3 = (v.to(x.dtype)[None, :, None, None]
                              for v in args[4:])

    def library():
        y = torch.relu(F.conv2d(x_cl, f1) * s1 + b1)
        y = torch.relu(F.conv2d(y, f2, padding=1) * s2 + b2)
        return torch.relu(F.conv2d(y, f3) * s3 + b3 + x_cl)

    lib_rel = rel_err(torch, library().permute(0, 2, 3, 1),
                      bn.bottleneck_ref(*args))[1]
    library_ms = device_ms(torch, lambda i: library(), 5)
    n, h, w, c = x.shape
    cm = w1.shape[1]
    flops = 2 * n * h * w * (c * cm + 9 * cm * cm + cm * c)
    nbytes = 2 * x.numel() * x.element_size()
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms > bytes_ms else "bytes"
    log(f"bottleneck bf16 (N={n} {h}x{w} {c}->{cm}->{c}, "
        f"{flops / 1e9:.2f} GFLOP, {nbytes} B), in turns simple/sm90/sm90/"
        f"simple " + "/".join(f"{v_:.4f}" for v_ in times["simple"][:1]
                              + times["sm90"] + times["simple"][1:])
        + f" ms: sm90 {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound_ms / ms:.3f} of the bound, {simple_ms / ms:.2f}x the simple "
        f"family's {simple_ms:.4f} ms), plain {plain_ms:.4f} ms, library (3 "
        f"cuDNN convs channels_last + epilogues, rel {lib_rel:.2e} to plain) "
        f"{library_ms:.4f} ms ({library_ms / ms:.2f}x the sm90 kernel), bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    del args, x, x_cl, f1, f2, f3
    torch.cuda.empty_cache()
    # the path: the reference experiment through its entry point
    kernels.reset_launches()
    if bench.main(["--batch", "128"]) != 0:
        raise AssertionError("the bottleneck experiment failed")
    launches = kernels.launch_counts()
    fams = kernels.family_counts()["bottleneck"]
    log("launches during the bottleneck experiment: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()) + f"; by family {fams}")
    if launches["bottleneck"] < 1 or any(
            v for k, v in launches.items() if k != "bottleneck"):
        raise AssertionError(f"the bottleneck experiment did not go "
                             f"through its kernel alone: {launches}")
    if fams != {"sm90": launches["bottleneck"], "simple": 0}:
        raise AssertionError(f"the bottleneck experiment launched another "
                             f"family than sm90: {fams}")
    torch.cuda.empty_cache()
    row = {"route": "cuda", "replaces": "benchmarks/bottleneck_pallas.py:111",
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    return (dict(row, name="bottleneck",
                 source="paddle_tpu_torch/csrc/bottleneck.cu",
                 max_abs_err=path_err["simple"], ms=simple_ms),
            dict(row, name="bottleneck_sm90",
                 source="paddle_tpu_torch/csrc/bottleneck_sm90.cu",
                 launches=fams["sm90"], max_abs_err=path_err["sm90"], ms=ms,
                 simple_ms=simple_ms))


# -- phase 4: full-width f32 served vs single-stream -------------------------

def generate_refs(torch, params, work, n_layer, n_head, d_model):
    """The port's single-stream ``generate`` on each request in f32:
    ``(tokens, logits)`` per request, the bar every served pass is held
    to."""
    from paddle_tpu_torch.models.transformer import (generate,
                                                     params_from_numpy)

    p32 = params_from_numpy(params, "cuda", torch.float32)
    refs = []
    for prompt, max_new in work:
        toks, logits = generate(p32, prompt[None],
                                max_len=len(prompt) + max_new,
                                n_layer=n_layer, n_head=n_head,
                                d_model=d_model, device="cuda")
        refs.append((toks[0].cpu().numpy(), logits[0]))
    return refs


def hold_to_generate(torch, np, outs, work, refs, what):
    """Every served output equal to ``generate``'s token for token, except
    from a first divergence where ``generate``'s top-2 logit gap is below
    1e-4 * max|logit| (a genuine near-tie that reassociating f32 sums can
    flip).  Returns how many are token-identical."""
    full = 0
    for k, ((prompt, _), out, (ref, logits)) in enumerate(
            zip(work, outs, refs)):
        if out.shape != ref.shape:
            raise AssertionError(
                f"{what} request {k}: {out.shape} vs {ref.shape}")
        diff = np.nonzero(out != ref)[0]
        if diff.size == 0:
            full += 1
            continue
        i = int(diff[0])
        lg = logits[i - 1]
        top = torch.topk(lg, 2).values
        gap = (top[0] - top[1]).item()
        limit = 1e-4 * lg.abs().max().item()
        log(f"  {what} request {k}: served and generate diverge at position "
            f"{i} (prompt {len(prompt)}), top-2 gap {gap:.3e} vs near-tie "
            f"limit {limit:.3e}")
        if not gap < limit:
            raise AssertionError(
                f"{what} request {k} diverges from generate at position {i} "
                f"where generate's top-2 gap {gap:.3e} is no near-tie")
    return full


def serve_f32(params, work, **kw):
    """Serve ``work`` through an f32 engine's background thread at the
    flagship geometry; returns the outputs and the engine."""
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.serving import ServingEngine

    obs.get_registry().clear(prefix="serving.")
    eng = ServingEngine(params, N_LAYER, N_HEAD, D_MODEL, max_len=MAX_LEN,
                        max_slots=SLOTS, decode_chunk=CHUNK,
                        min_bucket=MIN_BUCKET, block_tokens=BLOCK_TOKENS,
                        compute_dtype="float32", prefix_reuse=True, **kw)
    eng.start()
    try:
        reqs = [eng.submit(p, m) for p, m in work]
        outs = [r.result(timeout=900) for r in reqs]
    finally:
        eng.stop()
    return outs, eng


def paged_on_split(kernels, what):
    """The paged-attention calls since the last reset all ran the split
    family (the serving paths' shapes).  Returns their count."""
    fams = kernels.family_counts()["paged_attention"]
    if fams["simple"] or not fams["split"]:
        raise AssertionError(f"{what}: paged attention ran the families "
                             f"{fams}, expected every call on split")
    return fams["split"]


def correctness_phase(torch, np, params, work, kernels):
    """Phase 4; returns the ``generate`` references and the served
    outputs."""
    kernels.reset_launches()
    outs, eng = serve_f32(params, work)
    split = paged_on_split(kernels, "phase 4")
    hit = eng.stats().get("serving.prefix_hit_rate", 0.0)
    del eng
    refs = generate_refs(torch, params, work, N_LAYER, N_HEAD, D_MODEL)
    full = hold_to_generate(torch, np, outs, work, refs, "f32")
    log(f"f32 full width: {full}/{len(work)} requests token-identical to "
        f"generate, the rest diverge only at near-ties "
        f"(prefix hit rate {hit:.3f}); {split} paged calls, all split")
    return refs, outs


# -- phase 4b: the kill switch and speculative decoding, f32, full width ----

def correctness_spelling_phase(torch, np, params, work, refs, kernels):
    """The same eight requests and ``generate`` references as phase 4:
    (a) an engine built under ``PADDLE_TPU_PAGED_ATTN=0``, (b) a
    speculative engine (a 2-layer ``depth_draft`` of the same weights,
    ``spec_k=4``) under ``=1``, (c) the same under ``=0``."""
    from paddle_tpu_torch.serving import speculative

    draft = speculative.depth_draft(params, CHECK_DRAFT_LAYERS)
    spec_kw = dict(draft_params=draft, spec_k=CHECK_SPEC_K)
    for label, switch, kw in (("(a) gather", "0", {}),
                              ("(b) spec", "1", spec_kw),
                              ("(c) spec+gather", "0", spec_kw)):
        kernels.reset_launches()
        with paged_switch(switch):
            outs, eng = serve_f32(params, work, **kw)
        launches = kernels.launch_counts()
        want = "paged_attention" if switch == "1" else "decode_gather"
        other = "decode_gather" if switch == "1" else "paged_attention"
        if launches[want] <= 0 or launches[other] != 0:
            raise AssertionError(
                f"4b {label}: launches {launches} do not follow the switch")
        if switch == "1":
            paged_on_split(kernels, f"4b {label}")
        full = hold_to_generate(torch, np, outs, work, refs, f"4b {label}")
        note = ""
        if kw:
            sp = eng._spec
            if not sp.proposed > 0:
                raise AssertionError(f"4b {label}: no speculative round ran")
            note = (f", {sp.accepted}/{sp.proposed} draft tokens accepted "
                    f"(k={CHECK_SPEC_K}, {CHECK_DRAFT_LAYERS}-layer draft)")
        log(f"f32 full width {label} (PADDLE_TPU_PAGED_ATTN={switch}): "
            f"{full}/{len(work)} requests token-identical to generate, the "
            f"rest diverge only at near-ties; {launches[want]} {want} "
            f"launches, 0 {other}{note}")
        del eng


# -- phase 5: full-width bf16 serving ----------------------------------------

def serving_phase(torch, np, params, work, kernels, switch="1", load=None,
                  profile=True):
    """Phase 5 (``switch`` "1", the paged-attention kernel) or 5b
    (``PADDLE_TPU_PAGED_ATTN=0``: the decode_gather kernel and a dense
    softmax).  The switch holds for the whole pass: the engine makes its
    step callables, which read it, at first use.  The timed load is the
    first ``load`` requests of ``work`` (all by default); the warm-up
    and the profile (unless ``profile`` is false) take theirs from the
    whole ``work``.  Returns the pass's launch counts and its numbers."""
    with paged_switch(switch):
        return _serving_pass(torch, np, params, work, kernels, switch,
                             load or len(work), profile)


def _serving_pass(torch, np, params, work, kernels, switch, load, profile):
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.serving import ServingEngine

    reg = obs.get_registry()
    reg.clear(prefix="serving.")
    eng = ServingEngine(params, N_LAYER, N_HEAD, D_MODEL, max_len=MAX_LEN,
                        max_slots=SLOTS, decode_chunk=CHUNK,
                        min_bucket=MIN_BUCKET, block_tokens=BLOCK_TOKENS,
                        compute_dtype="bfloat16", prefix_reuse=True)
    # warm: the first two requests of each class, one at a time — the
    # first pays a full prefill, the second its prefix-hit suffix bucket
    for prompt, _ in work[: 2 * len(CLASSES)]:
        eng.generate_many([prompt], max_new_tokens=2)
    for nm in ("serving.queue_wait", "serving.decode_chunk",
               "serving.prefill_seconds", "serving.ttft_seconds",
               "serving.e2e_seconds", "serving.step_seconds"):
        h = reg.get(nm)
        if h is not None:
            h.reset()
    eng.reset_slo_accounting()
    # engines of earlier phases sit in reference cycles (engine <->
    # scheduler) until the collector runs: free them before the peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                     # counts start at 0 here
    t0 = time.perf_counter()
    reqs = [eng.submit(p, m) for p, m in work[:load]]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = eng.stats()
    for r, (prompt, max_new) in zip(reqs, work[:load]):
        out = r.result(timeout=0)
        gen = out[len(prompt):]
        if len(gen) != max_new or gen.min() < 0 or gen.max() >= VOCAB:
            raise AssertionError(f"request {r.rid}: bad output {gen}")
    emitted = sum(len(r.tokens) for r in reqs)
    chunks = st["serving.decode_chunk"]["count"]
    prefill_steps = int(st["serving.prefill_tokens"])
    expect = N_LAYER * (CHUNK * chunks + prefill_steps)
    ttft = st["serving.ttft_seconds"]
    peak = torch.cuda.max_memory_allocated()
    out = {"launches": launches, "tok_s": emitted / wall,
           "chunk_p50": st["serving.decode_chunk"]["p50"], "peak": peak,
           "wall": wall}
    if switch == "0":
        log(f"bf16 full width, PADDLE_TPU_PAGED_ATTN=0: {len(reqs)} requests, "
            f"{emitted} tokens in {wall:.3f} s = {emitted / wall:.1f} tok/s; "
            f"TTFT p50 {ttft['p50'] * 1e3:.1f} ms; decode_chunk p50 "
            f"{out['chunk_p50'] * 1e3:.2f} ms ({chunks} chunks); prefill "
            f"steps {prefill_steps}; max_memory_allocated {peak} B")
        log(f"decode_gather.launches {launches['decode_gather']} (2 x layers "
            f"x (decode steps + prefill steps) = {2 * expect}), "
            f"paged_attention.launches {launches['paged_attention']}")
        if (launches["decode_gather"] != 2 * expect
                or launches["paged_attention"] != 0):
            raise AssertionError(
                f"kill-switch pass: {launches['decode_gather']} gathers "
                f"(expected {2 * expect}) and "
                f"{launches['paged_attention']} paged launches (expected 0)")
        if profile:
            profile_decode(torch, eng, work)
        del eng
        return out
    log(f"bf16 full width: {len(reqs)} requests, {emitted} tokens in "
        f"{wall:.3f} s = {emitted / wall:.1f} tok/s; TTFT p50 "
        f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms; "
        f"decode_chunk p50 {st['serving.decode_chunk']['p50'] * 1e3:.2f} ms "
        f"({chunks} chunks); prefill steps {prefill_steps}; prefix hit rate "
        f"{st['serving.prefix_hit_rate']:.3f}; max_memory_allocated "
        f"{peak} B")
    log(f"paged_attention.launches {launches['paged_attention']} during the "
        f"pass (layers x (decode steps + prefill steps) = {expect}; "
        f"{N_LAYER * CHUNK} per decode chunk)")
    if launches["paged_attention"] <= 0:
        raise AssertionError("the serving pass never launched the kernel")
    if launches["paged_attention"] != expect:
        raise AssertionError(
            f"{launches['paged_attention']} kernel launches, expected "
            f"{expect}: some attention did not go through the kernel")
    if paged_on_split(kernels, "phase 5") != expect:
        raise AssertionError("phase 5: family counts disagree with launches")
    if profile:
        profile_decode(torch, eng, work)
    del eng
    return out


def profile_decode(torch, eng, work, chunks=3):
    """Where a decode chunk's time goes (measured, not judged): fill
    every slot, then trace ``chunks`` steady decode chunks with
    ``torch.profiler`` and print the device's kernel time per chunk
    against the chunk's wall, kernels per decode step, and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # enough tokens that every slot stays live through the admission
    # chunk, the unprofiled chunks and the profiled ones
    reqs = [eng.submit(p, CHUNK * (2 * chunks + 2)) for p, _ in
            work[:SLOTS]]
    eng.step()                        # admissions (prefills) + one chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / chunks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()
    if any(r.error is not None for r in reqs):
        raise AssertionError("a profiled request failed")
    # device-side rows only (kernels, memcpys, memsets): the CPU op rows
    # above them repeat the same device time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log("profile: the profiler recorded no device time")
        return
    dev_ms = sum(r[0] for r in rows) / 1e3 / chunks
    kernels_per_step = sum(r[1] for r in rows) / (chunks * CHUNK)
    log(f"profile: decode chunk wall {plain_wall * 1e3:.2f} ms unprofiled, "
        f"device kernel time {dev_ms:.2f} ms per chunk (busy share "
        f"{dev_ms / (plain_wall * 1e3):.3f}), {kernels_per_step:.1f} "
        f"kernels per decode step ({kernels_per_step / N_LAYER:.1f} per "
        f"layer-step)")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3 / chunks:8.3f} ms/chunk {count // chunks:6d} "
            f"calls/chunk  {key[:90]}")


# -- phase 5c: speculative decoding at the reference's spec configuration ---

def _spec_pass(torch, eng, work, kernels):
    """Warm ``eng`` (the first two requests of each class), zero the
    counters, then serve ``work`` at once until idle.  Returns the
    requests, the wall and the launch counts of the pass."""
    from paddle_tpu_torch.observability import metrics as obs

    reg = obs.get_registry()
    for prompt, _ in work[: 2 * len(CLASSES)]:
        eng.generate_many([prompt], max_new_tokens=2)
    for nm in ("serving.decode_chunk", "serving.step_seconds",
               "serving.ttft_seconds", "serving.prefill_seconds"):
        h = reg.get(nm)
        if h is not None:
            h.reset()
    eng.reset_slo_accounting()
    torch.cuda.synchronize()
    kernels.reset_launches()                     # counts start at 0 here
    t0 = time.perf_counter()
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for r, (prompt, max_new) in zip(reqs, work):
        gen = r.result(timeout=0)[len(prompt):]
        if len(gen) != max_new or gen.min() < 0 or gen.max() >= SPEC_VOCAB:
            raise AssertionError(f"5c request {r.rid}: bad output {gen}")
    return reqs, wall, launches


def spec_phase(torch, np, kernels, seed):
    """The reference's speculative pair at full width of its own
    configuration: the plain engine and the speculative engine (a
    ``depth_draft`` of 1 layer, ``spec_k=5``) over the same 64 requests;
    the first 8 of each held to ``generate``, every request served in
    full, no scratch block leaked, and the speculative pass's
    paged-attention launches equal to the count reckoned from the
    engine's own counters."""
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.serving import ServingEngine, speculative

    rng = np.random.default_rng([seed, 5])
    params = soften_deep_layers(
        make_params(rng, SPEC_VOCAB, SPEC_LAYERS, SPEC_D), SPEC_DRAFT_LAYERS,
        SPEC_SCALE)
    work = make_workload(rng, REQUESTS, CLASSES, SPEC_VOCAB, PREFIX_LEN)
    refs = generate_refs(torch, params, work[:8], SPEC_LAYERS, SPEC_HEADS,
                         SPEC_D)
    geom = dict(max_len=MAX_LEN, max_slots=SLOTS, decode_chunk=CHUNK,
                min_bucket=MIN_BUCKET, block_tokens=BLOCK_TOKENS,
                compute_dtype="float32", prefix_reuse=True)
    runs = {}
    for label, kw in (("plain", {}), ("spec", dict(
            draft_params=speculative.depth_draft(params, SPEC_DRAFT_LAYERS),
            spec_k=SPEC_K))):
        obs.get_registry().clear(prefix="serving.")
        eng = ServingEngine(params, SPEC_LAYERS, SPEC_HEADS, SPEC_D,
                            **geom, **kw)
        reqs, wall, launches = _spec_pass(torch, eng, work, kernels)
        paged_on_split(kernels, f"5c {label}")
        outs = [r.result(timeout=0) for r in reqs]
        full = hold_to_generate(torch, np, outs[:8], work[:8], refs,
                                f"5c {label}")
        emitted = sum(len(r.tokens) for r in reqs)
        st = eng.stats()
        runs[label] = emitted / wall
        log(f"5c {label}: {len(reqs)} requests, {emitted} tokens in "
            f"{wall:.3f} s = {emitted / wall:.1f} tok/s; {full}/8 "
            f"token-identical to generate (the rest only at near-ties); "
            f"decode_chunk p50 {st['serving.decode_chunk']['p50'] * 1e3:.2f}"
            f" ms over {st['serving.decode_chunk']['count']} rounds")
        if eng.kv_pool.blocks_in_use != len(eng.prefix_trie):
            raise AssertionError(
                f"5c {label}: {eng.kv_pool.blocks_in_use} blocks in use "
                f"after idle, the trie holds {len(eng.prefix_trie)}")
        if label == "plain":
            del eng
            continue
        sp = eng._spec
        if any(sp.chains) or np.count_nonzero(sp.table):
            raise AssertionError("5c: a scratch chain outlived its request")
        rounds = st["serving.decode_chunk"]["count"]
        prefill_steps = int(st["serving.prefill_tokens"])
        draft_prefill = sum(eng.bucket_for(len(p)) for p, _ in work)
        expect = (SPEC_DRAFT_LAYERS * (SPEC_K + 1) * rounds
                  + SPEC_LAYERS * rounds + SPEC_LAYERS * prefill_steps
                  + SPEC_DRAFT_LAYERS * draft_prefill)
        log(f"5c spec: accept rate {sp.accepted / sp.proposed:.4f} "
            f"({sp.accepted}/{sp.proposed}); serving.spec_draft_ms "
            f"{st['serving.spec_draft_ms']:.3f} (last round); "
            f"paged_attention.launches {launches['paged_attention']} = "
            f"{SPEC_DRAFT_LAYERS} x {SPEC_K + 1} x {rounds} rounds + "
            f"{SPEC_LAYERS} x {rounds} verifies + {SPEC_LAYERS} x "
            f"{prefill_steps} target prefill steps + {SPEC_DRAFT_LAYERS} x "
            f"{draft_prefill} draft prefill steps = {expect}")
        if not sp.proposed > 0:
            raise AssertionError("5c: no speculative round ran")
        if launches["paged_attention"] != expect:
            raise AssertionError(
                f"5c: {launches['paged_attention']} paged launches, "
                f"expected {expect}")
        if paged_on_split(kernels, "5c spec") != expect:
            raise AssertionError("5c: family counts disagree with launches")
        del eng
    log(f"5c tok/s: spec {runs['spec']:.1f} / plain {runs['plain']:.1f} = "
        f"{runs['spec'] / runs['plain']:.3f}x")


# -- phases 6 and 7: training through Program -> Executor --------------------

def build_training(pt, seed, max_len, dtype, fused_head):
    """The flagship training program at full width and its startup
    program, seeded; names restart so every build names alike."""
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        model = pt.models.transformer.build(
            vocab_size=VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
            d_model=D_MODEL, max_len=max_len, dropout_rate=0.0, dtype=dtype,
            fused_head=fused_head, learning_rate=TRAIN_LR)
    return main, startup, model


def make_batch(torch, rng, batch, t):
    """A learnable pattern: next = tok + 1 on a cycle of ``PATTERN``
    tokens, from a random start per row (over the whole 32768-token
    vocabulary a handful of steps sees each token once and learns
    nothing measurable); labels are the tokens shifted left, the last one
    padding."""
    start = torch.as_tensor(rng.integers(0, PATTERN, (batch, 1)),
                            device="cuda")
    toks = (start + torch.arange(t, device="cuda")[None, :]) % PATTERN
    labels = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -1)], dim=1)
    return {"tokens": toks, "labels": labels}


def grads_agree(params, got, want, tol, what):
    """Every step-1 gradient of ``got`` within ``tol`` of ``want``, max
    |a - b| / max |b|; the key biases' gradient is zero analytically
    (softmax ignores a shift of every key) and roundoff on both sides, so
    it is held to the largest gradient entry of the model, not to itself.
    Returns the worst (name, rel)."""
    biggest = max(g.abs().max().item() for g in want)
    worst = ("", 0.0)
    for name, ga, gb in zip(params, got, want):
        scale = biggest if "_att_k.b" in name else gb.abs().max().item()
        rel = (ga.float() - gb.float()).abs().max().item() / scale
        if rel > worst[1]:
            worst = (name, rel)
        if not rel <= tol:
            raise AssertionError(
                f"f32 step-1 gradient of {name} ({what}): rel {rel:.3e} > "
                f"{tol}")
    return worst


def training_check_phase(torch, np, pt, kernels, fa, ce, seed):
    """f32, full width, short sequence, two Adam steps from one startup
    state each: (a) unfused head, attention through the kernels, against
    the same with attention routed to the plain versions; (b) the fused
    head through the CE kernels against the unfused head (cuBLAS and
    softmax), both with attention in the kernels; (c) the unfused head with
    the backward forced onto the split route, against (a)'s fused route
    and its plain attention."""
    main, startup, model = build_training(pt, seed, CHECK_T, "float32",
                                          False)
    fmain, _, fmodel = build_training(pt, seed, CHECK_T, "float32", True)
    exe = pt.Executor()
    base = pt.Scope()
    exe.run(startup, scope=base)
    names = {v.name for v in main.persistable_vars()}
    if {v.name for v in fmain.persistable_vars()} != names:
        raise AssertionError("the fused and unfused programs hold other state")
    params = [p.name for p in main.all_parameters()]
    if [p.name for p in fmain.all_parameters()] != params:
        raise AssertionError("the fused and unfused programs order their "
                             "parameters differently")
    rng = np.random.default_rng(seed)
    batches = [make_batch(torch, rng, CHECK_B, CHECK_T) for _ in range(2)]

    def two_steps(prog, loss_var):
        fetch = [loss_var.name] + [p + "@GRAD" for p in params]
        scope = pt.Scope()
        for n in base.var_names():
            scope.set(n, base.get(n).clone())
        out = []
        for feed in batches:
            out.append(exe.run(prog, feed=feed, fetch_list=fetch,
                               scope=scope, return_numpy=False))
        torch.cuda.synchronize()
        return out

    def delta(c0):
        c1 = kernels.launch_counts()
        return {k: c1[k] - c0[k] for k in c1}

    c0 = kernels.launch_counts()
    with_kernels = two_steps(main, model["avg_cost"])
    d = delta(c0)
    if (d["flash_attention_fwd"], d["flash_attention_bwd"]) != (
            2 * N_LAYER, 2 * N_LAYER) or d["fused_ce_fwd"]:
        raise AssertionError(f"the f32 unfused steps missed the kernels: {d}")
    # the test-only switch: the autograd Function finds its wrappers by
    # name in the module, so the plain versions stand in for both
    real = fa.flash_fwd, fa.flash_bwd
    fa.flash_fwd = lambda q, k, v, causal=False, sm_scale=None: (
        fa.flash_attention_ref(q, k, v, causal, sm_scale))
    fa.flash_bwd = (lambda q, k, v, o, lse, do, dlse=None, causal=False,
                    sm_scale=None, block_q=None, block_k=None:
                    fa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse,
                                               causal, sm_scale))
    try:
        c0 = kernels.launch_counts()
        with_plain = two_steps(main, model["avg_cost"])
    finally:
        fa.flash_fwd, fa.flash_bwd = real
    if any(delta(c0).values()):
        raise AssertionError("the plain-version steps launched a kernel")
    c0 = kernels.launch_counts()
    fused = two_steps(fmain, fmodel["avg_cost"])
    d = delta(c0)
    if (d["flash_attention_fwd"], d["flash_attention_bwd"], d["fused_ce_fwd"],
            d["fused_ce_dx"], d["fused_ce_dw"]) != (
            2 * N_LAYER, 2 * N_LAYER, 2, 2, 2):
        raise AssertionError(f"the f32 fused-head steps missed a kernel: {d}")
    # 6+: the same unfused steps through the split route (forced)
    c0 = kernels.launch_counts()
    with forced_route(fa, "split"):
        split = two_steps(main, model["avg_cost"])
    d = delta(c0)
    if (d["flash_attention_fwd"], d["flash_attention_bwd"],
            d["flash_attention_bwd_dq"], d["flash_attention_bwd_dkv"]) != (
            2 * N_LAYER, 0, 2 * N_LAYER, 2 * N_LAYER):
        raise AssertionError(f"the f32 split-route steps missed a kernel: {d}")

    flash_tol = fa.oracle_tol(torch.float32, "grad")
    for what, a_run, b_run, tol in (
            ("flash kernels vs plain attention", with_kernels, with_plain,
             flash_tol),
            ("fused CE head vs unfused head", fused, with_kernels,
             ce.oracle_tol(torch.float32, "grad")),
            ("split backward route vs fused route", split, with_kernels,
             flash_tol),
            ("split backward route vs plain attention", split, with_plain,
             flash_tol)):
        losses = []
        for a, b in zip(a_run, b_run):
            la, lb = a[0].item(), b[0].item()
            losses.append((la, lb))
            if not (np.isfinite(la) and abs(la - lb) <= 1e-3 * abs(lb)):
                raise AssertionError(f"f32 training loss {la} vs {lb} ({what})")
        worst = grads_agree(params, a_run[0][1:], b_run[0][1:], tol,
                            what)
        log(f"f32 training, full width (t={CHECK_T}, b={CHECK_B}, 2 steps), "
            f"{what}: loss "
            + ", ".join(f"{a:.6f} vs {b:.6f}" for a, b in losses)
            + f"; step-1 gradients of {len(params)} parameters within "
            f"{tol:g} (worst {worst[0]} rel {worst[1]:.3e})")


def training_phase(torch, np, pt, kernels, seed, fused_head, t=TRAIN_T,
                   steps=TRAIN_STEPS, policy=None, warm=0, profile=True):
    """A training path at full width: bf16, batch 8, sequence ``t``, the
    fused head (the main paths) or the unfused one, ``policy`` remat or
    none.  ``warm`` steps run before the counts are zeroed; ``steps`` are
    counted.  Returns the launch counts of the counted steps, the peak
    device memory, the losses (warm steps first) and the steady step
    wall."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    tokens = TRAIN_B * t
    head = ("fused" if fused_head else "unfused") + " head" + (
        f", {policy} remat" if policy else "")
    if t == TRAIN_T:
        n_params = (VOCAB * D_MODEL * 2 + t * D_MODEL
                    + N_LAYER * 12 * D_MODEL * D_MODEL)
        # reckoned before running: f32 master copies do not exist (weights
        # are bf16, moments f32); each layer holds about 30 [tokens, d]
        # bf16 tensors' worth of residuals, the f32 LayerNorm inputs
        # included; the unfused head adds logits in bf16 and f32 plus
        # log-softmax, and transiently their gradients; the fused head
        # adds only O(tokens)
        est = (n_params * (2 + 2 + 8) + N_LAYER * 30 * tokens * D_MODEL * 2)
        if not fused_head:
            est += tokens * VOCAB * (2 + 4 + 4 + 4 + 2)
        log(f"training, {head}: {n_params} parameters, {tokens} tokens a "
            f"step; memory reckoned before the run: about "
            f"{est / 2**30:.1f} GiB")
    main, startup, model = build_training(pt, seed, t, "bfloat16",
                                          fused_head)
    if policy:
        pt.memory_optimize(main, policy=policy)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    watched = ("lm_head.w", "tok_emb.w", "block0_att_q.w", "block11_ffn2.b")
    before = {n: scope.get(n).clone() for n in watched}
    fetch = [model["avg_cost"].name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(warm + steps):
        if i == warm:
            kernels.reset_launches()             # counts start at 0 here
        feed = make_batch(torch, rng, TRAIN_B, t)
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
        losses.append(loss.item())               # ends in a device sync
        walls.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    fams = kernels.family_counts()
    families = {"forward": fams["flash_attention_fwd"],
                "fused": fams["flash_attention_bwd"],
                "split": fams["flash_attention_split"],
                "ce_fwd": fams["fused_ce_fwd"], "ce_dx": fams["fused_ce_dx"],
                "ce_dw": fams["fused_ce_dw"]}
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    route = fa.bwd_route((TRAIN_B, t, N_HEAD, D_HEAD), t, 2)
    log(f"bf16 training, {head}, full width (t={t}, b={TRAIN_B}): loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step wall first {walls[0]:.3f} s, then median {steady:.3f} s = "
        f"{tokens / steady:.0f} tok/s; grad norm "
        f"{scope.get('@GRAD_NORM@').item():.4f}; max_memory_allocated "
        f"{peak} B")
    log(f"launches during the {steps} counted steps: "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f" (expected a step: {N_LAYER} flash forward, {N_LAYER} delta "
        f"pre-pass, "
        + (f"{N_LAYER} fused backward" if route == "fused" else
           f"{N_LAYER} split dq + {N_LAYER} split dk/dv, 0 fused backward")
        + (", 1 of each CE kernel)" if fused_head else ", no CE)")
        + f"; kernels by family {families}")
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if abs(losses[0] - np.log(VOCAB)) > 0.5:
        raise AssertionError(
            f"first loss {losses[0]} is not near ln({VOCAB}) = "
            f"{np.log(VOCAB):.3f}")
    if not losses[-1] < losses[0] - 0.05:
        raise AssertionError(f"the loss did not fall: {losses}")
    want = N_LAYER * steps
    ce_want = steps if fused_head else 0
    expect = {"paged_attention": 0, "decode_gather": 0,
              "flash_attention_fwd": want,
              "flash_attention_bwd": want if route == "fused" else 0,
              "flash_attention_bwd_delta": want,
              "flash_attention_bwd_dq": want if route == "split" else 0,
              "flash_attention_bwd_dkv": want if route == "split" else 0,
              "fused_ce_fwd": ce_want, "fused_ce_dx": ce_want,
              "fused_ce_dw": ce_want, "bottleneck": 0}
    expect = dict(dict.fromkeys(launches, 0), **expect)   # the rest: none
    if launches != expect:
        raise AssertionError(
            f"launches {launches}, expected {expect}: some attention or "
            f"head call did not go through its kernel")
    split_calls = 2 * want if route == "split" else 0
    fused_calls = want if route == "fused" else 0
    expect = {"forward": {"sm90": want, "simple": 0},
              "fused": {"sm90": fused_calls, "simple": 0},
              "split": {"sm90": split_calls, "simple": 0},
              "ce_fwd": {"sm90": ce_want, "simple": 0},
              "ce_dx": {"sm90": ce_want, "simple": 0},
              "ce_dw": {"sm90": ce_want, "simple": 0}}
    if families != expect:
        raise AssertionError(
            f"flash and CE kernels by family {families}, expected every "
            f"one on sm90: {expect}")
    for n, old in before.items():
        if torch.equal(scope.get(n), old):
            raise AssertionError(f"parameter {n} did not change")
        if not torch.isfinite(scope.get(n).float()).all():
            raise AssertionError(f"parameter {n} is not finite")
    sums = {}
    if profile:
        sums = profile_step(torch, exe, main, scope, fetch,
                            make_batch(torch, rng, TRAIN_B, t), steady)
        # the profiled step's kernel list: one launch of each sm90 CE
        # kernel, none of the simple family
        ce_fams = ("CE forward", "CE dx", "CE dW")
        if fused_head and not (
                all(sums.get(f"{f} (sm90)", (0, 0))[1] == 1 for f in ce_fams)
                and not any(f"{f} (simple)" in sums for f in ce_fams)):
            raise AssertionError(
                f"the profiled step at t={t} does not list one "
                f"ce_fwd_sm90_kernel, ce_dx_sm90_kernel and "
                f"ce_dw_sm90_kernel each and no simple CE kernel: {sums}")
    del exe, scope, before
    return {"launches": launches, "peak": peak, "losses": losses,
            "steady": steady, "profile": sums}


def family_step_phase(torch, np, pt, fa, ce, seed, label, t, policy,
                      loss_tol, grad_tol):
    """Phases 7c and 8c: a training path's program (``t``, remat
    ``policy``, fused head, bf16) takes one step from one startup state and
    one batch twice: every flash kernel (forward, and the fused or split
    backward) and the three CE kernels (forward, dx, dW) on the family the
    rules pick (sm90) and on the simple family forced (a switch in this
    script only).  The losses must agree within
    ``loss_tol`` relative and every parameter's gradient within
    ``grad_tol`` of the other family's."""
    main, startup, model = build_training(pt, seed, t, "bfloat16", True)
    if policy:
        pt.memory_optimize(main, policy=policy)
    params = [p.name for p in main.all_parameters()]
    exe = pt.Executor()
    base = pt.Scope()
    exe.run(startup, scope=base)
    feed = make_batch(torch, np.random.default_rng(seed), TRAIN_B, t)
    fetch = [model["avg_cost"].name] + [p + "@GRAD" for p in params]
    route = fa.bwd_route((TRAIN_B, t, N_HEAD, D_HEAD), t, 2)
    want = {"forward": N_LAYER, "fused": N_LAYER if route == "fused" else 0,
            "split": 2 * N_LAYER if route == "split" else 0,
            "ce_fwd": 1, "ce_dx": 1, "ce_dw": 1}
    tables = {"forward": fa.FWD_FAMILY_CALLS, "fused": fa.FUSED_FAMILY_CALLS,
              "split": fa.BWD_FAMILY_CALLS, "ce_fwd": ce.CE_FWD_FAMILY_CALLS,
              "ce_dx": ce.CE_DX_FAMILY_CALLS, "ce_dw": ce.CE_DW_FAMILY_CALLS}
    runs, walls = {}, {}
    for family in ("sm90", "simple"):
        scope = pt.Scope()
        for n in base.var_names():
            scope.set(n, base.get(n).clone())
        c0 = {k: dict(v) for k, v in tables.items()}
        stack = contextlib.ExitStack()
        if family == "simple":
            stack.enter_context(forced_family(fa, family))
            stack.enter_context(forced_rule(ce, "ce_family", family))
        t0 = time.perf_counter()
        with stack:
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            loss = out[0].item()
        walls[family] = time.perf_counter() - t0
        calls = {k: {f: v[f] - c0[k][f] for f in v} for k, v in tables.items()}
        expect = {k: {"sm90": 0, "simple": 0, family: n}
                  for k, n in want.items()}
        if calls != expect:
            raise AssertionError(f"the {family} step's flash and CE kernels "
                                 f"by family: {calls}, expected {expect}")
        runs[family] = (loss, out[1:])
        del scope, out
    (la, ga), (lb, gb) = runs["sm90"], runs["simple"]
    if not (np.isfinite(la) and abs(la - lb) <= loss_tol * abs(lb)):
        raise AssertionError(f"phase {label} loss {la} (sm90) vs {lb} "
                             f"(simple)")
    worst = grads_agree(params, ga, gb, grad_tol,
                        "sm90 vs simple family, bf16")
    log(f"phase {label} t={t} ({route} backward, "
        f"{policy or 'no'} remat): one step from one state and batch, loss "
        f"{la:.6f} (sm90) vs {lb:.6f} (simple family forced; limit "
        f"{loss_tol:g} relative); gradients of {len(params)} parameters "
        f"within {grad_tol:g} (worst {worst[0]} rel {worst[1]:.6e}); step "
        f"wall {walls['sm90']:.3f} vs {walls['simple']:.3f} s (first steps: "
        f"allocation included)")
    del exe, base, runs, ga, gb


def long_phase(torch, np, pt, kernels, seed):
    """Phase 8, the long-context path: ``bench.py``'s flagship at t=16384,
    b=8, fused head, ``memory_optimize(policy="selective")`` (what its
    BENCH_GPT_TUNE=1 path resolves to on a tune-cache miss), a warm step
    and three counted Adam steps through the split backward; 8b, the same
    path for two steps without remat and with ``compact``."""
    tokens = TRAIN_B * LONG_T
    unit = tokens * D_MODEL * 2                 # one [tokens, d] bf16 tensor
    n_params = (VOCAB * D_MODEL * 2 + LONG_T * D_MODEL
                + N_LAYER * 12 * D_MODEL * D_MODEL)
    state = n_params * (2 + 2 + 8)
    scaled = T4096_FUSED_PEAK * LONG_T / TRAIN_T
    per_layer = state + N_LAYER * 30 * unit
    # selective, one checkpointed region a layer with the matrix ops'
    # outputs saved: a layer keeps its input and ln1's output (the
    # region inputs), the q, k, v, out-projection and FFN products before
    # their biases (3 + 1 + 4 + 1 units) and the flash residuals q, k, v, o
    # (4): ~15 units; the backward recomputes one layer at a time (~18
    # units of its saved tensors live at once)
    selective = state + N_LAYER * 15 * unit + 18 * unit
    log(f"phase 8, t={LONG_T} b={TRAIN_B}: {tokens} tokens a step; peak "
        f"memory reckoned before the run: phase 7's measured "
        f"{T4096_FUSED_PEAK / 1e9:.2f} GB x {LONG_T // TRAIN_T} = "
        f"{scaled / 1e9:.1f} GB (no remat); phase 7's per-layer reckoning "
        f"(30 [tokens, d] bf16 tensors a layer) {per_layer / 1e9:.1f} GB; "
        f"selective (~15 a layer, one layer recomputed at a time) "
        f"{selective / 1e9:.1f} GB")
    sel = training_phase(torch, np, pt, kernels, seed, True, t=LONG_T,
                         steps=LONG_STEPS, policy="selective", warm=1)
    torch.cuda.empty_cache()
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as ce
    family_step_phase(torch, np, pt, fa, ce, seed, "8c", LONG_T, "selective",
                      1e-2, fa.oracle_tol(torch.bfloat16, "grad"))
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"selective": sel}
    for policy in (None, "compact"):
        runs[policy or "none"] = training_phase(
            torch, np, pt, kernels, seed, True, t=LONG_T, steps=2,
            policy=policy, profile=False)
        torch.cuda.empty_cache()
    for name, r in runs.items():
        log(f"phase 8b t={LONG_T}: {name:9s} peak {r['peak'] / 1e9:.3f} GB, "
            f"step wall {r['steady']:.3f} s, losses "
            + ", ".join(f"{x:.6f}" for x in r["losses"][:2]))
    closest = min((("t=4096 peak x 4", scaled), ("per-layer", per_layer),
                   ("selective", selective)),
                  key=lambda kv: abs(kv[1] - sel["peak"]))
    log(f"reckoning that held for selective ({sel['peak'] / 1e9:.2f} GB "
        f"measured): {closest[0]} ({closest[1] / 1e9:.1f} GB); selective "
        f"saves {(runs['none']['peak'] - sel['peak']) / 1e9:.3f} GB and "
        f"compact {(runs['none']['peak'] - runs['compact']['peak']) / 1e9:.3f}"
        f" GB against no remat")
    if not runs["compact"]["peak"] < runs["none"]["peak"]:
        raise AssertionError("compact remat's peak is not below no remat's")
    if not sel["peak"] < runs["none"]["peak"]:
        raise AssertionError("selective remat's peak is not below no remat's")
    base = runs["none"]["losses"][:2]
    for name in ("selective", "compact"):
        got = runs[name]["losses"][:2]
        for a, b_ in zip(got, base):
            if not abs(a - b_) <= 2.0 ** -8 * abs(b_):
                raise AssertionError(
                    f"{name} remat's losses {got} stray from no remat's "
                    f"{base} beyond bf16 rounding")
        log(f"{name} remat losses {'equal' if got == base else 'within bf16 rounding of'}"
            f" no remat's")
    return sel["launches"]


# -- phases 9 and 9b: ResNet-50 training and inference -----------------------

def build_resnet(pt, seed, is_test=False):
    """``bench.py``'s headline model (``bench_resnet``): ResNet-50, 1000
    classes, 224x224, bf16, Momentum at lr 0.1; names restart so the
    training and the inference programs name alike."""
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        model = pt.models.resnet.build(
            depth=RESNET_DEPTH, class_dim=RESNET_CLASSES,
            image_shape=(3, RESNET_HW, RESNET_HW), dtype="bfloat16",
            is_test=is_test)
    return main, startup, model


def resnet_batch(torch, seed):
    """A synthetic batch made on the card from ``seed`` (no dataset):
    normal images in bf16, uniform labels."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    img = torch.randn((RESNET_BATCH, 3, RESNET_HW, RESNET_HW), generator=gen,
                      device="cuda").to(torch.bfloat16)
    label = torch.randint(0, RESNET_CLASSES, (RESNET_BATCH, 1),
                          generator=gen, device="cuda")
    return {"img": img, "label": label}


def resnet_activation_bytes(main, batch):
    """What eager autograd keeps for the backward, reckoned from the
    program's shapes: each conv's output (batch norm saves its input),
    each relu's output (relu saves it; it is also the next conv's input),
    the image (the first conv's input) and the max pool's int64 indices;
    bf16 activations."""
    block = main.global_block()

    def numel(name):
        n = batch
        for s in block._find_var(name).shape[1:]:
            n *= s
        return n

    elems, index_elems = 0, 0
    for op in block.ops[:block.backward_index]:
        if op.type in ("conv2d", "relu"):
            elems += numel(op.output_names()[0])
        elif op.type == "pool2d" and op.attrs["pooling_type"] == "max":
            index_elems += numel(op.output_names()[0])
    elems += numel("img")
    return 2 * elems + 8 * index_elems


def resnet_phase(torch, np, pt, kernels, seed):
    """Phase 9, a main path: ResNet-50 at ``bench.py``'s batch 128, 224x224,
    bf16, through Program -> Executor -> autograd -> Momentum on one card:
    a warm step, then the counted steps with every launch count zeroed just
    before them; the loss must stay finite and the parameters and the BN
    running statistics must move.  Prints img/s, step wall, peak memory
    beside the memory reckoned before the run, and one profiled step."""
    main, startup, model = build_resnet(pt, seed)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    acts = resnet_activation_bytes(main, RESNET_BATCH)
    # bf16 weights and their gradients, f32 velocities and BN state
    state = n_params * (2 + 2 + 4)
    log(f"phase 9, ResNet-{RESNET_DEPTH} b={RESNET_BATCH} "
        f"{RESNET_HW}x{RESNET_HW} bf16: {n_params} parameters; memory "
        f"reckoned before the run: activations kept for the backward "
        f"{acts / 1e9:.2f} GB + state {state / 1e9:.2f} GB = "
        f"{(acts + state) / 1e9:.2f} GB")
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    watched = [p.name for p in main.all_parameters()][:: 40]
    stats = sorted(v.name for v in main.persistable_vars()
                   if v.name.endswith((".mean", ".variance")))[:: 20]
    before = {n: scope.get(n).clone() for n in watched + stats}
    fetch = [model["avg_cost"].name, model["accuracy"].name]
    feeds = [resnet_batch(torch, seed + i) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(1 + RESNET_STEPS):
        if i == 1:
            kernels.reset_launches()             # counts start at 0 here
        t0 = time.perf_counter()
        loss, acc = exe.run(main, feed=feeds[i % 2], fetch_list=fetch,
                            scope=scope, return_numpy=False)
        losses.append(loss.item())               # ends in a device sync
        walls.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    log(f"bf16 ResNet-{RESNET_DEPTH} training (b={RESNET_BATCH}): loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step wall warm {walls[0]:.3f} s, then median {steady:.4f} s "
        f"(min {min(walls[1:]):.4f}) = {RESNET_BATCH / steady:.1f} img/s; "
        f"grad norm {scope.get('@GRAD_NORM@').item():.4f}; "
        f"max_memory_allocated {peak} B (reckoned "
        f"{(acts + state) / 1e9:.2f} GB)")
    log("launches during the counted steps: " + ", ".join(
        f"{k} {v}" for k, v in launches.items())
        + " (the model runs no hand-written kernel: every op is ATen/cuDNN)")
    if any(launches.values()):
        raise AssertionError(f"ResNet-50 launched a kernel: {launches}")
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite ResNet loss: {losses}")
    for n, old in before.items():
        new = scope.get(n)
        if torch.equal(new, old):
            raise AssertionError(f"{n} did not change")
        if not torch.isfinite(new.float()).all():
            raise AssertionError(f"{n} is not finite")
    profile_step(torch, exe, main, scope, fetch, feeds[0], steady)
    del exe, before
    return scope


def resnet_block_vars(main, block=1):
    """The identity bottleneck block of a ResNet program that ends at its
    ``block``-th residual add (from 0): 1 is the second stage-1 block (256
    -> 64 -> 256 at 56x56), 4 the second stage-2 block (512 -> 128 -> 512
    at 28x28).  Its input and output variables, its three conv filters
    and, for each conv, its batch norm's ``(Scale, Bias, Mean, Variance)``
    names and epsilon."""
    ops = main.global_block().ops
    adds = [i for i, op in enumerate(ops) if op.type == "elementwise_add"]

    def relu_after(i):
        out = ops[i].outputs["Out"][0]
        return next(op for op in ops[i:] if op.type == "relu"
                    and op.inputs["X"] == [out]).outputs["Out"][0]

    first, second = adds[block - 1], adds[block]
    convs = [op for op in ops[first:second] if op.type == "conv2d"]
    norms = [op for op in ops[first:second] if op.type == "batch_norm"]
    if len(convs) != 3 or len(norms) != 3:
        raise AssertionError(f"block {block} is not an identity bottleneck "
                             f"block")
    return (relu_after(first), relu_after(second),
            [op.inputs["Filter"][0] for op in convs],
            [(tuple(op.inputs[k][0] for k in ("Scale", "Bias", "Mean",
                                               "Variance")),
              op.attrs["epsilon"]) for op in norms])


def resnet_inference_phase(torch, pt, bn, kernels, seed, scope):
    """Phase 9b: the same model with ``is_test=True`` on the trained state,
    one forward (img/s); then B9 held against the model's own blocks: the
    second stage-1 bottleneck block (the sm90 family's shape) and the
    second stage-2 block (512 -> 128 -> 512: the simple family's), each
    with its batch norm folded from the trained parameters and running
    statistics, run by the kernel on the NHWC activation that enters the
    block, against the port's ``is_test`` forward of that block (the
    script's 2e-2 max-relative criterion), every count zeroed before the
    two calls: one launch on each family.  Neither package routes the
    model through the kernel: this shows only that the kernel computes
    the model's blocks.  Returns the simple family's launches."""
    main, _, model = build_resnet(pt, seed, is_test=True)
    blocks = [resnet_block_vars(main, i) for i in (1, 4)]
    exe = pt.Executor()
    feed = resnet_batch(torch, seed + 7)
    fetch = [model["prediction"].name] + [v for blk in blocks
                                          for v in blk[:2]]
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred, *acts = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(pred.float()).all():
        raise AssertionError("non-finite ResNet inference output")
    log(f"bf16 ResNet-{RESNET_DEPTH} inference (is_test, b={RESNET_BATCH}): "
        f"one forward {wall:.4f} s = {RESNET_BATCH / wall:.1f} img/s; "
        f"prediction {tuple(pred.shape)}, rows sum to "
        f"{pred.float().sum(-1).mean().item():.4f}")
    kernels.reset_launches()
    for i, (block_in, block_out, filters, norms) in enumerate(blocks):
        x, y = acts[2 * i], acts[2 * i + 1]
        sb = []
        for names, eps in norms:
            sb += bn.fold_bn(*(scope.get(n) for n in names), epsilon=eps)
        w = bn.block_weights(*(scope.get(n) for n in filters))
        before = dict(bn.BOTTLENECK_FAMILY_CALLS)
        got = bn.bottleneck(x.permute(0, 2, 3, 1).contiguous(), *w, *sb)
        family = next(f for f, v in bn.BOTTLENECK_FAMILY_CALLS.items()
                      if v != before[f])
        want = y.permute(0, 2, 3, 1)
        d, rel = rel_err(torch, got, want)
        log(f"B9 ({family}) on the trained model's block ({block_in} -> "
            f"{block_out}, {tuple(x.shape)} NCHW as NHWC): max abs err "
            f"{d:.3e}, rel {rel:.3e} against the port's is_test forward "
            f"(tol {bn.oracle_tol(torch.bfloat16):g})")
        if not rel < bn.oracle_tol(torch.bfloat16):
            raise AssertionError(f"B9 disagrees with the model's block: "
                                 f"{rel}")
    fams = kernels.family_counts()["bottleneck"]
    if fams != {"sm90": 1, "simple": 1}:
        raise AssertionError(f"phase 9b's blocks did not take one family "
                             f"each: {fams}")
    return fams["simple"]


def profile_step(torch, exe, main, scope, fetch, feed, steady):
    """Where one step's time goes (measured, not judged): the device's
    kernel time by kernel family of one step, recorded whole by
    ``profiler.middle_call_kernels`` (the CUDA activity over three steps
    with the card idle between them, the middle one counted: a recording
    can lose the device events at its edges, PERF.md §7), then the
    device time of each forward and optimizer op type by CUDA events
    around the op implementations (what is left is autograd's backward).
    It fails, saying so, when the profile lost events: when the counted
    step shows fewer device events than the step before or after it
    (``middle_call_kernels`` raises), or hand-written kernels other than
    the launches the counters count in it (they are zeroed just before
    it; each wrapper on these paths launches one kernel a count); and when
    it recorded no device time.  Returns ``{family: (ms, calls)}`` of the
    counted step."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.profiler import middle_call_kernels

    launched = []

    def run(i):
        if i == 1:
            kernels.reset_launches()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
        if i == 1:
            launched.append(sum(kernels.launch_counts().values()))

    agg = {}
    for _, ns, name in middle_call_kernels(run):
        us, n = agg.get(name, (0.0, 0))
        agg[name] = (us + ns / 1e3, n + 1)
    rows = [(us, n, key) for key, (us, n) in agg.items() if us > 0]
    if not rows:
        raise AssertionError("profile: the profiler recorded no device time")
    own = sum(n for _, n, key in rows if kernels.hand_written(key))
    if own != launched[0]:
        raise AssertionError(
            f"the profiler lost kernel events: the counted step lists "
            f"{own} hand-written kernels, the launch counters counted "
            f"{launched[0]} in it ({kernels.launch_counts()})")
    sums = family_sums(rows, steady)
    op_type_times(torch, exe, main, scope, fetch, feed)
    return sums


def family_sums(rows, steady):
    """``rows`` of one step's device time ``(us, calls, kernel name)``
    summed by kernel family (``observability.attribution.kernel_family``,
    the classifier the package's ``attribute_profile`` shares) and logged
    beside the unprofiled step wall ``steady``: ``{family: (ms, calls)}``."""
    from paddle_tpu_torch.observability.attribution import kernel_family

    sums = {}
    total = sum(r[0] for r in rows) / 1e3
    for us, count, key in rows:
        fam = kernel_family(key) or "elementwise, reductions, other"
        ms, n = sums.get(fam, (0.0, 0))
        sums[fam] = (ms + us / 1e3, n + count)
    log(f"profile: step wall {steady * 1e3:.1f} ms unprofiled, "
        f"device kernel time {total:.1f} ms (busy share "
        f"{total / (steady * 1e3):.3f}), {sum(r[1] for r in rows)} "
        f"kernels")
    for fam, (ms, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        log(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% {n:6d} calls  {fam}")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    top kernel {us / 1e3:9.3f} ms {count:5d} calls  "
            f"{key[:80]}")
    return sums


def op_type_times(torch, exe, main, scope, fetch, feed):
    """The device time of each forward and optimizer op type in one more
    step, by CUDA events around the op implementations (what is left is
    autograd's backward)."""
    from paddle_tpu_torch.core import registry

    spans = []
    real_call = registry.OpImpl.call

    def timed_call(self, ins, attrs, ctx, live=None):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_call(self, ins, attrs, ctx, live)
        e1.record()
        spans.append((self.type, e0, e1))
        return out

    registry.OpImpl.call = timed_call
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    try:
        s0.record()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
        s1.record()
        torch.cuda.synchronize()
    finally:
        registry.OpImpl.call = real_call
    by_type = {}
    for typ, e0, e1 in spans:
        ms, n = by_type.get(typ, (0.0, 0))
        by_type[typ] = (ms + e0.elapsed_time(e1), n + 1)
    step_ms = s0.elapsed_time(s1)
    op_ms = sum(v[0] for v in by_type.values())
    log(f"by op type (CUDA events, one step of {step_ms:.1f} ms): forward "
        f"and optimizer ops {op_ms:.1f} ms, the rest — autograd's backward "
        f"and the gradient norm — {step_ms - op_ms:.1f} ms")
    for typ, (ms, n) in sorted(by_type.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:9.3f} ms {n:5d} calls  {typ}")


# -- phase 10: training through the Trainer ----------------------------------

TRAINER_STEPS, TRAINER_CKPT_EVERY = 6, 2


def trainer_samples(np, seed, steps):
    """Phase 7's synthetic stream as a sample reader: next = tok + 1 on a
    cycle of ``PATTERN`` tokens from a seeded start per row, labels the
    tokens shifted left with the last one padding."""
    def samples():
        rng = np.random.default_rng(seed)
        for _ in range(steps * TRAIN_B):
            toks = (rng.integers(0, PATTERN) + np.arange(TRAIN_T)) % PATTERN
            yield toks, np.concatenate([toks[1:], [-1]])
    return samples


def trainer_run(torch, np, pt, seed, steps, ckdir=None, jsonl=None,
                resume=False, steps_per_call=1):
    """One ``Trainer.train`` over ``steps`` batches of phase 7's program
    (full width and depth, bf16, fused head) from its seeded startup
    state: a resumable ``reader.batch`` through ``DataFeeder``, prefetched
    two batches ahead on a side stream (unfused path), with step
    checkpoints every 2 steps (async, 2 kept) when ``ckdir`` is given.
    Returns the losses, the host clock at each EndIteration, the
    EndIteration events, the parameters after the run, and the
    trainer."""
    main, startup, model = build_training(pt, seed, TRAIN_T, "bfloat16",
                                          True)
    scope = pt.Scope()
    losses, stamps, ends = [], [], []

    def on_event(e):
        if isinstance(e, pt.EndIteration):
            losses.append(e.cost)
            stamps.append(time.perf_counter())
            ends.append(e)

    reader = pt.reader.resumable(pt.reader.batch(
        trainer_samples(np, seed, steps), TRAIN_B))
    with pt.scope_guard(scope):
        tr = pt.Trainer(model["avg_cost"], model["feed"], main_program=main,
                        startup_program=startup)
        rep = pt.MetricsReporter(log_every_n=0, jsonl_path=jsonl)
        kw = {"prefetch": 2} if steps_per_call == 1 else {}
        if ckdir:
            kw.update(checkpoint_dir=ckdir, resume=resume,
                      checkpoint_every_n_steps=TRAINER_CKPT_EVERY,
                      async_checkpoint=True, keep_checkpoints=2,
                      checkpoint_every_n_passes=10 ** 9)
        try:
            tr.train(reader, num_passes=1, event_handler=rep.chain(on_event),
                     steps_per_call=steps_per_call, **kw)
        finally:
            rep.close()
        torch.cuda.synchronize()
        params = {p.name: scope.get(p.name) for p in main.all_parameters()}
    return {"losses": losses, "stamps": stamps, "ends": ends,
            "params": params, "trainer": tr, "main": main, "startup": startup,
            "model": model}


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` for a bit-exact comparison
    (warnings only, so a PyTorch op without a deterministic spelling is
    named rather than fatal; uninitialized memory left unfilled, so the
    cost measured is the routes')."""
    import warnings

    from torch.utils import deterministic as det

    fill = det.fill_uninitialized_memory
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = fill


def check_checkpoint_files(np, path):
    """The checkpoint on disk in the JAX package's format: every manifest
    entry's CRC over its file, bf16 files under ``'<V2'`` headers with
    manifest dtype ``"bfloat16"``, the completion marker and the sidecar's
    torch RNG state.  Returns (files, bf16 files, bytes)."""
    import pickle
    import zlib

    with open(os.path.join(path, "__manifest__.pkl"), "rb") as f:
        manifest = pickle.load(f)
    if manifest.get("__nprocs__") != 1 or not os.path.exists(
            os.path.join(path, "__done0__")):
        raise AssertionError(f"{path}: no single-process completion marker")
    n_bf16 = 0
    for name, meta in manifest.items():
        if name == "__nprocs__":
            continue
        with open(os.path.join(path, meta["file"]), "rb") as f:
            raw = f.read()
        if zlib.crc32(raw) != meta["crc32"]:
            raise AssertionError(f"{path}: CRC of {name} disagrees")
        v2 = b"'descr': '<V2'" in raw[:128]
        if v2 != (meta["dtype"] == "bfloat16"):
            raise AssertionError(f"{path}: {name} is {meta['dtype']} with "
                                 f"header {raw[:80]!r}")
        n_bf16 += v2
    with open(os.path.join(path, "__train_state__.pkl"), "rb") as f:
        st = pickle.load(f)
    if st.get("rng_kind") != "torch" or st["rng_key"].dtype != np.uint8:
        raise AssertionError(f"{path}: sidecar RNG {st.get('rng_kind')}")
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    return len(manifest) - 1, n_bf16, nbytes, st


def pinned_reuse_ms(pt, seed, path):
    """``AsyncCheckpointer.save``'s blocking time (``checkpoint.
    snapshot_ms``) for phase 7's state once earlier saves have returned
    their pinned blocks to the caching host allocator."""
    from paddle_tpu_torch.observability import metrics as obs

    main, startup, _ = build_training(pt, seed, TRAIN_T, "bfloat16", True)
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    ck = pt.io.AsyncCheckpointer()
    with pt.scope_guard(scope):
        ck.save(path, main)
    ms = obs.get_registry().value("checkpoint.last_snapshot_ms")
    ck.close()
    return ms


def determinism_probe(torch, np, pt, fa, seed, ckpt):
    """The op that keeps two runs of one step apart, found by running it
    twice from one state: the flash backward at the path shape (dq, dk, dv
    compared bit for bit), then a whole step of phase 7's program from the
    ``ckpt`` state and one batch, by mode (the rules' routes; torch's
    deterministic algorithms).  Returns the parameters that differ by
    mode."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = flash_inputs(torch, gen, TRAIN_B, TRAIN_T, N_HEAD,
                               D_HEAD, torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    main, startup, model = build_training(pt, seed, TRAIN_T, "bfloat16",
                                          True)
    params = [p.name for p in main.all_parameters()]
    exe = pt.Executor()
    feed = make_batch(torch, np.random.default_rng(seed + 1), TRAIN_B,
                      TRAIN_T)
    out = {}
    for mode in ("rules", "deterministic"):
        stack = contextlib.ExitStack()
        if mode == "deterministic":
            stack.enter_context(deterministic(torch))
        with stack:
            a, b = (fa.flash_bwd(q, k, v, o, lse, do, causal=True)
                    for _ in range(2))
            grads = {g: int((x != y).sum()) for g, x, y in
                     zip(("dq", "dk", "dv"), a, b)}
            steps, walls = [], []
            for _ in range(2):
                scope = pt.Scope()
                exe.run(startup, scope=scope)
                with pt.scope_guard(scope):
                    pt.io.load_persistables(exe, ckpt, main)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, = exe.run(main, feed=feed, scope=scope,
                                fetch_list=[model["avg_cost"].name],
                                return_numpy=False)
                steps.append((loss.item(), {n: scope.get(n) for n in params}))
                walls.append(time.perf_counter() - t0)
                del scope
        differ = [n for n in params
                  if not torch.equal(steps[0][1][n], steps[1][1][n])]
        out[mode] = differ
        log(f"phase 10 probe, {mode}: the flash backward twice at the path "
            f"shape differs in {grads} elements; one step of phase 7's "
            f"program twice from the step-4 state: loss {steps[0][0]!r} vs "
            f"{steps[1][0]!r}, {len(differ)} of {len(params)} parameters "
            f"differ" + (f" ({', '.join(differ[:6])}, ...)" if differ
                         else "")
            + f"; step wall {walls[0]:.4f}, {walls[1]:.4f} s (no "
            f"checkpoint write in flight)")
        if mode == "deterministic" and (differ or any(grads.values())
                                        or steps[0][0] != steps[1][0]):
            raise AssertionError("phase 10: under deterministic algorithms "
                                 "one step twice is not the same bits")
        del steps
    return out


ROUTE_TURNS = ("rules", "split", "deterministic", "deterministic", "split",
               "rules")
ROUTE_ROUNDS = 8


def route_mode(torch, fa, mode):
    """One mode of the route-cost reading: the rules' fused route; the
    split route forced alone; torch's deterministic algorithms (the split
    route and every PyTorch op's deterministic spelling)."""
    if mode == "split":
        return forced_route(fa, "split")
    if mode == "deterministic":
        return deterministic(torch)
    return contextlib.nullcontext()


def route_cost(torch, np, pt, fa, seed, ckpt):
    """What determinism costs, read with no checkpoint write in flight:
    the flash backward at the path shape (device time of 12 queued calls,
    a step's worth), each mode in turns (``ROUTE_TURNS``); then
    ``ROUTE_ROUNDS`` rounds of one step of phase 7's program a mode
    through ``Executor.run`` from the ``ckpt`` state (host wall a step,
    the loss materialised), the modes' order reversed every other round,
    after one unrecorded step a mode.  A round's steps run within half a
    second of each other, so the host's drift, which moves one mode's
    steps by tens of ms over a few seconds, mostly cancels in each
    round's difference.  Returns ``{mode: (kernel ms a call by turn,
    step walls by round)}``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = flash_inputs(torch, gen, TRAIN_B, TRAIN_T, N_HEAD,
                               D_HEAD, torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    out = {m: ([], []) for m in ROUTE_TURNS}
    for mode in ROUTE_TURNS:
        with route_mode(torch, fa, mode):
            out[mode][0].append(device_ms(
                torch, lambda i: fa.flash_bwd(q, k, v, o, lse, do,
                                              causal=True), N_LAYER))
    del q, k, v, do, o, lse
    main, startup, model = build_training(pt, seed, TRAIN_T, "bfloat16",
                                          True)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        pt.io.load_persistables(exe, ckpt, main)
    feed = make_batch(torch, np.random.default_rng(seed + 1), TRAIN_B,
                      TRAIN_T)
    fetch = [model["avg_cost"].name]
    modes = ROUTE_TURNS[:3]
    for r in range(ROUTE_ROUNDS + 1):
        for mode in (modes if r % 2 else modes[::-1]):
            with route_mode(torch, fa, mode):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, = exe.run(main, feed=feed, fetch_list=fetch,
                                scope=scope, return_numpy=False)
                loss.item()
                if r:
                    out[mode][1].append(time.perf_counter() - t0)
    for mode, (ms, walls) in out.items():
        log(f"phase 10 route cost, {mode}: flash backward at the path "
            f"shape {', '.join(f'{x:.4f}' for x in ms)} ms a call by turn "
            f"(x{N_LAYER} a step: {N_LAYER * np.median(ms):.2f} ms); "
            f"Executor.run step wall median {np.median(walls):.4f} s "
            f"(by round {', '.join(f'{w:.4f}' for w in walls)}; no "
            f"checkpoint write in flight)")
    rules = np.asarray(out["rules"][1])
    for mode in ("split", "deterministic"):
        diff = (np.asarray(out[mode][1]) - rules) * 1e3
        log(f"phase 10 route cost, {mode} - rules: kernels "
            f"{N_LAYER * (np.median(out[mode][0]) - np.median(out['rules'][0])):+.2f} "
            f"ms a step; step wall by round "
            f"{', '.join(f'{d:+.2f}' for d in diff)} ms, median "
            f"{np.median(diff):+.2f} ms, quartiles "
            f"{np.percentile(diff, 25):+.2f} / {np.percentile(diff, 75):+.2f}"
            f" ms; {int((diff > 0).sum())} of {len(diff)} rounds slower")
    return out


def trainer_phase(torch, np, pt, kernels, fa, seed, exe_wall):
    """Phase 10: phase 7's training through ``Trainer.train`` (see the
    module docstring); checkpoints go to a temporary directory.  Returns
    10a's median step wall."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as root:
        return _trainer_phase(torch, np, pt, kernels, fa, seed, exe_wall,
                              root)


def _trainer_phase(torch, np, pt, kernels, fa, seed, exe_wall, root):
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.observability import runlog

    t_phase = time.perf_counter()
    steps = TRAINER_STEPS
    main, _, _ = build_training(pt, seed, TRAIN_T, "bfloat16", True)
    reckoned = sum(int(np.prod(v.shape)) * v.dtype.itemsize
                   for v in main.persistable_vars())
    log(f"phase 10: a checkpoint reckoned before the run at {reckoned} B of "
        f"tensors ({len(main.persistable_vars())} persistables: bf16 "
        f"weights, f32 moments) plus one 128 B .npy header each")
    del main
    # a. the Trainer on the rules' routes, every resilience knob on
    ck_a = os.path.join(root, "a")
    jsonl = os.path.join(root, "run.jsonl")
    kernels.reset_launches()                     # counts start at 0 here
    reg = obs.get_registry()
    reg.reset(prefix="checkpoint.")
    a = trainer_run(torch, np, pt, seed, steps, ck_a, jsonl)
    launches, fams = kernels.launch_counts(), kernels.family_counts()
    want = N_LAYER * steps
    expect = {"paged_attention": 0, "decode_gather": 0,
              "flash_attention_fwd": want, "flash_attention_bwd": want,
              "flash_attention_bwd_delta": want, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0, "fused_ce_fwd": steps,
              "fused_ce_dx": steps, "fused_ce_dw": steps, "bottleneck": 0}
    expect = dict(dict.fromkeys(launches, 0), **expect)   # the rest: none
    if launches != expect:
        raise AssertionError(f"phase 10 launches {launches}, expected "
                             f"{expect}")
    for name, n in (("flash_attention_fwd", want),
                    ("flash_attention_bwd", want), ("fused_ce_fwd", steps),
                    ("fused_ce_dx", steps), ("fused_ce_dw", steps)):
        if fams[name] != {"sm90": n, "simple": 0}:
            raise AssertionError(f"phase 10 {name} by family {fams[name]}")
    losses = a["losses"]
    if not (all(np.isfinite(x) for x in losses)
            and losses[-1] < losses[0] - 0.05):
        raise AssertionError(f"phase 10 losses {losses}")
    rows = runlog.read_jsonl(jsonl, event="step")
    if len(rows) != steps or any(r["mfu"] is None for r in rows):
        raise AssertionError(f"phase 10 JSONL: {len(rows)} step records, "
                             f"mfu {[r['mfu'] for r in rows]}")
    walls = [e.wall_time for e in a["ends"]]
    loop = np.diff(a["stamps"])
    after_ckpt = [loop[i - 1] for i in range(TRAINER_CKPT_EVERY, steps,
                                             TRAINER_CKPT_EVERY)]
    others = [loop[i - 1] for i in range(2, steps)
              if i % TRAINER_CKPT_EVERY]
    files, n_bf16, nbytes, _ = check_checkpoint_files(
        np, os.path.join(ck_a, f"step_{steps}"))
    snap = reg.get("checkpoint.snapshot_ms")
    save = reg.get("checkpoint.save_ms")
    sc = a["ends"][-1].step_cost
    log(f"phase 10a, Trainer.train, {steps} steps (t={TRAIN_T}, "
        f"b={TRAIN_B}, prefetch 2, async step checkpoints every "
        f"{TRAINER_CKPT_EVERY}): loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches}; JSONL {len(rows)} step records, mfu "
        + ", ".join(f"{r['mfu']:.4f}" for r in rows)
        + f" (flops a step {sc['flops']:.4e}, the port's count)")
    log(f"phase 10a step wall (EndIteration.wall_time) first "
        f"{walls[0]:.4f} s, then median {np.median(walls[1:]):.4f} s "
        f"(steps {', '.join(f'{w:.4f}' for w in walls[1:])}); phase 7's "
        f"Executor.run median {exe_wall:.4f} s; the loop's own overhead "
        f"{np.median(walls[1:]) - exe_wall:+.4f} s a step")
    log(f"phase 10a checkpoints: {int(reg.value('checkpoint.saves'))} "
        f"saves; save()'s synchronous copy (checkpoint.snapshot_ms) min "
        f"{snap.min:.1f}, mean {snap.mean:.1f}, max {snap.max:.1f} ms; the "
        f"worker's write (checkpoint.save_ms) min {save.min:.1f}, mean "
        f"{save.mean:.1f}, max {save.max:.1f} ms; checkpoint.bytes "
        f"{int(reg.value('checkpoint.last_bytes'))} B on disk against "
        f"{reckoned} B reckoned ({files} files, {n_bf16} bf16 under '<V2', "
        f"every CRC matching, __done0__ present; step_{steps} {nbytes} B); "
        f"loop interval after a checkpointed step "
        f"{', '.join(f'{x:.4f}' for x in after_ckpt)} s against "
        f"{', '.join(f'{x:.4f}' for x in others)} s after the others")
    gc.collect()
    torch.cuda.empty_cache()
    # a+. a save once the run's pinned blocks are back in the host cache
    reused = pinned_reuse_ms(pt, seed, os.path.join(root, "reuse"))
    log(f"phase 10a+ save() with the pinned block cached from phase 10a's "
        f"saves: {reused:.1f} ms (the copy of {reckoned} B alone)")
    # b. the op that is not deterministic, by running one step twice
    probe = determinism_probe(torch, np, pt, fa, seed,
                              os.path.join(ck_a, "step_4"))
    gc.collect()
    torch.cuda.empty_cache()
    route_cost(torch, np, pt, fa, seed, os.path.join(ck_a, "step_4"))
    del a
    gc.collect()
    torch.cuda.empty_cache()
    # c-e. under deterministic algorithms: the uninterrupted run, the
    #    resume from step 4, and steps_per_call=2 from the same start
    ck_b = os.path.join(root, "b")
    with deterministic(torch) as caught:
        kernels.reset_launches()
        b = trainer_run(torch, np, pt, seed, steps, ck_b)
        dlaunch = kernels.launch_counts()
        os.rename(os.path.join(ck_b, f"step_{steps}"),
                  os.path.join(root, "moved"))
        c = trainer_run(torch, np, pt, seed, steps, ck_b, resume=True)
        d = trainer_run(torch, np, pt, seed, 2, steps_per_call=2)
    if (dlaunch["flash_attention_bwd"], dlaunch["flash_attention_bwd_dq"],
            dlaunch["flash_attention_bwd_dkv"]) != (0, want, want):
        raise AssertionError(f"phase 10c launches {dlaunch}: the split "
                             f"route expected under deterministic algorithms")
    tail = b["losses"][4:]
    same = [n for n in b["params"]
            if torch.equal(b["params"][n], c["params"][n])]
    if c["losses"] != tail or len(same) != len(b["params"]):
        raise AssertionError(
            f"phase 10d resume: losses {c['losses']} vs {tail}, "
            f"{len(b['params']) - len(same)} parameters differ")
    if c["trainer"].last_resume["global_step"] != 4:
        raise AssertionError("phase 10d did not resume from step 4")
    if d["losses"] != b["losses"][:2]:
        raise AssertionError(f"phase 10e steps_per_call=2 losses "
                             f"{d['losses']} vs {b['losses'][:2]}")
    dwalls = [e.wall_time for e in b["ends"]]
    log(f"phase 10c under deterministic algorithms (the flash backward on "
        f"its split route: {dlaunch['flash_attention_bwd_dq']} dq + "
        f"{dlaunch['flash_attention_bwd_dkv']} dk/dv kernels, 0 fused): "
        f"loss " + " -> ".join(f"{x:.4f}" for x in b["losses"])
        + f"; step wall median {np.median(dwalls[1:]):.4f} s against "
        f"{np.median(walls[1:]):.4f} s on the rules' fused route "
        f"({np.median(dwalls[1:]) - np.median(walls[1:]):+.4f} s, both "
        f"runs with checkpoint writes in flight: the route cost is read "
        f"apart above); PyTorch warnings "
        f"{sorted({str(w.message)[:100] for w in caught}) or 'none'}")
    log(f"phase 10d resume from step_4: steps 5-6 loss "
        f"{c['losses']} == {tail}, all {len(same)} parameters bit-equal; "
        f"10e steps_per_call=2: {d['losses']} == {b['losses'][:2]}; the "
        f"rules' route differed step to step in {len(probe['rules'])} "
        f"parameters")
    log(f"phase 10 wall {time.perf_counter() - t_phase:.1f} s")
    return float(np.median(walls[1:]))


# -- phase 11: the training recipes at full width ----------------------------

RECIPE_STEPS, RECIPE_LR, RECIPE_END_LR = 6, 3e-4, 3e-5
RECIPE_L2, RECIPE_CLIP, RECIPE_EMA = 1e-4, 1.0, 0.999
OTHER_STEPS, RESNET_RECIPE_STEPS, OFFLOAD_STEPS, OFFLOAD_ROUNDS = 2, 4, 3, 4
BF16_TOL = 2e-2                     # ORACLE_TOL bf16, forward


@contextlib.contextmanager
def optimizer_of(module, name, make):
    """``module.build`` (the transformer's or ResNet's) with ``make()`` as
    its optimizer in place of the ``opt.<name>`` it constructs (a switch
    in this script only): build then appends the recipe's ops inside its
    program guard, where a user's script appends them."""
    import types

    orig = module.opt
    module.opt = types.SimpleNamespace(**{name: lambda **_: make()})
    try:
        yield
    finally:
        module.opt = orig


def recipe_training(pt, seed, make, t=TRAIN_T):
    """Phase 7's program (bf16, fused head, full width and depth) at
    sequence ``t`` with ``make()`` as its optimizer."""
    with optimizer_of(pt.models.transformer, "Adam", make):
        return build_training(pt, seed, t, "bfloat16", True)


def flagship_recipe(pt):
    """Adam on a polynomial schedule with L2 decay and a global-norm clip:
    the recipe of phase 11a."""
    lr = pt.learning_rate_decay.polynomial_decay(
        RECIPE_LR, decay_steps=RECIPE_STEPS, end_learning_rate=RECIPE_END_LR)
    return pt.optimizer.Adam(
        learning_rate=lr, regularization=pt.regularizer.L2Decay(RECIPE_L2),
        global_clip=pt.clip.GradientClipByGlobalNorm(RECIPE_CLIP))


def chain_end(main, prefix):
    """The last var the chain of schedule ``prefix`` writes (its rate)."""
    out = None
    for op in main.global_block().ops:
        for n in op.output_names():
            if re.match(rf"{prefix}_\d+\.tmp", n):
                out = n
    return out


def clip_factor_var(main):
    return next(n for n in main.global_block().vars
                if re.search(r"\.factor(_\d+)?$", n))


def step_kernels(torch, exe, main, scope, fetch, feed):
    """Kernels launched and their device time in one step (the second of
    two under ``torch.profiler``; the first warms it up): (calls, ms),
    or None when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
            prof.step()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    if not rows:
        return None
    return sum(r[1] for r in rows), sum(r[0] for r in rows) / 1e3


def recipe_phase(torch, np, pt, kernels, seed, adam_wall):
    """Phase 11a: phase 10's ``Trainer.train`` with the flagship recipe,
    then a ``ModelAverage`` evaluation; returns nothing, raises on any
    failed check."""
    t_phase = time.perf_counter()
    main, startup, model = recipe_training(pt, seed,
                                           lambda: flagship_recipe(pt))
    scope = pt.Scope()
    with pt.scope_guard(scope):
        ma = pt.optimizer.ModelAverage(RECIPE_EMA, main_program=main,
                                       startup_program=startup)
    lr_var, factor = chain_end(main, "polynomial_decay"), clip_factor_var(main)
    counter = next(v.name for v in main.persistable_vars()
                   if v.name.endswith(".step"))
    n_params = len(main.all_parameters())
    losses, lrs, factors, norms, walls = [], [], [], [], []

    def on_event(e):
        if isinstance(e, pt.EndIteration):
            losses.append(e.cost)
            lrs.append(float(e.metrics[0].reshape(-1)[0]))
            factors.append(float(e.metrics[1].reshape(-1)[0]))
            norms.append(float(e.grad_norm))
            walls.append(e.wall_time)

    kernels.reset_launches()                     # counts start at 0 here
    with pt.scope_guard(scope):
        tr = pt.Trainer(model["avg_cost"], model["feed"], main_program=main,
                        startup_program=startup, extra_fetch=[lr_var, factor])
        tr.train(pt.reader.batch(trainer_samples(np, seed, RECIPE_STEPS),
                                 TRAIN_B),
                 num_passes=1, event_handler=on_event, prefetch=2)
    torch.cuda.synchronize()
    launches, fams = kernels.launch_counts(), kernels.family_counts()
    steps, want = RECIPE_STEPS, N_LAYER * RECIPE_STEPS
    expect = {"paged_attention": 0, "decode_gather": 0,
              "flash_attention_fwd": want, "flash_attention_bwd": want,
              "flash_attention_bwd_delta": want, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0, "fused_ce_fwd": steps,
              "fused_ce_dx": steps, "fused_ce_dw": steps, "bottleneck": 0}
    expect = dict(dict.fromkeys(launches, 0), **expect)   # the rest: none
    if launches != expect:
        raise AssertionError(f"phase 11a launches {launches}, expected "
                             f"{expect}")
    for name in ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd",
                 "fused_ce_dx", "fused_ce_dw"):
        if fams[name]["simple"] or not fams[name]["sm90"]:
            raise AssertionError(f"phase 11a {name} by family {fams[name]}")
    if not (all(np.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 11a losses {losses}")
    closed = [(RECIPE_LR - RECIPE_END_LR) * (1 - min(k, steps) / steps)
              + RECIPE_END_LR for k in range(1, steps + 1)]
    if not all(abs(a - b) <= 1e-6 * b for a, b in zip(lrs, closed)):
        raise AssertionError(f"phase 11a rates {lrs}, closed form {closed}")
    if float(scope.get(counter)[0]) != steps:
        raise AssertionError(f"phase 11a counter {scope.get(counter)}")
    # @GRAD_NORM@ is the executor's f32 norm of the gradients before the
    # clip (as the reference's); the factor the bf16 op chain's
    want_f = [RECIPE_CLIP / max(g, RECIPE_CLIP) for g in norms]
    if not all(abs(a - b) <= BF16_TOL * b for a, b in zip(factors, want_f)):
        raise AssertionError(f"phase 11a clip factors {factors}, from "
                             f"@GRAD_NORM@ {want_f}")
    log(f"phase 11a, Trainer.train with Adam + polynomial_decay({RECIPE_LR}"
        f" -> {RECIPE_END_LR} over {steps}) + L2Decay({RECIPE_L2}) + "
        f"GradientClipByGlobalNorm({RECIPE_CLIP}) + ModelAverage("
        f"{RECIPE_EMA}), {steps} steps (t={TRAIN_T}, b={TRAIN_B}): loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + "; rate " + ", ".join(f"{x:.4e}" for x in lrs)
        + f" (the closed form at step 1..{steps}); {counter} = "
        f"{float(scope.get(counter)[0]):.0f}; clip factor "
        + ", ".join(f"{x:.5f}" for x in factors) + " against 1/max("
        "@GRAD_NORM@, 1) " + ", ".join(f"{x:.5f}" for x in want_f)
        + f" (@GRAD_NORM@ {', '.join(f'{g:.4f}' for g in norms)}); "
        f"launches {launches}")
    log(f"phase 11a step wall (EndIteration.wall_time) median "
        f"{np.median(walls[1:]):.4f} s (steps "
        f"{', '.join(f'{w:.4f}' for w in walls[1:])}); phase 10a's plain "
        f"Adam median {adam_wall:.4f} s; "
        f"{np.median(walls[1:]) - adam_wall:+.4f} s a step")
    # the ModelAverage evaluation: the averages swapped in for one
    # forward of the test program on a held-out batch
    test = main.clone(for_test=True)
    test_types = {op.type for op in test.global_block().ops}
    if test_types & {"increment", "adam", "squared_l2_norm"} or any(
            op.role != "forward" for op in test.global_block().ops):
        raise AssertionError(f"phase 11a's test program keeps training ops: "
                             f"{sorted(test_types)}")
    params = [p.name for p in main.all_parameters()]
    before = {n: scope.get(n) for n in params}
    values = {n: t.clone() for n, t in before.items()}
    emas = {e: scope.get(e).clone() for _, e in ma.pairs}
    count0 = scope.get(counter).clone()
    held_out = make_batch(torch, np.random.default_rng(seed + 7), TRAIN_B,
                          TRAIN_T)
    kernels.reset_launches()
    with ma.apply(scope=scope):
        swapped = all(torch.equal(scope.get(p), scope.get(e))
                      and scope.get(p).data_ptr() != scope.get(e).data_ptr()
                      for p, e in ma.pairs)
        ev, = tr.exe.run(test, feed=held_out, scope=scope,
                         fetch_list=[model["avg_cost"]], return_numpy=False)
        ev = ev.item()
    eval_launches = {k: v for k, v in kernels.launch_counts().items() if v}
    if eval_launches != {"flash_attention_fwd": N_LAYER, "fused_ce_fwd": 1}:
        raise AssertionError(f"phase 11a eval launches {eval_launches}")
    restored = all(scope.get(n) is before[n]
                   and torch.equal(scope.get(n), values[n]) for n in params)
    ema_kept = all(torch.equal(scope.get(e), v) for e, v in emas.items())
    if not (swapped and restored and ema_kept and np.isfinite(ev)
            and torch.equal(scope.get(counter), count0)):
        raise AssertionError(
            f"phase 11a ModelAverage: swapped {swapped}, restored "
            f"{restored}, averages kept {ema_kept}, eval loss {ev}")
    log(f"phase 11a ModelAverage.apply(): eval loss {ev:.4f} on a held-out "
        f"batch with the averages in (launches {eval_launches}); every one "
        f"of {len(params)} parameters the same tensor and bits after, the "
        f"averages and the counter unchanged")
    # what the recipe costs in launches: one step of the recipe program
    # against one of phase 7's plain Adam program, each profiled
    fetch = [model["avg_cost"]]
    recipe_k = step_kernels(torch, tr.exe, main, scope, fetch, held_out)
    del tr, scope, before, values, emas, ma
    gc.collect()
    torch.cuda.empty_cache()
    pmain, pstart, pmodel = build_training(pt, seed, TRAIN_T, "bfloat16",
                                           True)
    pexe, pscope = pt.Executor(), pt.Scope()
    pexe.run(pstart, scope=pscope)
    plain_k = step_kernels(torch, pexe, pmain, pscope, [pmodel["avg_cost"]],
                           held_out)
    if recipe_k and plain_k:
        log(f"phase 11a launches a step: recipe {recipe_k[0]} kernels "
            f"({recipe_k[1]:.1f} ms of device time), plain Adam "
            f"{plain_k[0]} ({plain_k[1]:.1f} ms): the recipe adds "
            f"{recipe_k[0] - plain_k[0]} kernels and "
            f"{recipe_k[1] - plain_k[1]:.1f} ms ({n_params} parameters: "
            f"the global clip's squared_l2_norm and elementwise_mul, L2's "
            f"scale and sum, the average's two scales and add, each per "
            f"parameter)")
    else:
        log("phase 11a launches a step: the profiler recorded no device "
            "time")
    del pexe, pscope
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11a wall {time.perf_counter() - t_phase:.1f} s")


# phase 11a+: every other optimizer, two with L1 decay and per-parameter
# clips (a clip attribute on every parameter, set where ParamAttr's
# gradient_clip lands)
OTHER_RECIPES = {
    "SGD + L1Decay + GradientClipByValue": (
        "sgd", lambda pt: pt.optimizer.SGD(
            learning_rate=1e-2, regularization=pt.regularizer.L1Decay(1e-5)),
        lambda pt: pt.clip.GradientClipByValue(1e-2)),
    "Momentum (Nesterov) + L1Decay + GradientClipByNorm": (
        "momentum", lambda pt: pt.optimizer.Momentum(
            learning_rate=1e-2, momentum=0.9, use_nesterov=True,
            regularization=pt.regularizer.L1Decay(1e-5)),
        lambda pt: pt.clip.GradientClipByNorm(1.0)),
    "Adagrad": ("adagrad", lambda pt: pt.optimizer.Adagrad(
        learning_rate=1e-3), None),
    "Adamax": ("adamax", lambda pt: pt.optimizer.Adamax(
        learning_rate=1e-3), None),
    "DecayedAdagrad": ("decayed_adagrad", lambda pt:
                       pt.optimizer.DecayedAdagrad(learning_rate=1e-3), None),
    "Adadelta": ("adadelta", lambda pt: pt.optimizer.Adadelta(
        learning_rate=1.0, rho=0.95), None),
    "RMSProp (momentum)": ("rmsprop", lambda pt: pt.optimizer.RMSProp(
        learning_rate=1e-4, momentum=0.9), None),
    "Ftrl (l1, l2)": ("ftrl", lambda pt: pt.optimizer.Ftrl(
        learning_rate=1e-2, l1=1e-4, l2=1e-4), None),
}
# each op's attrs as its optimizer passes them, and its state slots
# (positive: a sum of squares)
OP_STATE = {
    "sgd": ({}, {}),
    "momentum": ({"mu": 0.9, "use_nesterov": True}, {"Velocity": False}),
    "adagrad": ({"epsilon": 1e-6}, {"Moment": True}),
    "adamax": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
               {"Moment": False, "InfNorm": True}),
    "decayed_adagrad": ({"decay": 0.95, "epsilon": 1e-6}, {"Moment": True}),
    "adadelta": ({"rho": 0.95, "epsilon": 1e-6},
                 {"AvgSquaredGrad": True, "AvgSquaredUpdate": True}),
    "rmsprop": ({"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9},
                {"MeanSquare": True, "Moment": False}),
    "ftrl": ({"l1": 1e-4, "l2": 1e-4, "lr_power": -0.5},
             {"SquaredAccumulator": True, "LinearAccumulator": False}),
}


def op_card_vs_cpu(torch, op, shapes, gen):
    """``op`` on the card and on the CPU, on copies of the flagship's
    parameter ``shapes``: bf16 parameters and one gradient each from
    ``gen``, f32 state; the worst max-relative error over every output
    of every parameter, and the card's time for all of them."""
    from paddle_tpu_torch.core.registry import get_op_impl

    fn = get_op_impl(op).fn
    attrs, state = OP_STATE[op]
    lr = torch.tensor([1e-3], device="cuda")
    worst, ms = 0.0, 0.0
    for shape in shapes:
        ins = {"Param": torch.randn(shape, generator=gen, device="cuda"
                                    ).to(torch.bfloat16),
               "Grad": (1e-2 * torch.randn(shape, generator=gen,
                                           device="cuda")).to(torch.bfloat16)}
        for slot, pos in state.items():
            x = 1e-3 * torch.randn(shape, generator=gen, device="cuda")
            ins[slot] = x.abs() + 1e-4 if pos else x
        if op == "adamax":
            ins["Beta1Pow"] = torch.tensor([0.9], device="cuda")
        if op != "adadelta":
            ins["LearningRate"] = lr
        cpu = {k: v.cpu() for k, v in ins.items()}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got = fn(**ins, **attrs)
        e1.record()
        want = fn(**cpu, **attrs)
        e1.synchronize()
        ms += e0.elapsed_time(e1)
        for slot, t in got.items():
            w = want[slot].float()
            scale = float(w.abs().max()) or 1.0
            worst = max(worst, float((t.float().cpu() - w).abs().max())
                        / scale)
    return worst, ms


def other_optimizers_phase(torch, np, pt, seed):
    """Phase 11a+: each other optimizer's update op on the card against
    the CPU over each distinct parameter shape of the flagship (its layers
    repeat one set of shapes, so one of each is checked: the CPU's share
    of the phase scales with the elements), then two full-width
    ``Trainer.train`` steps with it."""
    t_phase = time.perf_counter()
    main, _, _ = build_training(pt, seed, TRAIN_T, "bfloat16", True)
    n_params = len(main.all_parameters())
    shapes = sorted({tuple(p.shape) for p in main.all_parameters()})
    del main
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for label, (op, make, clip) in OTHER_RECIPES.items():
        err, ms = op_card_vs_cpu(torch, op, shapes, gen)
        if not err <= BF16_TOL:
            raise AssertionError(f"phase 11a+ {op} on the card vs the CPU: "
                                 f"max-relative {err}")

        def recipe(make=make, clip=clip):
            if clip is not None:
                for p in pt.default_main_program().all_parameters():
                    p.gradient_clip_attr = clip(pt)
            return make(pt)

        main, startup, model = recipe_training(pt, seed, recipe)
        types = [op_.type for op_ in main.global_block().ops]
        if types.count(op) != n_params:
            raise AssertionError(f"phase 11a+ {label}: {types.count(op)} "
                                 f"{op} ops for {n_params} parameters")
        scope, losses = pt.Scope(), []
        with pt.scope_guard(scope):
            tr = pt.Trainer(model["avg_cost"], model["feed"],
                            main_program=main, startup_program=startup)
            tr.train(pt.reader.batch(trainer_samples(np, seed, OTHER_STEPS),
                                     TRAIN_B), num_passes=1,
                     event_handler=lambda e: losses.append(e.cost)
                     if isinstance(e, pt.EndIteration) else None)
        if len(losses) != OTHER_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"phase 11a+ {label} losses {losses}")
        log(f"phase 11a+ {label}: {op} on the card vs the CPU over the "
            f"{len(shapes)} distinct shapes of {n_params} parameters (bf16 "
            f"parameters, f32 state) "
            f"max-relative {err:.3e} (card {ms:.2f} ms for all); "
            f"{OTHER_STEPS} Trainer steps, loss "
            + " -> ".join(f"{x:.4f}" for x in losses))
        del tr, scope
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 11a+ wall {time.perf_counter() - t_phase:.1f} s")


def resnet_recipe_phase(torch, np, pt, kernels, seed):
    """Phase 11b: ResNet-50 (phase 9's) with Momentum on a staircase
    exponential decay and L2 decay, 4 steps."""
    t_phase = time.perf_counter()

    def recipe():
        lr = pt.learning_rate_decay.exponential_decay(
            0.1, decay_steps=2, decay_rate=0.1, staircase=True)
        return pt.optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            regularization=pt.regularizer.L2Decay(1e-4))

    with optimizer_of(pt.models.resnet, "Momentum", recipe):
        main, startup, model = build_resnet(pt, seed)
    lr_var = chain_end(main, "exponential_decay")
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = resnet_batch(torch, seed)
    kernels.reset_launches()
    losses, lrs = [], []
    for _ in range(RESNET_RECIPE_STEPS):
        loss, lr = exe.run(main, feed=feed, scope=scope,
                           fetch_list=[model["avg_cost"], lr_var],
                           return_numpy=False)
        losses.append(loss.item())
        lrs.append(lr.item())
    # the counter advances before the rate is read: step k reads
    # 0.1 * 0.1 ** floor(k / 2)
    want = [0.1 * 0.1 ** (k // 2) for k in range(1, RESNET_RECIPE_STEPS + 1)]
    if not all(abs(a - b) <= 1e-6 * b for a, b in zip(lrs, want)):
        raise AssertionError(f"phase 11b rates {lrs}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 11b losses {losses}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"phase 11b launched a hand-written kernel: "
                             f"{kernels.launch_counts()}")
    log(f"phase 11b, ResNet-{RESNET_DEPTH} b={RESNET_BATCH} with Momentum "
        f"(0.9) on exponential_decay(0.1, 2, 0.1, staircase) + "
        f"L2Decay(1e-4), {RESNET_RECIPE_STEPS} steps: rate "
        + ", ".join(f"{x:g}" for x in lrs) + "; loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; wall {time.perf_counter() - t_phase:.1f} s")
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()


def offload_phase(torch, np, pt, kernels, seed):
    """Phase 11c: phase 8's program (t=16384) under ``selective`` and under
    ``offload`` from one state and batch under deterministic algorithms:
    the same bits, offload's peak below selective's; the kill switch;
    step walls in alternated rounds."""
    t_phase = time.perf_counter()
    mains = {}
    for policy in ("selective", "offload"):
        main, startup, model = build_training(pt, seed, LONG_T, "bfloat16",
                                              True)
        pt.memory_optimize(main, policy=policy)
        mains[policy] = main
    fetch = [model["avg_cost"].name]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    start = {n: scope.get(n) for n in scope.var_names()}
    start = {n: v.cpu().clone() if isinstance(v, torch.Tensor) else v
             for n, v in start.items()}
    rng = np.random.default_rng(seed + 11)
    batches = [make_batch(torch, rng, TRAIN_B, LONG_T)
               for _ in range(OFFLOAD_STEPS)]
    params = [p.name for p in mains["selective"].all_parameters()]
    unit = TRAIN_B * LONG_T * D_MODEL * 2
    want = N_LAYER * OFFLOAD_STEPS

    def run(policy, switch="1"):
        for n, v in start.items():
            scope.set(n, v.to("cuda") if n != "@RNG@" else v.clone())
        prev = os.environ.get("PADDLE_TPU_OFFLOAD")
        os.environ["PADDLE_TPU_OFFLOAD"] = switch
        try:
            kernels.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = [exe.run(mains[policy], feed=b, fetch_list=fetch,
                              scope=scope, return_numpy=False)[0]
                      for b in batches]
            torch.cuda.synchronize()
        finally:
            if prev is None:
                os.environ.pop("PADDLE_TPU_OFFLOAD")
            else:
                os.environ["PADDLE_TPU_OFFLOAD"] = prev
        return {"losses": [x.cpu() for x in losses],
                "peak": torch.cuda.max_memory_allocated(),
                "plan": exe.last_remat_plan,
                "launches": kernels.launch_counts(),
                "params": {n: scope.get(n).cpu() for n in params}}

    with deterministic(torch) as caught:
        sel = run("selective")
        off = run("offload")
        killed = run("offload", switch="0")
        walls = {"selective": [], "offload": []}
        for r in range(OFFLOAD_ROUNDS + 1):
            for policy in (("selective", "offload") if r % 2
                           else ("offload", "selective")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, = exe.run(mains[policy], feed=batches[0],
                                fetch_list=fetch, scope=scope,
                                return_numpy=False)
                loss.item()
                if r:
                    walls[policy].append(time.perf_counter() - t0)
    for name, r in (("offload", off), ("PADDLE_TPU_OFFLOAD=0", killed)):
        same = [n for n in params if torch.equal(r["params"][n],
                                                 sel["params"][n])]
        if not (all(torch.equal(a, b) for a, b in zip(r["losses"],
                                                       sel["losses"]))
                and len(same) == len(params)):
            raise AssertionError(
                f"phase 11c {name}: losses {r['losses']} vs selective's "
                f"{sel['losses']}, {len(params) - len(same)} parameters "
                f"differ")
    for name, r in (("selective", sel), ("offload", off),
                    ("PADDLE_TPU_OFFLOAD=0", killed)):
        split = (r["launches"]["flash_attention_bwd_dq"],
                 r["launches"]["flash_attention_bwd_dkv"],
                 r["launches"]["flash_attention_bwd"])
        if split != (want, want, 0):
            raise AssertionError(f"phase 11c {name} split launches {split}")
    if (sel["plan"]["offload"], off["plan"]["offload"],
            killed["plan"]["offload"]) != ("off", "host", "off"):
        raise AssertionError(f"phase 11c modes {sel['plan']}, "
                             f"{off['plan']}, {killed['plan']}")
    if not off["peak"] < sel["peak"]:
        raise AssertionError(f"phase 11c offload's peak {off['peak']} B is "
                             f"not below selective's {sel['peak']} B")
    if abs(killed["peak"] - sel["peak"]) > 64 * 2 ** 20:
        raise AssertionError(f"phase 11c PADDLE_TPU_OFFLOAD=0 peak "
                             f"{killed['peak']} B, selective's {sel['peak']}")
    plan = off["plan"]
    group = plan["groups"][0]
    log(f"phase 11c t={LONG_T} b={TRAIN_B} under deterministic algorithms, "
        f"{OFFLOAD_STEPS} steps each from one state: losses "
        + ", ".join(f"{x.item():.6f}" for x in sel["losses"])
        + f" under selective, offload and PADDLE_TPU_OFFLOAD=0 alike, all "
        f"{len(params)} parameters bit-equal; max_memory_allocated "
        f"selective {sel['peak']} B, offload {off['peak']} B "
        f"({(sel['peak'] - off['peak']) / 1e9:.3f} GB less), "
        f"PADDLE_TPU_OFFLOAD=0 {killed['peak']} B; sent to the host a step "
        f"{plan['offloaded']} tensors, {plan['offloaded_bytes']} B (the "
        f"group's carry {group['carry']} x {group['count']} repeats; "
        f"reckoned: one [b, t, d] bf16 input a layer {N_LAYER * unit} B, "
        f"two {2 * N_LAYER * unit} B); split dq/dkv launches "
        f"{want}/{want} each run; PyTorch warnings "
        f"{sorted({str(w.message)[:100] for w in caught}) or 'none'}")
    for policy, ws in walls.items():
        log(f"phase 11c step wall {policy}: median {np.median(ws):.4f} s "
            f"(by round {', '.join(f'{w:.4f}' for w in ws)})")
    diff = (np.asarray(walls["offload"]) - np.asarray(walls["selective"]))
    log(f"phase 11c offload - selective by round "
        f"{', '.join(f'{d * 1e3:+.2f}' for d in diff)} ms, median "
        f"{np.median(diff) * 1e3:+.2f} ms; wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    del exe, scope, start
    gc.collect()
    torch.cuda.empty_cache()



# -- phase 12: the recurrent path ---------------------------------------------

# the reference's two recurrent rows of its benchmark sweep, f32, Adam at
# build's own rate: benchmarks/run.py:39-40 ("lstm": text_classification,
# bs64, t=100, hid 512, dict 10,000; the reference's
# benchmark/paddle/rnn/rnn.py) and :44-45 ("seq2seq": bs64, t=32, dict
# 30,000, word 256, hid 512; BASELINE config 3)
RNN_CFGS = {
    "text_classification": dict(dict_dim=10000, class_dim=2, emb_dim=128,
                                hid_dim=512, stacked_num=2, max_len=100),
    "seq2seq": dict(src_dict_size=30000, trg_dict_size=30000, word_dim=256,
                    hidden_dim=512, max_len=32),
}
RNN_BATCH, RNN_STEPS = 64, 6
# 12c: the card against the port's CPU path at a reduced width
RNN_CHECK_T, RNN_CHECK_HID, RNN_CHECK_BATCH = 16, 128, 16


def rnn_build(pt, name, cfg):
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        model = getattr(pt.models, name).build(**cfg)
    return main, startup, model


def rnn_rows(np, seed, name, cfg, batch, ragged):
    """One batch of rows in feed order, made from ``seed``: every
    sequence ``max_len`` long, or ragged (lengths drawn from
    ``[max_len // 5, max_len]``: 20-100 at t=100)."""
    rng = np.random.default_rng(seed)
    t = cfg["max_len"]

    def seq(high):
        n = int(rng.integers(t // 5, t + 1)) if ragged else t
        return rng.integers(0, high, n).tolist()

    if name == "text_classification":
        return [(seq(cfg["dict_dim"]), [int(rng.integers(0, 2))])
                for _ in range(batch)]
    rows = []
    for _ in range(batch):
        trg = seq(cfg["trg_dict_size"])
        rows.append((seq(cfg["src_dict_size"]), trg, trg[1:] + [0]))
    return rows


def rnn_phase(torch, np, pt, kernels, smi, seed, name, ragged):
    """Phase 12a / 12b: ``name`` at the full width of its benchmark row,
    f32, ``RNN_STEPS`` Adam steps on one batch through ``DataFeeder`` and
    ``Executor.run``: the losses finite and falling, no hand-written
    kernel launched (the path reaches none of the table's kernels); then,
    at full length, one profiled step."""
    cfg = RNN_CFGS[name]
    main, startup, model = rnn_build(pt, name, cfg)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rows = rnn_rows(np, seed, name, cfg, RNN_BATCH, ragged)
    feed = pt.DataFeeder(model["feed"]).feed(rows)
    lens = feed[model["feed"][0].name + "@LENGTH"]
    if name == "seq2seq":
        lens = feed["target_language_word@LENGTH"]
    tokens = int(lens.sum())
    fetch = [model["avg_cost"].name]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, walls = [], []
    for _ in range(RNN_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
        losses.append(loss.item())               # ends in a device sync
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    flops = exe.last_step_cost["flops"]
    what = (f"phase 12{'a' if name == 'text_classification' else 'b'} "
            f"{name} b={RNN_BATCH} t={cfg['max_len']} "
            f"{'ragged' if ragged else 'full length'} ({smi})")
    log(f"{what}: loss " + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step wall first {walls[0]:.3f} s, then median {steady:.4f} s "
        f"= {RNN_BATCH / steady:.1f} seq/s, {tokens / steady:.0f} tok/s "
        f"({tokens} tokens a step); {flops / 1e9:.2f} GFLOP a step by "
        f"step_flops = {flops / steady / 1e12:.3f} TFLOP/s "
        f"({flops / steady / PEAK_FLOPS['float32']:.4f} of the f32 peak); "
        f"max_memory_allocated {peak} B")
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"{what} launched a hand-written kernel: "
                             f"{kernels.launch_counts()}")
    if not ragged:
        sums = profile_step(torch, exe, main, scope, fetch, feed, steady)
        busy_ms = sum(ms for ms, _ in sums.values())
        log(f"{what}: {sum(n for _, n in sums.values())} kernels a step, "
            f"busy share {busy_ms / (steady * 1e3):.3f} ({busy_ms:.1f} ms "
            f"of kernels in a {steady * 1e3:.1f} ms step)")
    del exe, scope
    gc.collect()
    torch.cuda.empty_cache()


def rel_max(np, a, b):
    """max |a - b| over max |b| (max |a| where b is all zeros)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(
        np.abs(a).max())


def rnn_check_phase(torch, np, pt, smi, seed, name):
    """Phase 12c: ``name`` at t=16 and hidden 128 (the rest at full
    width), batch 16, ragged, from one startup state: one Adam step on
    the card and on the port's CPU path (TF32 off), the loss within
    ORACLE_TOL f32's forward bound (2e-4 relative) and every parameter's
    gradient within its gradient bound (1e-3 of the largest entry)."""
    cfg = dict(RNN_CFGS[name], max_len=RNN_CHECK_T)
    cfg["hid_dim" if name == "text_classification" else
        "hidden_dim"] = RNN_CHECK_HID
    main, startup, model = rnn_build(pt, name, cfg)
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    init = {v.name: cpu_scope.numpy(v.name).copy()
            for v in main.persistable_vars()
            if cpu_scope.find_var(v.name) is not None}
    exe, scope = pt.Executor(), pt.load_numpy_state(pt.Scope(), init)
    feed = pt.DataFeeder(model["feed"], pt.CPUPlace()).feed(
        rnn_rows(np, seed, name, cfg, RNN_CHECK_BATCH, True))
    params = [p.name for p in main.all_parameters()]
    fetch = [model["avg_cost"].name] + [p + "@GRAD" for p in params]
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    want = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)

    loss_err = rel_max(np, got[0], want[0])
    grad_errs = {p: rel_max(np, g, w)
                 for p, g, w in zip(params, got[1:], want[1:])}
    worst = max(grad_errs, key=grad_errs.get)
    log(f"phase 12c {name} t={RNN_CHECK_T} hid={RNN_CHECK_HID} "
        f"b={RNN_CHECK_BATCH}, one step card vs CPU ({smi}): loss "
        f"{float(np.ravel(got[0])[0]):.6f} vs {float(np.ravel(want[0])[0]):.6f}"
        f" (rel {loss_err:.2e}); {len(params)} gradients, worst "
        f"{worst} rel {grad_errs[worst]:.2e}")
    if loss_err > 2e-4:
        raise AssertionError(f"phase 12c {name}: loss rel {loss_err}")
    bad = {p: e for p, e in grad_errs.items() if e > 1e-3}
    if bad:
        raise AssertionError(f"phase 12c {name}: gradients off {bad}")


# -- phase 13: DeepSpeech2, the image rows and the CRF tagger -----------------

# benchmarks/run.py's ds2 row (:47-49; its _feed at :125-134): b=32, 256
# frames of 161 features, 3 BiGRU layers of 256, vocab 29 (+ the blank),
# labels of width 64 with lengths 40 drawn from 1..28; f32, Adam 5e-4
DS2_CFG = dict(feat_dim=161, max_audio_len=256, max_label_len=64,
               rnn_size=256, num_rnn_layers=3, vocab_size=29)
DS2_BATCH, ZOO_STEPS = 32, 6
# 13a's steps a run (2.6 s each on the card; the image rows keep
# ZOO_STEPS)
DS2_STEPS = 4
# run.py's image rows (:30-37) at its dtype (bf16; BENCH_DTYPE's default)
# and their builds' Momentum 0.9, and BASELINE config 1: the MNIST LeNet
# at its build's f32 and Adam, batch 64: name -> (build kwargs, batch)
IMAGE_ROWS = {
    "smallnet": (dict(class_dim=10, image_shape=(3, 32, 32),
                      dtype="bfloat16"), 64),
    "alexnet": (dict(class_dim=1000, image_shape=(3, 227, 227),
                     dtype="bfloat16"), 128),
    "googlenet": (dict(class_dim=1000, image_shape=(3, 224, 224),
                       dtype="bfloat16"), 128),
    "vgg": (dict(depth=19, class_dim=1000, image_shape=(3, 224, 224),
                 dtype="bfloat16"), 64),
    "lenet": (dict(), 64),
}
# label_semantic_roles.build's defaults (the book's db_lstm: word dict
# 44,068, 67 labels, 3,162 predicates, max_len 64, word_dim 32, hidden
# 512, depth 4, SGD at 0.01); the book's batch is not in the repo: 64,
# the sweep's RNN batch, with lengths 13-64
SRL_CFG = dict(word_dict_len=44068, label_dict_len=67, pred_dict_len=3162,
               max_len=64, word_dim=32, hidden_dim=512, depth=4,
               learning_rate=0.01)
SRL_BATCH, SRL_MIN_LEN = 64, 13
# 13d: the CPU tests' sizes (tests/test_torch_zoo_models.py)
ZOO_CHECK = {
    "deep_speech2": dict(feat_dim=8, max_audio_len=12, max_label_len=6,
                         rnn_size=8, num_rnn_layers=1, vocab_size=5,
                         learning_rate=0.01),
    "label_semantic_roles": dict(word_dict_len=30, label_dict_len=5,
                                 pred_dict_len=8, max_len=6, word_dim=4,
                                 hidden_dim=8, depth=2, learning_rate=0.02),
    "lenet": dict(learning_rate=0.001),
    "smallnet": dict(class_dim=10, learning_rate=0.002),
    "alexnet": dict(class_dim=4, image_shape=(3, 96, 96),
                    learning_rate=0.01, dtype="float32"),
    "googlenet": dict(class_dim=4, image_shape=(3, 128, 128),
                      learning_rate=0.001, dtype="float32"),
    "vgg": dict(depth=19, class_dim=4, image_shape=(3, 32, 32),
                learning_rate=0.01, dtype="float32"),
}
ZOO_CHECK_BATCH = {"lenet": 4, "smallnet": 4, "alexnet": 2, "googlenet": 2,
                   "vgg": 4}


def ds2_rows(np, seed, batch, ragged):
    """One batch of (audio [frames, 161], transcript) rows from ``seed``:
    as run.py feeds it (256 frames of uniform [0, 1) features, 40 labels
    from 1..28), or ragged (128-256 frames, 20-40 labels)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(batch):
        t = int(rng.integers(128, 257)) if ragged else 256
        n = int(rng.integers(20, 41)) if ragged else 40
        rows.append((rng.random((t, DS2_CFG["feat_dim"]), dtype=np.float32),
                     rng.integers(1, DS2_CFG["vocab_size"], n).tolist()))
    return rows


def image_rows(np, seed, name, batch):
    """run.py's image batch: uniform [0, 1) pixels, labels from seed."""
    cfg = IMAGE_ROWS[name][0]
    shape = tuple(cfg.get("image_shape", (1, 28, 28)))
    classes = cfg.get("class_dim", 10)
    rng = np.random.default_rng(seed)
    img = rng.random((batch,) + shape, dtype=np.float32)
    label = rng.integers(0, classes, batch)
    return [(img[i], [int(label[i])]) for i in range(batch)]


def srl_rows(np, seed, batch, cfg):
    """Nine columns a row (six word windows, the predicate, the mark, the
    target tags), one length a row from ``SRL_MIN_LEN`` to max_len."""
    rng = np.random.default_rng(seed)
    highs = [cfg["word_dict_len"]] * 6 + [cfg["pred_dict_len"], 2,
                                          cfg["label_dict_len"]]
    rows = []
    for _ in range(batch):
        n = int(rng.integers(SRL_MIN_LEN, cfg["max_len"] + 1))
        rows.append(tuple(rng.integers(0, h, n).tolist() for h in highs))
    return rows


def zoo_steps(torch, np, pt, kernels, what, name, cfg, rows, steps=ZOO_STEPS):
    """``steps`` steps of ``name``'s program from a fresh startup state on
    one batch fed through ``DataFeeder`` and ``Executor.run``: the losses
    finite, no hand-written kernel launched.  Returns the run's record."""
    main, startup, model = rnn_build(pt, name, cfg)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = pt.DataFeeder(model["feed"]).feed(rows)
    fetch = [model["avg_cost"].name]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
        losses.append(loss.item())               # ends in a device sync
        walls.append(time.perf_counter() - t0)
    rec = dict(main=main, model=model, exe=exe, scope=scope, feed=feed,
               fetch=fetch, losses=losses, walls=walls,
               steady=sorted(walls[1:])[len(walls[1:]) // 2],
               peak=torch.cuda.max_memory_allocated(),
               flops=exe.last_step_cost["flops"])
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"{what} launched a hand-written kernel: "
                             f"{kernels.launch_counts()}")
    return rec


def zoo_log(what, rec, items, unit, smi, flops=True):
    """The losses, the step walls, items/s, ``step_flops``' TFLOP/s
    (``flops``: it counts the matrix and recurrent products, not the
    convolutions) and the peak memory."""
    steady = rec["steady"]
    rate = (f"{rec['flops'] / 1e9:.2f} GFLOP a step by step_flops = "
            f"{rec['flops'] / steady / 1e12:.3f} TFLOP/s; " if flops else "")
    log(f"{what} ({smi}): loss " + " -> ".join(
        f"{x:.4f}" for x in rec["losses"])
        + f"; step wall first {rec['walls'][0]:.3f} s, then median "
        f"{steady:.4f} s = {items / steady:.1f} {unit}/s; {rate}"
        f"max_memory_allocated {rec['peak']} B")


def zoo_profile(torch, what, rec):
    """Kernels a step and the busy share of one profiled step."""
    sums = profile_step(torch, rec["exe"], rec["main"], rec["scope"],
                        rec["fetch"], rec["feed"], rec["steady"])
    busy_ms = sum(ms for ms, _ in sums.values())
    log(f"{what}: {sum(n for _, n in sums.values())} kernels a step, busy "
        f"share {busy_ms / (rec['steady'] * 1e3):.3f} ({busy_ms:.1f} ms of "
        f"kernels in a {rec['steady'] * 1e3:.1f} ms step)")


def ds2_phase(torch, np, pt, kernels, smi, seed):
    """Phase 13a: DeepSpeech2 at run.py's ds2 row, full length as run.py
    feeds it, then ragged; the losses finite and falling; the greedy
    decode's mean edit distance to the transcript; a profiled step; then
    the port's ``warpctc`` beside ``F.ctc_loss`` at the path's shape."""
    from paddle_tpu_torch.core.registry import get_op_impl

    ed = get_op_impl("edit_distance").fn
    for ragged in (False, True):
        t0 = time.perf_counter()
        rows = ds2_rows(np, seed + ragged, DS2_BATCH, ragged)
        what = (f"phase 13a deep_speech2 b={DS2_BATCH} "
                f"{'ragged' if ragged else 'full length'}")
        rec = zoo_steps(torch, np, pt, kernels, what, "deep_speech2",
                        DS2_CFG, rows, steps=DS2_STEPS)
        frames = int(rec["feed"]["audio@LENGTH"].sum())
        zoo_log(what, rec, frames, "frames", smi)
        log(f"{what}: {DS2_BATCH / rec['steady']:.2f} utterances/s")
        if not rec["losses"][-1] < rec["losses"][0]:
            raise AssertionError(f"{what}: the loss did not fall: "
                                 f"{rec['losses']}")
        # one more step that also fetches the greedy decode
        dec = rec["model"]["decoded"]
        out = rec["exe"].run(rec["main"], feed=rec["feed"],
                             fetch_list=[dec.name, dec.length_var().name],
                             scope=rec["scope"], return_numpy=False)
        dev = out[0].device
        dist = ed(Hyps=out[0], Refs=torch.tensor(rec["feed"]["transcript"],
                                                 device=dev),
                  HypsLength=out[1],
                  RefsLength=torch.tensor(
                      rec["feed"]["transcript@LENGTH"], device=dev))["Out"]
        log(f"{what}: greedy decode, mean edit distance to the transcript "
            f"{dist.mean().item():.3f} (mean decoded length "
            f"{out[1].float().mean().item():.1f} of "
            f"{float(rec['feed']['transcript@LENGTH'].mean()):.1f}); "
            f"{time.perf_counter() - t0:.1f} s with the set-up")
        if not ragged:
            full = rec
        else:
            del rec
    t0 = time.perf_counter()
    zoo_profile(torch, "phase 13a deep_speech2 full length", full)
    log(f"phase 13a profile: {time.perf_counter() - t0:.1f} s")
    del full
    gc.collect()
    torch.cuda.empty_cache()
    ctc_library_phase(torch, np, seed)


def ctc_library_phase(torch, np, seed):
    """Phase 13a+: the port's ``warpctc`` (forward, and forward plus
    backward) beside ``F.ctc_loss`` on the log-softmaxed logits
    (``reduction="none"``) at the path's shape, on rows whose labels fit
    their frames (all of them here): a yardstick for a later speed item,
    not on the path.  Host clock around work that ends in a sync."""
    import torch.nn.functional as F

    from paddle_tpu_torch.core.registry import get_op_impl

    ctc = get_op_impl("warpctc").fn
    b, t, v = DS2_BATCH, DS2_CFG["max_audio_len"], DS2_CFG["vocab_size"] + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((b, t, v), device="cuda", generator=g)
    frames = torch.randint(128, t + 1, (b,), device="cuda", generator=g,
                           dtype=torch.int32)
    lens = torch.randint(20, 41, (b,), device="cuda", generator=g,
                         dtype=torch.int32)
    labels = torch.randint(1, v - 1, (b, DS2_CFG["max_label_len"]),
                           device="cuda", generator=g, dtype=torch.int32)

    def ours(backward):
        x = logits.detach().requires_grad_(backward)
        loss = ctc(Logits=x, Label=labels, LogitsLength=frames,
                   LabelLength=lens, blank=v - 1)["Loss"][:, 0]
        if backward:
            loss.sum().backward()
        return loss

    def library(backward):
        x = logits.detach().requires_grad_(backward)
        loss = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1),
                          labels.long(), frames.long(), lens.long(),
                          blank=v - 1, reduction="none")
        if backward:
            loss.sum().backward()
        return loss

    def wall(fn, backward, n=3):
        fn(backward)
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn(backward)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[n // 2] * 1e3

    rel = ((ours(False) - library(False)).abs()
           / library(False).abs()).max().item()
    walls = {(nm, bw): wall(fn, bw) for nm, fn in (("port", ours),
                                                   ("F.ctc_loss", library))
             for bw in (False, True)}
    log(f"phase 13a+ warpctc at b={b} T={t} V={v}, labels 20-40 of width "
        f"{DS2_CFG['max_label_len']}, frames 128-{t}: the port's loop "
        f"forward {walls[('port', False)]:.2f} ms, forward+backward "
        f"{walls[('port', True)]:.2f} ms; F.ctc_loss (not on the path) "
        f"{walls[('F.ctc_loss', False)]:.3f} / "
        f"{walls[('F.ctc_loss', True)]:.3f} ms; losses agree to max rel "
        f"{rel:.2e}")
    if rel > 2e-4:
        raise AssertionError(f"phase 13a+: warpctc and F.ctc_loss differ "
                             f"by {rel} on rows whose labels fit")


def image_phase(torch, np, pt, kernels, smi, seed):
    """Phase 13b: run.py's four image rows and LeNet, each ``ZOO_STEPS``
    steps on one batch with the models' own dropout: the last loss below
    the first, then a profiled step.  Returns each row's steady step wall
    in ms."""
    steady = {}
    for name, (cfg, batch) in IMAGE_ROWS.items():
        what = (f"phase 13b {name} b={batch} "
                f"{cfg.get('dtype', 'float32')}")
        rec = zoo_steps(torch, np, pt, kernels, what, name, cfg,
                        image_rows(np, seed, name, batch))
        zoo_log(what, rec, batch, "img", smi, flops=False)
        # the last loss below the first held in every measured run of
        # these rows (PERF.md §6); the steps between may rise
        if not rec["losses"][-1] < rec["losses"][0]:
            raise AssertionError(f"{what}: the loss did not fall: "
                                 f"{rec['losses']}")
        zoo_profile(torch, what, rec)
        steady[name] = 1e3 * rec["steady"]
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return steady


def srl_phase(torch, np, pt, kernels, smi, seed):
    """Phase 13c: the CRF tagger at ``build``'s defaults, b=64, lengths
    13-64, SGD 0.01: the losses finite and falling, the Viterbi token
    accuracy of one more step, tokens/s, a profiled step."""
    what = f"phase 13c label_semantic_roles b={SRL_BATCH}"
    rec = zoo_steps(torch, np, pt, kernels, what, "label_semantic_roles",
                    SRL_CFG, srl_rows(np, seed, SRL_BATCH, SRL_CFG))
    tokens = int(rec["feed"]["word@LENGTH"].sum())
    zoo_log(what, rec, tokens, "tok", smi)
    if not rec["losses"][-1] < rec["losses"][0]:
        raise AssertionError(f"{what}: the loss did not fall: "
                             f"{rec['losses']}")
    path, = rec["exe"].run(rec["main"], feed=rec["feed"],
                           fetch_list=[rec["model"]["crf_decode"].name],
                           scope=rec["scope"], return_numpy=False)
    target = torch.tensor(rec["feed"]["target"], device=path.device)
    lens = torch.tensor(rec["feed"]["target@LENGTH"], device=path.device)
    valid = (torch.arange(path.shape[1], device=path.device)[None, :]
             < lens[:, None])
    acc = ((path == target) & valid).sum().item() / valid.sum().item()
    log(f"{what}: Viterbi token accuracy {acc:.4f} over {tokens} tokens "
        f"({SRL_CFG['label_dict_len']} tags)")
    zoo_profile(torch, what, rec)
    del rec
    gc.collect()
    torch.cuda.empty_cache()


def zoo_check_feed(np, name, seed):
    """The CPU tests' batches (tests/test_torch_zoo_models.py)."""
    rng = np.random.default_rng(seed)

    def ragged(batch, max_len, high):
        lens = rng.integers(2, max_len + 1, size=batch)
        data = np.zeros((batch, max_len), np.int64)
        for i, ln in enumerate(lens):
            data[i, :ln] = rng.integers(0, high, size=ln)
        return data, lens.astype(np.int32)

    if name == "deep_speech2":
        label, label_len = ragged(2, 6, 5)
        return {"audio": rng.normal(size=(2, 12, 8)).astype(np.float32),
                "audio@LENGTH": np.array([12, 9], np.int32),
                "transcript": label, "transcript@LENGTH": label_len}
    if name == "label_semantic_roles":
        feed = {}
        _, lens = ragged(3, 6, 30)
        for n, high in [("word", 30), ("ctx_n2", 30), ("ctx_n1", 30),
                        ("ctx_0", 30), ("ctx_p1", 30), ("ctx_p2", 30),
                        ("verb", 8), ("mark", 2), ("target", 5)]:
            feed[n], _ = ragged(3, 6, high)
            feed[n + "@LENGTH"] = lens
        return feed
    cfg = ZOO_CHECK[name]
    shape = tuple(cfg.get("image_shape",
                          (1, 28, 28) if name == "lenet" else (3, 32, 32)))
    b = ZOO_CHECK_BATCH[name]
    return {"img": rng.normal(size=(b,) + shape).astype(np.float32),
            "label": rng.integers(0, cfg.get("class_dim", 10),
                                  (b, 1)).astype(np.int64)}


def ctc_greedy_ties(np, what, got, want, probs):
    """Greedy decodes equal, or their differing frames' top two
    probabilities within 1e-5 of each other (printed)."""
    if np.array_equal(got, want):
        return
    top2 = np.sort(probs, axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    log(f"{what}: the greedy decodes differ; the closest top-two gap of "
        f"the probabilities is {gap:.2e}")
    if gap > 1e-5:
        raise AssertionError(f"{what}: greedy decodes differ, no near-tie")


def viterbi_ties(torch, np, what, got, want, emission, transition, lengths):
    """Viterbi paths equal, or both paths' scores within 1e-5 of each
    other (relative; printed)."""
    from paddle_tpu_torch.ops.crf_ops import crf_path_score

    if np.array_equal(got, want):
        return
    em = torch.as_tensor(np.asarray(emission, np.float32))
    tr = torch.as_tensor(np.asarray(transition, np.float32))
    ln = torch.as_tensor(np.asarray(lengths, np.int32))
    sg = crf_path_score(em, tr, torch.as_tensor(np.asarray(got)), ln)
    sw = crf_path_score(em, tr, torch.as_tensor(np.asarray(want)), ln)
    gap = ((sg - sw).abs() / sw.abs().clamp_min(1e-30)).max().item()
    log(f"{what}: the Viterbi paths differ; their scores within rel "
        f"{gap:.2e}")
    if gap > 1e-5:
        raise AssertionError(f"{what}: Viterbi paths differ, no near-tie")


def dead_biases(main):
    """Biases added just before a batch norm (VGG's conv biases): their
    gradient is zero analytically, roundoff in practice."""
    bn_inputs = {op.inputs["X"][0] for op in main.global_block().ops
                 if op.type == "batch_norm"}
    return {op.inputs["Y"][0] for op in main.global_block().ops
            if op.type == "elementwise_add"
            and op.outputs["Out"][0] in bn_inputs}


# 13d: cuDNN's f32 weight gradient of AlexNet's conv2 (5x5, 96 -> 256 at
# 10x10, batch 2) is 2.2e-3 of its largest entry off float64 under every
# cuDNN setting (default, deterministic, benchmark, NVIDIA_TF32_OVERRIDE=0)
# where PyTorch's own CUDA convolution is 2e-7 off (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §6, ROADMAP.md C): an algorithm of the
# library's, not TF32.  A convolution weight's gradient through cuDNN is
# held to this bound; the same step without cuDNN to ORACLE_TOL's 1e-3.
CUDNN_F32_WGRAD_TOL = 5e-3


def zoo_model_check(torch, np, pt, smi, name, seed):
    """Phase 13d, one model: one step at the CPU tests' size from one
    startup state (the port's CPU startup), the ``dropout_prob`` attrs set
    to 0, on the card and on the port's CPU path: the loss within 2e-4,
    every gradient within 1e-3 of its largest entry or within twice the
    CPU path's own spread under a one-ulp move of the weights, whichever
    is larger (VGG-19 at this size is chaotic: the spread reaches 13% for
    single gradients; every other model's is ~1e-6), a dead bias within
    1e-5 of the step's largest gradient on both sides, the decodes equal.
    A model with convolutions runs the card's step twice, through cuDNN
    (the path) and through PyTorch's own CUDA convolutions: a convolution
    weight's gradient through cuDNN takes ``CUDNN_F32_WGRAD_TOL`` in
    place of 1e-3."""
    main, startup, model = rnn_build(pt, name, ZOO_CHECK[name])
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    init = {v.name: cpu_scope.numpy(v.name).copy()
            for v in main.persistable_vars()
            if cpu_scope.find_var(v.name) is not None}
    params = [p.name for p in main.all_parameters()]
    conv_w = {op.inputs["Filter"][0] for op in main.global_block().ops
              if op.type == "conv2d"}
    extra = []
    if name == "deep_speech2":
        extra = [model["decoded"].name, model["logits"].name]
    elif name == "label_semantic_roles":
        extra = [model["crf_decode"].name, model["feature_out"].name]
    fetch = [model["avg_cost"].name] + [p + "@GRAD" for p in params] + extra
    feed = zoo_check_feed(np, name, seed)
    runs = []
    for bump in (0, 1, -1):
        start = {n: (np.nextafter(v, bump * np.inf).astype(v.dtype)
                     if bump and n in params else v)
                 for n, v in init.items()}
        runs.append([np.asarray(x) for x in cpu_exe.run(
            main, feed=feed, fetch_list=fetch,
            scope=pt.load_numpy_state(pt.Scope(), start,
                                      device="cpu"))])
    want = runs[0]
    spread = {p: max(rel_max(np, r[1 + i], want[1 + i]) for r in runs[1:])
              for i, p in enumerate(params)}
    dead = dead_biases(main)
    top = max(np.abs(w).max() for w in want[1:1 + len(params)])
    for cudnn in ((True, False) if conv_w else (True,)):
        what = (f"phase 13d {name}" + ("" if not conv_w else
                                        " (cuDNN)" if cudnn else
                                        " (PyTorch's CUDA convolutions)"))
        exe, scope = pt.Executor(), pt.load_numpy_state(pt.Scope(), init)
        with torch.backends.cudnn.flags(enabled=cudnn,
                                        deterministic=False,
                                        benchmark=False, allow_tf32=False):
            got = [np.asarray(x) for x in exe.run(main, feed=feed,
                                                  fetch_list=fetch,
                                                  scope=scope)]
        loss_err = rel_max(np, got[0], want[0])
        errs, tols = {}, {}
        for p, g, w in zip(params, got[1:], want[1:]):
            if p in dead:
                if max(np.abs(g).max(), np.abs(w).max()) > 1e-5 * top:
                    raise AssertionError(f"{what}: dead bias {p} not "
                                         f"roundoff")
                continue
            errs[p] = rel_max(np, g, w)
            tols[p] = max(CUDNN_F32_WGRAD_TOL if cudnn and p in conv_w
                          else 1e-3, 2 * spread[p])
        worst = max(errs, key=errs.get)
        log(f"{what}: one step card vs CPU ({smi}): loss "
            f"{float(np.ravel(got[0])[0]):.6f} vs "
            f"{float(np.ravel(want[0])[0]):.6f} (rel {loss_err:.2e}); "
            f"{len(errs)} gradients, worst {worst} rel {errs[worst]:.2e} "
            f"(the CPU's one-ulp spread there {spread[worst]:.2e}, largest "
            f"{max(spread[p] for p in errs):.2e})"
            + (f"; {len(dead)} dead biases roundoff" if dead else ""))
        if loss_err > 2e-4:
            raise AssertionError(f"{what}: loss rel {loss_err}")
        bad = {p: e for p, e in errs.items() if e > tols[p]}
        if bad:
            raise AssertionError(f"{what}: gradients off {bad}")
        past = {p: e for p, e in errs.items() if e > 1e-3}
        if past:
            log(f"{what}: gradients past 1e-3, within their bound: "
                + ", ".join(f"{p} {e:.2e} (bound {tols[p]:.2e})"
                            for p, e in past.items()))
    n = 1 + len(params)
    if name == "deep_speech2":
        logits = want[n + 1]
        e = np.exp(logits - logits.max(-1, keepdims=True))
        ctc_greedy_ties(np, what, got[n], want[n], e / e.sum(-1,
                                                             keepdims=True))
    elif name == "label_semantic_roles":
        viterbi_ties(torch, np, what, got[n], want[n], want[n + 1],
                     init["crfw"], feed["word@LENGTH"])


def zoo_op_check(torch, np, smi, seed):
    """Phase 13d, the ops alone at the path shapes: card against CPU."""
    from paddle_tpu_torch.core.registry import get_op_impl

    rng = np.random.default_rng(seed)

    def both(op, floats, fixed, attrs, outs, dtype=torch.float32,
             n_diff=1):
        res = {}
        for dev in ("cuda", "cpu"):
            ts = {k: torch.tensor(v, device=dev).to(dtype).requires_grad_(
                n_diff > 0) for k, v in floats.items()}
            r = get_op_impl(op).fn(**ts, **{
                k: torch.tensor(v, device=dev) for k, v in fixed.items()},
                **attrs)
            vals = [r[o] for o in outs]
            grads = []
            if n_diff:
                gen = torch.Generator().manual_seed(seed)
                total = sum((x.float() * torch.randn(
                    x.shape, generator=gen).to(dev)).sum()
                    for x in vals[:n_diff])
                grads = torch.autograd.grad(total, list(ts.values()))
            res[dev] = ([x.detach().float().cpu().numpy()
                         if x.is_floating_point() else x.cpu().numpy()
                         for x in vals], [x.float().cpu().numpy()
                                          for x in grads])
        return res["cuda"], res["cpu"]

    def hold(what, card, cpu, fwd=2e-4, grad=1e-3):
        f = max([rel_max(np, g, w) for g, w in zip(card[0], cpu[0])
                 if g.dtype.kind == "f"] or [0.0])
        d = max([rel_max(np, g, w) for g, w in zip(card[1], cpu[1])]
                or [0.0])
        log(f"phase 13d {what} card vs CPU ({smi}): outputs rel {f:.2e}, "
            f"gradients rel {d:.2e}")
        if f > fwd or d > grad:
            raise AssertionError(f"phase 13d {what}: {f} / {d}")

    b, t, v = DS2_BATCH, DS2_CFG["max_audio_len"], DS2_CFG["vocab_size"] + 1
    hold(f"warpctc [{b}, {t}, {v}]", *both(
        "warpctc", {"Logits": rng.standard_normal((b, t, v))},
        {"Label": rng.integers(1, v - 1, (b, 64)).astype(np.int32),
         "LogitsLength": rng.integers(128, t + 1, b).astype(np.int32),
         "LabelLength": rng.integers(20, 41, b).astype(np.int32)},
        {"blank": v - 1}, ("Loss",)))
    hold(f"row_conv [{b}, {t}, 512]", *both(
        "row_conv", {"X": rng.standard_normal((b, t, 512)),
                     "Filter": rng.standard_normal((5, 512))},
        {"Length": rng.integers(128, t + 1, b).astype(np.int32)}, {},
        ("Out",)))
    n, st = 67, SRL_CFG["max_len"]
    em = rng.standard_normal((SRL_BATCH, st, n))
    tr = 0.1 * rng.standard_normal((n + 2, n))
    ln = rng.integers(SRL_MIN_LEN, st + 1, SRL_BATCH).astype(np.int32)
    lbl = rng.integers(0, n, (SRL_BATCH, st))
    hold(f"linear_chain_crf [{SRL_BATCH}, {st}, {n}]", *both(
        "linear_chain_crf", {"Emission": em, "Transition": tr},
        {"Label": lbl, "Length": ln}, {},
        ("LogLikelihood", "EmissionExps", "TransitionExps", "Alpha")))
    card, cpu = both("crf_decoding", {"Emission": em, "Transition": tr},
                     {"Length": ln}, {}, ("ViterbiPath",), n_diff=0)
    viterbi_ties(torch, np, "phase 13d crf_decoding", card[0][0], cpu[0][0],
                 em, tr, ln)
    log(f"phase 13d crf_decoding [{SRL_BATCH}, {st}, {n}]: paths "
        f"{'equal' if np.array_equal(card[0][0], cpu[0][0]) else 'near-tie'}")
    x = 10.0 * np.abs(rng.standard_normal((32, 96, 55, 55)))
    for dt, fwd, grad in ((torch.float32, 2e-4, 1e-3),
                          (torch.bfloat16, 2e-2, 5e-2)):
        hold(f"lrn [32, 96, 55, 55] {str(dt)[6:]}", *both(
            "lrn", {"X": x}, {}, dict(n=5, k=2.0, alpha=1e-4, beta=0.75),
            ("Out", "MidOut"), dtype=dt), fwd=fwd, grad=grad)
    # the greedy decoder's tail at DS2's path shape: ctc_align, then
    # edit_distance to labels of 40
    hyps = rng.integers(0, 5, (b, t))
    hyp_len = rng.integers(128, t + 1, b).astype(np.int32)
    refs = rng.integers(1, 5, (b, 64))
    res = {}
    for dev in ("cuda", "cpu"):
        al = get_op_impl("ctc_align").fn(
            Input=torch.tensor(hyps, device=dev), blank=0,
            Length=torch.tensor(hyp_len, device=dev))
        out = get_op_impl("edit_distance").fn(
            Hyps=al["Output"], HypsLength=al["OutputLength"],
            Refs=torch.tensor(refs, device=dev),
            RefsLength=torch.full((b,), 40, dtype=torch.int32, device=dev),
            normalized=True)
        res[dev] = [x.cpu().numpy() for x in (al["Output"],
                                              al["OutputLength"], out["Out"])]
    same = all(np.array_equal(g, w) for g, w in zip(res["cuda"], res["cpu"]))
    log(f"phase 13d ctc_align + edit_distance [{b}, {t}] card vs CPU: "
        f"{'equal' if same else 'DIFFERENT'} (mean normalized distance "
        f"{float(res['cpu'][2].mean()):.4f})")
    if not same:
        raise AssertionError("phase 13d: ctc_align / edit_distance differ")


def zoo_check_phase(torch, np, pt, smi, seed):
    """Phase 13d: the seven models and the new ops, card against the
    port's CPU path, TF32 off."""
    for name in ZOO_CHECK:
        zoo_model_check(torch, np, pt, smi, name, seed)
    zoo_op_check(torch, np, smi, seed)


# -- phase 14: the seq2seq beam decode and the book's small models ----------

# 14a: benchmarks/run.py's seq2seq row (:44-45, BASELINE config 3: dicts
# 30,000, word 256, hidden 512, sources of up to 32 tokens, batch 64),
# f32, with build_decode's own beam (4) and max_out_len (16)
DECODE_CFG = dict(src_dict_size=30000, trg_dict_size=30000, word_dim=256,
                  hidden_dim=512, max_len=32, beam_size=4, max_out_len=16,
                  end_id=1)
DECODE_BATCH, DECODE_REPEATS = 64, 3
# 14b: each model at the CPU tests' size (tests/test_torch_book_models.py)
# for the card-vs-CPU step, then at full size: build's defaults at the
# dataset readers' sizes (imikolov's synthetic dictionary of 2,000
# words, MovieLens-1M's vocabularies, ctr_dnn's 100,000 x 8 and
# 1,000,000 x 4 tables) and benchmarks/ctr_pserver.py's batch of 256
BOOK_CHECK = {
    "fit_a_line": ("fit_a_line", "build", dict(learning_rate=0.05)),
    "word2vec": ("word2vec", "build", dict(dict_size=50, embed_size=8,
                                           hidden_size=16,
                                           learning_rate=0.1)),
    "recommender": ("recommender", "build",
                    dict(learning_rate=0.05, max_title_len=4,
                         max_cat_len=3)),
    "ctr_dnn": ("ctr_dnn", "build",
                dict(sparse_feature_dim=100, num_slots=3, embedding_size=4,
                     dense_dim=5, hidden=(8, 4), learning_rate=0.05)),
    "ctr_dnn_sparse_slots": ("ctr_dnn", "build_sparse_slots",
                             dict(sparse_feature_dim=100, num_slots=3,
                                  embedding_size=4, dense_dim=5,
                                  hidden=(8, 4), learning_rate=0.05)),
}
BOOK_FULL = {
    "fit_a_line": ("fit_a_line", "build", {}),
    "word2vec": ("word2vec", "build", dict(dict_size=2000)),
    "recommender": ("recommender", "build", {}),
    "ctr_dnn": ("ctr_dnn", "build", dict(sparse_feature_dim=100000,
                                         num_slots=8, dense_dim=13)),
    "ctr_dnn_sparse_slots": ("ctr_dnn", "build_sparse_slots",
                             dict(sparse_feature_dim=1_000_000, num_slots=4,
                                  dense_dim=13)),
}
BOOK_BATCH, BOOK_STEPS, BOOK_BAG = 256, 5, 8


def decode_build(pt, seed, **over):
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        out = pt.models.seq2seq.build_decode(**dict(DECODE_CFG, **over))
    return main, startup, out


def decode_feed(np, seed, batch, max_len, dict_size):
    """Ragged sources of 4..max_len ids from ``seed``, padded."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, max_len + 1, size=batch)
    src = np.zeros((batch, max_len), np.int64)
    for i, n in enumerate(lens):
        src[i, :n] = rng.integers(2, dict_size, size=n)
    return {"src_word_id": src, "src_word_id@LENGTH": lens.astype(np.int32)}


@contextlib.contextmanager
def beam_recorder(torch):
    """``beam_search`` patched to keep, for each call, the k + 1 best
    candidate totals of every sample (host tensors ``[b, k + 1]``, sorted
    as the op sorts): a check run's record, never a timed one's."""
    from paddle_tpu_torch.core.registry import get_op_impl
    from paddle_tpu_torch.ops.beam_search_ops import beam_totals

    impl = get_op_impl("beam_search")
    real, calls = impl.fn, []

    def recording(PreIds, PreScores, Scores, end_id=1, **kw):
        out = real(PreIds=PreIds, PreScores=PreScores, Scores=Scores,
                   end_id=end_id, **kw)
        top = torch.sort(beam_totals(PreIds, PreScores, Scores, end_id),
                         dim=-1, descending=True, stable=True)[0]
        calls.append(top[:, :Scores.shape[1] + 1].cpu())
        return out

    impl.fn = recording
    try:
        yield calls
    finally:
        impl.fn = real


def host_syncs(torch, fn):
    """The synchronizing CUDA calls ``fn`` makes, counted by torch's sync
    debug mode (a warning each): ``{"file:line": calls}``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            at = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[at] = sites.get(at, 0) + 1
    return sites


def decode_ties(np, what, card, cpu, card_top, cpu_top, k):
    """The card's decode against the CPU's: ids, parents and steps equal
    and the scores within 2e-4 of the largest; or, at the first trip
    where the ids or parents differ, in every sample that differs there,
    the CPU's k-th and (k+1)-th best totals within 1e-5 (relative), a
    near-tie that rounding can flip, and the card's k best totals within
    1e-5 of the CPU's, rank by rank.  A swap among candidates of equal
    totals (the k identical beams' ties) fails: both sides order ties
    alike.  Prints both gaps."""
    ids_c, par_c, steps_c, sc_c = card
    ids_p, par_p, steps_p, sc_p = cpu
    trips = min(int(steps_c[0]), int(steps_p[0]))
    first = next((s for s in range(trips)
                  if not (np.array_equal(ids_c[s], ids_p[s])
                          and np.array_equal(par_c[s], par_p[s]))), None)
    if first is None:
        if int(steps_c[0]) != int(steps_p[0]):
            raise AssertionError(f"{what}: steps {steps_c} vs {steps_p} "
                                 f"with equal ids")
        rel = rel_max(np, sc_c, sc_p)
        log(f"{what}: card vs CPU: ids, parents and steps equal over "
            f"{trips} trips, scores rel {rel:.2e}")
        if rel > 2e-4:
            raise AssertionError(f"{what}: scores rel {rel}")
        return
    rows = [r for r in range(ids_c.shape[1])
            if not (np.array_equal(ids_c[first, r], ids_p[first, r])
                    and np.array_equal(par_c[first, r], par_p[first, r]))]
    c = card_top[first][rows].double().numpy()
    p = cpu_top[first][rows].double().numpy()
    rank_gap = float((np.abs(c[:, :k] - p[:, :k])
                      / np.maximum(np.abs(p[:, :k]), 1e-30)).max())
    kk1 = float((np.abs(p[:, k - 1] - p[:, k])
                 / np.maximum(np.abs(p[:, k - 1]), 1e-30)).max())
    log(f"{what}: card vs CPU first differ at trip {first} in {len(rows)} "
        f"of {ids_c.shape[1]} samples: the CPU's k-th to (k+1)-th gap "
        f"there {kk1:.2e} at most; their {k} best totals within rel "
        f"{rank_gap:.2e} rank by rank")
    if kk1 > 1e-5 or rank_gap > 1e-5:
        raise AssertionError(f"{what}: the decodes differ at trip {first} "
                             f"in samples {rows} with no near-tie: k-th to "
                             f"(k+1)-th gap {kk1}, rank by rank {rank_gap}")


def decode_phase(torch, np, pt, kernels, smi, seed):
    """Phase 14a: ``seq2seq.build_decode`` at run.py's seq2seq row on the
    card: the decode wall (device-synced), sentences/s, trips, kernels
    and host syncs a trip (by the difference of a decode of 16 trips and
    one whose bias for end_id ends it after one), the busy share and the
    peak memory; then the card's ids, parents and steps against the
    port's CPU run of the same program with the same weights
    (``decode_ties``)."""
    t_phase = time.perf_counter()
    cfg = DECODE_CFG
    k = cfg["beam_size"]
    main, startup, out = decode_build(pt, seed)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    state = {v.name: scope.numpy(v.name).copy()
             for v in main.persistable_vars()
             if scope.find_var(v.name) is not None}
    host_feed = decode_feed(np, seed, DECODE_BATCH, cfg["max_len"],
                            cfg["src_dict_size"])
    feed = {n: torch.as_tensor(v, device="cuda")
            for n, v in host_feed.items()}
    fetch = [out[n].name for n in ("ids_array", "parents_array", "steps",
                                   "scores")]

    def decode(sc):
        return exe.run(main, feed=feed, fetch_list=fetch, scope=sc,
                       return_numpy=False)

    kernels.reset_launches()
    decode(scope)                                # the lowering
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(DECODE_REPEATS):
        t0 = time.perf_counter()
        res = decode(scope)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    card = [x.cpu().numpy() for x in res]
    trips = int(card[2][0])
    flops = exe.last_step_cost["flops"]
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"phase 14a launched a hand-written kernel: "
                             f"{kernels.launch_counts()}")
    if not (np.isfinite(card[3]).all() and card[0].shape == (
            cfg["max_out_len"], DECODE_BATCH, k)):
        raise AssertionError(f"phase 14a: scores {card[3]}, ids "
                             f"{card[0].shape}")
    # the same program, its end_id bias raised so every beam ends on the
    # first trip: the difference is what the other trips cost
    early = dict(state)
    early["decode_out.b"] = state["decode_out.b"].copy()
    early["decode_out.b"][cfg["end_id"]] += 1e3
    early_scope = pt.load_numpy_state(pt.Scope(), early)
    once = [x.cpu().numpy() for x in decode(early_scope)]
    if int(once[2][0]) != 1 or not (once[0][0] == cfg["end_id"]).all():
        raise AssertionError(f"phase 14a: the early decode ran "
                             f"{once[2]} trips")
    steady = sorted(walls)[len(walls) // 2]
    once_walls = []
    for _ in range(DECODE_REPEATS):
        t0 = time.perf_counter()
        decode(early_scope)
        torch.cuda.synchronize()
        once_walls.append(time.perf_counter() - t0)
    once_steady = sorted(once_walls)[len(once_walls) // 2]
    # the first count also holds a one-off sync of torch's own (a call
    # measured: one in torch/cuda/__init__.py): count the 16-trip decode
    # again after the one-trip one
    sites = [host_syncs(torch, lambda: decode(sc))
             for sc in (scope, early_scope, scope)][1:][::-1]
    syncs = [sum(s.values()) for s in sites]
    log("phase 14a host syncs of a decode by site (16 trips | 1 trip): "
        + "; ".join(f"{at} {sites[0].get(at, 0)} | {sites[1].get(at, 0)}"
                    for at in sorted(set(sites[0]) | set(sites[1]))))
    if syncs[0] - syncs[1] != trips - 1:
        raise AssertionError(f"phase 14a: {syncs} host syncs in decodes of "
                             f"{trips} and 1 trips: the loop must read only "
                             f"its condition on the host, once a trip")
    sums = [profile_step(torch, exe, main, sc, fetch, feed, w)
            for sc, w in ((scope, steady), (early_scope, once_steady))]
    n_k = [sum(n for _, n in s.values()) for s in sums]
    busy_ms = sum(ms for ms, _ in sums[0].values())
    what = (f"phase 14a seq2seq decode b={DECODE_BATCH} beam {k} "
            f"max_out_len {cfg['max_out_len']} dicts {cfg['src_dict_size']} "
            f"hid {cfg['hidden_dim']} f32 ({smi})")
    log(f"{what}: decode wall (after the lowering) median {steady:.4f} s "
        f"(of {', '.join(f'{w:.4f}' for w in walls)}) = "
        f"{DECODE_BATCH / steady:.1f} sentences/s, a one-trip decode "
        f"{once_steady:.4f} s; {trips} trips; "
        f"{n_k[0]} kernels a decode, {(n_k[0] - n_k[1]) / (trips - 1):.1f} "
        f"a trip ({n_k[0] - (trips * (n_k[0] - n_k[1])) / (trips - 1):.0f} "
        f"outside the loop); {syncs[0]} host syncs a decode, "
        f"{(syncs[0] - syncs[1]) / (trips - 1):.2f} a trip; busy share "
        f"{busy_ms / (steady * 1e3):.3f} ({busy_ms:.1f} ms of kernels); "
        f"{flops / 1e9:.2f} GFLOP by step_flops = "
        f"{flops / steady / 1e12:.3f} TFLOP/s; max_memory_allocated "
        f"{peak} B")
    # the card against the port's CPU run of the same program and weights
    with beam_recorder(torch) as card_top:
        decode(scope)
    cpu_exe = pt.Executor(pt.CPUPlace())
    t0 = time.perf_counter()
    with beam_recorder(torch) as cpu_top:
        cpu = [np.asarray(x) for x in cpu_exe.run(
            main, feed=host_feed, fetch_list=fetch,
            scope=pt.load_numpy_state(pt.Scope(), state, device="cpu"))]
    log(f"phase 14a: the port's CPU decode took "
        f"{time.perf_counter() - t0:.1f} s")
    decode_ties(np, what, card, cpu, card_top, cpu_top, k)
    sent = pt.models.seq2seq.decode_sentences(*card[:3],
                                              end_id=cfg["end_id"])
    log(f"phase 14a: sentences {sent.shape}, the first "
        f"{sent[0, 0].tolist()}; wall {time.perf_counter() - t_phase:.1f} s")


def book_build(pt, table, name, seed=None):
    module, fn, cfg = table[name]
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        out = getattr(getattr(pt.models, module), fn)(**cfg)
    return main, startup, out


def book_feed(np, name, seed, batch, full):
    """One batch from ``seed``: at the CPU tests' size (``full`` False:
    their ids, bags and vocabularies) or at full size (the dataset
    readers' samples, the tables' whole id ranges)."""
    from paddle_tpu_torch import dataset

    rng = np.random.default_rng(seed)

    def ragged(rows, width):
        data = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            data[i, :len(r)] = r[:width]
        return data, np.array([min(len(r), width) for r in rows], np.int32)

    if name == "fit_a_line":
        if full:
            rows = list(zip(range(batch), dataset.uci_housing.train()()))
            return {"x": np.stack([r[1][0] for r in rows]),
                    "y": np.stack([r[1][1] for r in rows])}
        x = rng.normal(size=(batch, 13)).astype(np.float32)
        return {"x": x, "y": x @ rng.normal(size=(13, 1)).astype(np.float32)}
    if name == "word2vec":
        if full:
            grams = np.array([g for _, g in zip(range(batch),
                              dataset.imikolov.train(
                                  dataset.imikolov.build_dict(), 5)())])
        else:
            grams = rng.integers(0, 50, (batch, 5))
        feed = {f"word_{i}": grams[:, i:i + 1].astype(np.int64)
                for i in range(4)}
        feed["next_word"] = grams[:, 4:5].astype(np.int64)
        return feed
    if name == "recommender":
        if full:
            rows = [r for _, r in zip(range(batch),
                                      dataset.movielens.train()())]
            cat, cat_len = ragged([r[5] for r in rows], 8)
            title, title_len = ragged([r[6] for r in rows], 16)
            cols = np.array([r[:5] for r in rows], np.int64)
            score = np.array([[r[7]] for r in rows], np.float32)
        else:
            cat, cat_len = ragged([rng.integers(0, 10, rng.integers(2, 4))
                                   for _ in range(batch)], 3)
            title, title_len = ragged([rng.integers(0, 50,
                                                    rng.integers(2, 5))
                                       for _ in range(batch)], 4)
            cols = np.stack([rng.integers(0, hi, batch)
                             for hi in (100, 2, 7, 10, 100)], 1)
            score = rng.uniform(1, 5, (batch, 1)).astype(np.float32)
        feed = {n: cols[:, i:i + 1] for i, n in enumerate(
            ("user_id", "gender_id", "age_id", "job_id", "movie_id"))}
        feed.update({"category_id": cat, "category_id@LENGTH": cat_len,
                     "movie_title": title, "movie_title@LENGTH": title_len,
                     "score": score})
        return feed
    cfg = (BOOK_FULL if full else BOOK_CHECK)[name][2]
    vocab, slots = cfg["sparse_feature_dim"], cfg["num_slots"]
    feed = {"dense_feature": rng.normal(size=(batch, cfg["dense_dim"])
                                        ).astype(np.float32),
        "click": rng.integers(0, 2, (batch, 1)).astype(np.int64)}
    for i in range(slots):
        if name == "ctr_dnn":
            feed[f"slot_{i}"] = rng.integers(0, vocab, (batch, 1))
            continue
        # multi-hot bags of 1..BOOK_BAG ids, 0-padded, a duplicate in row 0
        ids = rng.integers(0, vocab, (batch, BOOK_BAG))
        vals = rng.uniform(0.5, 2.0, (batch, BOOK_BAG)).astype(np.float32)
        for r, n in enumerate(rng.integers(1, BOOK_BAG + 1, batch)):
            ids[r, n:], vals[r, n:] = 0, 0.0
        ids[0, :2] = ids[0, 0]
        feed[f"slot_{i}@IDS"], feed[f"slot_{i}@VALS"] = ids, vals
    return feed


def book_check(torch, np, pt, smi, name, seed):
    """Phase 14b, one model at the CPU tests' size: one step from the
    port's CPU startup state on the card and on the CPU path: the loss
    (and ``ctr_dnn``'s ``auc``) within 2e-4, every gradient within 1e-3
    of its largest entry."""
    main, startup, out = book_build(pt, BOOK_CHECK, name)
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    init = {v.name: cpu_scope.numpy(v.name).copy()
            for v in main.persistable_vars()
            if cpu_scope.find_var(v.name) is not None}
    params = [p.name for p in main.all_parameters()]
    keys = ["avg_cost"] + (["auc"] if "auc" in out else [])
    fetch = [out[k].name for k in keys] + [p + "@GRAD" for p in params]
    feed = book_feed(np, name, seed, 16 if name in ("fit_a_line",
                                                    "word2vec") else
                     4 if name == "recommender" else 8, full=False)
    want = [np.asarray(x) for x in cpu_exe.run(
        main, feed=feed, fetch_list=fetch,
        scope=pt.load_numpy_state(pt.Scope(), init, device="cpu"))]
    got = [np.asarray(x) for x in pt.Executor().run(
        main, feed=feed, fetch_list=fetch,
        scope=pt.load_numpy_state(pt.Scope(), init))]
    outs = {k: rel_max(np, g, w) for k, g, w in zip(keys, got, want)}
    grads = {p: rel_max(np, g, w) for p, g, w in
             zip(params, got[len(keys):], want[len(keys):])}
    worst = max(grads, key=grads.get)
    log(f"phase 14b {name}: one step card vs CPU ({smi}): "
        + ", ".join(f"{k} rel {e:.2e}" for k, e in outs.items())
        + f"; {len(grads)} gradients, worst {worst} rel {grads[worst]:.2e}")
    if max(outs.values()) > 2e-4 or grads[worst] > 1e-3:
        raise AssertionError(f"phase 14b {name}: {outs}, {grads}")


def book_phase(torch, np, pt, kernels, smi, seed):
    """Phase 14b: the four book models (``ctr_dnn`` both ways) card vs
    CPU at the CPU tests' size, then ``BOOK_STEPS`` steps each at full
    size on one batch: the losses finite and the last below the first,
    no hand-written kernel launched, the median step wall, samples/s and
    the peak memory."""
    t_phase = time.perf_counter()
    for name in BOOK_CHECK:
        book_check(torch, np, pt, smi, name, seed)
    for name in BOOK_FULL:
        main, startup, out = book_build(pt, BOOK_FULL, name, seed)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        feed = {n: torch.as_tensor(v, device="cuda") for n, v in
                book_feed(np, name, seed, BOOK_BATCH, full=True).items()}
        fetch = [out["avg_cost"].name]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        losses, walls = [], []
        for _ in range(BOOK_STEPS):
            t0 = time.perf_counter()
            loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                            return_numpy=False)
            losses.append(loss.item())           # ends in a device sync
            walls.append(time.perf_counter() - t0)
        steady = sorted(walls[1:])[len(walls[1:]) // 2]
        tables = sum(scope.get(p.name).numel() * 4
                     for p in main.all_parameters())
        what = f"phase 14b {name} b={BOOK_BATCH} full size ({smi})"
        log(f"{what}: loss " + " -> ".join(f"{x:.4f}" for x in losses)
            + f"; step wall first {walls[0]:.4f} s, then median "
            f"{steady:.4f} s = {BOOK_BATCH / steady:.0f} samples/s; "
            f"{tables} B of parameters; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B")
        if not all(np.isfinite(x) for x in losses):
            raise AssertionError(f"{what}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{what}: the loss did not fall: {losses}")
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"{what} launched a hand-written kernel: "
                                 f"{kernels.launch_counts()}")
        del exe, scope, feed
    log(f"phase 14b wall {time.perf_counter() - t_phase:.1f} s")


# -- phase 15: the SSD detector, its ops and the op long tail ---------------

# 15a: SSD300's input and VOC's 21 classes (Liu et al. 2016); the rest
# the model's own defaults (max_gt 8, Momentum 0.9 at 1e-3, nms_top_k
# 400): P = 4 x (75^2 + 37^2) = 27,976 priors; batch 32, f32
SSD_CFG = dict(num_classes=21, image_shape=(3, 300, 300), max_gt=8)
SSD_BATCH, SSD_STEPS, SSD_REPEATS = 32, 10, 3
# 15b: build's defaults at the reference test's batch
# (tests/test_book.py:215-245)
SSD_CHECK_CFG = dict(num_classes=4, image_shape=(3, 64, 64), max_gt=8)
SSD_CHECK_BATCH = 16


def ssd_build(pt, cfg, seed, is_test=False):
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        out = pt.models.ssd.build(is_test=is_test, **cfg)
    return main, startup, out


def ssd_feed(pt, cfg, batch, seed):
    imgs, gt_box, gt_label = pt.models.ssd.synthetic_batch(
        batch, cfg["image_shape"], cfg["max_gt"], cfg["num_classes"], seed)
    return {"img": imgs, "gt_box": gt_box, "gt_label": gt_label}


def ssd_phase(torch, np, pt, kernels, smi, seed):
    """Phase 15a: SSD at 300x300 with 21 classes and batch 32 on the
    card: ``SSD_STEPS`` Momentum steps (losses finite and falling, no
    hand-written kernel), the step's wall, kernels and busy share by a
    profiled step, the peak memory; then the ``is_test`` program's
    detections on the trained weights: their wall, a profiled inference,
    and the NMS loop's launches; the host syncs of a step and of an
    inference by site, none inside the detection ops."""
    import paddle_tpu_torch.ops.detection_ops as det
    from paddle_tpu_torch.profiler import middle_call_kernels

    t_phase = time.perf_counter()
    main, startup, out = ssd_build(pt, SSD_CFG, seed)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(v, device="cuda") for n, v in
            ssd_feed(pt, SSD_CFG, SSD_BATCH, seed).items()}
    fetch = [out["avg_cost"].name]
    n_priors = out["priors"].shape[1]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, walls = [], []
    for _ in range(SSD_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
        losses.append(loss.item())               # ends in a device sync
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    what = (f"phase 15a ssd b={SSD_BATCH} {SSD_CFG['image_shape']} "
            f"{SSD_CFG['num_classes']} classes, {n_priors} priors, f32 "
            f"({smi})")
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"{what} launched a hand-written kernel: "
                             f"{kernels.launch_counts()}")
    sums = profile_step(torch, exe, main, scope, fetch, feed, steady)
    busy_ms = sum(ms for ms, _ in sums.values())
    log(f"{what}: loss " + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step wall first {walls[0]:.3f} s, then median "
        f"{steady * 1e3:.2f} ms = {SSD_BATCH / steady:.1f} images/s; "
        f"device time {busy_ms:.2f} ms a step in "
        f"{sum(n for _, n in sums.values())} kernels, busy share "
        f"{busy_ms / (steady * 1e3):.3f}; max_memory_allocated {peak} B")

    # the inference on the trained weights: the is_test program
    imain, _, iout = ssd_build(pt, SSD_CFG, seed, is_test=True)
    ifeed = {"img": feed["img"]}
    ifetch = [iout["detections"].name]

    def infer():
        return exe.run(imain, feed=ifeed, fetch_list=ifetch, scope=scope,
                       return_numpy=False)[0]

    captured = []
    real_nms = det.nms_keep

    def capturing(over, valid):
        captured.append((over.clone(), valid.clone()))
        return real_nms(over, valid)

    det.nms_keep = capturing
    try:
        dets = infer()                           # the lowering
    finally:
        det.nms_keep = real_nms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iwalls = []
    for _ in range(SSD_REPEATS):
        t0 = time.perf_counter()
        dets = infer()
        torch.cuda.synchronize()
        iwalls.append(time.perf_counter() - t0)
    ipeak = torch.cuda.max_memory_allocated()
    isteady = sorted(iwalls)[len(iwalls) // 2]
    dets = dets.cpu().numpy()
    keep_top_k = iout["detections"].shape[1]
    if dets.shape != (SSD_BATCH, keep_top_k, 6) or not np.isfinite(
            dets).all():
        raise AssertionError(f"phase 15a: detections {dets.shape}")
    kept = dets[..., 0] >= 0
    isums = profile_step(torch, exe, imain, scope, ifetch, ifeed, isteady)
    ibusy = sum(ms for ms, _ in isums.values())
    over, valid = captured[0]
    nms = middle_call_kernels(lambda i: real_nms(over, valid))
    nms_dev = sum(ns for _, ns, _ in nms) / 1e6
    nms_walls = []
    for _ in range(SSD_REPEATS):
        t0 = time.perf_counter()
        real_nms(over, valid)
        torch.cuda.synchronize()
        nms_walls.append(time.perf_counter() - t0)
    nms_wall = sorted(nms_walls)[len(nms_walls) // 2]
    log(f"phase 15a inference b={SSD_BATCH} ({smi}): wall median "
        f"{isteady * 1e3:.2f} ms (of "
        f"{', '.join(f'{w * 1e3:.2f}' for w in iwalls)}) = "
        f"{SSD_BATCH / isteady:.1f} images/s; device time {ibusy:.2f} ms "
        f"in {sum(n for _, n in isums.values())} kernels, busy share "
        f"{ibusy / (isteady * 1e3):.3f}; max_memory_allocated {ipeak} B; "
        f"{int(kept.sum())} of {kept.size} slots kept, labels "
        f"{sorted(set(dets[..., 0][kept].astype(int).tolist()))}")
    log(f"phase 15a NMS loop over {tuple(over.shape[:-1])} "
        f"({over.shape[-1]} trips, {smi}): {len(nms)} kernel launches, "
        f"{len(nms) / over.shape[-1]:.1f} a trip, {nms_dev:.3f} ms of "
        f"device time, wall median {nms_wall * 1e3:.2f} ms (alone, of "
        f"{', '.join(f'{w * 1e3:.2f}' for w in nms_walls)}) = "
        f"{nms_wall / isteady:.3f} of the inference wall; "
        f"{int(valid.sum())} of {valid.numel()} candidates past the "
        f"score threshold")
    del captured, over, valid

    # host syncs of a training step and an inference, by site
    for label, fn in (("training step", lambda: exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)), ("inference", infer)):
        sites = host_syncs(torch, fn)
        log(f"phase 15a host syncs of a {label} by site: "
            + ("; ".join(f"{at} {n}" for at, n in sorted(sites.items()))
               or "none"))
        inside = {at: n for at, n in sites.items()
                  if "ops/detection_ops.py" in at}
        if inside:
            raise AssertionError(f"phase 15a: host syncs inside the "
                                 f"detection ops ({label}): {inside}")
    log(f"phase 15a wall {time.perf_counter() - t_phase:.1f} s")


def detections_agree(np, what, got, want):
    """The card's detections against the CPU's: labels (the empty slots
    and the order) equal and the scores and boxes within 2e-4 of the
    largest; where a slot's label differs, the two scores there within
    1e-5 (a near-tie rounding can flip), the gap printed."""
    diff = got[..., 0] != want[..., 0]
    same = ~diff
    err = (float(np.abs(got[same][:, 1:] - want[same][:, 1:]).max()
                 / np.abs(want[same][:, 1:]).max()) if same.any() else 0.0)
    gap = (float(np.abs(got[diff][:, 1] - want[diff][:, 1]).max())
           if diff.any() else 0.0)
    log(f"{what}: detections card vs CPU: {int(diff.sum())} of "
        f"{diff.size} slots differ in label (score gap there {gap:.2e}), "
        f"the rest rel {err:.2e}")
    if err > 2e-4 or gap > 1e-5:
        raise AssertionError(f"{what}: detections differ: rel {err}, "
                             f"label swaps with a score gap of {gap}")


def ssd_check_phase(torch, np, pt, smi, seed):
    """Phase 15b: SSD at build's defaults and the reference test's batch,
    one step from the port's CPU startup state on the card and on the
    CPU path, TF32 off: the loss within 2e-4, every gradient within 1e-3
    of its largest entry, the detections fetched in the same run
    agreeing (``detections_agree``)."""
    main, startup, out = ssd_build(pt, SSD_CHECK_CFG, seed)
    cpu_exe, cpu_scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    init = {v.name: cpu_scope.numpy(v.name).copy()
            for v in main.persistable_vars()
            if cpu_scope.find_var(v.name) is not None}
    params = [p.name for p in main.all_parameters()]
    fetch = ([out["avg_cost"].name, out["detections"].name]
             + [p + "@GRAD" for p in params])
    feed = ssd_feed(pt, SSD_CHECK_CFG, SSD_CHECK_BATCH, seed)
    want = [np.asarray(x) for x in cpu_exe.run(
        main, feed=feed, fetch_list=fetch,
        scope=pt.load_numpy_state(pt.Scope(), init, device="cpu"))]
    got = [np.asarray(x) for x in pt.Executor().run(
        main, feed=feed, fetch_list=fetch,
        scope=pt.load_numpy_state(pt.Scope(), init))]
    what = (f"phase 15b ssd b={SSD_CHECK_BATCH} "
            f"{SSD_CHECK_CFG['image_shape']} ({smi})")
    loss_err = rel_max(np, got[0], want[0])
    grads = {p: rel_max(np, g, w) for p, g, w in
             zip(params, got[2:], want[2:])}
    worst = max(grads, key=grads.get)
    log(f"{what}: one step card vs CPU: loss "
        f"{float(np.ravel(got[0])[0]):.6f} vs "
        f"{float(np.ravel(want[0])[0]):.6f} (rel {loss_err:.2e}); "
        f"{len(grads)} gradients, worst {worst} rel {grads[worst]:.2e}")
    if loss_err > 2e-4 or grads[worst] > 1e-3:
        raise AssertionError(f"{what}: loss {loss_err}, gradients {grads}")
    detections_agree(np, what, got[1], want[1])


def op_tail_cases(np, rng):
    """Phase 15c's cases: ``(label, op, float inputs, fixed inputs, attrs,
    outputs)``; a float input may be a list.  The detection ops at the
    15a path's shapes, the tensor ops and activations at [256, 1024]
    or near."""
    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def boxes(*lead):
        xy = rng.uniform(0.0, 0.7, lead + (2,))
        wh = rng.uniform(0.05, 0.3, lead + (2,))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    b, c, p, g = SSD_BATCH, SSD_CFG["num_classes"], 27976, SSD_CFG["max_gt"]
    prior = boxes(p)
    pb = np.stack([prior, np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                  (p, 1))])
    logits = f(b, p, c)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    gt_label = rng.integers(1, c, (b, g)).astype(np.int32)
    gt_label[:, 3:] = -1
    cases = [
        ("prior_box 75x75 in 300x300", "prior_box", {},
         {"Input": np.zeros((1, 1, 75, 75), np.float32),
          "Image": np.zeros((1, 1, 300, 300), np.float32)},
         dict(min_sizes=[45.0], max_sizes=[105.0], aspect_ratios=[2.0],
              flip=True, clip=True), ("Boxes", "Variances")),
        ("iou_similarity [400] x [400]", "iou_similarity",
         {"X": boxes(400), "Y": boxes(400)}, {}, {}, ("Out",)),
        ("bipartite_match [8, 27976]", "bipartite_match", {},
         {"DistMat": np.round(rng.uniform(-0.2, 1.0, (8, p)), 2).astype(
             np.float32)}, {}, ("ColToRowMatchIndices", "ColToRowMatchDist")),
        ("roi_pool [2, 64, 38, 38], 16 ROIs 7x7", "roi_pool",
         {"X": np.round(f(2, 64, 38, 38), 1)},
         {"ROIs": np.concatenate([rng.integers(0, 2, (16, 1)),
                                  boxes(16) * 40], 1).astype(np.float32)},
         dict(pooled_height=7, pooled_width=7, spatial_scale=0.95),
         ("Out", "Argmax")),
        (f"detection_output [{b}, {p}, {c}]", "detection_output", {},
         {"Loc": f(b, p, 4, scale=0.5), "Conf": (e / e.sum(
             -1, keepdims=True)).astype(np.float32), "PriorBox": pb},
         dict(keep_top_k=20, score_threshold=0.05), ("Out",)),
        (f"multibox_loss [{b}, {p}, {c}]", "multibox_loss",
         {"Loc": f(b, p, 4, scale=0.5), "Conf": logits},
         {"PriorBox": pb, "GtBox": boxes(b, g), "GtLabel": gt_label}, {},
         ("Loss",)),
    ]
    x = f(256, 1024, scale=3.0)
    for name, attrs, kinks in (
            ("abs", {}, [0.0]), ("brelu", {"t_min": 1.0, "t_max": 5.0},
                                 [1.0, 5.0]),
            ("ceil", {}, [1.0]), ("elu", {"alpha": 0.7}, [0.0]),
            ("hard_shrink", {}, [0.5, -0.5]), ("hard_sigmoid", {},
                                               [-2.5, 2.5]),
            ("leaky_relu", {"alpha": 0.1}, [0.0]), ("log_softmax", {}, []),
            ("logsigmoid", {}, [0.0]), ("relu6", {}, [0.0, 6.0]),
            ("round", {}, [0.5, 1.5, 2.5]), ("soft_relu", {"threshold": 4.0},
                                             [4.0, -4.0]),
            ("softplus", {}, [0.0, 30.0]), ("softshrink", {"lambda": 0.25},
                                            [0.25, -0.25]),
            ("softsign", {}, [0.0]), ("stanh", {}, [0.0]),
            ("swish", {"beta": 1.5}, [0.0]), ("tanh_shrink", {}, [0.0]),
            ("thresholded_relu", {}, [1.0])):
        xk = x.copy()
        xk.reshape(-1)[:len(kinks)] = kinks
        cases.append((f"{name} [256, 1024]", name, {"X": xk}, {}, attrs,
                      ("Out",)))
    cases += [
        ("prelu [256, 1024]", "prelu", {"X": x, "Alpha": f(1)}, {}, {},
         ("Out",)),
        ("fill_zeros_like", "fill_zeros_like", {"X": x}, {}, {}, ("Out",)),
        ("assign_value [2, 3]", "assign_value", {}, {},
         dict(shape=[2, 3], dtype="float32",
              values=[1.5, -2.0, 3.25, 0.0, 7.0, -1.0]), ("Out",)),
        ("shape", "shape", {}, {"Input": x}, {}, ("Out",)),
        ("transpose [64, 32, 128]", "transpose", {"X": f(64, 32, 128)}, {},
         {"axis": [2, 0, 1]}, ("Out",)),
        ("split [256, 1024] in [100, 524, 400]", "split", {"X": x}, {},
         {"sections": [100, 524, 400], "axis": 1}, ("Out",)),
        ("gather 512 of 1024 rows", "gather", {"X": f(1024, 256)},
         {"Index": rng.integers(0, 1024, 512).astype(np.int32)}, {},
         ("Out",)),
        ("scatter, duplicate ids", "scatter",
         {"X": f(1024, 256), "Updates": f(512, 256)},
         {"Ids": rng.integers(0, 300, 512).astype(np.int32)}, {},
         ("Out",)),
        ("scatter add, duplicate ids", "scatter",
         {"X": f(1024, 256), "Updates": f(512, 256)},
         {"Ids": rng.integers(0, 300, 512).astype(np.int32)},
         {"overwrite": False}, ("Out",)),
        ("pad [256, 1024]", "pad", {"X": x}, {},
         {"paddings": [1, 2, 3, 4], "pad_value": 0.5}, ("Out",)),
        ("crop [256, 1024]", "crop", {"X": x}, {},
         {"offsets": [3, 5], "shape": [-1, 512]}, ("Out",)),
        ("multiplex 3 x [256, 1024]", "multiplex",
         {"X": [x, f(256, 1024), f(256, 1024)]},
         {"Ids": rng.integers(0, 3, (256, 1)).astype(np.int32)}, {},
         ("Out",)),
        ("embedding_grad_rows", "embedding_grad_rows", {"Grad": f(512, 64)},
         {"Ids": rng.integers(0, 100, (512, 1)).astype(np.int32)},
         {"table_height": 100}, ("Out",)),
        ("arg_min [256, 1024]", "arg_min", {}, {"X": np.round(x)},
         {"axis": 1}, ("Out",)),
        ("is_empty", "is_empty", {}, {"X": x}, {}, ("Out",)),
        ("isfinite", "isfinite", {}, {"X": [x, np.float32([1.0, np.inf])]},
         {}, ("Out",)),
        ("scale_sub_region [32, 64, 38, 38]", "scale_sub_region",
         {"X": f(32, 64, 38, 38)},
         {"Indices": np.tile(np.int32([3, 40, 5, 30, 2, 38]), (32, 1))},
         {"value": 2.5}, ("Out",)),
    ]
    return cases


def op_tail_phase(torch, np, smi, seed):
    """Phase 15c: the 41 op types this slice adds, each alone card
    against CPU on seeded inputs: float outputs within 2e-4 of the
    largest (infinities equal), ints and bools equal, the float inputs'
    gradients under one seeded cotangent within 1e-3."""
    from paddle_tpu_torch.core.executor import LoweringCtx
    from paddle_tpu_torch.core.registry import get_op_impl

    t_phase = time.perf_counter()
    cases = op_tail_cases(np, np.random.default_rng(seed))
    seen = set()
    for label, op, floats, fixed, attrs, outs in cases:
        seen.add(op)
        res = {}
        for dev in ("cuda", "cpu"):
            def put(v, grad):
                if isinstance(v, list):
                    return [put(a, grad) for a in v]
                t = torch.tensor(v, device=dev)
                return t.requires_grad_() if grad else t

            ts = {k: put(v, True) for k, v in floats.items()}
            leaves = [t for v in ts.values()
                      for t in (v if isinstance(v, list) else [v])]
            impl = get_op_impl(op)
            extra = ({"_ctx": LoweringCtx(torch.device(dev), None)}
                     if impl.wants_ctx else {})
            r = impl.fn(**ts, **{k: put(v, False) for k, v in fixed.items()},
                        **attrs, **extra)
            vals = [x for o in outs for x in (
                r[o] if isinstance(r[o], list) else [r[o]])]
            grads = []
            diff = [x for x in vals if x.requires_grad]
            if diff:
                gen = torch.Generator().manual_seed(seed)
                total = sum((x * torch.randn(x.shape, generator=gen).to(
                    dev)).sum() for x in diff)
                grads = [torch.zeros_like(t) if g is None else g
                         for t, g in zip(leaves, torch.autograd.grad(
                             total, leaves, allow_unused=True))]
            res[dev] = ([x.detach().cpu().numpy() for x in vals],
                        [g.cpu().numpy() for g in grads])
        fwd, grad = 0.0, 0.0
        for g, w in zip(res["cuda"][0], res["cpu"][0]):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"phase 15c {label}: {g.shape} "
                                     f"{g.dtype} vs {w.shape} {w.dtype}")
            if g.dtype.kind != "f":
                if not np.array_equal(g, w):
                    raise AssertionError(f"phase 15c {label}: differ")
                continue
            fin = np.isfinite(w)
            if not np.array_equal(g[~fin], w[~fin]):
                raise AssertionError(f"phase 15c {label}: infinities differ")
            if fin.any():
                fwd = max(fwd, rel_max(np, g[fin], w[fin]))
        for g, w in zip(res["cuda"][1], res["cpu"][1]):
            grad = max(grad, rel_max(np, g, w))
        log(f"phase 15c {label} card vs CPU ({smi}): outputs rel "
            f"{fwd:.2e}, gradients rel {grad:.2e}")
        if fwd > 2e-4 or grad > 1e-3:
            raise AssertionError(f"phase 15c {label}: {fwd} / {grad}")
    log(f"phase 15c: {len(seen)} op types in {len(cases)} cases, "
        f"{time.perf_counter() - t_phase:.1f} s")
    if len(seen) != 41:
        raise AssertionError(f"phase 15c covers {len(seen)} op types")


# -- phase 16: BASELINE config 5 over the parameter servers, the elastic
#    data path and the command line -----------------------------------------

# benchmarks/ctr_pserver.py:28's size: 100,000-row tables, 4 slots,
# embedding 16; ctr_dnn.build's own dense_dim 13, hidden (64, 32), Adam
# 1e-3; batch 256, one id a slot; four servers
PS_CFG = dict(sparse_feature_dim=100_000, num_slots=4, embedding_size=16)
PS_BATCH, PS_STEPS, PS_SERVERS, PS_FEEDS = 256, 20, 4, 8
# 16c: the dataset the master serves and the checkgrad config
PS_RECORDS, PS_CHUNK = 2048, 256

PS_TRAIN_CONFIG = '''
import os
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed.store import FileStore, discover_services

def build():
    return pt.models.ctr_dnn.build(sparse_feature_dim=100_000, num_slots=4,
                                   embedding_size=16)

def train_reader():
    master, = discover_services(FileStore(os.environ["CTR_STORE"]), "master")
    with open(os.environ["CTR_SEEN"], "a") as seen:
        for rec in pt.reader.creator.cloud_reader(
                [], etcd_endpoints=master)():
            seen.write(f"{rec[0]}\\n")
            yield rec[1:]
'''

PS_CHECKGRAD_CONFIG = '''
import numpy as np
import paddle_tpu_torch as pt

def build():
    return pt.models.ctr_dnn.build(sparse_feature_dim=50, num_slots=2,
        embedding_size=4, dense_dim=3, hidden=(8,), learning_rate=1e-2)

def train_reader():
    rng = np.random.default_rng(0)
    for _ in range(16):
        dense = rng.normal(size=3).astype(np.float32)
        yield (dense, [int(rng.integers(0, 50))], [int(rng.integers(0, 50))],
               [int(dense[0] > 0)])
'''


def ps_samples(np, seed, n):
    """``n`` CTR rows from ``seed``: 13 dense features, one id a slot
    (uniform over the table), a click that follows the first dense
    feature and the first slot's id (so the loss can fall)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 13)).astype(np.float32)
    ids = rng.integers(0, PS_CFG["sparse_feature_dim"],
                       (n, PS_CFG["num_slots"]))
    click = ((dense[:, 0] + (ids[:, 0] % 2 - 0.5)) > 0).astype(np.int64)
    return dense, ids, click


def ps_feeds(np, seed):
    dense, ids, click = ps_samples(np, seed, PS_BATCH * PS_FEEDS)
    feeds = []
    for b in range(PS_FEEDS):
        sl = slice(b * PS_BATCH, (b + 1) * PS_BATCH)
        feed = {"dense_feature": dense[sl], "click": click[sl, None]}
        for s in range(PS_CFG["num_slots"]):
            feed[f"slot_{s}"] = ids[sl, s:s + 1]
        feeds.append(feed)
    return feeds


def ps_build(pt, seed):
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        out = pt.models.ctr_dnn.build(**PS_CFG)
    return main, startup, out


def ps_cli(args, **env):
    """``python -m paddle_tpu_torch <args>`` from the repo's root, its
    output piped."""
    root = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ, **env)
    full["PYTHONPATH"] = root + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch"] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=full,
        cwd=root)


def ps_discover(procs, store, kind, n, timeout=180):
    """The ``n`` endpoints of ``kind`` registered in the FileStore at
    ``store`` (polled: each process registers once it serves); raises
    when a process exits first or the deadline passes."""
    from paddle_tpu_torch.distributed.store import FileStore, \
        discover_services

    fs, deadline = FileStore(store), time.time() + timeout
    while True:
        found = discover_services(fs, kind)
        if len(found) == n:
            return sorted(found)
        dead = [p for p in procs if p.poll() is not None]
        if dead or time.time() > deadline:
            raise AssertionError(
                f"phase 16: {len(found)} of {n} {kind} processes registered"
                + "".join(f"\n{p.args}: rc {p.returncode} "
                          f"{p.stderr.read()[-2000:]}" for p in dead))
        time.sleep(0.1)


def ps_reap(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=20)


def ps_train(torch, np, pt, main, out, state, feeds, servers, mode, device,
             steps=PS_STEPS):
    """``steps`` steps of config 5 through ``DistributedTrainer`` on
    ``device`` from ``state``, the four embedding tables on the sparse
    path.  Returns the trainer (open, in its own scope) and the run's
    record: losses, step walls, fetched dense bytes, the parameters on the
    servers after the steps."""
    from paddle_tpu_torch.distributed import (DistributedTrainer,
                                              DistributeTranspiler)

    scope = pt.load_numpy_state(pt.Scope(), state, device=device)
    tables = [p.name for p in main.all_parameters()
              if tuple(p.shape) == (PS_CFG["sparse_feature_dim"],
                                    PS_CFG["embedding_size"])]
    with pt.scope_guard(scope):
        t = DistributeTranspiler().transpile(main, pservers=len(servers))
        dt = DistributedTrainer(
            t, pt.Executor(device), servers, learning_rate=1e-3, mode=mode,
            sparse_params={p: f"slot_{i}" for i, p in enumerate(tables)})
        dt.init_params_on_pservers()
        ptrs = {n: scope.get(n).data_ptr() for n in dt.param_names}
        losses, walls, parts = [], [], []
        fetched0 = dt.total_fetch_bytes
        for i in range(steps):
            t0 = time.perf_counter()
            loss, = dt.train_step(feeds[i % len(feeds)],
                                  extra_fetch=[out["avg_cost"]])
            walls.append(time.perf_counter() - t0)
            losses.append(float(np.asarray(loss).ravel()[0]))
            parts.append(dict(dt.last_step_seconds))
        dt.flush()
        fetched = (dt.total_fetch_bytes - fetched0) / steps
        moved = [n for n in dt.param_names
                 if scope.get(n).data_ptr() != ptrs[n]]
        params = dt.client.get_params(dt.param_names)
    return dt, scope, {"losses": losses, "walls": walls, "fetched": fetched,
                       "params": params, "moved": moved, "tables": tables,
                       "parts": parts}


def ps_step_bytes(np, dt, feeds, emb):
    """Bytes a step sends (dense grads, sparse rows with their int64 ids)
    and fetches beside the dense delta (the prefetched rows), as the
    mean over ``feeds``."""
    block = dt.trainer_program.global_block()
    dense = sum(int(np.prod(block.var(n).shape)) * 4 for n in dt.dense_names)
    rows = np.mean([sum(np.unique(f[s]).size for s in dt.sparse.values())
                    for f in feeds])
    return dense + rows * (emb * 4 + 8), rows * emb * 4


def ps_report(torch, np, pt, smi, kernels, what, dt, scope, rec, feeds):
    """Phase 16a's numbers and checks for one trainer: step wall p50 and
    spread, samples/s, bytes a step, kernels a step and the busy share
    (a profiled step), host syncs a step by site; the losses finite and
    falling, the tables (and every parameter) kept in place, every scope
    tensor on the card, syncs only at the planned sites, no hand-written
    kernel launched."""
    from paddle_tpu_torch.core.scope import RNG_VAR
    from paddle_tpu_torch.profiler import middle_call_kernels

    losses, walls = rec["losses"], rec["walls"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    head, tail = np.mean(losses[:3]), np.mean(losses[-3:])
    if not tail < head:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    if rec["moved"]:
        raise AssertionError(f"{what}: {rec['moved']} left their storage")
    off = [n for n in scope.var_names() if n != RNG_VAR
           and isinstance(scope.get(n), torch.Tensor)
           and scope.get(n).device.type != "cuda"]
    if off:
        raise AssertionError(f"{what}: scope tensors off the card: {off}")
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"{what} launched a hand-written kernel: "
                             f"{kernels.launch_counts()}")
    with pt.scope_guard(scope):
        taken = [0]

        def run(_):
            taken[0] += 1
            dt.train_step(feeds[taken[0] % len(feeds)])

        dt.train_step(feeds[0])          # a warm step before the counts
        # the first count may hold a one-off sync of torch's own (14a and
        # 15a saw one in torch/cuda/__init__.py): the second is the step's
        sites = [host_syncs(torch, lambda: run(0)) for _ in range(2)][1]
        events = middle_call_kernels(run)
        dt.flush()
    planned = ps_planned_sites()
    stray = {at: n for at, n in sites.items() if at not in planned}
    if stray:
        raise AssertionError(f"{what}: host syncs outside the grad fetch "
                             f"and the installs: {stray} (planned: "
                             f"{sorted(planned)})")
    copies = [e for e in events if e[2].startswith(("Memcpy", "Memset"))]
    busy_ms = sum(ns for _, ns, _ in events) / 1e6
    steady = sorted(walls[2:])
    p50 = steady[len(steady) // 2]
    sent, rows = ps_step_bytes(np, dt, feeds, PS_CFG["embedding_size"])
    parts = {k: sorted(p[k] for p in rec["parts"][2:])
             for k in rec["parts"][0]}
    parts = {k: v[len(v) // 2] for k, v in parts.items()}
    log(f"{what} ({smi}): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first three {head:.4f}, last three {tail:.4f}); step wall p50 "
        f"{p50 * 1e3:.2f} ms (min {steady[0] * 1e3:.2f}, max "
        f"{steady[-1] * 1e3:.2f}; first {walls[0] * 1e3:.1f}) = "
        f"{PS_BATCH / p50:.0f} samples/s (medians: " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in parts.items())
        + f"); a step sends {sent / 1e3:.1f} kB "
        f"and fetches {(rec['fetched'] + rows) / 1e3:.1f} kB (dense delta "
        f"{rec['fetched'] / 1e3:.1f} kB, rows {rows / 1e3:.1f} kB); "
        f"{len(events) - len(copies)} kernels and {len(copies)} copies a "
        f"step, {busy_ms:.3f} ms of device time, busy share "
        f"{busy_ms / (p50 * 1e3):.3f}; host syncs a step "
        f"{sum(sites.values())}: " + ", ".join(
            f"{at} {n}" for at, n in sorted(sites.items())))
    return p50


def ps_planned_sites():
    """The ``file:line``s where a config-5 step may wait for the card:
    the gradient fetch (``tensor_to_numpy``'s copy to the host) and the
    row and parameter installs of the transpiler."""
    import inspect

    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.distributed import transpiler

    sites = set()
    for mod, marks in ((scope_mod, ("t.cpu().numpy()",)),
                       (transpiler, (".index_copy_(", ".to(table.device",
                                     "table.device, table.dtype",
                                     ".copy_(tensor_from_numpy"))):
        path = os.path.relpath(inspect.getsourcefile(mod))
        for i, line in enumerate(inspect.getsource(mod).splitlines(), 1):
            if any(m in line for m in marks):
                sites.add(f"{path}:{i}")
    return sites


def ps_check(np, smi, card, cpu):
    """16b: the card's run against the CPU's from the same state and
    feeds: the losses within 2e-4, every parameter within 1e-3 of its
    largest entry."""
    losses = max(abs(a - b) / max(abs(b), 1e-6)
                 for a, b in zip(card["losses"], cpu["losses"]))
    errs = {n: rel_max(np, card["params"][n], cpu["params"][n])
            for n in cpu["params"]}
    worst = max(errs, key=errs.get)
    log(f"phase 16b config 5, {PS_STEPS} serial steps card vs CPU ({smi}): "
        f"losses rel {losses:.2e}; {len(errs)} parameters, worst {worst} "
        f"rel {errs[worst]:.2e}")
    if losses > 2e-4 or errs[worst] > 1e-3:
        raise AssertionError(f"phase 16b: losses {losses:.3e}, "
                             f"parameters {errs}")


def ps_cli_phase(np, pt, smi, root):
    """16c: a synthetic CTR dataset written to recordio through
    ``dataset.common.convert`` and served by ``python -m paddle_tpu_torch
    master``; ``train`` on the card from ``cloud_reader`` for one pass
    (exit 0, finite costs, every record once), ``train --job=checkgrad``
    on a small config (PASSED), ``version`` (the card, the native
    library available)."""
    dense, ids, click = ps_samples(np, 1, PS_RECORDS)
    rows = [(i, dense[i], *[[int(x)] for x in ids[i]], [int(click[i])])
            for i in range(PS_RECORDS)]
    data = os.path.join(root, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    paths = pt.dataset.common.convert(data, lambda: iter(rows), PS_CHUNK,
                                      "ctr")
    convert_s = time.perf_counter() - t0
    store, seen = os.path.join(root, "store16c"), os.path.join(root, "seen")
    for name, text in (("ctr.py", PS_TRAIN_CONFIG),
                       ("grad.py", PS_CHECKGRAD_CONFIG)):
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    procs = [ps_cli(["master", "--dataset", *paths, "--store", store])]
    try:
        ps_discover(procs, store, "master", 1)
        t0 = time.perf_counter()
        jobs = {
            "train": ps_cli(["train", os.path.join(root, "ctr.py"),
                             "--num-passes", 1, "--batch-size", PS_BATCH,
                             "--log-period", 1],
                            CTR_STORE=store, CTR_SEEN=seen),
            "checkgrad": ps_cli(["train", "--job=checkgrad",
                                 os.path.join(root, "grad.py"),
                                 "--batch-size", 8]),
            "version": ps_cli(["version"]),
        }
        procs += list(jobs.values())
        res = {k: p.communicate(timeout=300) + (p.returncode,)
               for k, p in jobs.items()}
        wall = time.perf_counter() - t0
    finally:
        ps_reap(procs)
    for k, (out, err, rc) in res.items():
        if rc != 0:
            raise AssertionError(f"phase 16c {k}: rc {rc}\n{out[-3000:]}\n"
                                 f"{err[-3000:]}")
    costs = [float(c) for c in re.findall(r"cost (\S+)", res["train"][0])]
    with open(seen) as f:
        got = sorted(int(x) for x in f.read().split())
    if not (len(costs) == PS_RECORDS // PS_BATCH
            and all(np.isfinite(costs))):
        raise AssertionError(f"phase 16c train: costs {costs}")
    if got != list(range(PS_RECORDS)):
        raise AssertionError(f"phase 16c: {len(got)} records read, "
                             f"{len(set(got))} distinct, of {PS_RECORDS}")
    if "checkgrad PASSED" not in res["checkgrad"][0]:
        raise AssertionError(f"phase 16c checkgrad: {res['checkgrad'][0]}")
    version = res["version"][0]
    import torch

    if (f"card: {torch.cuda.get_device_name(0)}" not in version
            or "native: available" not in version):
        raise AssertionError(f"phase 16c version: {version}")
    log(f"phase 16c ({smi}): {PS_RECORDS} records in {len(paths)} recordio "
        f"files ({convert_s:.2f} s to convert); the master subprocess, "
        f"then train (one pass, {len(costs)} batches of {PS_BATCH}, cost "
        f"{costs[0]:.4f} -> {costs[-1]:.4f}, every record once), "
        f"checkgrad (PASSED) and version together in {wall:.1f} s; "
        + " | ".join(line for line in version.splitlines()[1:]))


def pserver_phase(torch, np, pt, kernels, smi, seed):
    """Phase 16: BASELINE config 5 (CTR-DNN over the parameter servers) on
    the card — 16a (i) four in-process loopback servers, serial, and (ii)
    four ``python -m paddle_tpu_torch pserver`` subprocesses over TCP,
    found through a FileStore, pipelined; 16b (i) card vs CPU; 16c the
    elastic data path and the command line.  Every subprocess is stopped
    before it returns."""
    import tempfile

    from paddle_tpu_torch.distributed import ParameterServer

    t_phase = time.perf_counter()
    main, startup, out = ps_build(pt, seed)
    init = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=init)
    state = {v.name: init.numpy(v.name).copy()
             for v in main.persistable_vars()
             if init.find_var(v.name) is not None}
    feeds = ps_feeds(np, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pserver_") as root:
        store = os.path.join(root, "store")
        # the TCP servers start now and come up while (i) runs
        procs = [ps_cli(["pserver", "--index", i, "--store", store])
                 for i in range(PS_SERVERS)]
        try:
            kernels.reset_launches()
            what = (f"phase 16a config 5 (tables {PS_CFG['num_slots']} x "
                    f"{PS_CFG['sparse_feature_dim']} x "
                    f"{PS_CFG['embedding_size']}, b={PS_BATCH}, Adam 1e-3)")
            dt, scope, card = ps_train(
                torch, np, pt, main, out, state, feeds,
                [ParameterServer(index=i) for i in range(PS_SERVERS)],
                "serial", "cuda")
            ps_report(torch, np, pt, smi, kernels,
                      f"{what} (i) {PS_SERVERS} loopback servers, serial",
                      dt, scope, card, feeds)
            dt.close()
            endpoints = ps_discover(procs, store, "pserver", PS_SERVERS)
            log(f"phase 16a: {PS_SERVERS} pserver subprocesses registered "
                f"{time.perf_counter() - t_phase:.1f} s into the phase")
            dt, scope, tcp = ps_train(torch, np, pt, main, out, state,
                                      feeds, endpoints, "pipelined", "cuda")
            ps_report(torch, np, pt, smi, kernels,
                      f"{what} (ii) {PS_SERVERS} pserver subprocesses over "
                      f"TCP, pipelined", dt, scope, tcp, feeds)
            dt.close()
        finally:
            ps_reap(procs)
        t0 = time.perf_counter()
        dt, _, cpu = ps_train(
            torch, np, pt, main, out, state, feeds,
            [ParameterServer(index=i) for i in range(PS_SERVERS)],
            "serial", "cpu")
        dt.close()
        log(f"phase 16b: the CPU run took {time.perf_counter() - t0:.1f} s")
        ps_check(np, smi, card, cpu)
        ps_cli_phase(np, pt, smi, root)
    log(f"phase 16 wall {time.perf_counter() - t_phase:.1f} s")


# -- phase 17: sharded training over a mesh ---------------------------------
MESH_RANKS, MESH_STEPS = 4, 3
# 17a (bf16): each tensor's update within this share of the norm of the
# unsharded run's update (mesh_updates_agree).  Set between the sound runs'
# worst tensor (0.068, dp2 x tp2) and the controls' least (0.176, the last
# step on half the rows); PERF.md's Findings give the readings
MESH_UPDATE_TOL = 0.1
# (phase, label, mesh axes, layers, dtype, FSDP) — 17a the flagship at full
# width and depth in bf16, 17b two layers of the same widths in f32
# 17a's depth: the flagship's widths at 4 of its 12 layers (its gloo
# round trips dominate the phase; MESH_UPDATE_TOL was set on 12 layers,
# where the bf16 roundoff is larger)
MESH_17A_LAYERS = 4
MESH_CONFIGS = (
    ("17a", "dp2xtp2", {"dp": 2, "tp": 2}, MESH_17A_LAYERS, "bfloat16",
     False),
    ("17a", "dp2xfsdp2", {"dp": 2, "fsdp": 2}, MESH_17A_LAYERS, "bfloat16",
     True),
    ("17b", "dp4", {"dp": 4}, 2, "float32", False),
    ("17b", "dp2xtp2", {"dp": 2, "tp": 2}, 2, "float32", False),
    ("17b", "dp2xfsdp2", {"dp": 2, "fsdp": 2}, 2, "float32", True),
)
# the flash forward, the fused backward and the three CE kernels (rows 4,
# 5 and 8-10 of PERF.md's table)
MESH_ROWS = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_fwd",
             "fused_ce_dx", "fused_ce_dw")


def mesh_program(pt, seed, n_layer, dtype, axes=None, fsdp=False):
    """The flagship program with ``n_layer`` layers (fused head, Adam),
    annotated for ``axes`` as the reference annotates it: the tp rules,
    data parallelism over dp, and with FSDP the selective remat (its layer
    groups) and ``shard_fsdp``'s tags."""
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        model = pt.models.transformer.build(
            vocab_size=VOCAB, n_layer=n_layer, n_head=N_HEAD,
            d_model=D_MODEL, max_len=TRAIN_T, dropout_rate=0.0, dtype=dtype,
            fused_head=True, learning_rate=TRAIN_LR)
    if fsdp:
        pt.memory_optimize(main, policy="selective")
    if axes:
        par = pt.parallel
        if axes.get("tp", 1) > 1:
            for prog in (main, startup):
                par.shard_parameters_by_rule(
                    prog, pt.models.transformer.tp_rules())
        par.data_parallel(main, "dp", programs=(startup,))
        if fsdp:
            par.shard_fsdp(main, programs=(startup,))
    return main, startup, model


def mesh_train(torch, np, pt, seed, n_layer, dtype, state, axes=None,
               fsdp=False, before_last=False):
    """``MESH_STEPS`` steps through ``Trainer`` (with ``mesh=`` when
    ``axes`` is given: prefetch lands this rank's rows) from ``state``
    (``{name: CPU tensor}``, copied into the started scope): the losses,
    the step walls, the whole parameters, the launches and kernel
    families, the peak memory, and on a mesh the last step's comm summary
    (what ran), the contract violations and a digest of each parameter
    block this rank holds.  ``before_last`` (unsharded): also the
    parameters before the last step (a copy on the card, taken in the
    event handler)."""
    import hashlib

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.parallel.api import spec_axes
    from paddle_tpu_torch.parallel.contracts import training_step_contract

    main, startup, model = mesh_program(pt, seed, n_layer, dtype, axes,
                                        fsdp)
    mesh = pt.parallel.make_mesh(axes) if axes else None
    scope = pt.Scope()
    losses, stamps, snap = [], [], {}
    pnames = [p.name for p in main.all_parameters()]

    def on_event(e):
        if isinstance(e, pt.EndIteration):
            losses.append(float(np.asarray(e.cost).reshape(-1)[0]))
            stamps.append(time.perf_counter())
            if before_last and len(losses) == MESH_STEPS - 1:
                snap.update({n: scope.get(n).detach().clone()
                             for n in pnames})

    reader = pt.reader.batch(trainer_samples(np, seed, MESH_STEPS), TRAIN_B)
    with pt.scope_guard(scope):
        tr = pt.Trainer(model["avg_cost"], model["feed"],
                        place=pt.CUDAPlace(0), main_program=main,
                        startup_program=startup, mesh=mesh)
        tr.init_params()
        for n, t in state.items():
            scope.get(n).copy_(t)
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train(reader, num_passes=1, event_handler=on_event,
                 prefetch=2 if mesh else 0)
        torch.cuda.synchronize()
        out = {"losses": losses,
               "walls": [b - a for a, b in zip([t0] + stamps, stamps)],
               "launches": kernels.launch_counts(),
               "families": kernels.family_counts(),
               "peak": torch.cuda.max_memory_allocated()}
        if mesh is not None:
            cost = tr.exe.last_step_cost
            out["comm"] = cost["comm_plan"]
            out["overlapped"] = cost["overlapped_reductions"]
            out["viol"] = [
                v["message"] for c in training_step_contract(
                    mesh, fsdp=fsdp, grad_rs=True)
                for v in c.check(tr.exe.last_comm_plan)]
            # the block a rank holds, keyed by its place on the axes the
            # parameter is cut over: every rank of a key holds a replica
            coords = tr.exe.comm.coords
            out["blocks"] = {}
            for n in pnames:
                cut = sorted(a for a in spec_axes(tr.exe.shard_spec(main, n))
                             if mesh.shape.get(a, 1) > 1)
                t = scope.get(n).detach().contiguous().reshape(-1)
                out["blocks"][(n, tuple((a, coords[a]) for a in cut))] = (
                    hashlib.sha256(t.view(torch.uint8).cpu().numpy())
                    .hexdigest())
        out["params"] = {n: t.detach().cpu() for n, t in
                         tr.exe.gather_state(main, scope, pnames).items()}
        if snap:
            out["before_last"] = {n: t.cpu() for n, t in snap.items()}
    return out


def mesh_state(torch, pt, seed, n_layer, dtype):
    """The seeded startup state of the ``n_layer`` program on the card,
    as CPU tensors — the one state every run of a configuration
    imports."""
    main, startup, _ = mesh_program(pt, seed, n_layer, dtype)
    scope = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=scope)
    torch.cuda.synchronize()
    return {v.name: scope.get(v.name).detach().cpu()
            for v in main.persistable_vars()}


def mesh_rank(rank, store, seed, state_paths, q):
    """One rank of phase 17 (a process of its own on the one card): joins
    the gloo group (``distributed.launch``, a file store; NCCL refuses two
    ranks on one device), runs every mesh configuration, and reports."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import launch

    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        launch.init_multihost(f"file://{store}", MESH_RANKS, rank,
                              backend="gloo")
        states = {k: torch.load(p) for k, p in state_paths.items()}
        res = {}
        for ph, label, axes, n_layer, dtype, fsdp in MESH_CONFIGS:
            r = mesh_train(torch, np, pt, seed, n_layer, dtype,
                           states[(n_layer, dtype)], axes, fsdp)
            params = r.pop("params")
            if rank == 0:
                # tensors through the queue would be shared by file
                # descriptor with a process about to exit: a file
                torch.save(params, os.path.join(os.path.dirname(store),
                                                f"{ph}{label}.pt"))
            del params
            res[(ph, label)] = r
            gc.collect()
            torch.cuda.empty_cache()
        # 17b+: 17b's dp4 run with the boundary's overlap on and off,
        # both under deterministic algorithms (the fused flash backward's
        # dq atomics alone change the bits from run to run)
        with deterministic(torch):
            for knob in ("1", "0"):
                os.environ["PADDLE_TPU_COMM_OVERLAP"] = knob
                try:
                    r = mesh_train(torch, np, pt, seed, 2, "float32",
                                   states[(2, "float32")],
                                   {"dp": MESH_RANKS})
                finally:
                    del os.environ["PADDLE_TPU_COMM_OVERLAP"]
                del r["params"]
                res["overlap_" + ("on" if knob == "1" else "off")] = r
        # 17d-f: sequence, pipeline and expert parallelism
        for name, fn in (("17d", ring_phase), ("17e", pipeline_phase),
                         ("17f", moe_phase)):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            res[name] = fn(torch, pt, rank, seed)
            res[name]["phase_wall"] = time.perf_counter() - t0
        q.put((rank, res, None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback

        q.put((rank, None, traceback.format_exc()))


def mesh_params_agree(got, want, tol, what, zero_start=()):
    """Every parameter within ``tol`` of its largest entry; returns the
    worst tensor.  A tensor that starts at zero (``zero_start``: the
    biases) is held to the model's largest entry: after a few Adam steps
    its entries are only the ±lr steps, whose sign rounding decides
    wherever the gradient is small (the key biases, zero-gradient
    analytically, are one such case)."""
    biggest = max(float(t.float().abs().max()) for t in want.values())
    worst, bad = ("", 0.0), []  # worst: of the tensors held to their own
    for n, w in want.items():
        err = float((got[n].float() - w.float()).abs().max())
        own = err / float(w.float().abs().max())
        plain = "_att_k.b" not in n and n not in zero_start
        if plain:
            worst = max(worst, (n, own), key=lambda x: x[1])
        held = own if plain else err / biggest
        if held > tol:
            bad.append((n, held))
    if bad:
        raise AssertionError(f"{what}: {bad[:4]} off by more than {tol} of "
                             f"the largest entry")
    return worst


def mesh_updates_agree(got, ref, start, lr, what):
    """17a's parameter check (bf16): each tensor's update within
    ``MESH_UPDATE_TOL`` of the reference's — ||got - want|| / ||want -
    start||, where a state never updated reads 1 and a tensor the
    reference left unchanged reads 0 where the run left it unchanged too,
    else inf.  The key biases stand apart: their gradient is zero
    analytically, so both runs move them by Adam's steps on rounding
    noise; they are held to ``MESH_STEPS`` such steps.  Three controls,
    read on the same tensors, must fail the limit: the state before any
    step (a rank whose optimizer never ran), the reference's parameters
    before its last step (a rank that missed the last update) and the
    same with only the first half of each tensor's rows updated (a rank
    that skipped the last ZeRO-1 gather).  Logs every reading before it
    judges; returns the worst tensor's name and ratio."""
    keyb = {n for n in ref["params"] if "_att_k.b" in n}
    want = {n: t.float() for n, t in ref["params"].items() if n not in keyb}
    moved = {n: float((w - start[n].float()).norm())
             for n, w in want.items()}

    def reading(run):
        """Per-tensor ratios and the whole model's."""
        err = {n: float((run[n].float() - w).norm())
               for n, w in want.items()}
        per = {n: e / moved[n] if moved[n] else
               (0.0 if e == 0 else math.inf) for n, e in err.items()}
        whole = math.sqrt(sum(e * e for e in err.values())
                          / sum(m * m for m in moved.values()))
        return per, whole

    before = ref["before_last"]
    half = {}
    for n in want:
        h = ref["params"][n].clone()
        h[h.shape[0] // 2:] = before[n][h.shape[0] // 2:]
        half[n] = h
    ratios, whole = reading(got)
    controls = {c: reading(r) for c, r in (
        ("unchanged", start), ("before_last", before), ("half_rows", half))}
    worst = max(ratios.items(), key=lambda kv: kv[1])
    srt = sorted(ratios.values())
    keymove = max(float((got[n].float() - start[n].float()).abs().max())
                  for n in keyb)

    def least_median(per):
        v = sorted(x for x in per.values() if 0 < x < math.inf)
        return f"{v[0]:.3e} / {v[len(v) // 2]:.3e}"

    log(f"{what}: update ratio ||mesh - unsharded|| / ||unsharded - start|| "
        f"per tensor ({len(ratios)} tensors): worst {worst[0]} "
        f"{worst[1]:.3e}, median {srt[len(srt) // 2]:.3e}, whole model "
        f"{whole:.3e}; controls, whole model / per-tensor least / median: "
        + "; ".join(f"{c} {w:.3e} / {least_median(per)}"
                    for c, (per, w) in controls.items())
        + f"; tensors the reference left unchanged "
        f"{sum(1 for m in moved.values() if not m)}; key biases moved "
        f"{keymove:.3e} at most (limit {2 * MESH_STEPS * lr:.1e})")
    bad = sorted(((r, n) for n, r in ratios.items()
                  if not r <= MESH_UPDATE_TOL), reverse=True)
    if bad:
        raise AssertionError(f"{what}: updates off the reference's by more "
                             f"than {MESH_UPDATE_TOL} of their norm: "
                             f"{bad[:4]}")
    for c, (_, w) in controls.items():
        if not w > MESH_UPDATE_TOL:
            raise AssertionError(f"{what}: control {c} reads {w:.3e}, "
                                 f"within the limit {MESH_UPDATE_TOL}")
    if not keymove <= 2 * MESH_STEPS * lr:
        raise AssertionError(f"{what}: a key bias moved {keymove:.3e}, more "
                             f"than {MESH_STEPS} Adam steps of {lr}")
    return worst


# 17d: the flagship's attention at bench.py's long sequence, cut over sp
RING_B, RING_T = 2, 16384
# 17e: the flagship's 12 blocks over pp=4, 8 microbatches of one row
PIPE_MICRO, PIPE_V = 8, 3
D_FF = 4 * D_MODEL
# 17f: 8 experts, the flagship's d and FFN width, 4096 tokens a rank
MOE_E, MOE_TOKENS = 8, 4096


def _parallel_module(name):
    import importlib

    # the package re-exports functions under these modules' names
    return importlib.import_module(f"paddle_tpu_torch.parallel.{name}")


def ring_phase(torch, pt, rank, seed):
    """17d on this rank: ``ring_attention(impl="flash")`` on sp=4 at
    b=2, t=16384, 6 heads of 128, bf16, causal, forward and backward —
    its launches (counted from zero, after one warm call), its wall and
    backward route, the output and gradients against one whole-sequence
    ``flash_attention`` on rank 0; and a small f32 ring, flash against
    dense."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel.collectives import mesh_comm

    ra = _parallel_module("ring_attention")
    mesh = pt.parallel.make_mesh({"sp": MESH_RANKS})
    comm = mesh_comm(mesh)
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    q, k, v, do = (torch.randn(RING_B, RING_T, N_HEAD, D_HEAD,
                               generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))

    def ring():
        loc = [comm.block(x, "sp", 1).contiguous().requires_grad_(True)
               for x in (q, k, v)]
        o = ra.ring_attention(*loc, mesh, causal=True, impl="flash")
        o.backward(comm.block(do, "sp", 1).contiguous())
        return o.detach(), [x.grad for x in loc]

    ring()                                   # warm: load, allocate
    torch.cuda.synchronize()
    comm.take_log()
    routes = dict(fa.BWD_ROUTE_CALLS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    o, grads = ring()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    route = {r: fa.BWD_ROUTE_CALLS[r] - routes[r] for r in routes}
    shifts = sum(e["kind"] == "collective-permute" for e in comm.take_log())
    if launches["flash_attention_fwd"] != rank + 1:
        raise AssertionError(f"17d rank {rank}: {launches['flash_attention_fwd']}"
                             f" flash forwards, expected {rank + 1}")
    got = [comm.all_gather(t, "sp", 1) for t in [o] + grads]
    out = {"wall": wall, "route": route, "shifts": shifts,
           "launches": {n: c for n, c in launches.items() if c}}
    if rank == 0:
        whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ow = fa.flash_attention(*whole, causal=True)
        ow.backward(do)
        errs = {}
        for name, a, want, kind in zip(
                ("o", "dq", "dk", "dv"), got, [ow.detach()] +
                [x.grad for x in whole], ("fwd", "grad", "grad", "grad")):
            errs[name] = rel_err(torch, a, want)[1]
            if not errs[name] <= fa.oracle_tol("bfloat16", kind):
                raise AssertionError(f"17d {name}: {errs[name]:.3e} off the "
                                     f"whole-sequence flash_attention")
        out["errs"] = errs
        del whole, ow
    # a small f32 ring (TF32 off), the flash impl against the dense one
    g2 = torch.Generator(device="cuda").manual_seed(seed + 18)
    small = [torch.randn(1, MESH_RANKS * 256, 2, 64, generator=g2,
                         device="cuda") for _ in range(4)]
    res = {}
    for impl in ("flash", "dense"):
        loc = [comm.block(x, "sp", 1).contiguous().requires_grad_(True)
               for x in small[:3]]
        o2 = ra.ring_attention(*loc, mesh, causal=True, impl=impl)
        o2.backward(comm.block(small[3], "sp", 1).contiguous())
        res[impl] = [o2.detach()] + [x.grad for x in loc]
    out["f32_errs"] = {}
    for name, a, want, kind in zip(("o", "dq", "dk", "dv"), res["flash"],
                                   res["dense"], ("fwd",) + ("grad",) * 3):
        e = rel_err(torch, a, want)[1]
        out["f32_errs"][name] = e
        if not e <= fa.oracle_tol("float32", kind):
            raise AssertionError(f"17d f32 {name}: flash ring {e:.3e} off "
                                 f"the dense ring")
    return out


def lm_blocks(torch, seed):
    """The flagship's 12 pre-LN blocks (bf16), each a dict, from a seeded
    generator on the card — the same on every rank."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    dm = D_MODEL

    def w(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                ).to(torch.bfloat16)

    def zeros(n):
        return torch.zeros(n, device="cuda", dtype=torch.bfloat16)

    def ones(n):
        return torch.ones(n, device="cuda", dtype=torch.bfloat16)

    return [{"ln1_g": ones(dm), "ln1_b": zeros(dm),
             "w_qkv": w(dm, 3 * dm), "b_qkv": zeros(3 * dm),
             "w_o": w(dm, dm), "b_o": zeros(dm),
             "ln2_g": ones(dm), "ln2_b": zeros(dm),
             "w_1": w(dm, D_FF), "b_1": zeros(D_FF),
             "w_2": w(D_FF, dm), "b_2": zeros(dm)} for _ in range(N_LAYER)]


def lm_block(torch, fa, p, h):
    """One pre-LN transformer block on the flash kernels (what
    ``models/transformer.py`` builds a layer of): attention over 6 heads
    of 128, causal, and a GELU FFN, each residual."""
    F = torch.nn.functional
    dm = D_MODEL
    x = F.layer_norm(h, (dm,), p["ln1_g"], p["ln1_b"])
    q, k, v = (x @ p["w_qkv"] + p["b_qkv"]).split(dm, dim=-1)
    a = fa.flash_attention_packed(q, k, v, N_HEAD, causal=True)
    h = h + a @ p["w_o"] + p["b_o"]
    x = F.layer_norm(h, (dm,), p["ln2_g"], p["ln2_b"])
    return h + F.gelu(x @ p["w_1"] + p["b_1"]) @ p["w_2"] + p["b_2"]


def pipeline_phase(torch, pt, rank, seed):
    """17e on this rank: ``pipeline_lm`` over pp=4 with the flagship's
    blocks (3 a stage, then the interleaved schedule, one a stage), its
    embedding and the fused CE head, one step each; rank 0 runs the same
    functions in order and holds the loss and every gradient."""
    import torch.distributed as dist
    import torch.utils._pytree as pytree

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as ce
    from paddle_tpu_torch.parallel.collectives import mesh_comm

    P = _parallel_module("pipeline")
    F = torch.nn.functional
    mesh = pt.parallel.make_mesh({"pp": MESH_RANKS})
    comm = mesh_comm(mesh)
    blocks = lm_blocks(torch, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    emb = {"tok": (torch.randn(VOCAB, D_MODEL, generator=gen, device="cuda")
                   * 0.02).to(torch.bfloat16),
           "pos": (torch.randn(TRAIN_T, D_MODEL, generator=gen,
                               device="cuda") * 0.01).to(torch.bfloat16)}
    head = {"lnf_g": torch.ones(D_MODEL, device="cuda", dtype=torch.bfloat16),
            "lnf_b": torch.zeros(D_MODEL, device="cuda",
                                 dtype=torch.bfloat16),
            "w": (torch.randn(D_MODEL, VOCAB, generator=gen, device="cuda")
                  * 0.02).to(torch.bfloat16)}
    tok = torch.randint(0, VOCAB, (TRAIN_B, TRAIN_T), generator=gen,
                        device="cuda")
    tgt = torch.roll(tok, -1, dims=1)

    def embed_fn(p, t):
        return p["tok"][t] + p["pos"][:t.shape[-1]]

    def stage_fn(p, h):
        for i in range(p["w_qkv"].shape[0]):
            h = lm_block(torch, fa, {n: x[i] for n, x in p.items()}, h)
        return h

    def head_loss_fn(p, h, t):
        x = F.layer_norm(h, (D_MODEL,), p["lnf_g"], p["lnf_b"])
        return ce.fused_softmax_ce_head(x, p["w"], t).mean()

    def leaf(tree):
        return pytree.tree_map(
            lambda x: x.detach().clone().requires_grad_(True), tree)

    def run(v):
        per = N_LAYER // (MESH_RANKS * v)     # blocks a stage
        stages = [pytree.tree_map(lambda *xs: torch.stack(xs),
                                  *blocks[s * per:(s + 1) * per])
                  for s in range(MESH_RANKS * v)]
        loc = leaf(P.stage_block(P.stack_stage_params(stages), mesh,
                                 virtual_stages=v))
        e, h = leaf(emb), leaf(head)
        t0 = time.perf_counter()
        loss = P.pipeline_lm(embed_fn, stage_fn, head_loss_fn, e, loc, h,
                             tok, tgt, mesh, num_microbatches=PIPE_MICRO,
                             virtual_stages=v)
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # this rank's block gradients by block index, gathered over pp
        idx = comm.index("pp")
        mine = []
        for r in range(v):
            s = r * MESH_RANKS + idx
            for i in range(per):
                mine.append((s * per + i, {n: g.grad[r, i] for n, g in
                                           loc.items()}))
        names = sorted(blocks[0])
        flat = torch.cat([d[n].reshape(-1) for _, d in mine for n in names])
        parts = comm.all_gather(flat, "pp", 0).view(MESH_RANKS, -1)
        grads = {}
        for r in range(MESH_RANKS):
            off = 0
            for rr in range(v):
                s = rr * MESH_RANKS + r
                for i in range(per):
                    g = {}
                    for n in names:
                        k = blocks[0][n].numel()
                        g[n] = parts[r, off:off + k].view(blocks[0][n].shape)
                        off += k
                    grads[s * per + i] = g
        return {"loss": float(loss.detach()), "wall": wall, "grads": grads,
                "embed": e["tok"].grad, "head": h["w"].grad}

    run(1)                                   # warm
    torch.cuda.synchronize()
    comm.take_log()
    kernels.reset_launches()
    gp = run(1)
    launches = {n: c for n, c in kernels.launch_counts().items() if c}
    shifts = sum(e["kind"] == "collective-permute" for e in comm.take_log())
    il = run(PIPE_V)
    out = {"walls": (gp["wall"], il["wall"]), "loss": gp["loss"],
           "loss_il": il["loss"], "launches": launches, "shifts": shifts}
    if rank == 0:
        seq = {"blocks": leaf(blocks), "e": leaf(emb), "h": leaf(head)}
        mb = TRAIN_B // PIPE_MICRO
        total = 0.0
        for j in range(PIPE_MICRO):
            x = embed_fn(seq["e"], tok[j * mb:(j + 1) * mb])
            for p in seq["blocks"]:
                x = lm_block(torch, fa, p, x)
            lj = head_loss_fn(seq["h"], x, tgt[j * mb:(j + 1) * mb]).float()
            (lj / PIPE_MICRO).backward()
            total += float(lj.detach()) / PIPE_MICRO
        tol_f = fa.oracle_tol("bfloat16", "fwd")
        tol_g = fa.oracle_tol("bfloat16", "grad")
        errs = {"loss": abs(gp["loss"] - total) / abs(total),
                "loss_il": abs(il["loss"] - gp["loss"]) / abs(gp["loss"])}
        worst = ("", 0.0)
        for key, run_ in (("gpipe", gp), ("interleaved", il)):
            for b, p in enumerate(seq["blocks"]):
                for n, t in p.items():
                    e = rel_err(torch, run_["grads"][b][n], t.grad)[1]
                    worst = max(worst, (f"{key} block{b}.{n}", e),
                                key=lambda x: x[1])
            for n, a, want in (("embed", run_["embed"], seq["e"]["tok"].grad),
                               ("head", run_["head"], seq["h"]["w"].grad)):
                e = rel_err(torch, a, want)[1]
                worst = max(worst, (f"{key} {n}", e), key=lambda x: x[1])
        errs["worst_grad"] = worst
        if not (errs["loss"] <= tol_f and errs["loss_il"] <= tol_f
                and worst[1] <= tol_g):
            raise AssertionError(f"17e: pipeline_lm off the blocks run in "
                                 f"order: {errs} (loss {gp['loss']}, "
                                 f"interleaved {il['loss']}, in order "
                                 f"{total})")
        out["errs"] = errs
        out["loss_seq"] = total
        del seq
    dist.barrier()
    return out


def dense_moe(torch, M, params, x, cf, e):
    """A dense top-2 over all ``e`` experts on this rank's tokens, with
    moe_ffn's capacity rule (tests/test_parallel_pipeline_moe.py's)."""
    n = x.shape[0]
    cap = int(max(1, cf * n / e))
    disp, comb, aux = M._top2_dispatch(x @ params["gate"].to(x.dtype), cap)
    ein = torch.einsum("nec,nd->ecd", disp.to(x.dtype), x)
    h = torch.relu(torch.einsum("end,edf->enf", ein, params["w1"])
                   + params["b1"][:, None, :])
    y = torch.einsum("enf,efd->end", h, params["w2"]) + params["b2"][:, None]
    return torch.einsum("nec,ecd->nd", comb.to(y.dtype), y), aux


def moe_phase(torch, pt, rank, seed):
    """17f on this rank: ``moe_ffn`` on ep=4, 8 experts, d 768, hidden
    3072, 4096 tokens a rank, bf16, forward and backward at capacity 2.0
    and at one that drops no token (held against a dense top-2)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel.collectives import mesh_comm

    M = _parallel_module("moe")
    mesh = pt.parallel.make_mesh({"ep": MESH_RANKS})
    comm = mesh_comm(mesh)
    gen = torch.Generator().manual_seed(seed + 21)
    whole = M.init_moe_params(gen, MOE_E, D_MODEL, D_FF,
                              dtype=torch.bfloat16)
    gx = torch.Generator(device="cuda").manual_seed(seed + 22)
    x_all = torch.randn(MESH_RANKS * MOE_TOKENS, D_MODEL, generator=gx,
                        device="cuda").to(torch.bfloat16)
    x = comm.block(x_all, "ep", 0).contiguous()
    out = {}
    for key, cf in (("cf2", 2.0), ("nodrop", float(MOE_E))):
        p = {n: (comm.block(t, "ep", 0) if n != "gate" else t)
             .contiguous().clone().requires_grad_(True)
             for n, t in whole.items()}
        xl = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = M.moe_ffn(p, xl, mesh, capacity_factor=cf)
        (y.float().square().sum() + 0.01 * aux).backward()
        torch.cuda.synchronize()
        r = {"wall": time.perf_counter() - t0, "aux": float(aux.detach())}
        auxes = comm.all_gather(aux.detach().reshape(1).float(), "ep", 0)
        ok = all(bool(torch.isfinite(t).all()) for t in
                 [y, xl.grad] + [q.grad for q in p.values()])
        if not ok or len(set(auxes.tolist())) != 1:
            raise AssertionError(f"17f {key} rank {rank}: finite {ok}, aux "
                                 f"{auxes.tolist()}")
        r["dropped"] = int((y.detach() == 0).all(dim=1).sum())
        if key == "nodrop":
            dense = {n: t.clone().requires_grad_(True)
                     for n, t in whole.items()}
            xd = x.clone().requires_grad_(True)
            yd, auxd = dense_moe(torch, M, dense, xd, cf, MOE_E)
            (yd.float().square().sum() + 0.01 * auxd / MESH_RANKS).backward()
            r["errs"] = {"y": rel_err(torch, y.detach(), yd.detach())[1],
                         "dx": rel_err(torch, xl.grad, xd.grad)[1]}
            if not (r["errs"]["y"] <= fa.oracle_tol("bfloat16", "fwd")
                    and r["errs"]["dx"] <= fa.oracle_tol("bfloat16", "grad")
                    and r["dropped"] == 0):
                raise AssertionError(f"17f rank {rank}: no-drop moe_ffn off "
                                     f"the dense top-2: {r}")
        out[key] = r
    return out


def parallel_report(ranks, smi):
    """17b+ and 17d-f: hold what the ranks returned and log it."""
    on = [ranks[r]["overlap_on"] for r in range(MESH_RANKS)]
    off = [ranks[r]["overlap_off"] for r in range(MESH_RANKS)]
    for r in range(MESH_RANKS):
        if (on[r]["losses"] != off[r]["losses"]
                or on[r]["blocks"] != off[r]["blocks"]):
            raise AssertionError(f"17b+ rank {r}: overlap on and off differ:"
                                 f" losses {on[r]['losses']} vs "
                                 f"{off[r]['losses']}")
        if not (on[r]["overlapped"] > 0 and off[r]["overlapped"] == 0):
            raise AssertionError(f"17b+ rank {r}: overlapped reductions "
                                 f"{on[r]['overlapped']} on, "
                                 f"{off[r]['overlapped']} off")
    log(f"17b+ dp4 f32 under deterministic algorithms, "
        f"PADDLE_TPU_COMM_OVERLAP on vs 0: losses and every "
        f"parameter block bit for bit equal on all {MESH_RANKS} ranks; "
        f"{on[0]['overlapped']} boundary reductions started during the "
        f"backward; step walls on {[round(w, 4) for w in on[0]['walls']]} "
        f"s, off {[round(w, 4) for w in off[0]['walls']]} s ({smi})")
    d = [ranks[r]["17d"] for r in range(MESH_RANKS)]
    log(f"17d ring_attention(impl='flash') sp={MESH_RANKS}, b={RING_B}, "
        f"t={RING_T} ({RING_T // MESH_RANKS} a rank), {N_HEAD} heads of "
        f"{D_HEAD}, bf16, causal, forward + backward: launches by rank "
        f"{[x['launches'] for x in d]}; backward routes "
        f"{[x['route'] for x in d]}; shifts a rank {d[0]['shifts']}; wall "
        f"by rank {[round(x['wall'], 4) for x in d]} s; vs the whole-"
        f"sequence flash_attention {d[0]['errs']}; small f32 ring flash vs "
        f"dense {d[0]['f32_errs']}; phase wall "
        f"{max(x['phase_wall'] for x in d):.1f} s ({smi})")
    e = [ranks[r]["17e"] for r in range(MESH_RANKS)]
    log(f"17e pipeline_lm pp={MESH_RANKS}, {N_LAYER} blocks d{D_MODEL} "
        f"(3 a stage; interleaved {PIPE_V} laps, one a stage), vocab {VOCAB}"
        f", t={TRAIN_T}, batch {TRAIN_B} in {PIPE_MICRO} microbatches, bf16,"
        f" one step: loss GPipe {e[0]['loss']:.6f}, interleaved "
        f"{e[0]['loss_il']:.6f}, in order {e[0]['loss_seq']:.6f}; errors "
        f"{e[0]['errs']}; launches by rank (GPipe) "
        f"{[x['launches'] for x in e]}; shifts a rank {e[0]['shifts']}; "
        f"walls GPipe / interleaved by rank "
        f"{[tuple(round(w, 3) for w in x['walls']) for x in e]} s; phase "
        f"wall {max(x['phase_wall'] for x in e):.1f} s ({smi})")
    f = [ranks[r]["17f"] for r in range(MESH_RANKS)]
    log(f"17f moe_ffn ep={MESH_RANKS}, {MOE_E} experts, d {D_MODEL}, hidden "
        f"{D_FF}, {MOE_TOKENS} tokens a rank, bf16, forward + backward: "
        f"capacity 2.0 aux {f[0]['cf2']['aux']:.6f} on every rank, tokens "
        f"dropped by rank {[x['cf2']['dropped'] for x in f]}, wall by rank "
        f"{[round(x['cf2']['wall'], 4) for x in f]} s; capacity "
        f"{float(MOE_E)} (none dropped) vs a dense top-2 by rank "
        f"{[x['nodrop']['errs'] for x in f]}, wall by rank "
        f"{[round(x['nodrop']['wall'], 4) for x in f]} s; phase wall "
        f"{max(x['phase_wall'] for x in f):.1f} s ({smi})")


def mesh_nccl_phase(torch, np, pt, smi, seed):
    """17c: phase 10's flagship through ``Trainer(mesh=make_mesh({"dp":
    1}))`` on a one-rank NCCL group against the mesh-less Trainer, bit for
    bit (deterministic algorithms on), both step walls in the same call."""
    import tempfile

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import launch

    with tempfile.TemporaryDirectory() as d:
        launch.init_multihost(f"file://{d}/store", 1, 0, backend="nccl")
        try:
            t = torch.ones(1, device="cuda")
            dist.all_reduce(t)
            assert dist.get_backend() == "nccl" and float(t[0]) == 1.0
            state = mesh_state(torch, pt, seed, N_LAYER, "bfloat16")
            with deterministic(torch):
                plain = mesh_train(torch, np, pt, seed, N_LAYER, "bfloat16",
                                   state, before_last=True)
                meshed = mesh_train(torch, np, pt, seed, N_LAYER,
                                    "bfloat16", state, {"dp": 1})
        finally:
            dist.destroy_process_group()
    if plain["losses"] != meshed["losses"]:
        raise AssertionError(f"17c: losses {meshed['losses']} != "
                             f"{plain['losses']}")
    for n, w in plain["params"].items():
        if not torch.equal(meshed["params"][n], w):
            raise AssertionError(f"17c: {n} differs from the mesh-less run")
    log(f"17c one rank over NCCL, dp1: losses {meshed['losses']} equal the "
        f"mesh-less Trainer's bit for bit, every parameter too; step walls "
        f"mesh {[round(w, 4) for w in meshed['walls']]} s, mesh-less "
        f"{[round(w, 4) for w in plain['walls']]} s ({smi})")
    del state, plain, meshed
    gc.collect()
    torch.cuda.empty_cache()


def mesh_phase(torch, np, pt, smi, seed):
    """Phase 17: sharded training over a device mesh, as four processes
    on the one card (gloo with CUDA tensors), against the single-process
    unsharded Trainer on the card (17a, 17b), and one rank over NCCL
    (17c)."""
    import tempfile

    import torch.multiprocessing as mp

    from paddle_tpu_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    mesh_nccl_phase(torch, np, pt, smi, seed)
    t_17c = time.perf_counter() - t_phase
    keys = sorted({(c[3], c[4]) for c in MESH_CONFIGS})
    with tempfile.TemporaryDirectory() as d:
        paths, refs, zero_start, starts = {}, {}, {}, {}
        for n_layer, dtype in keys:
            state = mesh_state(torch, pt, seed, n_layer, dtype)
            # bf16 keeps the state before the last step for the controls
            # of mesh_updates_agree
            refs[(n_layer, dtype)] = mesh_train(
                torch, np, pt, seed, n_layer, dtype, state,
                before_last=dtype == "bfloat16")
            zero_start[(n_layer, dtype)] = {
                n for n, t in state.items() if not bool(t.any())}
            starts[(n_layer, dtype)] = {
                n: state[n] for n in refs[(n_layer, dtype)]["params"]}
            paths[(n_layer, dtype)] = os.path.join(d, f"{n_layer}{dtype}.pt")
            torch.save(state, paths[(n_layer, dtype)])
            del state
            gc.collect()
            torch.cuda.empty_cache()
        t_refs = time.perf_counter() - t_phase - t_17c
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, os.path.join(d, "store"), seed, paths,
                                   q)) for r in range(MESH_RANKS)]
        try:
            for p in procs:
                p.start()
            ranks = {}
            for _ in procs:
                rank, res, err = q.get(timeout=900)
                if err:
                    raise AssertionError(f"phase 17 rank {rank} failed:\n"
                                         f"{err}")
                ranks[rank] = res
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        for ph, label, *_ in MESH_CONFIGS:
            ranks[0][(ph, label)]["params"] = torch.load(
                os.path.join(d, f"{ph}{label}.pt"))
    t_ranks = time.perf_counter() - t_phase - t_17c - t_refs
    for ph, label, axes, n_layer, dtype, fsdp in MESH_CONFIGS:
        ref = refs[(n_layer, dtype)]
        loss_tol = (fa.oracle_tol("bfloat16", "fwd") if dtype == "bfloat16"
                    else 2e-4)
        rel = [abs(a - b) / abs(b) for a, b in
               zip(ranks[0][(ph, label)]["losses"], ref["losses"])]
        if max(rel) > loss_tol:
            raise AssertionError(
                f"{ph} {label}: losses {ranks[0][(ph, label)]['losses']} "
                f"vs unsharded {ref['losses']}")
        # bf16: each tensor's update against the unsharded run's (Adam
        # turns bf16-rounding-level gradients into ±lr steps of either
        # sign, so entries are not held one by one); f32: each tensor
        # within 1e-3 of its largest entry
        if dtype == "bfloat16":
            worst = mesh_updates_agree(
                ranks[0][(ph, label)]["params"], ref,
                starts[(n_layer, dtype)], TRAIN_LR, f"{ph} {label}")
            unit = "of the unsharded run's update"
        else:
            worst = mesh_params_agree(
                ranks[0][(ph, label)]["params"], ref["params"], 1e-3,
                f"{ph} {label}", zero_start[(n_layer, dtype)])
            unit = "of its own largest entry"
        del ranks[0][(ph, label)]["params"]
        # every rank that holds the same block of a parameter holds it
        # bit for bit (replicas over dp, tp and fsdp)
        held = {}
        for rank in range(MESH_RANKS):
            for key, digest in ranks[rank][(ph, label)]["blocks"].items():
                held.setdefault(key, []).append((rank, digest))
        split = {k: v for k, v in held.items()
                 if len({d for _, d in v}) > 1}
        if split:
            raise AssertionError(f"{ph} {label}: replicas differ: "
                                 f"{sorted(split)[:4]}")
        n_rep = sum(1 for v in held.values() if len(v) > 1)
        for rank in range(MESH_RANKS):
            r = ranks[rank][(ph, label)]
            # ranks that compute the same rows (fsdp peers) sum the
            # card's atomics in their own orders: equal within the bound
            if max(abs(a - b) / abs(b) for a, b in zip(
                    r["losses"], ranks[0][(ph, label)]["losses"])) > loss_tol:
                raise AssertionError(f"{ph} {label}: rank {rank}'s losses "
                                     f"{r['losses']} off rank 0's")
            if r["viol"]:
                raise AssertionError(f"{ph} {label} rank {rank}: contract "
                                     f"violations {r['viol']}")
            missing = [k for k in MESH_ROWS if not r["launches"][k]]
            if missing:
                raise AssertionError(f"{ph} {label} rank {rank}: no launch "
                                     f"of {missing}")
            if ph == "17a" and axes.get("tp", 1) > 1:
                fam = r["families"]
                off = [k for k in ("flash_attention_fwd",
                                   "flash_attention_bwd", "fused_ce_fwd",
                                   "fused_ce_dx", "fused_ce_dw")
                       if not fam[k].get("sm90")]
                if off:
                    raise AssertionError(f"17a tp rank {rank}: {off} did "
                                         f"not run the sm90 family: {fam}")
        r0 = ranks[0][(ph, label)]
        by_kind = {}
        for row in r0["comm"]:
            by_kind[row["kind"]] = by_kind.get(row["kind"], 0) + row["bytes"]
        log(f"{ph} {label} ({n_layer} layers, {dtype}, global batch "
            f"{TRAIN_B}, t={TRAIN_T}): losses {r0['losses']} vs unsharded "
            f"{ref['losses']} (worst rel {max(rel):.2e}); worst parameter "
            f"{worst[0]} {worst[1]:.2e} {unit}; step walls "
            f"{[round(w, 3) for w in r0['walls']]} s (unsharded "
            f"{[round(w, 3) for w in ref['walls']]} s); comm bytes a step "
            f"{by_kind}; {n_rep} parameter blocks held by several ranks, "
            f"each bit for bit alike; peak memory per rank "
            f"{[ranks[k][(ph, label)]['peak'] for k in range(MESH_RANKS)]} B "
            f"(unsharded {ref['peak']} B); launches on rank 0 "
            f"{ {k: r0['launches'][k] for k in MESH_ROWS} }; contracts hold "
            f"on every rank ({smi})")
    parallel_report(ranks, smi)
    log(f"phase 17 wall {time.perf_counter() - t_phase:.1f} s (17c "
        f"{t_17c:.1f} s, unsharded references {t_refs:.1f} s, the four "
        f"ranks {t_ranks:.1f} s)")


# -- phase 18: the autotuner on the card ------------------------------------

# 18b's candidates: the flagship's step under four policies, each on the
# fused (block_k 1024) and the split (block_k 256) backward route
TUNE_POLICIES = ("none", "selective", "compact", "full")
TUNE_BLOCK_CAPS, TUNE_MEASURE, TUNE_REPEATS = (1024, 256), 6, 2


@contextlib.contextmanager
def tune_env(mode, cache):
    """``PADDLE_TPU_TUNE=mode`` and ``PADDLE_TPU_TUNE_CACHE=cache`` inside
    the block (the cache singleton re-read on entry and exit)."""
    from paddle_tpu_torch import tune

    old = {k: os.environ.get(k)
           for k in ("PADDLE_TPU_TUNE", "PADDLE_TPU_TUNE_CACHE")}
    os.environ["PADDLE_TPU_TUNE"] = mode
    os.environ["PADDLE_TPU_TUNE_CACHE"] = cache
    tune.reset_cache()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tune.reset_cache()


def tune_paged_phase(torch, np, pa, kernels, smi, seed, cache):
    """18a: ``tune_paged_attention`` at phase 5's decode shape (bf16, where
    row 1 is timed) and in f32 (phase 4's engine dtype), each count held
    against ``paged_attention_split_ref`` at that count inside the search;
    then phase 4's f32 engine in cached mode takes the f32 winner for its
    decode call and its tokens are held to an untuned engine's on phase
    4's eight requests, and a speculative engine at k=8 with the entry
    present serves two of them (draft chunk at the winner, verify window
    on the simple family) with the tuned engine's tokens."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.observability import metrics as obs

    nb = MAX_LEN // BLOCK_TOKENS
    rule = pa.paged_splits(SLOTS, N_HEAD, nb)[0]
    winners = {}
    with tune_env("search", cache):
        for dt in ("bfloat16", "float32"):
            rep = tune.tune_paged_attention(
                N_HEAD, D_HEAD, MAX_LEN, BLOCK_TOKENS, dtype=dt,
                slots=SLOTS, repeats=7, seed=seed, device="cuda")
            if rep["source"] != "search":
                raise AssertionError(f"18a {dt}: the search did not run: "
                                     f"{rep['source']}")
            for m in rep["measured"]:
                log(f"18a {dt} S={SLOTS} W=1 h={N_HEAD} dh={D_HEAD} "
                    f"B={BLOCK_TOKENS} NB={nb}: splits {m['splits']:2d}"
                    f"{' (the rule)' if m['splits'] == rule else '':11s} "
                    f"{m['median_s'] * 1e3:.4f} ms (CUDA events over 50 "
                    f"queued calls, median of 7), rel err vs the split plain version "
                    f"{m['rel_err']:.3e} (tol {pa.oracle_tol(dt)}) [{smi}]")
            winners[dt] = rep["entry"]["config"]["splits"]
            by = {m["splits"]: m["median_s"] for m in rep["measured"]}
            log(f"18a {dt}: the winner splits {winners[dt]} at "
                f"{by[winners[dt]] * 1e3:.4f} ms beside the rule's "
                f"{rule} at {by[rule] * 1e3:.4f} ms [{smi}]")
    rng = np.random.default_rng(seed)
    params = make_params(rng)
    work = make_workload(rng, REQUESTS, CLASSES, VOCAB, PREFIX_LEN)[:8]
    reg = obs.get_registry()
    win = winners["float32"]

    def rule(S):
        return pa.paged_splits(S, N_HEAD, nb)[0]

    def split_counts(what, tuned):
        """The split launches since the last reset, ``{(S, W, splits):
        n}``: the decode-shaped call (SLOTS rows, one token) at ``tuned``
        (the rule's count when None), every other call at the rule's."""
        counts = dict(pa.PAGED_SPLIT_CALLS)
        bad = {at: n for at, n in counts.items()
               if at[2] != (tuned if tuned and at[:2] == (SLOTS, 1)
                            else rule(at[0]))}
        if bad or not any(at[:2] == (SLOTS, 1) for at in counts):
            raise AssertionError(
                f"18a {what}: split launches {counts}; tuned count "
                f"{tuned} for the ({SLOTS}, 1) call, the rule elsewhere")
        return counts

    def tied(outs, base, sel, what):
        """``outs`` equal ``base`` on the requests ``sel``, or differ only
        where ``generate``'s top-2 logit gap is below 1e-5; returns how
        many are equal."""
        same = [k for k, a, b in zip(sel, outs, base) if np.array_equal(a, b)]
        rest = [k for k in sel if k not in same]
        if rest:
            refs = generate_refs(torch, params, [work[k] for k in rest],
                                 N_LAYER, N_HEAD, D_MODEL)
            for k, (_, logits) in zip(rest, refs):
                a, b = outs[sel.index(k)], base[sel.index(k)]
                i = int(np.nonzero(a != b)[0][0])
                top = torch.topk(logits[i - 1], 2).values
                gap = (top[0] - top[1]).item()
                log(f"18a {what} request {k}: differs at position {i}; top-2 "
                    f"logit gap there {gap:.3e} (limit 1e-5)")
                if not gap < 1e-5:
                    raise AssertionError(f"18a {what} request {k}: tokens "
                                         f"differ where the gap is {gap:.3e}")
        return len(same)

    with tune_env("cached", cache):
        h0 = reg.value("tune.cache_hits")
        kernels.reset_launches()
        tuned, eng = serve_f32(params, work)
        hits = reg.value("tune.cache_hits") - h0
        if not (hits > 0 and eng.attn_splits == win):
            raise AssertionError(f"18a: the cached engine did not take the "
                                 f"winner {win}: hits {hits}, attn_splits "
                                 f"{eng.attn_splits}")
        counts = split_counts("tuned engine", win)
        del eng
        # a speculative engine at k=8 with the entry present: its draft
        # chunk makes the decode call (the tuned count), its verify window
        # (9 tokens) the simple family, its prefill the rule
        from paddle_tpu_torch.serving import speculative

        sel = [k for k, (_, m) in enumerate(work) if m == CLASSES[0][1]]
        kernels.reset_launches()
        spec_outs, eng = serve_f32(
            params, [work[k] for k in sel], spec_k=8,
            draft_params=speculative.depth_draft(params, CHECK_DRAFT_LAYERS))
        spec_counts = split_counts("spec engine k=8", win)
        simple = kernels.family_counts()["paged_attention"]["simple"]
        if not (eng.attn_splits == win and eng._spec.proposed > 0
                and simple > 0):
            raise AssertionError(
                f"18a spec engine k=8: attn_splits {eng.attn_splits}, "
                f"proposed {eng._spec.proposed}, simple launches {simple}")
        spec_same = tied(spec_outs, [tuned[k] for k in sel], sel,
                         "spec k=8 vs tuned")
        del eng
    with tune_env("0", cache):
        kernels.reset_launches()
        plain, eng = serve_f32(params, work)
        if eng.attn_splits is not None:
            raise AssertionError(f"18a: the untuned engine took splits "
                                 f"{eng.attn_splits}")
        untuned = split_counts("untuned engine", None)
    del eng
    same = tied(tuned, plain, list(range(len(work))), "tuned vs untuned")
    log(f"18a f32 engine at phase 4's configuration: cached mode took "
        f"splits {win} for the ({SLOTS}, 1) decode call (tune.cache_hits "
        f"+{int(hits)}; split launches by (S, W, splits) {counts}); untuned "
        f"ran the rule's {untuned}; {same}/{len(work)} requests "
        f"token-identical")
    log(f"18a speculative f32 engine, k=8, the entry present: split "
        f"launches {spec_counts}, {simple} simple-family (verify, W=9); "
        f"{spec_same}/{len(sel)} requests token-identical to the tuned "
        f"engine's")
    return winners


def tune_step_phase(torch, np, pt, smi, cache):
    """18b: ``tune_gpt_step`` at the flagship (12L, d768, 6x128, vocab
    32768, t=4096, b=8, fused head, bf16) over ``TUNE_POLICIES`` x the two
    backward routes, at most ``TUNE_MEASURE`` measured."""
    from paddle_tpu_torch import tune

    with tune_env("search", cache):
        rep = tune.tune_gpt_step(
            TRAIN_T, N_LAYER, D_MODEL, N_HEAD, VOCAB, TRAIN_B,
            dtype="bfloat16", fused_head=True, steps=2, warmup=1,
            repeats=TUNE_REPEATS, block_caps=TUNE_BLOCK_CAPS,
            block_q_caps=(1024,),
            policies=TUNE_POLICIES, accums=(1,), max_measure=TUNE_MEASURE,
            learning_rate=TRAIN_LR, device="cuda")
    timed = [m for m in rep["measured"] if m["verdict"] == "measured"]
    for m in rep["measured"]:
        if m["verdict"] != "measured":
            log(f"18b {m['policy']:9s} block_k {m['block_k']:4d}: "
                f"{m['verdict']} ({m['reason']})")
            continue
        base = m.get("hbm_baseline_bytes", 0)
        ratio = (m["hbm_high_water_bytes"] - base) / m["hbm_est_bytes"]
        log(f"18b {m['policy']:9s} block_k {m['block_k']:4d} "
            f"({m['route']} backward): median {m['median_s']:.4f} s for 2 "
            f"steps, {m['tok_s']:.0f} tok/s; max_memory_allocated "
            f"{m['hbm_high_water_bytes'] / 1e9:.3f} GB (of it "
            f"{base / 1e9:.3f} GB held before the candidate) beside "
            f"estimate_gpt_step_hbm {m['hbm_est_bytes'] / 1e9:.3f} GB: "
            f"measured / estimate {ratio:.3f} [{smi}]")
    if rep["source"] != "search" or len(timed) < 2:
        raise AssertionError(f"18b: no winner from two measured candidates "
                             f"({rep['source']}, {len(timed)} measured)")
    win = rep["entry"]["config"]
    log(f"18b winner {win} of {len(timed)} measured, "
        f"{rep['pruned_preflight']} rejected by the preflight, "
        f"{rep['candidates']} candidates ({rep.get('truncated_to')} after "
        f"the cap) [{smi}]")
    return win


def tune_resolve_phase(torch, np, pt, seed, win, cache):
    """18c: in cached mode ``memory_optimize(policy="auto")`` on a fresh
    flagship applies the winner's policy, and one ``Trainer`` step equals
    a step of the same program with that policy spelled out, bit for bit
    under deterministic algorithms; under ``PADDLE_TPU_TUNE=0`` ``auto``
    resolves to ``selective``."""
    policy = win["policy"]

    def one_step(spelled):
        main, startup, model = build_training(pt, seed, TRAIN_T, "bfloat16",
                                              True)
        if spelled is None:
            pt.memory_optimize(main, policy="auto")
        elif spelled != "none":
            pt.memory_optimize(main, policy=spelled)
        label = getattr(main, "_remat_policy", None) or "none"
        losses = []

        def on_event(e):
            if isinstance(e, pt.EndIteration):
                losses.append(e.cost)

        scope = pt.Scope()
        with pt.scope_guard(scope), deterministic(torch):
            tr = pt.Trainer(model["avg_cost"], model["feed"],
                            main_program=main, startup_program=startup)
            tr.train(pt.reader.batch(trainer_samples(np, seed, 1), TRAIN_B),
                     num_passes=1, event_handler=on_event)
            torch.cuda.synchronize()
            params = {p.name: scope.get(p.name).clone()
                      for p in main.all_parameters()}
        attrs = next(op.attrs for op in main.global_block().ops
                     if op.type.startswith("flash_attention"))
        return label, losses, params, (attrs.get("block_q"),
                                       attrs.get("block_k"))

    with tune_env("cached", cache):
        auto = one_step(None)
        spelled = one_step(policy)
    if auto[0] != policy:
        raise AssertionError(f"18c: auto resolved to {auto[0]}, the winner "
                             f"is {policy}")
    if auto[3] != (win["block_q"], win["block_k"]):
        raise AssertionError(f"18c: the flash op's blocks {auto[3]} are not "
                             f"the winner's")
    bad = [n for n in auto[2] if not torch.equal(auto[2][n], spelled[2][n])]
    if auto[1] != spelled[1] or bad:
        raise AssertionError(f"18c: auto's step {auto[1]} vs the spelled-out "
                             f"{spelled[1]}; parameters differing: {bad[:5]}")
    with tune_env("0", cache):
        main = build_training(pt, seed, TRAIN_T, "bfloat16", True)[0]
        pt.memory_optimize(main, policy="auto")
        if main._remat_policy != "selective":
            raise AssertionError(f"18c: PADDLE_TPU_TUNE=0 resolved auto to "
                                 f"{main._remat_policy}")
    log(f"18c: cached auto -> {auto[0]} with blocks {auto[3]}; one Trainer "
        f"step loss {auto[1][0]!r} equals the spelled-out {policy}'s "
        f"{spelled[1][0]!r} and all {len(auto[2])} parameters bit for bit "
        f"(deterministic algorithms); PADDLE_TPU_TUNE=0 -> selective")


# the selftests phases 18d and 19d run on the card, all four side by side
# at the end of phase 19 (each a process of its own, host-bound)
SELFTESTS = (("18d", "--tune-selftest"), ("18d", "--spec-selftest"),
             ("19d", "--attribution-selftest"), ("19d", "--memory-selftest"))


def selftests_phase(cache):
    """18d and 19d: ``python -m paddle_tpu_torch <flag>`` for each of
    ``SELFTESTS`` on the card, side by side, each exit 0."""
    env = dict(os.environ, PADDLE_TPU_TUNE_CACHE=cache)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {(ph, flag): subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", flag], cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for ph, flag in SELFTESTS}
    try:
        outs = {key: p.communicate(timeout=300) + (p.returncode,)
                for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for (ph, flag), (out, err, rc) in outs.items():
        if rc != 0:
            raise AssertionError(f"{ph} {flag} exited {rc}:\n{out[-3000:]}"
                                 f"{err[-3000:]}")
        for line in out.splitlines():
            if "profiled step" in line or "memory figure" in line:
                log(f"{ph} {flag}: {line.strip()[:200]}")
        log(f"{ph} {flag} on the card: exit 0 "
            f"({out.strip().splitlines()[-1]})")
    log(f"18d and 19d: {len(SELFTESTS)} selftests side by side: "
        f"{time.perf_counter() - t0:.1f} s")


def tune_phase(torch, np, pt, pa, kernels, smi, seed, cache):
    """Phase 18a-c, every cache write to ``cache`` (phase 19 reads it;
    18d runs with 19d, ``selftests_phase``)."""
    t0 = time.perf_counter()
    walls = {}
    t = time.perf_counter()
    tune_paged_phase(torch, np, pa, kernels, smi, seed, cache)
    walls["18a"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    win = tune_step_phase(torch, np, pt, smi, cache)
    walls["18b"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    tune_resolve_phase(torch, np, pt, seed, win, cache)
    walls["18c"] = time.perf_counter() - t
    log(f"phase 18 wall {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + f") [{smi}]")


# -- phase 19: the analysis and attribution layer on the card ---------------

# 19a's measured steps (each a corpus row) after the first run
ATTR_STEPS = 5
# 19b's policies, each linted at every level
LINT_POLICIES = ("none", "selective", "compact", "offload")


def attribution_step_phase(torch, np, pt, smi, seed):
    """19a: the flagship's step (t=4096, b=8, fused head, bf16), every
    run inside a declared timed run (``analysis.jaxpr_checks.timed_run``,
    so the fold-in's ``jaxpr.kernel-backend`` holds each kernel op to its
    sm90 family): the attribution table and the lints its first run
    folds in (``exe.last_attribution``, zero findings), what the fold-in
    hook cost that run (``executor.fold_in_seconds``), ``ATTR_STEPS``
    measured steps (host clock around a step ending in a host read of the
    loss), and ``attribute_profile`` of a middle step, printed class by
    class beside the table; every hand-written kernel the profiled steps
    launched must show under its own family.  Returns ``(table, walls,
    main, scope, feed, fetch)``."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.analysis.jaxpr_checks import timed_run
    from paddle_tpu_torch.core.executor import step_flops
    from paddle_tpu_torch.observability import attribution as attr
    from paddle_tpu_torch.observability import get_registry

    main, startup, model = build_training(pt, seed, TRAIN_T, "bfloat16",
                                          True)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = make_batch(torch, np.random.default_rng(seed), TRAIN_B, TRAIN_T)
    fetch = [model["avg_cost"].name]
    hook = get_registry().histogram("executor.fold_in_seconds")
    with timed_run():
        h0 = hook.total
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
        loss.item()
        first = time.perf_counter() - t0
        hook_s = hook.total - h0
        cost = dict(exe.last_step_cost)
        att = exe.last_attribution
        flops = step_flops(main, TRAIN_B)
        cov = att["product_flops"] / flops
        if abs(cov - 1.0) > 0.01:
            raise AssertionError(f"19a: the table's product flops "
                                 f"{att['product_flops']} are not within "
                                 f"1% of step_flops {flops}")
        backends = (cost.get("kernel_families"),
                    cost.get("kernel_backends"))
        if cost.get("lint_findings") != 0 or backends != (
                {"flash_attention": "sm90", "fused_ce": "sm90"},
                {"flash_attention": "cuda", "fused_ce": "cuda"}):
            raise AssertionError(
                f"19a: the first run's fold-in in a timed run: "
                f"{cost.get('lint_findings')} lint findings "
                f"{cost.get('lint_checks')}, kernels {backends}")
        walls = []
        for _ in range(ATTR_STEPS):
            t0 = time.perf_counter()
            loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                            return_numpy=False)
            loss.item()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[len(walls) // 2]

        def run(_i):
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)

        l0, f0 = kernels.launch_counts(), kernels.family_counts()
        prof = attr.attribute_profile(run, step_s=wall)
        l1, f1 = kernels.launch_counts(), kernels.family_counts()
    want = attr.launched_families(
        {w: l1[w] - l0[w] for w in l1},
        {c: {f: n - f0[c].get(f, 0) for f, n in calls.items()}
         for c, calls in f1.items()})
    rec = attr.reconcile(att, wall)
    log(f"19a flagship step (t={TRAIN_T}, b={TRAIN_B}, fused head, bf16): "
        f"product flops {att['product_flops']:.6e} = step_flops x "
        f"{cov:.6f}; bytes at op boundaries {att['bytes_total']:.6e}; "
        f"workload {att['workload']} [{smi}]")
    log(f"19a first run in a timed run: {first * 1e3:.1f} ms, of which the "
        f"fold-in hook {hook_s * 1e3:.2f} ms ({hook_s / first:.2%}); "
        f"lint findings {cost['lint_findings']}, kernels {backends}")
    log(f"19a step wall median {wall * 1e3:.2f} ms of {ATTR_STEPS} "
        f"({', '.join(f'{w * 1e3:.2f}' for w in walls)}); the table's "
        f"roofline estimate {att['est_ms_total']:.3f} ms: reconcile err "
        f"{rec['err_pct']:+.2f}%; profiled kernel time "
        f"{prof['total_ms']:.3f} ms (busy share {prof['busy_share']})")
    log(f"19a {'class':24s} {'est ms':>10s} {'est share':>9s} {'bound':>8s}"
        f" {'meas ms':>10s} {'meas share':>10s} {'calls':>6s}")
    for cls in sorted(set(att["classes"]) | set(prof["classes"]),
                      key=lambda c: -prof["classes"].get(c, {}).get(
                          "ms", 0.0)):
        est = att["classes"].get(cls, {})
        meas = prof["classes"].get(cls, {})
        log(f"19a {cls:24s} {est.get('est_ms', 0.0):10.3f} "
            f"{est.get('share', 0.0):9.4f} {est.get('bound', '-'):>8s} "
            f"{meas.get('ms', 0.0):10.3f} {meas.get('share', 0.0):10.4f} "
            f"{meas.get('calls', 0):6d}")
    log(f"19a the classes account for {prof['accounted_ms']:.3f} of "
        f"{prof['total_ms']:.3f} ms ({prof['accounted_share']:.4f}); "
        f"unmatched {[(n[:60], ms) for n, ms in prof['unmatched']]}")
    for fam in want:
        ms = prof["families"].get(fam, 0.0)
        log(f"19a   pallas: {fam:36s} {ms:9.3f} ms, "
            f"{ms / prof['total_ms']:.4f} of the step's kernel time")
    missing = [f for f in want if prof["families"].get(f, 0.0) <= 0.0]
    if not want or missing:
        raise AssertionError(f"19a: hand-written kernels launched but not "
                             f"under their families in the profile: "
                             f"{missing} of {want}")
    if prof["accounted_share"] < 0.95:
        raise AssertionError(f"19a: the classes account for "
                             f"{prof['accounted_share']} of the kernel "
                             f"time: {prof['unmatched']}")
    return att, walls, main, scope, feed, fetch


def lint_phase(torch, pt, smi, seed, feed):
    """19b: ``analysis.lint`` of the flagship under ``LINT_POLICIES``,
    every level, on 19a's batch (``feed``; zero state of the declared
    shapes; the hlo level's memory figure is one step's
    ``max_memory_allocated``): zero findings each.  Then the ``none`` step
    at a budget one byte below its measured peak: ``hlo.hbm-preflight``
    fires, and strict mode raises."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis.framework import CheckContext

    peak = None
    for policy in LINT_POLICIES:
        main, _startup, model = build_training(pt, seed, TRAIN_T,
                                               "bfloat16", True)
        if policy != "none":
            pt.memory_optimize(main, policy=policy)
        ctx = CheckContext(main, feed=feed, fetch_list=[model["avg_cost"]])
        specs = analysis.registered_checks()
        rep = analysis.framework._run_checks(ctx, specs,
                                             analysis.AnalysisReport())
        mem = ctx.memstats
        log(f"19b lint {policy:9s}: {rep.summary()} {rep.ids()}; memory "
            f"figure {mem['hbm_high_water_bytes']} B "
            f"({mem['source']}), state written in place "
            f"{mem.get('alias_bytes')} of {mem.get('argument_bytes')} B "
            f"[{smi}]")
        if len(rep):
            raise AssertionError(f"19b {policy}: {[repr(f) for f in rep]}")
        if policy == "none":
            peak = mem["hbm_high_water_bytes"]
            ctx.hbm_budget = peak - 1
            fired = analysis.registered_checks("hlo")
            over = analysis.framework._run_checks(
                ctx, fired, analysis.AnalysisReport())
            try:
                over.raise_for_errors()
                raise AssertionError("19b: strict mode did not raise")
            except analysis.AnalysisError as e:
                log(f"19b budget {peak - 1} B: {over.ids()}; strict "
                    f"raises: {str(e).splitlines()[1].strip()[:160]}")
        del ctx, main
        gc.collect()
        torch.cuda.empty_cache()


def costmodel_fit_phase(torch, pt, smi, cache, att, walls, main, scope,
                        feed, fetch):
    """19c: a corpus of 19a's measured steps (``ingest_attribution``) and
    phase 18b's tune cache (``ingest_tune_cache``), fitted by
    ``fit_and_save`` into a cost model next to the cache; a step of the
    19a program lowered after the fit reports ``costmodel`` fitted."""
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.observability.corpus import Corpus
    from paddle_tpu_torch.tune import costmodel as cm

    co = Corpus()
    for i, w in enumerate(walls):
        co.ingest_attribution(att, w, run_id="chip_smoke-19a", step=i)
    with tune_env("cached", cache):
        co.ingest_tune_cache(tune.get_cache())
        cm.reset_model()
        try:
            model = cm.fit_and_save(co)
            entry = model.entry(tune.device_platform())
            log(f"19c corpus {co.summary()}")
            if entry is None:
                raise AssertionError("19c: the fit left the card analytic")
            log(f"19c fitted on the card: total (ms per Gflop, ms per GB, "
                f"ms a step) {entry['total']}; classes {entry['classes']}; "
                f"hbm_scale {entry['hbm_scale']}; holdout err "
                f"{entry['holdout_err_pct']}% against the analytic "
                f"{entry['analytic_err_pct']}% over {entry['holdout_rows']} "
                f"held-out of {entry['train_rows'] + entry['holdout_rows']} "
                f"rows [{smi}]")
            exe = pt.Executor()
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)
            status = exe.last_step_cost["costmodel"]
            if status.get("mode") != "fitted":
                raise AssertionError(f"19c: a step after the fit reports "
                                     f"{status}")
            log(f"19c a step lowered after the fit: costmodel {status}; "
                f"its table's estimate {exe.last_attribution['est_ms_total']}"
                f" ms against 19a's median wall "
                f"{sorted(walls)[len(walls) // 2] * 1e3:.2f} ms")
        finally:
            cm.reset_model()


def analysis_phase(torch, np, pt, smi, seed, cache):
    """Phase 19 (reads phase 18's tune cache ``cache``), with 18d's
    selftests beside 19d's."""
    t0 = time.perf_counter()
    walls = {}
    t = time.perf_counter()
    att, steps, main, scope, feed, fetch = attribution_step_phase(
        torch, np, pt, smi, seed)
    walls["19a"] = time.perf_counter() - t
    t = time.perf_counter()
    lint_phase(torch, pt, smi, seed, feed)
    walls["19b"] = time.perf_counter() - t
    t = time.perf_counter()
    costmodel_fit_phase(torch, pt, smi, cache, att, steps, main, scope,
                        feed, fetch)
    walls["19c"] = time.perf_counter() - t
    del main, scope, feed
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    selftests_phase(cache)
    walls["18d, 19d"] = time.perf_counter() - t
    log(f"phase 19 wall {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + f") [{smi}]")


# -- phase 20: the v1 layer DSL (compat/) on the card ------------------------

# run.py's smallnet and lstm rows (:30-44) as v1 configs; the lstm row's
# embedding is text_classification's 128 (phase 12a)
V1_SMALLNET_B, V1_LSTM = 64, dict(batch=64, seq_len=100, hid=512,
                                  dict_dim=10000, classes=2, emb=128)
V1_STEPS, V1_VGG_STEPS, V1_VGG_B, V1_VGG_HW = 5, 3, 64, 224
# 20a's update bound a parameter: the norm of the card's first-step update
# minus the CPU's, over the CPU's norm (ORACLE_TOL f32's forward bound)
V1_UPDATE_TOL = 2e-4
# 20d: the flagship's LM head scaled x6 so softmax(logits / 0.8) over the
# 32,768 tokens is far from uniform (its top probabilities ~0.1); the
# draws' histogram over the 31 likeliest tokens and the rest pooled
GEN_PROMPT, GEN_NEW, GEN_DRAWS, GEN_T, GEN_HEAD = 16, 64, 4096, 0.8, 6.0
GEN_TOP, GEN_TV_BOUND = 31, 0.08
# a temperature-1e-4 token may differ from the greedy one only at a
# near-tie: the greedy run's top-2 logit gap there below this
GEN_TIE = 2e-3


def v1_smallnet(pt, v1):
    """benchmark/paddle/image/smallnet_mnist_cifar.py in v1 names: b64,
    3x32x32, 10 classes, Momentum 0.9 with L2 1e-4 at 0.002, f32."""
    net = v1.data_layer("data", size=3 * 32 * 32, height=32, width=32)
    label = v1.data_layer("label", size=1, is_label=True)
    net = v1.img_conv_layer(input=net, filter_size=5, num_filters=32,
                            stride=1, padding=2, act=v1.ReluActivation())
    net = v1.img_pool_layer(input=net, pool_size=3, stride=2, padding=1)
    net = v1.img_conv_layer(input=net, filter_size=5, num_filters=32,
                            stride=1, padding=2, act=v1.ReluActivation())
    net = v1.img_pool_layer(input=net, pool_size=3, stride=2, padding=1,
                            pool_type=v1.AvgPooling())
    net = v1.fc_layer(input=net, size=64, act=v1.ReluActivation())
    out = v1.fc_layer(input=net, size=10, act=v1.SoftmaxActivation())
    cost = v1.classification_cost(input=out, label=label)
    v1.settings(batch_size=V1_SMALLNET_B, learning_rate=0.002,
                learning_method=v1.MomentumOptimizer(0.9),
                regularization=v1.L2Regularization(1e-4)).minimize(cost)
    return cost


def v1_lstm(pt, v1):
    """benchmark/paddle/rnn/rnn.py in v1 names: embedding -> simple_lstm
    -> max pooling -> fc, b64, t=100, hidden 512, dict 10000, 2 classes,
    Adam, f32."""
    c = V1_LSTM
    words = v1.data_layer("words", size=c["dict_dim"], dtype="int64",
                          seq_len=c["seq_len"])
    label = v1.data_layer("label", size=1, is_label=True)
    emb = v1.embedding_layer(input=words, size=c["emb"])
    lstm = v1.simple_lstm(input=emb, size=c["hid"])
    pooled = v1.pooling_layer(input=lstm, pooling_type=v1.MaxPooling())
    out = v1.fc_layer(input=pooled, size=c["classes"],
                      act=v1.SoftmaxActivation())
    cost = v1.classification_cost(input=out, label=label)
    v1.settings(learning_rate=2e-3,
                learning_method=v1.AdamOptimizer()).minimize(cost)
    return cost


def v1_vgg(pt, v1):
    """``v1_ext.vgg_16_network`` at run.py's vgg row: b64, 3x224x224,
    1000 classes, bf16, Momentum 0.9."""
    hw = V1_VGG_HW
    img = v1.data_layer("image", size=3 * hw * hw, height=hw, width=hw,
                        dtype="bfloat16")
    label = v1.data_layer("label", size=1, is_label=True)
    out = v1.vgg_16_network(img, num_channels=3, num_classes=1000)
    cost = v1.classification_cost(input=out, label=label)
    v1.settings(learning_rate=0.01,
                learning_method=v1.MomentumOptimizer(0.9)).minimize(cost)
    return cost


def v1_program(pt, build):
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost = build(pt, pt.compat.v1)
    return main, startup, cost


def v1_feed(np, name, seed):
    rng = np.random.default_rng(seed)
    if name == "smallnet":
        return {"data": rng.standard_normal(
            (V1_SMALLNET_B, 3, 32, 32)).astype(np.float32),
                "label": rng.integers(0, 10, (V1_SMALLNET_B, 1))}
    c = V1_LSTM
    return {"words": rng.integers(0, c["dict_dim"],
                                  (c["batch"], c["seq_len"])),
            "words@LENGTH": rng.integers(c["seq_len"] // 5, c["seq_len"] + 1,
                                         c["batch"]).astype(np.int32),
            "label": rng.integers(0, c["classes"], (c["batch"], 1))}


def v1_train_phase(torch, np, pt, smi, seed):
    """20a: the smallnet and lstm rows as v1 configs, 5 steps on the card
    (f32, TF32 off) from the startup state the card made; the first
    step's loss within 2e-4 and each parameter's update within
    ``V1_UPDATE_TOL`` of the port's CPU step from the same state and
    batch; the losses falling; no hand-written kernel on these paths.
    Returns each config's step walls."""
    from paddle_tpu_torch import kernels

    out = {}
    for name, build in (("smallnet", v1_smallnet), ("lstm", v1_lstm)):
        main, startup, cost = v1_program(pt, build)
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()]
        state = {v.name: scope.get(v.name).detach().cpu().clone()
                 for v in main.persistable_vars()
                 if scope.find_var(v.name) is not None}
        feed = v1_feed(np, name, seed)
        cscope = pt.load_numpy_state(
            pt.Scope(), {k: v.clone() for k, v in state.items()},
            device="cpu")
        t0 = time.perf_counter()
        (cpu_loss,) = pt.Executor(pt.CPUPlace()).run(
            main, feed=feed, fetch_list=[cost], scope=cscope)
        cpu_wall = time.perf_counter() - t0
        kernels.reset_launches()
        losses, walls, first = [], [], None
        for i in range(V1_STEPS):
            t0 = time.perf_counter()
            (loss,) = exe.run(main, feed=feed, fetch_list=[cost],
                              scope=scope, return_numpy=False)
            losses.append(loss.item())           # ends in a device sync
            walls.append(time.perf_counter() - t0)
            if i == 0:
                first = {n: scope.get(n).detach().cpu().clone()
                         for n in params}
        worst = (params[0], 0.0)
        for n in params:
            want = cscope.get(n) - state[n]
            got = first[n] - state[n]
            err = float((got - want).norm() / max(float(want.norm()), 1e-30))
            if err > worst[1]:
                worst = (n, err)
        rel = abs(losses[0] - float(cpu_loss.ravel()[0])) / abs(
            float(cpu_loss.ravel()[0]))
        log(f"20a {name} v1 config (f32, TF32 off, {smi}): losses "
            + " -> ".join(f"{x:.4f}" for x in losses) + f"; step 1 loss "
            f"{losses[0]:.6f} vs the CPU's {float(cpu_loss.ravel()[0]):.6f} "
            f"(rel {rel:.2e}); worst parameter update {worst[0]} rel "
            f"{worst[1]:.2e} of the CPU's ({len(params)} parameters); step "
            f"wall first {walls[0]:.3f} s, then median "
            f"{sorted(walls[1:])[len(walls[1:]) // 2]:.4f} s; CPU step "
            f"{cpu_wall:.2f} s")
        if rel > 2e-4 or worst[1] > V1_UPDATE_TOL:
            raise AssertionError(f"20a {name}: card vs CPU {rel} / {worst}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"20a {name}: losses {losses}")
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"20a {name} launched a hand-written "
                                 f"kernel: {kernels.launch_counts()}")
        out[name] = walls
    return out


def v1_vgg_phase(torch, np, pt, smi, seed, vgg19_ms):
    """20a at full width: ``vgg_16_network`` at run.py's vgg row in bf16,
    3 steps on one device-resident batch: finite, falling losses; the ms
    a step beside phase 13b's VGG-19 row."""
    main, startup, cost = v1_program(pt, v1_vgg)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feed = {"image": torch.randn((V1_VGG_B, 3, V1_VGG_HW, V1_VGG_HW),
                                 generator=gen,
                                 device="cuda").to(torch.bfloat16),
            "label": torch.randint(0, 1000, (V1_VGG_B, 1), generator=gen,
                                   device="cuda")}
    losses, walls = [], []
    for _ in range(V1_VGG_STEPS):
        t0 = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                          return_numpy=False)
        losses.append(loss.item())
        walls.append(time.perf_counter() - t0)
    ms = 1e3 * sorted(walls[1:])[len(walls[1:]) // 2]
    log(f"20a vgg_16_network v1 b={V1_VGG_B} {V1_VGG_HW}x{V1_VGG_HW} 1000 "
        f"classes bf16 "
        f"({smi}): losses " + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step wall first {walls[0]:.3f} s, then median {ms:.1f} ms = "
        f"{V1_VGG_B / ms * 1e3:.1f} img/s; phase 13b's VGG-19 (models.vgg) "
        + (f"{vgg19_ms:.1f} ms" if vgg19_ms else "not run")
        + f"; max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"20a vgg_16_network: losses {losses}")


def v1_attention_phase(torch, np, pt, smi, seed):
    """20b: ``v1_ext.multi_head_attention`` at the flagship's attention
    (b=8, t=4096, d_model 768, 6 heads, bf16), forward and backward: the
    launch counters and one profiled step show the flash forward and the
    fused backward (rows 4 and 5 of PERF.md's table) on the sm90 family;
    the output and every parameter's gradient within ORACLE_TOL bf16 of
    ``layers.multi_head_attention`` on the same weights and input."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.profiler import middle_call_kernels

    b, t, d, h = TRAIN_B, TRAIN_T, D_MODEL, N_HEAD

    def build(spelling):
        pt.core.unique_name.reset()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", shape=[t, d], dtype="bfloat16")
            c = pt.layers.data("c", shape=[t, d], dtype="bfloat16")
            if spelling == "v1":
                out = pt.compat.v1.multi_head_attention(x, x, x, head_num=h)
            else:
                out = pt.layers.multi_head_attention(x, x, x, d_model=d,
                                                     n_head=h)
            loss = pt.layers.mean(pt.layers.elementwise_mul(out, c))
            pt.append_backward(loss)
        return main, startup, out

    gen = torch.Generator(device="cuda").manual_seed(seed)
    feed = {k: torch.randn((b, t, d), generator=gen, device="cuda").to(
        torch.bfloat16) for k in ("x", "c")}
    res = {}
    for spelling in ("v1", "layers"):
        main, startup, out = build(spelling)
        params = [p.name for p in main.all_parameters()]
        exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
        if spelling == "v1":
            exe.run(startup, scope=scope)
            state = {n: scope.get(n).detach().clone() for n in params}
        else:
            pt.load_numpy_state(scope, state, device="cuda")
        fetch = [out.name] + [n + "@GRAD" for n in params]
        kernels.reset_launches()
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        res[spelling] = (dict(zip(fetch, got)), kernels.launch_counts(),
                         kernels.family_counts())
        if spelling == "v1":
            names = []

            def run(_i):
                exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)

            for _, ns, name in middle_call_kernels(run):
                names.append(name)
    v1_out, launched, fams = res["v1"]
    ref_out = res["layers"][0]
    worst = {}
    for k, w in ref_out.items():
        kind = "fwd" if k == fetch[0] else "grad"
        e = rel_max(np, v1_out[k].float().cpu().numpy(),
                    w.float().cpu().numpy())
        worst[kind] = max(worst.get(kind, 0.0), e)
        if e > fa.oracle_tol("bfloat16", kind):
            raise AssertionError(f"20b {k}: {e} off layers."
                                 f"multi_head_attention")
    rows = {k: sum(1 for n in names if k in n) for k in (
        "flash_fwd_sm90_kernel", "flash_bwd_sm90_fused_kernel")}
    log(f"20b v1 multi_head_attention b={b} t={t} d_model {d} {h} heads "
        f"bf16 ({smi}): launches flash_attention_fwd "
        f"{launched['flash_attention_fwd']}, flash_attention_bwd "
        f"{launched['flash_attention_bwd']} (families "
        f"{fams['flash_attention_fwd']}, {fams['flash_attention_bwd']}); "
        f"profiled step: {rows}; output rel {worst['fwd']:.2e}, gradients "
        f"rel {worst['grad']:.2e} of layers.multi_head_attention's "
        f"(ORACLE_TOL bf16 {fa.oracle_tol('bfloat16', 'fwd')} / "
        f"{fa.oracle_tol('bfloat16', 'grad')})")
    if not (launched["flash_attention_fwd"] and launched[
            "flash_attention_bwd"] and all(rows.values())
            and fams["flash_attention_fwd"].get("sm90")
            and fams["flash_attention_bwd"].get("sm90")):
        raise AssertionError(f"20b: rows 4 and 5 not launched on sm90: "
                             f"{launched} {fams} {rows}")
    return launched


def v1_op_cases(np, rng):
    """20c's cases at mid sizes: ``(op, float inputs, fixed inputs,
    attrs, outputs)``, one for each op type the v1 DSL added but
    ``nce``, ``sampling_id`` and ``print`` (held on their own)."""
    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def ints(hi, *shape):
        return rng.integers(0, hi, shape).astype(np.int64)

    b, s, t = 32, 8, 16
    length = rng.integers(1, s + 1, b).astype(np.int32)
    sub = rng.integers(0, t + 1, (b, s)).astype(np.int32)
    lens = rng.integers(1, 101, 64).astype(np.int32)
    inf = ints(9, 64, 100)
    lab = inf.copy()
    lab[rng.random(lab.shape) < 0.2] = 8
    sel = ints(5000, 256, 32)
    sel[:, ::7] = -1
    shapes = [(1, 40, 4), (4, 40, 4), (16, 40, 4)]
    beam = [[], [], []]
    for e, (r, ln, k) in enumerate(shapes):
        beam[0].append(f(64, r, ln))
        ids = np.stack([np.stack([rng.permutation(ln)[:k] for _ in range(r)])
                        for _ in range(64)]).astype(np.int64)
        beam[1].append(ids)
        g = ids[:, 0, 0].copy()
        g[::3] = ln - 1 - e                       # some fall off the beam
        beam[2].append(g)
    return [
        ("conv3d", {"Input": f(4, 16, 8, 16, 16), "Filter": f(32, 16, 3, 3,
                                                             3)},
         {}, dict(strides=[1, 1, 1], paddings=[1, 1, 1]), ("Output",)),
        ("conv_shift", {"X": f(64, 256), "Y": f(64, 9)}, {}, {}, ("Out",)),
        # ceil_mode pads W's high side: its last window half in the pad
        ("pool3d", {"X": f(4, 16, 8, 17, 15)}, {},
         dict(ksize=[2, 3, 2], strides=[2, 2, 2], paddings=[1, 1, 0],
              pooling_type="avg", ceil_mode=True), ("Out",)),
        ("spp", {"X": f(8, 32, 13, 13)}, {},
         dict(pyramid_height=3, pooling_type="max"), ("Out",)),
        ("im2sequence", {"X": f(8, 16, 32, 32)}, {},
         dict(kernels=[3, 3], strides=[2, 2], paddings=[1, 1, 1, 1]),
         ("Out",)),
        ("bilinear_interp", {"X": f(8, 16, 15, 17)}, {},
         dict(out_h=31, out_w=33), ("Out",)),
        ("sigmoid_cross_entropy_with_logits", {"X": f(256, 1024, scale=3)},
         {"Label": rng.random((256, 1024)).astype(np.float32)}, {},
         ("Out",)),
        ("smooth_l1_loss", {"X": f(256, 512), "Y": f(256, 512)},
         {"InsideWeight": np.abs(f(256, 512)),
          "OutsideWeight": np.abs(f(256, 512))}, dict(sigma=1.5),
         ("Out", "Diff")),
        ("huber_loss", {"X": f(4096, 1), "Y": f(4096, 1)}, {},
         dict(delta=0.8), ("Out", "Residual")),
        ("modified_huber_loss", {"X": f(4096, 1, scale=2)},
         {"Y": ints(2, 4096, 1).astype(np.float32)}, {},
         ("Out", "IntermediateVal")),
        ("hierarchical_sigmoid", {"X": f(256, 128), "W": f(999, 128),
                                  "Bias": f(999)},
         {"Label": ints(1000, 256, 1)}, dict(num_classes=1000),
         ("Out", "PreOut")),
        ("bilinear_tensor_product", {"X": f(128, 64), "Y": f(128, 96),
                                     "Weight": f(32, 64, 96), "Bias": f(32)},
         {}, {}, ("Out",)),
        ("dot", {"X": f(512, 256), "Y": f(512, 256)}, {}, {}, ("Out",)),
        ("maxout", {"X": f(16, 64, 16, 16)}, {}, dict(groups=4), ("Out",)),
        ("selective_fc", {"X": f(256, 128), "W": f(5000, 128),
                          "Bias": f(5000)}, {"Select": sel}, {}, ("Out",)),
        ("precision_recall", {}, {"Indices": ints(10, 4096, 1),
                                  "Labels": ints(10, 4096, 1),
                                  "Weights": ints(3, 4096, 1).astype(
                                      np.float32),
                                  "StatesInfo": ints(50, 10, 4).astype(
                                      np.float32)},
         dict(class_number=10),
         ("BatchMetrics", "AccumMetrics", "AccumStatesInfo")),
        ("positive_negative_pair", {}, {
            "Score": np.round(f(1024, 1), 1),
            "Label": ints(3, 1024, 1).astype(np.float32),
            "QueryID": ints(16, 1024, 1)}, {},
         ("PositivePair", "NegativePair", "NeutralPair")),
        ("chunk_eval", {}, {"Inference": inf, "Label": lab, "Length": lens},
         dict(num_chunk_types=2, chunk_scheme="IOBES",
              excluded_chunk_types=(1,)),
         ("Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks")),
        ("cross_entropy_over_beam", {"Scores": beam[0]},
         {"Ids": beam[1], "Gold": beam[2]}, {}, ("Out",)),
        ("nested_sequence_pool", {"X": f(b, s, t, 64)},
         {"Length": length, "SubLength": sub}, dict(pooltype="MAX"),
         ("Out",)),
        ("nested_sequence_expand", {"X": f(b, s, 64)},
         {"Y": f(b, s, t, 64), "Length": length, "SubLength": sub}, {},
         ("Out",)),
        ("nested_sequence_slice", {"X": f(b, s, t, 64)},
         {"Offset": ints(4, b), "Size": ints(6, b), "Length": length,
          "SubLength": sub}, {}, ("Out", "OutLength", "OutSubLength")),
        ("sub_nested_seq", {"X": f(b, s, t, 64)},
         {"Indices": rng.integers(-1, s + 2, (b, 5)), "Length": length,
          "SubLength": sub}, {}, ("Out", "OutLength", "OutSubLength")),
        ("nested_rnn", {"Input": f(16, 4, 12, 384, scale=0.5),
                        "Weight": f(128, 384, scale=0.1),
                        "Bias": f(1, 384), "H0": f(16, 128)},
         {"Length": rng.integers(1, 5, 16).astype(np.int32),
          "SubLength": rng.integers(0, 13, (16, 4)).astype(np.int32)}, {},
         ("Hidden", "OuterHidden")),
    ]


def _op_on(torch, op, floats, fixed, attrs, outs, dev, seed, gen=None):
    """``op`` on ``dev``: its outputs and the float inputs' gradients
    under one seeded cotangent, as numpy."""
    from paddle_tpu_torch.core.registry import get_op_impl

    def put(v, grad):
        if isinstance(v, list):
            return [put(a, grad) for a in v]
        x = torch.tensor(v, device=dev)
        return x.requires_grad_() if grad else x

    ts = {k: put(v, True) for k, v in floats.items()}
    leaves = [x for v in ts.values() for x in (v if isinstance(v, list)
                                                else [v])]
    extra = {"_gen": gen} if gen is not None else {}
    r = get_op_impl(op).fn(**ts, **{k: put(v, False) for k, v in
                                    fixed.items()}, **attrs, **extra)
    vals = [r[o] for o in outs]
    diff = [x for x in vals if x.requires_grad]
    grads = []
    if diff:
        g = torch.Generator().manual_seed(seed)
        total = sum((x * torch.randn(x.shape, generator=g).to(dev)).sum()
                    for x in diff)
        grads = [torch.zeros_like(x) if d is None else d for x, d in zip(
            leaves, torch.autograd.grad(total, leaves, allow_unused=True))]
    return ([x.detach().cpu().numpy() for x in vals],
            [d.cpu().numpy() for d in grads], r)


def _agree(np, label, card, cpu):
    """Ints and bools equal, floats within 2e-4 (infinities equal), the
    gradients within 1e-3: ``(outputs rel, gradients rel)``."""
    fwd = grad = 0.0
    for g, w in zip(card[0], cpu[0]):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"20c {label}: {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if g.dtype.kind != "f":
            if not np.array_equal(g, w):
                raise AssertionError(f"20c {label}: integer outputs differ")
            continue
        fin = np.isfinite(w)
        if not np.array_equal(g[~fin], w[~fin]):
            raise AssertionError(f"20c {label}: infinities differ")
        if fin.any():
            fwd = max(fwd, rel_max(np, g[fin], w[fin]))
    for g, w in zip(card[1], cpu[1]):
        grad = max(grad, rel_max(np, g, w))
    if fwd > 2e-4 or grad > 1e-3:
        raise AssertionError(f"20c {label}: outputs {fwd}, gradients {grad}")
    return fwd, grad


def _tv_and_chi2(np, draws, p, top):
    """Total variation and Pearson's chi-square of ``draws`` against
    ``p`` over the ``top`` likeliest categories, the rest pooled, and
    chi-square's six-sigma bound ``df + 6 sqrt(2 df)``."""
    order = np.argsort(-p)[:top]
    n = draws.size
    q = np.bincount(draws.reshape(-1), minlength=p.size) / n
    qs = np.append(q[order], 1.0 - q[order].sum())
    ps = np.append(p[order], 1.0 - p[order].sum())
    tv = 0.5 * np.abs(qs - ps).sum()
    keep = ps * n >= 5
    pooled_q = np.append(qs[keep], qs[~keep].sum())
    pooled_p = np.append(ps[keep], ps[~keep].sum())
    pooled_q, pooled_p = pooled_q[pooled_p > 0], pooled_p[pooled_p > 0]
    chi2 = n * np.sum((pooled_q - pooled_p) ** 2 / pooled_p)
    df = len(pooled_p) - 1
    return tv, chi2, df + 6 * np.sqrt(2 * df)


def v1_ops_phase(torch, np, pt, smi, seed):
    """20c: each of the 27 op types the v1 DSL added, alone on the card
    against the port's CPU run on seeded inputs at mid sizes, one line
    an op (``nce``'s cost and logits as a function of the card's drawn
    negatives; ``sampling_id``'s 4096 draws against the row's
    distribution; ``print`` through a Program on the card); then the five
    evaluator classes over 10 batches on the card against the CPU."""
    import io
    from unittest import mock

    rng = np.random.default_rng(seed)
    seen = set()
    for op, floats, fixed, attrs, outs in v1_op_cases(np, rng):
        card = _op_on(torch, op, floats, fixed, attrs, outs, "cuda", seed)
        cpu = _op_on(torch, op, floats, fixed, attrs, outs, "cpu", seed)
        fwd, grad = _agree(np, op, card, cpu)
        seen.add(op)
        log(f"20c {op} card vs CPU ({smi}): outputs rel {fwd:.2e}, "
            f"gradients rel {grad:.2e}")
    # nce: the CPU op on the card's negatives
    floats = {"Input": rng.standard_normal((512, 128)).astype(np.float32),
              "Weight": rng.standard_normal((10000, 128)).astype(
                  np.float32) * 0.1,
              "Bias": rng.standard_normal(10000).astype(np.float32)}
    fixed = {"Label": rng.integers(0, 10000, (512, 1))}
    attrs = dict(num_neg_samples=32, num_total_classes=10000)
    outs = ("Cost", "SampleLogits", "SampleLabels")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    card = _op_on(torch, "nce", floats, fixed, attrs, outs, "cuda", seed,
                  gen)
    neg = torch.tensor(card[0][2][:, 1:], dtype=torch.int64)
    with mock.patch.object(torch, "randint", return_value=neg):
        cpu = _op_on(torch, "nce", floats, fixed, attrs, outs, "cpu", seed,
                     torch.Generator())
    fwd, grad = _agree(np, "nce", card, cpu)
    # uniform over the 10000 classes: over 40 equal bins of 250 ids
    tv, chi2, bound = _tv_and_chi2(np, card[0][2][:, 1:].astype(np.int64)
                                   // 250, np.full(40, 1 / 40), 40)
    seen.add("nce")
    log(f"20c nce card vs CPU on the card's negatives ({smi}): outputs rel "
        f"{fwd:.2e}, gradients rel {grad:.2e}; the 16384 negatives in 40 "
        f"bins against uniform: TV {tv:.4f} (bound {GEN_TV_BOUND}), chi2 "
        f"{chi2:.1f} (bound {bound:.1f})")
    if tv > GEN_TV_BOUND or chi2 > bound:
        raise AssertionError(f"20c nce negatives: TV {tv}, chi2 {chi2}")
    # sampling_id: 4096 draws of one row against its distribution
    row = np.abs(rng.standard_normal(50)).astype(np.float32) ** 3
    ids = pt.core.registry.get_op_impl("sampling_id").fn(
        X=torch.tensor(np.tile(row, (GEN_DRAWS, 1)), device="cuda"),
        _gen=torch.Generator(device="cuda").manual_seed(seed))["Out"]
    p = row.astype(np.float64) / row.sum()
    tv, chi2, bound = _tv_and_chi2(np, ids.cpu().numpy().astype(np.int64),
                                   p, GEN_TOP)
    seen.add("sampling_id")
    log(f"20c sampling_id {GEN_DRAWS} draws on the card ({smi}): TV {tv:.4f}"
        f" (bound {GEN_TV_BOUND}), chi2 {chi2:.1f} (bound {bound:.1f})")
    if ids.dtype != torch.int32 or tv > GEN_TV_BOUND or chi2 > bound:
        raise AssertionError(f"20c sampling_id: TV {tv}, chi2 {chi2}")
    # print, through a Program on the card (not timed)
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[3])
        printed = main.global_block().create_var(
            name="x_printed", shape=[-1, 3], dtype="float32")
        main.global_block().append_op(
            type="print", inputs={"In": [x.name]},
            outputs={"Out": [printed.name]}, attrs={"message": "20c probe"})
        y = pt.layers.scale(printed, scale=2.0)
    buf = io.StringIO()
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    with contextlib.redirect_stdout(buf):
        (got,) = pt.Executor(pt.CUDAPlace(0)).run(main, feed={"x": xv},
                                       fetch_list=[y])
    if "20c probe x =" not in buf.getvalue() or not np.array_equal(
            got, 2 * xv):
        raise AssertionError(f"20c print: {buf.getvalue()!r} {got}")
    seen.add("print")
    log(f"20c print on the card: {buf.getvalue().strip()!r}; Out is its "
        f"input")
    if len(seen) != 27:
        raise AssertionError(f"20c covers {len(seen)} op types: "
                             f"{sorted(seen)}")
    v1_evaluator_phase(torch, np, pt, smi, seed)


def v1_evaluator_phase(torch, np, pt, smi, seed):
    """20c's evaluators: ``Accuracy``, ``ChunkEvaluator`` and
    ``EditDistance`` (states in the program) over 10 batches on the card
    and on the CPU from one startup state, ``eval()`` equal after every
    batch; ``Auc`` over the two runs' fetched scores; ``DetectionMAP``
    over 10 batches of detections as card tensors and as numpy."""
    rng = np.random.default_rng(seed)

    def build():
        pt.core.unique_name.reset()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", shape=[64])
            lbl = pt.layers.data("lbl", shape=[1], dtype="int64")
            prob = pt.layers.fc(x, 10, act="softmax")
            inf = pt.layers.data("inf", shape=[50], dtype="int64",
                                 lod_level=1)
            lab = pt.layers.data("lab", shape=[50], dtype="int64",
                                 lod_level=1)
            evs = [pt.evaluator.Accuracy(input=prob, label=lbl, k=3),
                   pt.evaluator.ChunkEvaluator(inf, lab, chunk_scheme="IOE",
                                               num_chunk_types=4),
                   pt.evaluator.EditDistance(inf, lab)]
        return main, startup, prob, evs

    batches = []
    for _ in range(10):
        lens = rng.integers(1, 51, 128).astype(np.int32)
        inf = rng.integers(0, 9, (128, 50))
        lab = inf.copy()
        lab[rng.random(lab.shape) < 0.2] = 8
        batches.append({"x": rng.standard_normal((128, 64)).astype(
            np.float32), "lbl": rng.integers(0, 10, (128, 1)), "inf": inf,
            "inf@LENGTH": lens, "lab": lab, "lab@LENGTH": lens})
    evals, aucs = {}, {}
    state = None
    for dev in ("cuda", "cpu"):
        main, startup, prob, evs = build()
        exe = pt.Executor(pt.CUDAPlace(0) if dev == "cuda"
                          else pt.CPUPlace())
        scope = pt.Scope()
        with pt.scope_guard(scope):
            if state is None:
                exe.run(startup)
                state = {v.name: scope.get(v.name).detach().cpu().clone()
                         for v in main.persistable_vars()}
            else:
                pt.load_numpy_state(scope, state, device="cpu")
            for ev in evs:
                ev.reset(exe)
            auc = pt.evaluator.Auc()
            evals[dev] = []
            for feed in batches:
                (scores,) = exe.run(main, feed=feed, fetch_list=[prob],
                                    return_numpy=False)
                auc.update(scores[:, 1], feed["lbl"] == 1)
                evals[dev].append([ev.eval() for ev in evs])
            aucs[dev] = auc.eval()
    for got, want in zip(evals["cuda"], evals["cpu"]):
        # Accuracy's top-3 may part at a near-tie of the card's and the
        # CPU's fc outputs: one row a batch at most; the rest exact
        if abs(got[0] - want[0]) > 1.0 / 128 or got[1:] != want[1:]:
            raise AssertionError(f"20c evaluators: {got} vs {want}")
    maps = []
    for wrap in (lambda a: torch.tensor(a, device="cuda"), np.asarray):
        m = pt.evaluator.DetectionMAP(overlap_threshold=0.5)
        drng = np.random.default_rng(seed)
        for _ in range(10):
            gt = drng.uniform(0, 50, (4, 2))
            gt = np.concatenate([gt, gt + drng.uniform(5, 20, (4, 2))], 1)
            dets = np.concatenate([
                drng.integers(0, 3, (12, 1)), drng.random((12, 1)),
                np.repeat(gt, 3, 0) + drng.normal(0, 2, (12, 4))], 1)
            m.update(wrap(dets.astype(np.float32)),
                     wrap(gt.astype(np.float32)),
                     wrap(drng.integers(0, 3, 4)))
        maps.append(m.eval())
    last = evals["cuda"][-1]
    log(f"20c evaluators over 10 batches on the card, equal to the CPU's "
        f"after each ({smi}): Accuracy {last[0]:.4f}, ChunkEvaluator "
        f"(P, R, F1) {tuple(round(v, 4) for v in last[1])}, EditDistance "
        f"(avg, error rate) {tuple(round(v, 4) for v in last[2])}; Auc card "
        f"{aucs['cuda']:.6f} vs CPU {aucs['cpu']:.6f}; DetectionMAP from "
        f"card tensors {maps[0]:.6f} vs numpy {maps[1]:.6f}")
    # a score pair of different rows may swap ranks by roundoff
    if abs(aucs["cuda"] - aucs["cpu"]) > 1e-4 or maps[0] != maps[1]:
        raise AssertionError(f"20c Auc / DetectionMAP: {aucs} {maps}")


def v1_generate_phase(torch, np, pt, smi, seed):
    """20d: ``models.transformer.generate`` at the flagship's width (12
    layers, d768, 6 heads, vocab 32768; the LM head x6), prompt batch 8,
    64 new tokens at temperature 0.8: the same seed twice gives the same
    tokens; 4096 rows of one prompt give a first sampled token whose
    histogram is within ``GEN_TV_BOUND`` of ``softmax(logits / 0.8)``
    (the greedy run's logits there); temperature 1e-4 gives the greedy
    tokens but at near-ties."""
    from paddle_tpu_torch.models import transformer

    rng = np.random.default_rng(seed + 20)
    params = make_params(rng, VOCAB, N_LAYER, D_MODEL)
    params["lm_head.w"] = params["lm_head.w"] * GEN_HEAD
    params = transformer.params_from_numpy(params, "cuda")
    prompt = rng.integers(1, VOCAB, (8, GEN_PROMPT)).astype(np.int32)
    kw = dict(max_len=GEN_PROMPT + GEN_NEW, n_layer=N_LAYER, n_head=N_HEAD,
              d_model=D_MODEL, device="cuda")
    t0 = time.perf_counter()
    a, _ = transformer.generate(params, prompt, temperature=GEN_T,
                                key=seed, return_logits=False, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b, _ = transformer.generate(params, prompt, temperature=GEN_T, key=seed,
                                return_logits=False, **kw)
    greedy, logits = transformer.generate(params, prompt, **kw)
    cold, _ = transformer.generate(params, prompt, temperature=1e-4,
                                   key=seed, return_logits=False, **kw)
    if not torch.equal(a, b):
        raise AssertionError("20d: the same seed gave other tokens")
    if not torch.equal(a[:, :GEN_PROMPT].cpu(), torch.tensor(prompt)):
        raise AssertionError("20d: the prompt was not kept")
    ties = 0
    for r in range(8):
        diff = (cold[r] != greedy[r]).nonzero()
        if len(diff):
            pos = int(diff[0])
            top2 = torch.topk(logits[r, pos - 1], 2).values
            if float(top2[0] - top2[1]) >= GEN_TIE:
                raise AssertionError(f"20d: temperature 1e-4 row {r} left "
                                     f"the greedy tokens at {pos} (gap "
                                     f"{float(top2[0] - top2[1])})")
            ties += 1
    p = torch.softmax(logits[0, GEN_PROMPT - 1].double() / GEN_T,
                      0).cpu().numpy()
    rows = np.repeat(prompt[:1], GEN_DRAWS, axis=0)
    t1 = time.perf_counter()
    many, _ = transformer.generate(
        params, rows, max_len=GEN_PROMPT + 1, n_layer=N_LAYER,
        n_head=N_HEAD, d_model=D_MODEL, temperature=GEN_T, key=seed + 1,
        return_logits=False, device="cuda")
    draws = many[:, GEN_PROMPT].long().cpu().numpy()
    many_wall = time.perf_counter() - t1
    tv, chi2, bound = _tv_and_chi2(np, draws, p, GEN_TOP)
    hot = torch.softmax(logits[0, GEN_PROMPT - 1].double() / (2 * GEN_T),
                        0).cpu().numpy()
    order = np.argsort(-p)[:GEN_TOP]
    tv_hot = 0.5 * (np.abs(hot[order] - p[order]).sum()
                    + abs(hot[order].sum() - p[order].sum()))
    log(f"20d generate at full width (8 x {GEN_PROMPT} prompt, {GEN_NEW} new "
        f"tokens, T={GEN_T}, f32, {smi}): the same seed twice the same "
        f"tokens ({wall:.2f} s a call); temperature 1e-4 equals greedy on "
        f"{8 - ties} of 8 rows (the rest from a near-tie under {GEN_TIE}); "
        f"{GEN_DRAWS} draws of the first sampled token ({many_wall:.2f} s): "
        f"TV {tv:.4f} over the {GEN_TOP} likeliest tokens and the rest "
        f"(bound {GEN_TV_BOUND}; T={2 * GEN_T}'s distribution is "
        f"{tv_hot:.4f} away), chi2 {chi2:.1f} (bound {bound:.1f}); top "
        f"probabilities {np.round(np.sort(p)[::-1][:4], 4).tolist()}")
    if tv > GEN_TV_BOUND or chi2 > bound:
        raise AssertionError(f"20d: TV {tv}, chi2 {chi2} over {bound}")


def v1_phase(torch, np, pt, smi, seed, vgg19_ms):
    """Phase 20: the v1 layer DSL and temperature sampling on the card."""
    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    v1_train_phase(torch, np, pt, smi, seed)
    torch.cuda.reset_peak_memory_stats()
    v1_vgg_phase(torch, np, pt, smi, seed, vgg19_ms)
    parts["20a"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launched = v1_attention_phase(torch, np, pt, smi, seed)
    parts["20b"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v1_ops_phase(torch, np, pt, smi, seed)
    parts["20c"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v1_generate_phase(torch, np, pt, smi, seed)
    parts["20d"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 20 wall {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + f") [{smi}]")
    return launched


# -- phase 21: the kernel registry on the card --------------------------------

@contextlib.contextmanager
def env_var(name, value):
    """The environment variable ``name`` set to ``value`` inside."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def registry_resolution_phase(torch):
    """21a: auto resolves ``cuda`` for every op class on CUDA tensors, and
    the registry's precedence and strictness hold on the card
    (``kernels.selftest.check_registry``)."""
    from paddle_tpu_torch.kernels import registry, selftest

    got = {op: registry.resolve_name(op, platform="cuda")
           for op in registry.registered_op_classes()}
    if set(got.values()) != {"cuda"} or len(got) != 4:
        raise AssertionError(f"21a: auto on the card resolved {got}")
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(what)

    selftest.check_registry(check, torch.device("cuda"))
    if failures:
        raise AssertionError(f"21a: registry checks failed: {failures}")
    avail = {op: [b for b, ok, _ in registry.available_backends(op) if ok]
             for op in got}
    log(f"21a: auto on the card {got}; available {avail}; precedence and "
        f"strictness checks passed")


def triton_flash_phase(torch, fa, tr):
    """21b, flash: the Triton forward, dq and dk/dv kernels alone at the
    training path's shape (b=8, t=4096, h=6, d=128, bf16, causal) against
    the plain versions on the same inputs (two batch rows at a time),
    within ORACLE_TOL bf16; each timed over queued calls beside the cuda
    backend's kernel for the same work, the plain version and SDPA, with
    rows 4, 6 and 7's operation counts as the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2424)
    b, t, h, d = TRAIN_B, TRAIN_T, N_HEAD, D_HEAD
    q, k, v, do = flash_inputs(torch, gen, b, t, h, d, torch.bfloat16)
    o, lse = tr.flash_fwd_triton(q, k, v, True)
    dq = tr.flash_bwd_dq_triton(q, k, v, o, lse, do, None, True)
    dk, dv = tr.flash_bwd_dkv_triton(q, k, v, o, lse, do, None, True)
    ro, rlse = _chunked(lambda a, b_, c: fa.flash_attention_ref(a, b_, c, True),
                        (q, k, v))
    rdq, rdk, rdv = plain_bwd(fa, q, k, v, o, lse, do, None, True)
    torch.cuda.synchronize()
    errs = {"o": rel_err(torch, o, ro), "lse": rel_err(torch, lse, rlse),
            "dq": rel_err(torch, dq, rdq), "dk": rel_err(torch, dk, rdk),
            "dv": rel_err(torch, dv, rdv)}
    del ro, rlse, rdq, rdk, rdv
    for name, (_, rel) in errs.items():
        tol = fa.oracle_tol(torch.bfloat16,
                            "fwd" if name in ("o", "lse") else "grad")
        if not rel <= tol:
            raise AssertionError(f"21b: Triton flash {name} rel err "
                                 f"{rel:.3e} > {tol}")
    n = 10
    ms = {"fwd": device_ms(torch, lambda i: tr.flash_fwd_triton(
              q, k, v, True), n),
          "dq": device_ms(torch, lambda i: tr.flash_bwd_dq_triton(
              q, k, v, o, lse, do, None, True), n),
          "dkv": device_ms(torch, lambda i: tr.flash_bwd_dkv_triton(
              q, k, v, o, lse, do, None, True), n)}
    cuda_ms = {"fwd": device_ms(torch, lambda i: fa.flash_fwd(
                   q, k, v, True), n),
               "dq": device_ms(torch, lambda i: fa.flash_bwd_dq(
                   q, k, v, o, lse, do, None, True), n),
               "dkv": device_ms(torch, lambda i: fa.flash_bwd_dkv(
                   q, k, v, o, lse, do, None, True), n),
               "fused": device_ms(torch, lambda i: fa.flash_bwd(
                   q, k, v, o, lse, do, None, True), n)}
    plain_fwd_ms = device_ms(torch, lambda i: _chunked(
        lambda a, b_, c: fa.flash_attention_ref(a, b_, c, True),
        (q, k, v)), 1)
    plain_bwd_ms = device_ms(torch, lambda i: plain_bwd(
        fa, q, k, v, o, lse, do, None, True), 1)
    q4, k4, v4 = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.transpose(1, 2)

    def lib_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def lib_both(i):
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        torch.autograd.grad(out, (q4, k4, v4), do4)

    lib_fwd_ms = device_ms(torch, lib_fwd, 4)
    lib_bwd_ms = device_ms(torch, lib_both, 4) - lib_fwd_ms
    # the bounds of rows 4, 6 and 7: t (t + 1) / 2 causal entries a head,
    # 2 d flops an entry a product (forward two, dq three, dk/dv four);
    # each input read once, each output written once (these kernels read
    # o for delta, where the sm90 ones read the pre-pass's delta)
    entries = b * h * t * (t + 1) // 2
    nel, es, stat = q.numel(), q.element_size(), 4 * b * h * t
    rows = []
    for kind, line, flops, nbytes, err, plain, lib in (
            ("fwd", 114, 4 * d * entries, 4 * nel * es + stat,
             max(errs["o"][0], errs["lse"][0]), plain_fwd_ms, lib_fwd_ms),
            ("dq", 257, 6 * d * entries, 6 * nel * es + stat,
             errs["dq"][0], plain_bwd_ms, lib_bwd_ms),
            ("dkv", 276, 8 * d * entries, 7 * nel * es + stat,
             max(errs["dk"][0], errs["dv"][0]), plain_bwd_ms, lib_bwd_ms)):
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"21b flash_attention_triton_{kind} bf16 causal (b={b} t={t} "
            f"h={h} d={d}, {flops / 1e12:.4f} TFLOP, {nbytes} bytes): "
            f"kernel {ms[kind]:.4f} ms ({flops / ms[kind] / 1e9:.1f} "
            f"TFLOP/s, {bound_ms / ms[kind]:.3f} of the bound), cuda "
            f"backend {cuda_ms[kind]:.4f} ms ({ms[kind] / cuda_ms[kind]:.2f}x"
            f"), plain {plain:.4f} ms, library (sdpa"
            f"{'' if kind == 'fwd' else ' backward, for the pair'}) "
            f"{lib:.4f} ms ({ms[kind] / lib:.2f}x), bound {bound_ms:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        rows.append({"name": f"flash_attention_triton_{kind}",
                     "route": "triton",
                     "source": "paddle_tpu_torch/kernels/triton_attention.py",
                     "replaces": f"paddle_tpu/kernels/triton_attention.py:"
                                 f"{line}",
                     "max_abs_err": err, "ms": ms[kind], "plain_ms": plain,
                     "bound_ms": bound_ms,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "library_ms": lib, "cuda_ms": cuda_ms[kind]})
    log(f"21b: errors against the plain versions (rel): " + ", ".join(
        f"{k} {v[1]:.3e}" for k, v in errs.items()) + f"; the cuda "
        f"backend's fused backward {cuda_ms['fused']:.4f} ms against the "
        f"Triton pair's {ms['dq'] + ms['dkv']:.4f} ms")
    del q, k, v, do, o, lse, dq, dk, dv, q4, k4, v4, do4
    torch.cuda.empty_cache()
    return rows


def _gathered_sdpa(torch, q, table, pos, layers, B):
    """SDPA over each slot's gathered ``[S, T, h, dh]`` view with the
    ``j <= pos`` mask (the gather is set-up, not timed): the call and its
    output on ``layers[0]``."""
    import torch.nn.functional as F

    S, W, h, dh = q.shape
    T = table.shape[1] * B
    idx = table.long()
    gathered = [(pk[idx].reshape(S, T, h, dh).transpose(1, 2),
                 pv[idx].reshape(S, T, h, dh).transpose(1, 2))
                for pk, pv in layers]
    mask = (torch.arange(T, device="cuda")[None, None, :]
            <= pos.long()[:, :, None])[:, None]                  # [S,1,W,T]
    q4 = q.transpose(1, 2)

    def call(i):
        return F.scaled_dot_product_attention(
            q4, *gathered[i % len(layers)], attn_mask=mask)

    return call, call(0).transpose(1, 2)


def triton_paged_phase(torch, pa):
    """21b, paged: the Triton paged-attention kernel alone at phase 5's
    decode shape (S=32, W=1, h=6, dh=128, B=32, NB=16, bf16) and at 5c's
    verify window (S=32, W=6, h=8, dh=32, f32), against the plain block
    scan within ORACLE_TOL, then timed over queued calls (one pool pair a
    layer) beside the cuda backend's split kernels, the plain version and
    SDPA on the gathered view, with row 1's bound."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4242)
    out = {}
    for label, S, W, h, dh, dtype, n_layer in (
            ("decode", 32, 1, N_HEAD, D_HEAD, torch.bfloat16, N_LAYER),
            ("verify", SLOTS, SPEC_K + 1, SPEC_HEADS, SPEC_D // SPEC_HEADS,
             torch.float32, SPEC_LAYERS)):
        q, _, _, table, pos = paged_case(torch, gen, S, W, dtype, h=h,
                                         dh=dh)
        layers = [paged_case(torch, gen, S, W, dtype, h=h, dh=dh)[1:3]
                  for _ in range(n_layer)]
        got = pa.paged_attention_triton(q, *layers[0], table, pos)
        want = pa.paged_attention_ref(q, *layers[0], table, pos)
        err, rel = rel_err(torch, got, want)
        if not (torch.isfinite(got).all() and rel <= pa.oracle_tol(dtype)):
            raise AssertionError(f"21b: Triton paged attention ({label}) "
                                 f"rel err {rel:.3e}")
        if not torch.equal(got, pa.paged_attention_triton(
                q, *layers[0], table, pos)):
            raise AssertionError(f"21b: Triton paged attention ({label}) "
                                 f"not the same bits twice")
        n = 8 * n_layer
        ms = device_ms(torch, lambda i: pa.paged_attention_triton(
            q, *layers[i % n_layer], table, pos), n)
        cuda_ms = device_ms(torch, lambda i: pa.paged_attention(
            q, *layers[i % n_layer], table, pos), n)
        plain_ms = device_ms(torch, lambda i: pa.paged_attention_ref(
            q, *layers[i % n_layer], table, pos), n_layer)
        lib, lib_out = _gathered_sdpa(torch, q, table, pos, layers,
                                      BLOCK_TOKENS)
        _, lib_rel = rel_err(torch, lib_out, want)
        library_ms = device_ms(torch, lib, n)
        # row 1's bound: each slot's keys 0..max(pos) read once (the W
        # rows share them), q read and ctx written once, the live chain
        # entries and the positions read once; 4 flops a live element
        es = q.element_size()
        keys = int((pos.long().max(dim=1).values + 1).sum().item())
        entries = int((pos.max(dim=1).values // BLOCK_TOKENS + 1).sum()
                      .item())
        nbytes = (2 * keys * h * dh * es + 2 * q.numel() * es + 4 * entries
                  + 4 * pos.numel())
        flops = 4 * int((pos.long() + 1).sum().item()) * h * dh
        dname = str(dtype).replace("torch.", "")
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        ops_ms = flops / PEAK_FLOPS[dname] * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"21b paged_attention_triton {label} {dname} (S={S} W={W} h={h} "
            f"dh={dh} B={BLOCK_TOKENS}, {nbytes} bytes): kernel {ms:.4f} ms "
            f"({bound_ms / ms:.3f} of the bound), cuda backend (split) "
            f"{cuda_ms:.4f} ms ({ms / cuda_ms:.2f}x), plain {plain_ms:.4f} "
            f"ms, library (sdpa on the gathered view, rel err {lib_rel:.2e})"
            f" {library_ms:.4f} ms ({ms / library_ms:.2f}x), bound "
            f"{bound_ms:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}"
            f"); rel err {rel:.3e}")
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "bytes" if bytes_ms >= ops_ms
                      else "operations",
                      "library_ms": library_ms, "cuda_ms": cuda_ms}
    row = {"name": "paged_attention_triton", "route": "triton",
           "source": "paddle_tpu_torch/kernels/triton_attention.py",
           "replaces": "paddle_tpu/kernels/paged_attention.py:311"}
    row.update(out["decode"])
    row["verify"] = out["verify"]
    return row


def triton_training_phase(torch, np, pt, kernels, seed):
    """21c: three flagship steps (t=4096, b=8, fused head, bf16) with
    ``PADDLE_TPU_KERNEL_BACKEND_FLASH_ATTENTION=triton``, from the same
    startup state and batches as three steps on auto: the losses within
    ORACLE_TOL bf16 of each other, the step's ``kernel_backends`` naming
    triton for flash (cuda for the CE head), and 12 launches a step of
    each Triton flash kernel (counts zeroed just before the steps).
    Returns the Triton launches."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    main, startup, model = build_training(pt, seed, TRAIN_T, "bfloat16",
                                          True)
    base = pt.Scope()
    pt.Executor().run(startup, scope=base)
    rng = np.random.default_rng(seed)
    feeds = [make_batch(torch, rng, TRAIN_B, TRAIN_T) for _ in range(3)]
    fetch = [model["avg_cost"].name]
    runs = {}
    for label in ("auto", "triton"):
        scope = pt.Scope()
        for name in base.var_names():
            scope.set(name, base.get(name).clone())
        exe = pt.Executor()
        stack = contextlib.ExitStack()
        if label == "triton":
            stack.enter_context(env_var(
                "PADDLE_TPU_KERNEL_BACKEND_FLASH_ATTENTION", "triton"))
        with stack:
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            losses = [exe.run(main, feed=f, fetch_list=fetch, scope=scope,
                              return_numpy=False)[0].item() for f in feeds]
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
        runs[label] = (losses, launches, wall,
                       dict(exe.last_step_cost["kernel_backends"]))
        del scope, exe
    steps = len(feeds) * N_LAYER
    lt, launches, wall, kb = runs["triton"]
    la, auto_launches, auto_wall, auto_kb = runs["auto"]
    want = {"flash_attention_triton_fwd": steps,
            "flash_attention_triton_dq": steps,
            "flash_attention_triton_dkv": steps, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"21c: the Triton-routed steps launched "
                             f"{launches}, expected {want}")
    if auto_launches["flash_attention_triton_fwd"] or \
            auto_launches["flash_attention_fwd"] != steps:
        raise AssertionError(f"21c: the auto steps launched {auto_launches}")
    if kb != {"flash_attention": "triton", "fused_ce": "cuda"} or \
            auto_kb != {"flash_attention": "cuda", "fused_ce": "cuda"}:
        raise AssertionError(f"21c: kernel_backends {kb} (triton) and "
                             f"{auto_kb} (auto)")
    tol = fa.oracle_tol(torch.bfloat16, "fwd")
    for i, (a, b_) in enumerate(zip(lt, la)):
        if not (math.isfinite(a) and abs(a - b_) <= tol * abs(b_)):
            raise AssertionError(f"21c: step {i + 1} loss {a} (triton) vs "
                                 f"{b_} (auto), limit {tol} relative")
    log(f"21c: three flagship steps from one state, losses "
        f"{[round(x, 6) for x in lt]} (flash on triton) vs "
        f"{[round(x, 6) for x in la]} (auto: cuda), limit {tol} relative; "
        f"kernel_backends {kb}; Triton launches "
        f"{ {k: launches[k] for k in want if 'triton' in k} }; walls "
        f"{wall:.3f} vs {auto_wall:.3f} s (first steps included)")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def triton_serving_phase(torch, np, params, work, refs, cuda_outs, kernels):
    """21d: phase 4's f32 engine on its eight requests with
    ``PADDLE_TPU_KERNEL_BACKEND_PAGED_ATTENTION=triton``: every paged call
    on the Triton kernel (counts zeroed before), every step callable's
    ``kernel_backends`` naming it, and the tokens of phase 4's cuda engine,
    or a difference only where ``generate``'s top-2 logit gap is below
    1e-5 (printed).  Returns the Triton launches."""
    kernels.reset_launches()
    with env_var("PADDLE_TPU_KERNEL_BACKEND_PAGED_ATTENTION", "triton"):
        outs, eng = serve_f32(params, work)
    launches = kernels.launch_counts()
    if launches["paged_attention"] or not launches["paged_attention_triton"]:
        raise AssertionError(f"21d: the Triton-routed engine launched "
                             f"{launches}")
    sel = set(map(str, eng.kernel_backends.values()))
    if sel != {str({"paged_attention": "triton"})}:
        raise AssertionError(f"21d: kernel_backends {eng.kernel_backends}")
    same = 0
    for k, (a, b_, (_, logits)) in enumerate(zip(outs, cuda_outs, refs)):
        if np.array_equal(a, b_):
            same += 1
            continue
        i = int(np.nonzero(a != b_)[0][0])
        top = torch.topk(logits[i - 1], 2).values
        gap = (top[0] - top[1]).item()
        log(f"21d request {k}: Triton and cuda engines differ at position "
            f"{i}; generate's top-2 logit gap there {gap:.3e} (limit 1e-5)")
        if not gap < 1e-5:
            raise AssertionError(f"21d request {k}: tokens differ where the "
                                 f"gap is {gap:.3e}")
    log(f"21d: the Triton-routed f32 engine, {same}/{len(work)} requests "
        f"token-identical to phase 4's cuda engine; "
        f"{launches['paged_attention_triton']} Triton paged launches, 0 "
        f"cuda; kernel_backends {sorted(eng.kernel_backends)} all triton")
    del eng
    return launches["paged_attention_triton"]


def kernels_selftest_start():
    """21e: ``python -m paddle_tpu_torch --kernels-selftest`` on the card,
    started in the background (it shares the card with 4b and 21d, no
    timed phase); :func:`kernels_selftest_wait` collects it."""
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "--kernels-selftest"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernels_selftest_wait(proc, t0):
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = out.strip().splitlines()
    fails = [ln for ln in lines if ln.startswith("FAIL")]
    log(f"21e: --kernels-selftest exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s, {len(lines)} lines, "
        f"{sum(ln.startswith('ok') for ln in lines)} checks ok: "
        f"{lines[-1] if lines else ''}")
    if proc.returncode != 0:
        raise AssertionError("21e: --kernels-selftest failed:\n"
                             + "\n".join(fails or lines[-40:]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.benchmarks import bottleneck as bench
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import bottleneck as bn
    from paddle_tpu_torch.kernels import decode_gather as dg
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as ce
    from paddle_tpu_torch.kernels import paged_attention as pa

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)} (count "
        f"{torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. the build
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(_build.sources())} (nvcc "
        + ", ".join(f"{k} {v:.2f} s" for k, v in _build.build_seconds.items())
        + ")")
    for name in _build.sources():
        with open(_build.log_path(name)) as f:
            for line in f:
                if "Compiling entry" in line or "registers" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version, and its times
    row = kernel_phase(torch, pa)
    walls = {}
    t0 = time.perf_counter()
    verify_ms = verify_kernel_phase(torch, pa)
    walls["3a+"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gather_row = gather_phase(torch, dg)
    walls["3d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    flash_rows = flash_phase(torch, fa)
    torch.cuda.empty_cache()
    split_rows, fwd16k = split_phase(torch, fa)
    ce_rows = ce_phase(torch, ce)
    torch.cuda.empty_cache()
    ce_long_phase(torch, ce)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bn_row, bn_sm90_row = bottleneck_phase(torch, kernels, bn, bench)
    walls["3e"] = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    params = make_params(rng)
    work = make_workload(rng, REQUESTS, CLASSES, VOCAB, PREFIX_LEN)
    log(f"weights: {sum(v.size for v in params.values())} parameters, "
        f"made in {time.perf_counter() - t0:.1f} s")

    # 4. correctness at full width, f32; 4b. the kill switch and
    #    speculative decoding held to the same references
    refs, cuda_outs = correctness_phase(torch, np, params, work[:8], kernels)
    # 21e. the registry's selftest in a subprocess, beside 4b and 21d (no
    #      timed phase runs while it does)
    t0 = time.perf_counter()
    selftest = kernels_selftest_start()
    try:
        correctness_spelling_phase(torch, np, params, work[:8], refs,
                                   kernels)
        walls["4b"] = time.perf_counter() - t0
        # 21d. phase 4's engine with paged attention on the Triton kernel
        t1 = time.perf_counter()
        triton_paged_launches = triton_serving_phase(
            torch, np, params, work[:8], refs, cuda_outs, kernels)
        walls["21d"] = time.perf_counter() - t1
    finally:
        kernels_selftest_wait(selftest, t0)
    walls["4b+21d+21e"] = time.perf_counter() - t0
    del refs, cuda_outs
    torch.cuda.empty_cache()

    # 5. the main path: serving at full width, bf16; 5b. the same pass
    #    under PADDLE_TPU_PAGED_ATTN=0 (the decode_gather path)
    served = serving_phase(torch, np, params, work, kernels)
    launches = served["launches"]
    # 5b's load on phase 5's engine, so that the two compare like with
    # like (phase 5's profile stands for it)
    t0 = time.perf_counter()
    paged = serving_phase(torch, np, params, work, kernels, load=GATHER_LOAD,
                          profile=False)
    walls[f"5 at {GATHER_LOAD}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gathered = serving_phase(torch, np, params, work, kernels, switch="0",
                             load=GATHER_LOAD)
    walls["5b"] = time.perf_counter() - t0
    log(f"5b beside 5, both over the first {GATHER_LOAD} of the {REQUESTS} "
        f"requests: tok/s {gathered['tok_s']:.1f} vs {paged['tok_s']:.1f}; "
        f"decode_chunk p50 {gathered['chunk_p50'] * 1e3:.2f} vs "
        f"{paged['chunk_p50'] * 1e3:.2f} ms; peak memory {gathered['peak']} "
        f"vs {paged['peak']} B (phase 5 over all {REQUESTS}: tok/s "
        f"{served['tok_s']:.1f}, decode_chunk p50 "
        f"{served['chunk_p50'] * 1e3:.2f} ms)")
    del params, work
    gc.collect()
    torch.cuda.empty_cache()

    # 5c. speculative decoding at the reference's spec configuration
    t0 = time.perf_counter()
    spec_phase(torch, np, kernels, args.seed)
    walls["5c"] = time.perf_counter() - t0
    log("wall of the serving-completion phases: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()))
    gc.collect()
    torch.cuda.empty_cache()

    # 6. training correctness at full width, f32: kernels vs plain, fused
    #    head vs unfused head
    training_check_phase(torch, np, pt, kernels, fa, ce, args.seed)
    torch.cuda.empty_cache()

    # 7. the other main path: training at full width, bf16, fused head;
    #    7b. the unfused head, the same steps, for its peak memory
    fused = training_phase(torch, np, pt, kernels, args.seed,
                           fused_head=True)
    prof = fused["profile"]
    if not all(prof.get(f, (0, 0))[1] == N_LAYER for f in (
            "flash forward (sm90)", "flash backward (fused, sm90)")):
        raise AssertionError(f"phase 7's profiled step does not list "
                             f"{N_LAYER} flash_fwd_sm90_kernel and "
                             f"flash_bwd_sm90_fused_kernel calls: {prof}")
    torch.cuda.empty_cache()
    # 7c. one step of phase 7's program on each kernel family
    family_step_phase(torch, np, pt, fa, ce, args.seed, "7c", TRAIN_T, None,
                      1e-3, 1e-2)
    gc.collect()
    torch.cuda.empty_cache()
    unfused = training_phase(torch, np, pt, kernels, args.seed,
                             fused_head=False)
    fused_peak, unfused_peak = fused["peak"], unfused["peak"]
    log(f"peak memory: fused head {fused_peak} B, unfused head "
        f"{unfused_peak} B, {(unfused_peak - fused_peak) / 1e9:.3f} GB less")
    if not fused_peak <= unfused_peak - 10e9:
        raise AssertionError(
            f"the fused head's peak {fused_peak} B is not 10 GB below the "
            f"unfused head's {unfused_peak} B")
    torch.cuda.empty_cache()

    # 8. the long-context path: t=16384, selective remat, the split
    #    backward; 8b. no remat and compact beside it
    long_launches = long_phase(torch, np, pt, kernels, args.seed)
    gc.collect()
    torch.cuda.empty_cache()

    # 9. ResNet-50 training, bench.py's headline model; 9b. its inference
    #    form, and B9 held against the trained model's block
    t0 = time.perf_counter()
    scope = resnet_phase(torch, np, pt, kernels, args.seed)
    bn_row["launches"] = resnet_inference_phase(torch, pt, bn, kernels,
                                                args.seed, scope)
    del scope
    log(f"wall of phases 9 and 9b: {time.perf_counter() - t0:.1f} s; "
        f"3e: {walls['3e']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 10. phase 7's training through Trainer.train: prefetch, async step
    #     checkpoints, the reporter's JSONL, a bit-exact resume
    adam_wall = trainer_phase(torch, np, pt, kernels, fa, args.seed,
                              fused["steady"])
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the training recipes at full width: the flagship's recipe and
    #     ModelAverage, every other optimizer, ResNet-50's staircase
    #     recipe, and t=16384 under offload
    t0 = time.perf_counter()
    recipe_phase(torch, np, pt, kernels, args.seed, adam_wall)
    other_optimizers_phase(torch, np, pt, args.seed)
    resnet_recipe_phase(torch, np, pt, kernels, args.seed)
    offload_phase(torch, np, pt, kernels, args.seed)
    log(f"phase 11 wall {time.perf_counter() - t0:.1f} s")

    # 12. the recurrent path: the reference's two RNN rows at full width,
    #     f32 (12a the stacked-LSTM classifier, 12b seq2seq with
    #     attention), each full length and ragged; 12c each against the
    #     port's CPU path at a reduced width
    t0 = time.perf_counter()
    for name in RNN_CFGS:
        # ragged first: a step run after torch.profiler read slower
        rnn_phase(torch, np, pt, kernels, smi, args.seed + 1, name, True)
        rnn_phase(torch, np, pt, kernels, smi, args.seed, name, False)
        rnn_check_phase(torch, np, pt, smi, args.seed, name)
    log(f"phase 12 wall {time.perf_counter() - t0:.1f} s")

    # 13. the rest of the reference's benchmark rows, no hand-written
    #     kernel on their paths: 13a DeepSpeech2 with CTC (and warpctc
    #     beside F.ctc_loss), 13b the image rows and LeNet, 13c the CRF
    #     tagger, 13d each model and the new ops card vs CPU
    t0 = time.perf_counter()
    ds2_phase(torch, np, pt, kernels, smi, args.seed)
    image_ms = image_phase(torch, np, pt, kernels, smi, args.seed)
    srl_phase(torch, np, pt, kernels, smi, args.seed)
    zoo_check_phase(torch, np, pt, smi, args.seed)
    log(f"phase 13 wall {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 14. the seq2seq beam decode (while, the tensor arrays, beam_search)
    #     at run.py's seq2seq row, card vs CPU; 14b. the book's four small
    #     models card vs CPU, then at full size
    t0 = time.perf_counter()
    decode_phase(torch, np, pt, kernels, smi, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    book_phase(torch, np, pt, kernels, smi, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14 wall {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 15. the SSD detector at 300x300, 21 classes, batch 32 (training,
    #     inference, host syncs); 15b. card vs CPU at build's defaults;
    #     15c. the slice's 41 op types alone, card vs CPU
    t0 = time.perf_counter()
    ssd_phase(torch, np, pt, kernels, smi, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    ssd_check_phase(torch, np, pt, smi, args.seed)
    op_tail_phase(torch, np, smi, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15 wall {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 16. BASELINE config 5: CTR-DNN over four parameter servers, in
    #     process and as TCP subprocesses; 16b card vs CPU; 16c the
    #     elastic data path (recordio, master, cloud_reader) and the CLI
    pserver_phase(torch, np, pt, kernels, smi, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"the script so far {time.perf_counter() - t_start:.1f} s")

    # 17. sharded training over a mesh: 17a the flagship's widths at 4
    #     layers on dp2 x tp2 and dp2 x fsdp2, 17b two layers in f32 on
    #     dp4, dp2 x tp2, dp2 x fsdp2 (four ranks on the card), 17c one
    #     rank over NCCL
    mesh_phase(torch, np, pt, smi, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"the script so far {time.perf_counter() - t_start:.1f} s")

    # 18. the autotuner on the card: 18a the paged split count, 18b the
    #     flagship's step schedule, 18c memory_optimize(policy="auto"),
    #     18d the tune and spec selftests; 19. the analysis and
    #     attribution layer at the flagship (19c fits phase 18b's cache)
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        cache = os.path.join(root, "tuned.json")
        tune_phase(torch, np, pt, pa, kernels, smi, args.seed, cache)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"the script so far {time.perf_counter() - t_start:.1f} s")
        analysis_phase(torch, np, pt, smi, args.seed, cache)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"the script so far {time.perf_counter() - t_start:.1f} s")

    # 20. the v1 layer DSL (compat/): 20a the v1 benchmark configs,
    #     20b its multi_head_attention on the flash kernels, 20c the ops
    #     and evaluators it reaches card vs CPU, 20d temperature sampling
    v1_phase(torch, np, pt, smi, args.seed, image_ms.get("vgg"))
    log(f"the script so far {time.perf_counter() - t_start:.1f} s")

    # 21. the kernel registry on the card: 21a resolution, 21b the Triton
    #     kernels alone and timed, 21c the flagship's flash on Triton (21d
    #     and 21e ran beside 4b)
    t0 = time.perf_counter()
    registry_resolution_phase(torch)
    from paddle_tpu_torch.kernels import triton_attention as tr

    triton_rows = triton_flash_phase(torch, fa, tr)
    triton_paged_row = triton_paged_phase(torch, pa)
    triton_launches = triton_training_phase(torch, np, pt, kernels,
                                            args.seed)
    for r in triton_rows:
        r["launches"] = triton_launches[r["name"]]
    triton_paged_row["launches"] = triton_paged_launches
    log(f"phase 21 wall {time.perf_counter() - t0:.1f} s, and 4b with 21d "
        f"and 21e beside it {walls['4b+21d+21e']:.1f} s (4b "
        f"{walls['4b']:.1f} s, 21d {walls['21d']:.1f} s); the script so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 22. the kernels line, 23. the result
    row["launches"] = launches["paged_attention"]
    gather_row["launches"] = gathered["launches"]["decode_gather"]
    log(f"paged_attention at the verify shape: kernel {verify_ms[0]:.4f} ms, "
        f"plain {verify_ms[1]:.4f} ms, bound {verify_ms[2]:.4f} ms, simple "
        f"family {verify_ms[3]:.4f} ms")
    for r in flash_rows + ce_rows:
        r["launches"] = fused["launches"][r["name"]]
    for r in split_rows:
        r["launches"] = long_launches[r["name"]]
    fwd16k["launches"] = long_launches["flash_attention_fwd"]
    flash_rows[0]["t16384"] = fwd16k
    print(json.dumps({"kernels": [row, gather_row] + flash_rows + split_rows
                      + ce_rows + [bn_row, bn_sm90_row, triton_paged_row]
                      + triton_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
