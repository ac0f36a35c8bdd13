#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

  1. card: require torch.cuda; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them.
  2. build: compile every CUDA kernel of the port from its sources in
     ``paddle_tpu_torch/csrc`` (one nvcc per source, started together);
     print the build seconds and nvcc's register report.
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the serving path's shapes, and time kernel, plain version,
     the least time the card could take (bound) and one PyTorch library
     call computing the same function (a yardstick the port never
     calls): paged attention (K2) on an edge matrix (head dims 48, 50,
     80, 100; windows of 17, 33 and 64 slots; splits past a short row's
     end) and on the prefill-chunk matrix (C=64, Dh 64, block 16: valid
     spans of 1, 7, 33 and 64 slots in one call, a decode row at
     position 500 whose window runs past the table, two rows on shared
     adopted blocks, an inactive row), and timed at C=1 (decode), C=7
     (the linear verify window), C=17 (the spec_k=16 window), C=8 (phase
     4b's chunk windows), C=64 (the prefill chunk, B=8, H=8, a context
     of 512) and C=16 (phase 4d's chunk windows, B=8, windows from 0 to
     64); the tree-mask window (K3) on an edge
     matrix (width 1 against K2 up to C=41, null tails, windows past the
     table, an inactive row, Dh 32 to 128 and 48/80/100, C up to 64 with
     two mask words a slot, a window across two splits) and timed at the
     tree legs' shapes (C=13, C=33).
  4. serving: the flagship decoder at full width (vocab 32000, d_model
     512, 8 heads, 6 layers, d_ff 2048, max_seq_len 512; random weights
     from seed 0) served by ``ServingEngine`` on cuda:0 for 64 open-loop
     Poisson requests. Every request must finish without error, the
     first 4 must be token-identical to the numpy ``reference_decode``,
     and the kernel launch counts must show the path went through the
     kernels (paged attention: once per layer per decode step). A second
     stream of 32 requests then runs under torch.profiler (the card
     only) for the device's busy share and the kernels' time per step.
  4b. speculative serving: the same decoder behind ``ServingEngine(
     max_batch=8, block_size=16)`` on bench.py's speculative traffic (16
     repetitive prompts, 48 new tokens each, all submitted at once) in
     three legs — legacy (spec_k=0), linear (spec_k=6: K2 at C=7) and
     tree (spec_tree="2x6": K3 at C=13). Every request of every leg must
     be token-identical to ``reference_decode`` (a difference prints the
     position and the reference's top-2 logit margin there), the pool
     must drain clean, and the launch counts must show K2 at C=7 once a
     layer a linear window and K3 once a layer a tree window. Then two
     legs past the kernels' former window limits on the first 4
     prompts, held the same way: spec_k=16 (K2 at C=17) and a 4x8 tree
     (K3 at C=33). Then two legs over chunked prefill (bench.py:784's
     prefill_chunk=8) on all 16 prompts, held the same way: linear_c8
     (spec_k=6) and tree_model (spec_tree="2x6", drafted by a
     ModelDrafter over the target itself, bench.py:804-812: catch-up
     chunks at C=8, draft steps of 5 one-token steps at C=1); the
     ModelDrafter's pool must drain clean too and its draft steps run;
     every launch is accounted for (the drafter's by their sum). Then one
     tree window under torch.profiler.
  4c. serving fast path: bench_serving_fastpath (bench.py:659-729) at the
     flagship's full width (a fresh model, seed 0) behind
     ``ServingEngine(max_batch=8, block_size=16)``: 32 prompts of a
     256-token shared prefix and a 2-8-token unique tail
     (RandomState(11)), 32 new tokens each, all submitted at once after
     one priming request, in three legs: legacy (one-token prefill),
     chunked (prefill_chunk=64, the default budget of 256) and fast
     (chunked + prefix_cache). All legs equal on all 32 requests, the
     first 8 equal to ``reference_decode``; the fast leg reuses all 16
     shared blocks of every request (hit rate 1.0) and ends with >= 16
     cached; every pool drains clean; K2 once a layer a chunk step at
     C=64 and a one-token step at C=1; the chunked and fast legs' TTFT
     p50 below legacy's. Then one chunk step under torch.profiler (the
     device's busy share, K2's ms at C=64).
  4d. serving bench legs: bench.py's four serving functions through the
     port's bench (``paddle_tpu_torch.bench``: bench_serving,
     bench_serving_fastpath, bench_serving_spec, bench_serving_quant)
     at the flagship's full width (vocab 32000, d_model 512, 8 heads, 6
     layers, d_ff 2048, max_seq_len 512) with bench.py's own traffic,
     through ``ServingEngine``, ``GenerationModel.quantized`` and
     ``ModelDrafter``: a 32-request Poisson stream batched (16 slots) and
     one at a time; 10 shared-prefix requests legacy and fast (chunk 16,
     prefix cache); 6 repetitive requests in the legacy, linear (k=6),
     2x6 tree (a ModelDrafter over the target) and int8 tree (the
     drafter and the target over the int8 store) legs over chunk 8; 16
     requests over fp32 weights and the int8 store. Each function's
     K2/K3 counts are zeroed before it and read after. Fatal unless
     every outputs_match is true (the int8 legs against
     ``reference_decode`` over the dequantized weights; a mismatch
     prints the request and the reference's top-2 logit margin), every
     K2/K3 launch is accounted for by the engines' steps (a drafter's
     catch-ups at its chunk 16 and draft steps read from their sum), both
     int8 legs served the int8 store (26 int8 weights) and the fast
     path's prefix hit rate is 1.0. Prints each leg's tokens/s,
     latency and TTFT p50/p99, steps and tokens a step, draft steps,
     blocks reused, the int8 store's bytes against fp32, and K2's
     launches by C and K3's. Then one int8 decode step beside one fp32
     decode step (16 rows) under torch.profiler: device ms by kernel.
  4e. the serving fleet and online hot swap: bench.py's
     bench_serving_fleet and bench_serving_online through the port's
     bench at the flagship's full width (vocab 32000, d_model 512, 8
     heads, 6 layers, d_ff 2048, max_seq_len 512), through
     ``ServingRouter``, ``ServingEngine``, ``OnlineUpdater``,
     ``save_checkpoint`` and ``export_generation_model``: 16 requests of
     4-12 tokens, 16 new, on 1 then 2 replicas (max_batch 4, block 16,
     random weights from seed 0); 24 requests of 3-8 tokens, 12 new,
     through 2 replicas (max_batch 4, block 4) steady and while v1 (the
     startup state of ``transformer_fluid.build``'s defaults, perturbed,
     saved as checkpoint 1) rolls mid-stream. Then a failover leg (2
     replicas, ``serve_die_at_step`` armed 6 steps past the primers, the
     fleet leg's prompts) and a swap leg (``swap_weights`` from the v1
     artifact on a draining replica while the other serves 8 requests,
     then 8 more across both). Fatal unless every output equals
     ``reference_decode`` (under the version that served it), both
     replicas stepped in every 2-replica leg, the failover leg shows
     exactly 1 failover, 0 lost, a drained dead pool and the unfailed
     outputs, the online leg lost 0, published 1 version, swapped twice
     and ends on [1, 1], and K2's launches by C equal the replicas'
     summed steps x 6 layers (the dead replica's included). Prints one
     ``fleet`` line a leg: tokens/s, the 2/1 scaling, each replica's
     steps, failovers, readmitted and version restarts, the
     rollout/steady ratio, K2's launches by C and the card.

  5. flash attention kernels: K1's forward and backward CUDA kernels
     against the plain version's forward and autograd, each call by its
     route (bf16: the tensor-core kernels both ways; fp16: the same
     source's fp16 instantiation both ways; fp32: the 3xTF32
     tensor-core kernels both ways), through the strided
     views of [B, T, H, Dh] tensors, all at H=8, T=512, causal: checked,
     then kernel, plain and library (scaled_dot_product_attention in the
     same dtype) times each way, the bounds and the factor to the
     library, at head dim 64 in bf16 at the training path's B=160 and in
     fp32 at the int8 path's B=32 (and phase 7's B=2, path_* keys) and in
     fp16 at the amp_fp16 bench leg's B=160; at head dim 128 at B=80
     (bf16, fp16) and B=32 (fp32) and at phase 6b's own B=8 (path_*
     keys); at head dim 256 at phase 6c's own shape (B=4).
     Also checked: fp32 B=4, non-causal Tq=128/Tk=256 at Dh 64, 128 and
     256, and head dims 96 and 192 through the pad (4 copies counted).
     Past the largest instantiation (the wide kernels: a block a
     128-column part, the head dim streamed in 128-column chunks), no
     model path reaching them: head dim 512 (B=2, causal) on all four
     kernels and 320 (padded to 384), checked and timed beside SDPA (a
     `flash_wide_heads` line). Two fp32 backward calls on the same inputs
     must give bitwise-equal grads (no atomics).
  6. training: the Fluid-API Transformer LM (bench.py's headline step)
     through the port's entry points on cuda:0 — full width, 6 layers,
     seq 512, batch 160, bf16 params and residual stream, the legacy AMP
     decorator over SGD(0.01) — 3 warm-up and 10 timed steps on fixed
     seeded tokens. Every loss finite, the loss falling from the first
     step to the last, flash attention launched exactly 6 times forward
     and 6 backward per step, every launch by the tensor-core route and
     no operand copied; then 2 more steps under torch.profiler (K1's
     device ms a step).
  6b. head dim 128: the LM widened to d_model 1024 over 8 heads (head
     dim 128), 2 layers, batch 8: 5 bf16 AMP training steps (loss finite
     and falling, K1 once a layer a step each way by the tensor-core
     route), 5 steps of the fp32 program's inference clone (K1 once a
     layer a step forward by the 3xTF32 route, no backward) and 5 fp32
     SGD steps (K1 once a layer a step by the 3xTF32 kernels both ways,
     then one profiled step: K1's device ms) and 5 steps of the fp32
     program under amp.decorate(dtype="float16") (K1 once a layer a step
     by the fp16 route both ways); each leg's counts zeroed before it, no
     operand copied.
  6c. head dim 256: the same at d_model 2048 over 8 heads (the head
     width of Gemma-family decoders), d_ff 8192, 2 layers, batch 4 (no
     fp16 leg).
  6d. bench legs: ``paddle_tpu_torch.bench.bench_transformer_fluid``,
     the port's bench.py, at its defaults (the flagship at full width,
     batch 160, seq 512, 3 warm-up and 24 timed steps, the
     compile-pipeline receipt in the program) in bench.py's training
     legs and the port's fp16 one: async (the in-flight window), sync,
     noopt (PTPU_NO_PROGRAM_OPT=1), fp32, amp (amp.decorate, bf16) and
     amp_fp16 (amp.decorate(dtype="float16"), dynamic loss scaling).
     Each prints tokens/s, ms a step (device and host), the last loss,
     the peak memory, K1's launches by route and (async) the window's
     deepest depth. Fatal unless every loss is finite and falls over the
     leg, K1 runs 6 forward and 6 backward launches a step by the route
     the leg's dtype names ("tc", "f32tc", "fp16") with no operand
     copied, the compiler/* and amp/* counters equal the pipeline's on
     the CPU for the same program (none on noopt), the async window
     reaches 12 steps, and the amp_fp16 leg's loss scale and counters
     equal the update_loss_scaling state machine's for the overflows it
     saw. The fp32 leg runs at the largest batch of 160 / 2^k that fits.
  6e. training as users configure it: ``transformer_fluid.build`` with
     its own defaults (remat=True: three two-layer ``layers.recompute``
     segments) in bf16 under ``contrib.mixed_precision.decorate`` at its
     defaults (dynamic loss scaling), ``optimizer.Adam`` (beta2 0.98,
     epsilon 1e-9) on ``layers.linear_lr_warmup`` over
     ``layers.exponential_decay``, ``regularizer.L2Decay(1e-4)`` and
     ``clip.set_gradient_clip(GradientClipByGlobalNorm(1.0))``, through
     ``Executor()`` (the card), 3 warm-up and 12 timed steps on
     RandomState(0) tokens, in three legs: remat (batch 160), no_remat
     (the same program built with remat=False) and dropout (dropout_rate
     0.1, batch 32: the explicit-score attention path, no flash
     attention). Fatal unless each leg's loss is finite and falls, K1
     launches 12 "tc" forwards and 6 "tc" backwards a step under remat
     (each layer's forward again in its segment's re-run), 6 + 6
     without, none with dropout, with no operand copied; every
     parameter's beta1_pow_acc reads beta1^16 as fp32 forms it, the
     learning rate the schedule's closed form at run 15 and
     @step_counter@ 15; the remat leg's peak memory lies below the
     no-remat leg's; and one step of the dropout program under remat
     gives the grads of its no-remat build (same weights, same op seeds:
     the re-run redrew the masks) within bf16's STEP_TOL. One
     ``train_user`` line a leg (device and host ms a step, tokens/s,
     peak GiB) and a ``train_user_remat`` line (the peak and time
     ratios).
  6f. the stacked flagship: ``examples/train_transformer_fluid.py
     --stacked`` uncut — ``transformer_fluid.build_stacked`` (the layer
     stack as one ``StaticRNN(remat=True)`` over stacked [6, ...]
     weights) at full width, bf16 under the legacy decorator with a
     static loss scale of 1.0, Adam 3e-4, batch 64, 3 warm-up and 8
     timed steps — then the same example without ``--stacked``
     (``build()`` at its defaults, remat=True). Fatal unless each leg's
     loss is finite and falls, K1 launches 12 "tc" forwards (6 in the
     no-grad scan or segments, 6 in their replay) and 6 "tc" backwards a
     step with no operand copied (a copy fails naming its count) and no
     predicate is read on the host. One ``train_stacked`` line a leg
     (device and host ms a step, tokens/s, peak GiB; a profiled step's
     launches, and its update section's) and a ``train_stacked_ratio``
     line.
  7. card vs CPU: the same program from one set of weights (startup run
     once on the card, the scope copied to the CPU), two SGD steps at
     batch 2 on cuda:0 (the kernels) and on the CPU (the plain
     versions); per-step losses, step 1's grads and every updated
     parameter must agree. Twice: the headline bf16 program, and the
     same model in fp32 without AMP, where the updates do not round
     away and the limits are tight enough to see a skipped one. Each
     prints its largest errors over their limits. Then phase 6e's
     program in fp32 at 2 layers (its clip at 0.25, where it binds), two
     steps each way: the losses, the learning rate, the clip's scale,
     every raw, clipped and decayed grad, each decay term and, after
     step 2, every parameter within what the grads' errors let Adam move
     it; K1 launched 8 "f32tc" forwards and 4 backwards on the card.
     Then phase 6f's stacked program in fp32 at 2 layers under Adam on
     ``piecewise_decay([3], [1e-3, 5e-4])`` inside
     ``GradientMergeOptimizer(k_steps=2)`` with an
     ``ExponentialMovingAverage(0.999)``, 4 runs each way: the losses,
     the rate (rtol 1e-6 of the closed form), every raw grad (each
     layer's slice of a stacked weight on its own), the parameters
     unmoved on the merge-only runs and within what the merged grads'
     errors let the two updates move them, each EMA shadow to rtol 1e-6
     of the recurrence over its own device's parameters and across the
     devices within the parameters' limits; 3 predicates read on the
     host a run; K1 16 "f32tc" forwards and 8 backwards on the card.
  8. int8 inference: the fused int8 matmul (K4) bitwise against its
     plain version on an edge matrix (M 1/7/33/127/129 x K
     1/5/31/33/129/2048 x N 1/3/7/9/127/129/32000: tails and both sides
     of the tensor-core tiles' edges), ties, saturation, strided and
     unaligned x, and at
     the path's three shapes, where kernel, plain version, the library
     yardstick (torch._int_mm, the product alone) and the fp32 matmul
     are timed; then the fp32 LM's inference clone at batch 32,
     calibrated on 4 batches and decorated full_int8, against the same
     clone in fp32 (3 warm-up and 10 timed steps each): every loss
     finite, K4 launched exactly once a dense layer a step (12 FFN, 2
     lm_head chunks) and never by the fp32 clone, K1's fp32 forward
     once a layer a step by the 3xTF32 route in both, the int8 loss within
     1% of the fp32 loss; the int8 / fp32 step ratio and K4's share of
     the card's busy time in a profiled int8 step. Last, the int8 program
     card vs CPU at batch 2: every dense layer's output on the card
     bitwise the plain version's on its own input, the loss to rtol
     1e-4, a 1% act-scale fault caught at every layer.
  9. image classification: benchmark/fluid_benchmark.py's
     run_static_model recipe through the port. First the conv op in fp32
     at a ResNet-50 shape with cudnn.allow_tf32 on and off (cuDNN's
     deterministic algorithms): output and grads bitwise equal, the
     switch left as it was. 9a: ``models.resnet.build(dataset=
     "imagenet")`` (ResNet-50, 1000 classes, 3x224x224) under
     ``optimizer.Adam(0.01)`` at batch 64 (``_DEFAULT_BATCH``) in two
     legs, fp32 and amp (``contrib.mixed_precision.decorate`` with a
     static loss scale of 1.0: the convolutions and mul in bf16), each 5
     warm-up and 10 timed steps on RandomState(0)'s fixed batch staged on
     the card, the loss fetched every step: fatal unless the loss is
     finite and falls, every moving mean and variance is finite and moved
     from its start, and the ``clone(for_test=True)`` program, run once on
     the trained weights, gives a finite loss and leaves every moving
     statistic bitwise unmoved. One ``image_train`` line a leg (images/s,
     device and host ms a step, peak GiB; a profiled step's launches, the
     card's busy share, the device ms of the convolutions, Adam and the
     rest, the update section's launches and host ms, the top kernels)
     and an ``image_train_ratio`` line. 9b: one step of each other
     builder at its ``_DEFAULT_BATCH`` — mnist mlp and cnn (128), cifar
     ResNet-32 (64), VGG-16 (64), SE-ResNeXt-50 (32): each loss finite.
     9c: the fp32 cifar ResNet at depth 8 plus one bottleneck stage, two
     Adam steps at batch 8 on cuda:0 and on the CPU, each from one state
     (the CPU's set on the card before step 2): each step's loss, grads,
     moving statistics and parameters (Adam's bound from the grad
     limit) within fp32's STEP_TOL (``tests/test_torch_chip_smoke.py`` runs
     it on two CPU executors with planted faults: a skipped
     moving-statistics update, the unbiased variance, a TF32
     convolution). Phase 9 launches none of K1-K4 (their counts read
     before and after it).
  10. the inference predictor: a model saved by
     ``io.save_inference_model`` (target: the softmax output) from a
     scope whose batch norms moved (scales and shifts drawn from
     RandomState(0), moving statistics the batch statistics of a
     train-mode forward) and served by ``inference.AnalysisPredictor`` on
     cuda:0 on a fixed batch staged on the card. 10a: ResNet-50
     (ImageNet, 3x224x224) at batch 64 in four legs, 3 warm-up and 10
     timed runs each — fp32 with ``switch_ir_optim(False)``, fp32 with
     the load-time passes (conv_bn_fold, dropout_remove,
     conv_elementwise_add_fuse), ``full_int8`` (calibrated on 4 batches:
     the classifier on K4; every convolution carries a folded bias, so
     stays weight-only or, fused with its residual, fp32) and
     ``weight_only``. Fatal unless every output is finite, no batch_norm
     is left after the passes, the folded output lies within
     PREDICT_FOLD_ATOL of the unfolded one with the same top-1 but where
     the top-2 margin is below it, K4 launched once a run in full_int8
     and never in the other legs, and the classifier's output is bitwise
     K4's plain version on its own input. One ``predictor`` line a leg
     (images/s, ms and host ms a batch, peak GiB, launches a run and the
     card's busy share in a profiled run; for full_int8 its top-1
     agreement and max abs error against fp32 and the weight store's
     bytes saved). 10b: the mnist cnn through a full_int8 predictor at
     batch 128 (its convolutions on int8 operands, K4 at N=10) against
     the same predictor on the CPU: the classifier bitwise on its own
     input, the outputs within PREDICT_CARD_CPU_ATOL; the int8
     convolutions' device ms a run. 10c: bench_quant_predictor through
     the port's bench, bench.py's keys. Phase 10 launches none of K1-K3;
     K4's rows at its five shapes are checked and timed.
  11. the rest of benchmark/fluid's model set through the port's own
     harness. 11a: ``paddle_tpu_torch.fluid_benchmark.run_static_model``
     (Adam(0.01), RandomState(0)'s batch staged once, 5 warm-up and 10
     timed steps, the loss fetched every step) in fp32 at full width and
     each model's ``_DEFAULT_BATCH``: deepfm (vocab 1e5, 26 fields, embed
     16, MLP 400x3, batch 256), stacked_dynamic_lstm (dict 30000,
     emb/hid 128, 3 layers, seq 80, batch 32) and machine_translation
     (vocab 10000, 512 wide, len 50, batch 16). Each prints the
     harness's examples/sec line and JSON, then a ``bench_model`` line:
     device and host ms a step, examples/s, peak GiB, a profiled step's
     launches and the card's busy share. Fatal unless the losses are
     finite and fall, and for deepfm one more run's AUC is finite and in
     [0, 1] with StatPos + StatNeg summing to 256 x the runs. 11b:
     word2vec at `build()`'s defaults (batch 64, the book test's
     next-word data) trained the same way, its loss finite and falling;
     the beam decoder at its defaults (batch 16): its sentence ids equal
     a numpy backtrack of the per-step ids and parents it stacked, every
     parent in [0, beam). 11c: two fp32 Adam steps of a reduced DeepFM
     and a 2-layer stacked LSTM (seq 16) on cuda:0 and on the CPU from
     one state: the loss to rtol 1e-5, every grad within fp32's
     STEP_TOL (1e-3 of its tensor's largest plus 1e-7 of the largest of
     all), every parameter within what those grads let Adam move it,
     DeepFM's StatPos / StatNeg bitwise (``tests/
     test_torch_chip_smoke_models.py`` runs 11c on two CPU executors with
     planted faults). Phase 11 launches none of K1-K4.
  12. the native flagship (``paddle_tpu_torch/models/transformer.py``:
     plain functions over a stacked parameter tree). 12a: bench.py's
     ``bench_transformer`` through the port's (``bench.bench_transformer``:
     vocab 32000, d_model 512, 8 heads, 6 layers, d_ff 2048, seq 512,
     batch 192, bf16 with parameters of two or more dims stored in bf16,
     remat, Adam 1e-4 with fp32 moments; RandomState(0) tokens fixed on
     the card; 3 warm-up and 24 timed steps, the loss read every 12) with
     metrics on, so its first step is counted (``observability/cost.py``).
     Fatal unless the losses are finite and fall, the counted step's FLOPs
     equal ``native_step_flops``'s closed form (K1's counts reaching the
     count from autograd's threads), and K1 launched 12 "tc" forwards
     (remat: each layer again in its recompute) and 6 "tc" backwards a
     step with no operand copied. Then one step under torch.profiler (a
     fresh state): launches, busy ms and device ms by group (GEMMs, K1,
     the CE head, the update, the rest). One ``native_train`` line:
     tokens/s, device and host ms a step, peak GiB, step_flops and
     mfu_pct against the card's peak (989.4 TFLOP/s for an H100 80GB
     HBM3), busy share, the card. 12b: ``__graft_entry__.entry()``'s
     forward — batch 8, seq 512, bf16, remat off, fp32 parameters from
     seed 0, zero tokens — fatal unless the logits are fp32 [8, 512,
     32000] and finite and K1 launched 6 "tc" forwards and no backward;
     then 5 timed runs (a ``native_entry`` line). 12c: two native steps
     (remat on) at 2 layers and full width, batch 4, seq 256, in fp32
     and in bf16, on cuda:0 and on the CPU, each from one state (the
     CPU's carried to the card before step 2): the embedding's output
     bitwise, the forward's fp32 logits to NATIVE_LOGITS_RTOL of their
     largest, the loss, every grad within STEP_TOL and every parameter
     within Adam's bound from the grad limit; K1 12 forwards (the
     logits' forward, the step's and its recompute) and 4 backwards by
     the dtype's route ("f32tc", "tc")
     (``tests/test_torch_chip_smoke_native.py`` runs 12c on two CPUs
     with planted faults: exact GELU, sqrt(D) in fp32, Adam without bias
     correction). Phase 5 checks and times K1 in bf16 at this path's
     B=192 too, on q, k and v packed as the path packs them (views of
     one [B, T, 3, H, Dh] tensor; ``path_*`` keys of the tc rows).
  13. the LM trained from recordio shards and kept alive (the data
     plane, ``QueueDataset``'s resumable stream, ``ResilientTrainer``,
     ``CheckpointManager``). 13a: 4 shards of 320 records (tokens int32
     [512] from the first 4 ids, RandomState(shard); labels the tokens
     rolled by one) written by the port's
     ``convert_reader_to_recordio_file``, shards 1 and 3 deflate: 1,280
     records, 8 batches of 160 an epoch; fatal unless QueueDataset
     (set_thread(2)) reads them back record for record. 13b: bench.py's
     program (``build_lm``: bf16, legacy AMP, SGD 0.01, no remat) under
     ``ResilientTrainer(guard_every=4, checkpoint_every=4)`` over
     ``resumable_batches(DatasetCursor(seed=3), epochs=2)``, from one
     saved initial state: 16 steps across the epoch boundary; fatal
     unless the losses are finite, each batch's loss in the second epoch
     is below the same records' loss in the first, and K1 launched 6 "tc"
     forwards and 6 "tc" backwards a step with no operand copied. 13c:
     the same run in a child process (``chip_smoke.py --phase13-child``)
     with ``PTPU_FAULT_INJECT=sigterm_at_step:5``, which must drain into
     an emergency checkpoint, then another child that restores it,
     rebuilds the cursor from the scope and finishes; fatal unless their
     losses put together are the oracle's bitwise (the float32 bits),
     the second starts at the cursor the first wrote and the two took
     2 x 1,280 records. 13d: the run in process with a NaN written into
     a parameter as step 10 takes its batch (the LM's feeds are ints, so
     the trainer's ``nan_at_step`` would not fire): one anomaly, one
     rollback, the losses bitwise the oracle's, K1 6 + 6 a step over
     the 20 steps run (the NaN's window replayed). 13e: three
     ``Executor.train_from_dataset`` steps with a cursor at 2 layers and
     full width, batch 4, seq 256, in fp32 and bf16, on cuda:0 and on
     the CPU from one carried state: the last loss, its grads and every
     parameter within STEP_TOL (the parameter limit times the steps),
     the cursors equal; K1 6 + 6 by the dtype's route. 13f at 13b's
     operating point: 8 dataset batches unguarded and guarded at one
     sync cadence (twice each, in turns), a scope snapshot's bytes and
     ms, an async checkpoint's ms in the caller and until ``wait``
     returns, and ``bench.bench_data_ingestion`` at bench.py's defaults
     (records/s through the data plane onto the card, healthy and with
     one shard quarantined). A ``data_plane`` and a ``resilient_train``
     line, each with the card's name and power limit
     (``tests/test_torch_chip_smoke_data.py`` runs 13a-13f on the CPU at
     a small LM, with planted faults).
  14. data-parallel training: one child process a visible card, up to
     4 (``chip_smoke.py --phase14-rank``), each a rank of an NCCL group
     named by the fleet's env contract (``PADDLE_TRAINER_ID``,
     ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``); the world
     size is printed and chooses nothing else. 14a: bench.py's headline
     program (batch 160 global, seq 512, bf16, legacy AMP, SGD(0.01);
     tokens from 4 ids, as 13a's) through ``fluid.ParallelExecutor(
     loss_name=...)``, 3 warm-up and 8 timed steps: the loss finite and
     falling by more than 0.1, K1 6 "tc" forwards and 6 backwards a step
     on each rank with no operand copied, the backend nccl, and the
     collective counters' all-reduce calls and bytes a step equal to the
     plan's prediction from the program (one a batch reduction, one a
     region entry's grad); two steps from one state against
     ``Executor.run`` of the global batch on each rank's card within
     bf16's STEP_TOL (the largest differences and whether they are
     bitwise are printed). 14b: ResNet-50 (ImageNet,
     batch 64, fp32) through ``fluid_benchmark.run_static_model`` with
     update_method "nccl2": the loss finite and falling, every moving
     statistic finite and moved, K1-K4 unlaunched. 14c:
     ``incubate.fleet.collective.fleet.init()`` and
     ``distributed_optimizer(SGD(0.1))`` on tests/test_distributed.py's
     regression, 10 steps: the last loss below half the first. One
     ``parallel`` line a leg with every rank's numbers and the card; a
     rank that fails fails the phase (``tests/test_torch_chip_smoke_
     parallel.py`` runs the legs over two gloo ranks on the CPU, with
     planted faults).
  15. the telemetry plane (``profiler``, ``observability``,
     ``analysis.concurrency``). 15a, in a child (``chip_smoke.py
     --phase15-profile``): phase 6's program (the headline LM,
     batch 160) — spans and metrics on against off (alternating legs of
     3 steps: the wall and host ms a step), then 2 steps inside
     ``profiler.profiler()``: the device table by Fluid op printed
     (``print_device_op_profile``'s layout, 25 rows), fatal unless the op
     rows hold at least 95% of the window's CUDA kernel time, K1's 12
     forward kernels sit under ``fused_multihead_attention`` rows and its
     12 backward launches' kernels under the grad rows with all of K1's
     kernel time, and a step with the session closed enters no fluid/
     range; then ``python -m paddle_tpu_torch.fluid_benchmark --model
     transformer --profile --iterations 8`` must exit 0 with its event
     table and device table. 15b: the flagship decoder (phase 3's width,
     seed 0) serving 16 pinned requests (4-12 prompt tokens, 16 new) with
     metrics and tracing on and the endpoint on port 0, /metrics, /varz
     and /healthz scraped in flight: fatal unless every request's trace
     holds its queue_wait, admit, one prefill_chunk a prompt token but
     the last and one decode_window a new token, the serving_step spans
     equal the dispatches (and /varz's serving/steps), /healthz answers
     200, the tokens equal an untraced run's and K2 runs once a layer a
     step. 15c: the same leg in a child (``chip_smoke.py
     --phase15-lockcheck``) under PTPU_LOCK_CHECK=1: no violation, the
     same tokens. 15d: 3 native steps (phase 12a's, batch 192) with spans
     and a session on, the loss read after each: each enqueue's and read's
     span, and where the host time inside an enqueue went (runtime calls
     by name, launches that blocked on a full launch queue, the longest
     ops); then a fresh process's first program (``--phase15-first-
     program``: the headline LM, 3 steps, the first inside a session):
     each step's optimize / lower / compile / execute / fetch spans and
     the first step's longest op ranges and runtime calls.
     (``tests/test_torch_chip_smoke_telemetry.py`` runs phase 15 on the
     CPU at a small size, with planted faults.)
  16. the SPMD Transformer trainer (``parallel/transformer.py``'s
     ``SPMDTrainer``: dp × pp × tp with sequence parallelism, the 1F1B
     pipeline, the expert-parallel switch MoE). 16a: the flagship at mesh
     (1, 1, 1), phase 12a's operating point (vocab 32000, d_model 512, 8
     heads, 6 layers, d_ff 2048, batch 192, seq 512, bf16, remat), 3
     warm-up and 8 timed steps (the first counted by
     ``observability/cost.py``: tokens/s and MFU); fatal unless the losses
     are finite and falling, the first within SPMD_REF_RTOL of
     ``single_chip_loss`` on the same parameters and batch, and K1
     launched 12 "tc" forwards (remat) and 6 backwards a step with no
     operand copied; then the same trainer in fp32 at 2 layers, batch 4,
     seq 256, 2 steps on cuda:0 and on the CPU from one tree: the losses
     to STEP_TOL's fp32 limit, each parameter leaf within
     SPMD_PARAM_RATIO of its move; ``lm_logits``'s bf16 grads on the
     card (the cotangent rounded first) within LOGITS_GRAD_RTOL of the
     exact transpose's at the head's width. 16b: the model with a
     4-expert switch MoE (ep = 1), 4 steps: the loss falling, the first
     within SPMD_REF_RTOL of the plain reference's (the layers, then a
     plain MoE loop), the all-to-all calls a step 2 forward, 2 in the
     remat recompute and 2 backward, as ``collective.counts`` reads
     them. Then K1 against its plain version at each 16c leg's rank
     shape, q, k, v packed [B, T, 3, H/tp, Dh] (B 48, 96, 24; H 4, 4,
     8). 16c: one child process a visible
     card (``chip_smoke.py --phase16-rank``; 4 ranks with four cards, 2
     with two or three, the fleet's env contract, NCCL): each leg of
     SPMD_LEGS at full width, batch 192 global, the plain reference's
     loss on each rank's card from the tree gathered back from its
     shards, 2 warm-up and 4 timed
     steps — (1, 2, 2) dense at M = 4, (2, 1, 2) with 4 experts, (1, 4, 1)
     at 8 layers and M = 8 — then its fp32 twin at 2 steps against mesh
     (1, 1, 1) on each rank; fatal unless each leg's losses are finite
     and falling, the first within SPMD_REF_RTOL of the reference's,
     every twin's losses are within
     SPMD_LOSS_RTOL and its leaves within SPMD_PARAM_RATIO, each rank's
     embedding and head calls are 0 off their stage, the stash holds at
     most 2·pp inputs, the ranks' losses agree and K1 ran the schedule's
     count. One ``spmd_multi`` line a leg with every rank's step, tokens/s
     and host ms inside each kind of collective; with one card, one line
     saying 16c ran no multi-rank mesh
     (``tests/test_torch_chip_smoke_spmd.py`` runs phase 16 on the CPU
     over gloo ranks of 1, 2 and 4, with planted faults).
 17. Fluid tensor parallelism and ZeRO-1 through
     ``CompiledProgram.with_data_parallel``. 17a on cuda:0: the plan of
     bench.py's headline program at full width at meshes (2, 2) and
     (1, 4), computed without groups, must equal the JAX planner's table
     (TP_TABLE, pinned by ``tests/test_torch_tensor_parallel.py``); its
     predicted collectives a step (``tp_plan`` line); K1 bf16 causal at
     the tp-local [80, 4, 512, 64] and [160, 2, 512, 64] with the fused
     op's strides, checked and timed (``tp_k1`` lines). 17b and 17c with
     four cards (``chip_smoke.py --phase17-rank``, one child a card,
     NCCL): the headline program at (2, 2) and (1, 4), 3 + 8 steps, and
     the LM under Adam and ReduceStrategy.Reduce at (2, 2), 2 steps with
     its AllReduce twin; fatal unless every rank's first loss is within
     SPMD_REF_RTOL of Executor.run's on the same init and batch, the
     losses fall and agree, replicated params are bitwise equal on every
     rank and tp shards across their dp replicas, the collectives counted
     equal the plan's, no seam lies at an op of TP_NO_SEAM, attention ran
     on H/tp heads, K1 ran 6 + 6 "tc" a step, and Reduce's params are
     within the bf16 update limit of AllReduce's with its state at half
     the bytes (``tp_multi`` lines: ms a step, tokens/s, peak GiB a
     rank); with fewer cards one line saying 17b and 17c need four
     (``tests/test_torch_chip_smoke_tp.py`` runs them on four gloo CPU
     ranks, with planted faults).
 18. The ZeRO ladder (``parallel/zero.py``'s ShardedAdam) training the
     native flagship at full width (``bench.native_config(192, 512)``)
     from fp32 leaves (``transformer.init_params``, seed 0) on bench.py's
     batch, Adam 1e-3, buckets of 25 MiB (4 at fp32, 3 at bf16). K1 at
     18b's rank shape [48, 8, 512, 64], packed, checked and timed
     (``zero_k1``). 18a on cuda:0: legs per_leaf, bucketed,
     zero2_overlap, zero3_overlap, offload and zero2_bf16, 2 + 4 steps
     each (``zero_train`` lines: ms a step, tokens/s, peak GiB, m/v and
     parameter bytes, host ms in each ZeRO kind, the overlap record;
     ``zero_compare``); fatal unless the losses are finite and falling
     with the first within SPMD_REF_RTOL of ``single_chip_loss``'s, the
     fp32-wire bucketed rungs' params, m and v bitwise equal, per-leaf
     within the bf16 update limit of bucketed, each leaf of the bf16 wire
     within SPMD_PARAM_RATIO of its move off the fp32 wire's, K1 12 + 6
     "tc" a step with no copy, the counted ZeRO collectives the plan's,
     the overlap record in segment order with all but the last bucket
     issued before the last leaf grad, stage 2's peak at most stage 1's
     (ZERO_PEAK_SLACK). 18c: bench.py's ``bench_zero`` on cuda:0 (a
     ``bench_zero`` line; fatal unless every ``*_close`` holds and every
     loss falls). 18b with four cards (``chip_smoke.py --phase18-rank``,
     one child a card, NCCL): the same legs at dp = 4, 48 rows a rank,
     then an fp32 twin at 2 layers (ZeRO-2 at dp = 4 against one rank's
     per-leaf run on the global batch); fatal unless the ranks' losses
     agree, replicated params are bitwise equal across the ranks, m and v
     hold 1/4 of the plan's state (a quarter of world 1's bytes: no pad at
     these widths), stage 3 a quarter of the parameters, the bucketed
     rungs are bitwise equal where their plans agree and within
     SPMD_PARAM_RATIO of each other's leaves where they do not, the twin
     within SPMD_LOSS_RTOL and SPMD_PARAM_RATIO (params, m and v), and the
     per-leg gates above hold on every rank (``zero_multi`` and
     ``zero_multi_compare`` lines); with fewer cards one line saying 18b
     needs four (``tests/test_torch_chip_smoke_zero.py`` runs 18a and
     18b on gloo CPU ranks of 1 and 4, with planted faults).

Then one JSON line ``{"kernels": [...]}`` (every kernel of every path,
each with the launches of its path's run; a kernel launched no time there
fails the run) and, last, the result line ``{"ok": true, "device":
{...}}``.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time
import zlib

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
H100_FP16_FLOPS = 989e12     # fp16 tensor cores, dense
H100_TF32_FLOPS = 494.7e12   # TF32 tensor cores, dense
H100_INT8_OPS = 1979e12      # int8 tensor cores, dense
ATOL = 1e-4                  # fp32, different summation order
# flash attention vs its plain version, |got - want| <= atol + rtol|want|,
# (atol, rtol) for the output and for the three grads: fp32 sums in
# another order; in bf16 both sides round to bf16 (1 ulp is 2^-8 to 2^-7
# of |want|), and the grads are reductions over up to 512 rounded terms
# that the kernel's backward forms from the bf16-rounded O; fp16 rounds
# the same places with 3 more bits (1 ulp 2^-11 to 2^-10 of |want|): the
# bf16 limits over 8
FLASH_TOL = {"float32": {"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)},
             "bfloat16": {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)},
             "float16": {"out": (2e-3, 2e-3), "grads": (4e-3, 2e-3)}}
# K1's (forward, backward) routes by dtype: the kernels that run
FLASH_ROUTES = {"bfloat16": ("tc", "tc"), "float16": ("fp16", "fp16"),
                "float32": ("f32tc", "f32tc")}


def fail(msg):
    print("chip_smoke FAILED: %s" % msg, file=sys.stderr)
    sys.exit(1)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail("nvidia-smi did not run: %r" % (e,))
    if out.returncode != 0 or not out.stdout.strip():
        fail("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def gpu_clocks():
    """The card's SM clock, power draw and limit, as nvidia-smi reads them
    now (a reading, not a check)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


def time_ms(torch, fn, flush, iters=20):
    """Mean device time of ``fn`` in ms over ``iters`` launches, each
    after evicting the 50 MB L2 (a decode step finds the pool cold).

    Before each launch the card spins, so that the host has queued the
    start event, ``fn`` and the end event before the card reaches the
    start event: the time between the events is then the card's alone,
    not the host's enqueue. A sample whose start event the card had
    already passed when the end event was queued is taken again after
    a longer spin."""
    fn()
    torch.cuda.synchronize()
    spin = 1 << 21            # clock cycles, about 1 ms
    total, n = 0.0, 0
    while n < iters:
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        host_late = start.query()
        end.synchronize()
        if host_late:
            if spin >= 1 << 28:
                fail("timing: the host took longer than a %d-cycle spin "
                     "to queue one launch" % spin)
            spin *= 2
            continue
        total += start.elapsed_time(end)
        n += 1
    return total / iters


# K2's timed shapes, each its main path's: (C, rows, window starts drawn
# from [lo, hi), the first rows' starts). C=1 is the serving phase
# (max_batch 32, positions up to 511: a full row, the first page, page
# edges); C=7 the linear leg (max_batch 8, 12-token prompts and 48 new
# tokens: a window starts at 12..58; the first and last start, one
# crossing a page); C=8 phase 4b's chunk windows (the 12-token prompts'
# chunks at 0 and 8, the drafter's catch-up up to position 60); C=64 the
# fast path's prefill chunk (phase 4c), timed at a context of 512: every
# row's window ends at position 511; C=16 phase 4d's chunk windows
# (bench_serving_fastpath's chunk 16 over a 64-token prefix and a 2-8
# token tail: windows from 0 to 64; the drafter's catch-ups, from 0)
PAGED_CASES = ((1, 32, 0, 512, (511, 0, 16, 17)),
               (7, 8, 12, 59, (12, 58, 13)),
               (17, 8, 12, 60, (12, 59, 13)),
               (8, 8, 0, 53, (0, 8, 52)),
               (64, 8, 448, 449, ()),
               (16, 8, 0, 65, (0, 16, 48, 64)))
# K2's edge matrix, checked: (C, Dh, bs, Mb, the first rows' window
# starts): head dims between the instantiated widths (48, 80, 100: masked
# columns; 50: 4-byte copies), windows of one to three 32-slot chunks, a
# row at position 0 whose other splits lie past its end, a window at the
# table's end
PAGED_EDGES = ((17, 64, 16, 8, (0, 111, 40)), (33, 64, 16, 8, (0, 95, 7)),
               (64, 48, 16, 8, (0, 64, 30)), (1, 80, 16, 8, (0, 127, 64)),
               (7, 100, 5, 12, (0, 53, 20)), (17, 48, 16, 8, (0, 100, 63)),
               (3, 50, 4, 16, (0, 61, 31)))


def paged_inputs(torch, C, B, lo, hi, edges, seed=0, Dh=64, bs=16, Mb=32,
                 H=8):
    """Attention inputs, by default at the serving path's width: B rows,
    H=8, Dh=64, block_size 16, 32 table slots (max_seq_len 512), a pool
    of B*Mb + 1 pages; row b's window covers positions pos0[b] .. pos0[b]
    + C - 1, pages scattered over the pool, null tails."""
    rng = np.random.RandomState(seed)
    pos0 = rng.randint(lo, hi, size=B)
    pos0[:len(edges)] = edges
    last = pos0 + C - 1
    pos = (pos0[:, None] + np.arange(C)[None, :]).astype(np.int32)
    tables = np.zeros((B, Mb), np.int32)      # page 0: the null page
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        n = last[b] // bs + 1
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    v = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    q = torch.randn(B, C, H, Dh, device="cuda", generator=gen)
    return (k, v, q, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda())


def paged_bound_ms(k, q, tables, pos):
    """Least time for the work: K and V of every visible position read
    once, q/tables/positions read and the output written once, over the
    memory rate; against the flops (QK and PV) over the fp32 rate."""
    B, C, H, Dh = q.shape
    pos = pos.cpu().numpy().astype(np.int64)
    row = H * Dh * 4
    visible = pos.max(axis=1) + 1
    nbytes = (2 * int(visible.sum()) * row + 2 * q.numel() * 4
              + tables.numel() * 4 + pos.size * 4)
    flops = 4 * int((pos + 1).sum()) * H * Dh
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_check(torch, pa_mod, inputs, label):
    got = pa_mod.paged_attention(*inputs)
    want = pa_mod.paged_attention_reference(*inputs)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("paged_attention %s: non-finite output" % label)
    err = float((got - want).abs().max())
    if err > ATOL:
        fail("paged_attention %s disagrees with its plain version: max abs "
             "err %.3g > %g" % (label, err, ATOL))
    return got, want, err


def chunk_window_inputs(torch, seed=7):
    """K2's prefill-chunk window as the fast path's engine gives it (C=64,
    H=8, Dh=64, block 16, max_seq_len 512): rows whose valid spans are 1,
    7, 33 and 64 slots (the rest of each window runs on past the span,
    into null table entries), a decode row at position 500 whose window
    runs past the table (the context clamped to Mb*bs), two rows whose
    tables share 16 adopted blocks (both starting past the shared span),
    and an inactive row (an all-null table, a stale position)."""
    C, H, Dh, bs, Mb = 64, 8, 64, 16, 32
    rng = np.random.RandomState(seed)
    # (window start, valid span, shares the adopted blocks)
    rows = ((0, 1, False), (100, 7, False), (300, 33, False),
            (448, 64, False), (500, 1, False), (256, 64, True),
            (256, 5, True), (40, 0, False))
    B = len(rows)
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    shared = perm[-16:]
    for b, (start, span, adopts) in enumerate(rows):
        if not span:
            continue                              # the inactive row
        n = min((start + span - 1) // bs + 1, Mb)
        tables[b, :n] = perm[b * Mb:b * Mb + n]
        if adopts:
            tables[b, :16] = shared
    pos = (np.array([r[0] for r in rows])[:, None]
           + np.arange(C)[None, :]).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    v = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    q = torch.randn(B, C, H, Dh, device="cuda", generator=gen)
    return (k, v, q, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda())


def kernel_phase(torch, pa_mod):
    """K2 against its plain version on the edge matrix (PAGED_EDGES) and
    the prefill-chunk matrix (``chunk_window_inputs``), then checked and
    timed at its paths' shapes (PAGED_CASES): C=1 the serving phase's
    decode, C=7 the linear leg's window, C=17 the spec_k=16 leg's, C=8
    phase 4b's chunk windows, C=64 the fast path's prefill chunk, C=16
    phase 4d's chunk windows. Returns the kernels-line rows."""
    import torch.nn.functional as F

    _, _, err = paged_check(torch, pa_mod, chunk_window_inputs(torch),
                            "prefill-chunk matrix C=64")
    print("kernel paged_attention prefill-chunk matrix C=64 Dh=64 bs=16 "
          "Mb=32 (spans 1/7/33/64, a decode row past the table, two rows "
          "on adopted blocks, an inactive row; splits %r): max_abs_err "
          "%.3g (limit %g)" % (pa_mod.paged_attention.last_plan, err, ATOL),
          flush=True)
    for i, (C, Dh, bs, Mb, edges) in enumerate(PAGED_EDGES):
        inputs = paged_inputs(torch, C, 6, 0, Mb * bs - C + 1, edges,
                              seed=100 + i, Dh=Dh, bs=bs, Mb=Mb, H=4)
        _, _, err = paged_check(torch, pa_mod, inputs, "C=%d Dh=%d bs=%d"
                                % (C, Dh, bs))
        print("kernel paged_attention C=%d Dh=%d bs=%d Mb=%d (splits %r): "
              "max_abs_err %.3g (limit %g)"
              % (C, Dh, bs, Mb, pa_mod.paged_attention.last_plan, err, ATOL),
              flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for C, B, lo, hi, edges in PAGED_CASES:
        k, v, q, tables, pos = paged_inputs(torch, C, B, lo, hi, edges)
        _, want, err = paged_check(torch, pa_mod, (k, v, q, tables, pos),
                                   "C=%d" % C)
        splits = pa_mod.paged_attention.last_plan     # the checked call's
        _, _, H, Dh = q.shape
        T = tables.shape[1] * k.shape[1]
        # library yardstick: SDPA over K/V gathered contiguous outside
        # the timed region, with the same visibility mask
        tl = tables.long()
        k_ctx = k[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
        v_ctx = v[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
        q_l = q.transpose(1, 2).contiguous()
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= pos.long()[:, :, None])[:, None]
        lib_out = F.scaled_dot_product_attention(q_l, k_ctx, v_ctx,
                                                 attn_mask=mask)
        lib_err = float((lib_out.transpose(1, 2) - want).abs().max())
        if lib_err > ATOL:
            fail("library yardstick C=%d disagrees: %.3g" % (C, lib_err))
        ms = time_ms(torch, lambda: pa_mod.paged_attention(
            k, v, q, tables, pos), flush)
        plain_ms = time_ms(torch, lambda: pa_mod.paged_attention_reference(
            k, v, q, tables, pos), flush)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_l, k_ctx, v_ctx, attn_mask=mask), flush)
        bound_ms, bound_by = paged_bound_ms(k, q, tables, pos)
        rows.append({
            "name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:316",
            "C": C, "shape": "B=%d H=8 Dh=64 bs=16 Mb=32 pool=%d pos %d..%d "
                             "fp32" % (B, k.shape[0], int(pos.min()),
                                       int(pos.max())),
            "max_abs_err": err, "max_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention over K/V gathered "
                       "contiguous outside the timed region (yardstick)",
            "splits": splits})
        print("kernel paged_attention C=%d %s (splits %r): max_abs_err %.3g "
              "(limit %g), %.4f ms (plain %.4f ms, library %.4f ms, bound "
              "%.4f ms by %s)"
              % (C, rows[-1]["shape"], rows[-1]["splits"], err, ATOL, ms,
                 plain_ms, library_ms, bound_ms, bound_by), flush=True)
        del k, v, q, k_ctx, v_ctx
    return rows


def tree_inputs(torch, W, D, B, H, Dh, bs, Mb, seed, edges=()):
    """A tree window's inputs on the card: pos0 drawn so the window fits
    the table (positions up to Mb*bs - 1), the first rows set to
    ``edges`` (a pos0 of 0 is an inactive row with an all-null table;
    one past Mb*bs - C runs the window past the table), pages scattered
    over the pool, null tails."""
    from paddle_tpu_torch.serving import tree_topology

    C = 1 + W * D
    T = Mb * bs
    rng = np.random.RandomState(seed)
    pos0 = rng.randint(1, T - C + 1, size=B)
    pos0[:len(edges)] = edges
    tables = np.zeros((B, Mb), np.int32)      # page 0: the null page
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        if pos0[b]:
            n = min((pos0[b] + C - 1) // bs + 1, Mb)
            tables[b, :n] = perm[b * Mb:b * Mb + n]
    pos = (pos0[:, None] + np.arange(C)[None, :]).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    v = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    q = torch.randn(B, C, H, Dh, device="cuda", generator=gen)
    anc = torch.from_numpy(tree_topology(W, D)[2]).cuda()
    return (k, v, q, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda(), anc)


def tree_mask(torch, pos, anc, T):
    """[B, C, T] visibility of the tree window: t < pos0, or t - pos0 a
    window slot that is the query's slot or one of its ancestors."""
    C = anc.shape[0]
    rel = (torch.arange(T, device=pos.device)[None, None, :]
           - pos[:, :1, None].long())
    in_win = (rel >= 0) & (rel < C)
    anc_t = anc[torch.arange(C, device=pos.device)[None, :, None],
                rel.clamp(0, C - 1)]
    return (rel < 0) | (in_win & anc_t)


def tree_check(torch, pat_mod, inputs, label):
    got = pat_mod.paged_attention_tree(*inputs)
    want = pat_mod.paged_attention_tree_reference(*inputs)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("paged_attention_tree %s: non-finite output" % label)
    err = float((got - want).abs().max())
    if err > ATOL:
        fail("paged_attention_tree %s disagrees with its plain version: "
             "max abs err %.3g > %g" % (label, err, ATOL))
    print("kernel paged_attention_tree %s: max_abs_err %.3g (limit %g)"
          % (label, err, ATOL), flush=True)
    return got, err


# K3's edge matrix: (W, D, Dh, bs, edge rows' pos0). 4x8 (C=33) and 7x9
# (C=64): two 32-slot chunks and two ancestor words a slot, a window
# across the edge of two 64-position splits (some slots see nothing of
# the second: l = 0); Dh 48, 80, 100 between the instantiated widths;
# 1x40 at width 1 (C=41) also against K2
TREE_EDGES = ((1, 6, 64, 16, (0, 125, 1)), (2, 6, 32, 16, (0, 120, 16)),
              (2, 6, 128, 16, (3, 127)), (3, 8, 64, 16, (0, 110, 5)),
              (1, 31, 128, 16, (97, 1)), (4, 4, 64, 5, (0, 37, 10)),
              (4, 8, 64, 16, (0, 50, 95)), (7, 9, 64, 16, (0, 40, 65)),
              (2, 8, 48, 16, (0, 60, 3)), (4, 4, 80, 16, (0, 55)),
              (3, 11, 100, 16, (0, 30)), (1, 40, 80, 16, (0, 20, 87)))
# K3's timed shapes, each its main path's leg: (W, D, edge rows' pos0) at
# B=8, H=8, Dh=64, bs 16, 32 table slots: the 2x6 tree leg (positions up
# to 511) and the 4x8 leg (windows from the 12-token prompts on)
TREE_TIMED = ((2, 6, (499, 1, 16, 243)), (4, 8, (12, 59, 30)))


def tree_kernel_phase(torch, pa_mod, pat_mod):
    """K3 against its plain version on the edge matrix (width 1 also
    against K2) and at its legs' shapes (TREE_TIMED), where it is timed.
    Returns the kernels-line rows."""
    for W, D, Dh, bs, edges in TREE_EDGES:
        inputs = tree_inputs(torch, W, D, B=6, H=4, Dh=Dh, bs=bs, Mb=8,
                             seed=W * 100 + D, edges=edges)
        got, _ = tree_check(torch, pat_mod, inputs,
                            "%dx%d Dh=%d bs=%d C=%d" % (W, D, Dh, bs,
                                                        1 + W * D))
        if W == 1:
            lin = pa_mod.paged_attention(*inputs[:5])
            torch.cuda.synchronize()
            err = float((got - lin).abs().max())
            if err > ATOL:
                fail("paged_attention_tree at width 1 disagrees with "
                     "paged_attention: %.3g" % err)
            print("kernel paged_attention_tree %dx%d vs paged_attention: "
                  "max_abs_err %.3g" % (W, D, err), flush=True)
    return [tree_timed_row(torch, pa_mod, pat_mod, W, D, edges, seed)
            for seed, (W, D, edges) in enumerate(TREE_TIMED)]


def tree_timed_row(torch, pa_mod, pat_mod, W, D, edges, seed):
    """K3 at a leg's shape (B=8, H=8, Dh=64, bs 16, Mb 32): checked, then
    kernel, plain version and SDPA with the tree mask timed, and the
    bound. Returns its kernels-line row."""
    import torch.nn.functional as F

    B, H, Dh, bs, Mb = 8, 8, 64, 16, 32
    C = 1 + W * D
    inputs = tree_inputs(torch, W, D, B, H, Dh, bs, Mb, seed=seed,
                         edges=edges)
    k, v, q, tables, pos, anc = inputs
    label = "%dx%d B=8 H=8 Dh=64 bs=16 Mb=32 pos %d..%d fp32" % (
        W, D, int(pos.min()), int(pos.max()))
    _, err = tree_check(torch, pat_mod, inputs, label)
    splits = pa_mod.paged_attention.last_plan         # the checked call's
    T = Mb * bs
    mask = tree_mask(torch, pos, anc, T)                 # [B, C, T]
    # library yardstick: SDPA with the boolean tree mask over K/V
    # gathered contiguous outside the timed region
    tl = tables.long()
    k_ctx = k[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
    v_ctx = v[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
    q_l = q.transpose(1, 2).contiguous()
    lib_out = F.scaled_dot_product_attention(q_l, k_ctx, v_ctx,
                                             attn_mask=mask[:, None])
    want = pat_mod.paged_attention_tree_reference(*inputs)
    lib_err = float((lib_out.transpose(1, 2) - want).abs().max())
    if lib_err > ATOL:
        fail("library yardstick (tree) disagrees: %.3g" % lib_err)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: pat_mod.paged_attention_tree(*inputs),
                 flush)
    plain_ms = time_ms(torch, lambda: pat_mod.paged_attention_tree_reference(
        *inputs), flush)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q_l, k_ctx, v_ctx, attn_mask=mask[:, None]), flush)
    # bound: K and V of every position some slot of the row sees, read
    # once, q/tables/positions/anc read and the output written once;
    # against QK and PV over the (b, c, t) pairs the mask lets through
    row = H * Dh * 4
    nbytes = (2 * int(mask.any(dim=1).sum()) * row + 2 * q.numel() * 4
              + tables.numel() * 4 + pos.numel() * 4 + anc.numel())
    flops = 4 * int(mask.sum()) * H * Dh
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print("kernel paged_attention_tree %s (splits %r): %.4f ms (plain %.4f "
          "ms, library %.4f ms, bound %.4f ms by %s)"
          % (label, splits, ms, plain_ms, library_ms, bound_ms, bound_by),
          flush=True)
    del k, v, q, k_ctx, v_ctx, inputs
    return {
        "name": "paged_attention_tree", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention_tree.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:475",
        "C": C, "shape": label, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "F.scaled_dot_product_attention with the boolean tree "
                   "mask over K/V gathered contiguous outside the timed "
                   "region (yardstick)", "splits": splits}


def device_us(event):
    """A profiler event's own device time in microseconds."""
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def kernel_times(prof, steps, top=8):
    """(device busy seconds, the kernels with the most device time, per
    step) from a torch.profiler run over `steps` steps."""
    rows = []
    for e in prof.key_averages():
        us = device_us(e)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    return busy_s, [{"kernel": key[:80], "calls": n,
                     "ms_per_step": us / 1e3 / max(steps, 1)}
                    for us, n, key in rows[:top]]


def device_profile(torch, engine, cfg):
    """Where a serving step's time goes: a second open-loop stream of 32
    requests (seed 1) through the same engine under torch.profiler,
    tracing the card only. Returns the device's busy share of the wall
    time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import PoissonLoadGenerator

    loadgen = PoissonLoadGenerator(rate=200.0, n_requests=32,
                                   prompt_len=(16, 64), max_new_tokens=32,
                                   vocab_size=cfg.vocab_size, seed=1)
    steps0 = engine.stats()["default"]["steps"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        accepted, _ = loadgen.run(engine)
        for r in accepted:
            r.wait(900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = engine.stats()["default"]["steps"] - steps0
    busy_s, top = kernel_times(prof, steps)
    return {"wall_s": wall, "steps": steps,
            "step_ms": 1e3 * wall / max(steps, 1),
            "device_busy_ms_per_step": 1e3 * busy_s / max(steps, 1),
            "device_busy_share": busy_s / wall,
            "top_kernels": top}


def serving_phase(torch, pa_mod):
    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          PoissonLoadGenerator,
                                          ServingEngine, reference_decode)

    cfg = GenerationConfig(vocab_size=32000, d_model=512, n_heads=8,
                           n_layers=6, d_ff=2048, max_seq_len=512)
    model = GenerationModel.random(cfg, seed=0)   # device None: cuda:0
    if model.device.type != "cuda":
        fail("the model resolved to %s, not the card" % model.device)
    loadgen = PoissonLoadGenerator(rate=200.0, n_requests=64,
                                   prompt_len=(16, 64), max_new_tokens=32,
                                   vocab_size=cfg.vocab_size, seed=0)
    with ServingEngine(model, max_batch=32, max_seq_len=cfg.max_seq_len,
                       block_size=16, max_queue=128) as engine:
        warm = engine.generate([1, 2, 3, 4], max_new_tokens=4, timeout=600)
        if len(warm) != 4:
            fail("warm-up request returned %r" % (warm,))
        steps0 = engine.stats()["default"]["steps"]
        torch.cuda.synchronize()
        pa_mod.paged_attention.window_launches.clear()   # main path starts
        t0 = time.perf_counter()
        accepted, rejected = loadgen.run(engine)
        errors = []
        for r in accepted:
            try:
                r.wait(900)
            except Exception as e:  # every request's result is checked
                errors.append("request %d: %r" % (r.id, e))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_c = dict(pa_mod.paged_attention.window_launches)  # main path ends
        stats = engine.stats()["default"]
        profile = device_profile(torch, engine, cfg)
    if rejected:
        fail("%d requests were rejected at admission" % len(rejected))
    if errors:
        fail("%d requests ended with an error: %s"
             % (len(errors), "; ".join(errors[:3])))
    steps = stats["steps"] - steps0
    specs = loadgen.make_requests()
    short = [(r.id, len(r.tokens), s["max_new_tokens"])
             for r, s in zip(accepted, specs)
             if len(r.tokens) != s["max_new_tokens"]]
    if short:
        fail("requests ended short of max_new_tokens: %r" % short[:4])
    for r, s in list(zip(accepted, specs))[:4]:
        ref = reference_decode(model, s["prompt"], s["max_new_tokens"])
        if r.tokens != ref:
            first = next(i for i, (a, b) in enumerate(zip(r.tokens, ref))
                         if a != b)
            fail("request %d differs from reference_decode at token %d: "
                 "%r vs %r" % (r.id, first, r.tokens, ref))
    launches = by_c.get(1, 0)
    if launches < 1 or by_c != {1: cfg.n_layers * steps}:
        fail("paged_attention launched %r times by window over %d decode "
             "steps (expected C=1: %d x %d)"
             % (by_c, steps, cfg.n_layers, steps))
    tokens = sum(len(r.tokens) for r in accepted)
    lat = np.array([r.latency for r in accepted])
    summary = {
        "model": "vocab 32000, d_model 512, 8 heads, 6 layers, d_ff 2048",
        "requests": len(accepted), "generated_tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "steps": steps, "steps_per_s": steps / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "paged_attention_launches": launches,
        "reference_checked": 4,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("serving " + json.dumps(summary), flush=True)
    print("profile " + json.dumps(profile), flush=True)
    return launches


# the speculative serving phase: the flagship decoder on bench.py's
# speculative traffic (bench_serving_spec, bench.py:774-776)
SPEC = dict(cfg=dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                     d_ff=2048, max_seq_len=512),
            max_batch=8, block_size=16, n_requests=16, pattern_len=4,
            reps=3, max_new_tokens=48,
            legs=(("legacy", {"spec_k": 0}), ("linear", {"spec_k": 6}),
                  ("tree", {"spec_tree": "2x6"})),
            # windows the engine once refused (F2): K2 at C=17, K3 at C=33
            wide_legs=(("linear16", {"spec_k": 16}),
                       ("tree4x8", {"spec_tree": "4x8"})),
            wide_requests=4,
            # over chunked prefill (bench.py:784's prefill_chunk=8): the
            # linear window, and bench.py:804-812's tree leg, the target
            # drafting for itself through a ModelDrafter (catch-up chunks
            # of draft_chunk tokens: K2 at C=8; draft steps: K2 at C=1)
            chunk_legs=(("linear_c8", {"spec_k": 6, "prefill_chunk": 8}),
                        ("tree_model", {"spec_tree": "2x6",
                                        "prefill_chunk": 8,
                                        "model_drafter": True})),
            draft_chunk=8)


def spec_prompts(vocab_size):
    """bench_serving_spec's generation set: RandomState(11), each prompt a
    random ``pattern_len``-token pattern repeated ``reps`` times —
    templated, repetitive traffic, what n-gram drafting serves."""
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab_size, size=SPEC["pattern_len"]).tolist()
            * SPEC["reps"] for _ in range(SPEC["n_requests"])]


def spec_references(model, prompts):
    """reference_decode of each prompt for SPEC["max_new_tokens"] tokens,
    and each generated token's top-2 logit margin."""
    from paddle_tpu_torch.serving import reference_decode

    refs, margins = [], []
    for p in prompts:
        m = []
        refs.append(reference_decode(model, p, SPEC["max_new_tokens"],
                                     margins=m))
        margins.append(m)
    return refs, margins


def spec_serving_phase(torch, pa_mod, pat_mod, device=None):
    """The three speculative legs on one model (device None: cuda:0;
    the tests pass "cpu", where no kernel launches and none is counted).
    Returns (model, {leg: summary})."""
    from paddle_tpu_torch.serving import GenerationConfig, GenerationModel

    cfg = GenerationConfig(**SPEC["cfg"])
    model = GenerationModel.random(cfg, seed=0, device=device)
    prompts = spec_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    refs, margins = spec_references(model, prompts)
    print("spec reference_decode: %d prompts x %d tokens in %.1f s, "
          "smallest top-2 logit margin %.3g"
          % (len(prompts), SPEC["max_new_tokens"], time.perf_counter() - t0,
             min(min(m) for m in margins)), flush=True)
    legs = {}
    for name, kw in SPEC["legs"]:
        legs[name] = spec_leg(torch, pa_mod, pat_mod, model, prompts, refs,
                              margins, name, kw)
    return model, legs


def spec_wide_phase(torch, pa_mod, pat_mod, model):
    """The windows past the kernels' former limits on the speculative
    phase's model: a linear spec_k=16 leg (C=17) and a 4x8 tree leg
    (C=33), each on the first `wide_requests` prompts, every request
    token-identical to reference_decode, launch counts held as in the
    other legs. Returns {leg: summary}."""
    prompts = spec_prompts(model.config.vocab_size)[:SPEC["wide_requests"]]
    refs, margins = spec_references(model, prompts)
    return {name: spec_leg(torch, pa_mod, pat_mod, model, prompts, refs,
                           margins, name, kw)
            for name, kw in SPEC["wide_legs"]}


def spec_chunk_phase(torch, pa_mod, pat_mod, model):
    """The speculative legs over chunked prefill (SPEC["chunk_legs"]) on
    all the speculative phase's prompts, held as the other legs; the
    ModelDrafter leg also shows draft steps ran and its drafter's pool
    drained. Returns {leg: summary}."""
    prompts = spec_prompts(model.config.vocab_size)
    refs, margins = spec_references(model, prompts)
    return {name: spec_leg(torch, pa_mod, pat_mod, model, prompts, refs,
                           margins, name, kw)
            for name, kw in SPEC["chunk_legs"]}


def spec_leg(torch, pa_mod, pat_mod, model, prompts, refs, margins, name,
             kw):
    """One leg: every request submitted at once, each checked against
    its reference, the drained pools audited and the launch counts held
    to the steps the leg took. ``model_drafter`` in ``kw`` drafts with a
    ModelDrafter over the target itself."""
    from paddle_tpu_torch.serving import ModelDrafter, ServingEngine

    cfg = model.config
    on_card = model.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    engine_kw = {k: v for k, v in kw.items() if k != "model_drafter"}
    drafter = None
    if kw.get("model_drafter"):
        drafter = engine_kw["drafter"] = ModelDrafter(
            model, block_size=SPEC["block_size"], chunk=SPEC["draft_chunk"])
    with ServingEngine(model, max_batch=SPEC["max_batch"],
                       max_seq_len=cfg.max_seq_len,
                       block_size=SPEC["block_size"], device=model.device,
                       **engine_kw) as engine:
        warm = engine.generate(prompts[0][:3], max_new_tokens=2, timeout=600)
        if len(warm) != 2:
            fail("spec %s: warm-up request returned %r" % (name, warm))
        base = engine.stats()["default"]
        sync()
        pa_mod.paged_attention.window_launches.clear()   # main path starts
        pat_mod.paged_attention_tree.launches = 0
        t0 = time.perf_counter()
        reqs = [engine.submit(p, max_new_tokens=SPEC["max_new_tokens"])
                for p in prompts]
        errors = []
        for r in reqs:
            try:
                r.wait(900)
            except Exception as e:  # every request's result is checked
                errors.append("request %d: %r" % (r.id, e))
        sync()
        wall = time.perf_counter() - t0
        k2 = dict(pa_mod.paged_attention.window_launches)
        k3 = pat_mod.paged_attention_tree.launches      # main path ends
        stats = engine.stats()["default"]
    pool = engine._workers["default"].pool
    if errors:
        fail("spec %s: %d requests ended with an error: %s"
             % (name, len(errors), "; ".join(errors[:3])))
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        if r.tokens != ref:
            at = next((j for j, (a, b) in enumerate(zip(r.tokens, ref))
                       if a != b), min(len(r.tokens), len(ref)))
            fail("spec %s: request %d differs from reference_decode at "
                 "generated token %d (got %r, reference %r; the reference's "
                 "top-2 logit margin there is %.3g)"
                 % (name, i, at, r.tokens[at:at + 1], ref[at:at + 1],
                    margins[i][at] if at < len(margins[i]) else float("nan")))
    for pname, p in (("pool", pool),
                     ("drafter pool", drafter and drafter.pool)):
        if p is None:
            continue
        problems = p.check_invariants()
        pst = p.stats()
        if problems or pst["blocks_in_use"] or pst["blocks_free"] != \
                pst["blocks_total"]:
            fail("spec %s: the %s did not drain clean: %r %r"
                 % (name, pname, problems[:3], pst))
    steps = stats["steps"] - base["steps"]
    spec_steps = stats["spec_steps"] - base["spec_steps"]
    chunk_steps = stats["prefill_chunk_steps"] - base["prefill_chunk_steps"]
    draft_steps = stats["spec_draft_steps"] - base["spec_draft_steps"]
    tokens = sum(len(r.tokens) for r in reqs)
    if stats["spec_k"] and spec_steps < 1:
        fail("spec %s: no verify window ran" % name)
    if stats["spec_tree"] and stats["spec_tree_slots"] == \
            base["spec_tree_slots"]:
        fail("spec %s: no tree slot was verified" % name)
    if kw.get("prefill_chunk") and chunk_steps < 1:
        fail("spec %s: no chunk step ran" % name)
    if drafter is not None and draft_steps < 1:
        fail("spec %s: the ModelDrafter ran no draft step" % name)
    if on_card:
        run = {"steps": steps, "spec_steps": spec_steps,
               "prefill_chunk_steps": chunk_steps,
               "spec_draft_steps": draft_steps,
               **{k: stats[k] for k in ("prefill_chunk", "spec_k",
                                        "spec_tree")}}
        want_k2, want_k3 = engine_launches(cfg.n_layers, {name: {
            "stats": {"default": run},
            "drafter_chunk": drafter and SPEC["draft_chunk"]}},
            k2)
        if k2 != want_k2 or k3 != want_k3:
            fail("spec %s: over %d steps (%d verify windows, %d chunk "
                 "steps, %d draft steps) paged_attention launched %r times "
                 "by window and paged_attention_tree %d; expected %r and %d"
                 % (name, steps, spec_steps, chunk_steps, draft_steps, k2,
                    k3, want_k2, want_k3))
    lat = np.array([r.latency for r in reqs])
    summary = {
        "leg": name, **kw,
        "requests": len(reqs), "generated_tokens": tokens,
        "reference_identical": len(reqs), "wall_s": wall,
        "tokens_per_s": tokens / wall, "target_steps": steps,
        "tokens_per_target_step": tokens / max(steps, 1),
        "one_token_steps": steps - spec_steps - chunk_steps,
        "chunk_steps": chunk_steps, "draft_steps": draft_steps,
        "verify_windows": spec_steps,
        "accept_rate": stats["spec_accept_rate"],
        "tree_slots": stats["spec_tree_slots"] - base["spec_tree_slots"],
        "tree_commits": stats["spec_tree_commits"]
        - base["spec_tree_commits"],
        "blocks_rolled_back": stats["spec_blocks_rolled_back"]
        - base["spec_blocks_rolled_back"],
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "paged_attention_launches_by_window": k2,
        "paged_attention_tree_launches": k3}
    print("spec_serving " + json.dumps(summary), flush=True)
    return summary


# the serving fast path (phase 4c): bench_serving_fastpath
# (bench.py:659-729) at the flagship's full width
FAST = dict(cfg=dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                     d_ff=2048, max_seq_len=512),
            max_batch=8, block_size=16, prefix_len=256, n_requests=32,
            max_new_tokens=32, reference_checked=8, chunk=64,
            legs=(("legacy", {"prefill_chunk": 0, "prefix_cache": False}),
                  ("chunked", {"prefill_chunk": 64, "prefix_cache": False}),
                  ("fast", {"prefill_chunk": 64, "prefix_cache": True})))


def fastpath_prompts(vocab_size):
    """bench_serving_fastpath's request set: RandomState(11), a shared
    ``prefix_len``-token prefix, then each prompt's unique tail of 2 to
    8 tokens. Returns (shared, prompts)."""
    rng = np.random.RandomState(11)
    shared = rng.randint(0, vocab_size, size=FAST["prefix_len"]).tolist()
    return shared, [shared + rng.randint(
        0, vocab_size, size=int(rng.randint(2, 9))).tolist()
        for _ in range(FAST["n_requests"])]


def fastpath_phase(torch, pa_mod, device=None):
    """Shared-system-prompt traffic in three legs (FAST["legs"]): one
    priming request (the compile-free warm-up and, in the fast leg, the
    prefill that seals the shared blocks), then every request submitted
    at once. All legs must give equal tokens, the first
    ``reference_checked`` equal to reference_decode; the fast leg must
    reuse every shared block (hit rate 1.0) and keep them cached; every
    pool drains clean; K2 runs once a layer a chunk step at C=chunk;
    the chunked and fast legs' TTFT p50 must be below legacy's. Returns
    {leg: summary}."""
    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          ServingEngine, reference_decode)

    cfg = GenerationConfig(**FAST["cfg"])
    model = GenerationModel.random(cfg, seed=0, device=device)
    on_card = model.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    shared, prompts = fastpath_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    refs = [reference_decode(model, p, FAST["max_new_tokens"])
            for p in prompts[:FAST["reference_checked"]]]
    print("fastpath reference_decode: %d prompts x %d tokens in %.1f s"
          % (len(refs), FAST["max_new_tokens"], time.perf_counter() - t0),
          flush=True)
    shared_blocks = FAST["prefix_len"] // FAST["block_size"]
    L = cfg.n_layers
    legs, outputs = {}, {}
    for name, kw in FAST["legs"]:
        with ServingEngine(model, max_batch=FAST["max_batch"],
                           max_seq_len=cfg.max_seq_len,
                           block_size=FAST["block_size"], device=device,
                           **kw) as engine:
            warm = engine.generate(shared + [7], max_new_tokens=2,
                                   timeout=900)
            if len(warm) != 2:
                fail("fastpath %s: priming request returned %r"
                     % (name, warm))
            base = engine.stats()["default"]
            sync()
            pa_mod.paged_attention.window_launches.clear()  # path starts
            t0 = time.perf_counter()
            reqs = [engine.submit(p, max_new_tokens=FAST["max_new_tokens"])
                    for p in prompts]
            errors = []
            for r in reqs:
                try:
                    r.wait(900)
                except Exception as e:  # every request's result is checked
                    errors.append("request %d: %r" % (r.id, e))
            sync()
            wall = time.perf_counter() - t0
            k2 = dict(pa_mod.paged_attention.window_launches)  # path ends
            stats = engine.stats()["default"]
        if errors:
            fail("fastpath %s: %d requests ended with an error: %s"
                 % (name, len(errors), "; ".join(errors[:3])))
        outputs[name] = [r.tokens for r in reqs]
        for i, ref in enumerate(refs):
            if reqs[i].tokens != ref:
                at = next((j for j, (a, b) in enumerate(
                    zip(reqs[i].tokens, ref)) if a != b), len(ref))
                fail("fastpath %s: request %d differs from reference_decode "
                     "at generated token %d" % (name, i, at))
        pool = engine._workers["default"].pool
        problems = pool.check_invariants()
        pst = pool.stats()
        if problems or pst["blocks_in_use"] or \
                pst["blocks_free"] != pst["blocks_total"]:
            fail("fastpath %s: the pool did not drain clean: %r %r"
                 % (name, problems[:3], pst))
        steps = stats["steps"] - base["steps"]
        chunk_steps = stats["prefill_chunk_steps"] - \
            base["prefill_chunk_steps"]
        reused = stats["prefix_blocks_reused"] - base["prefix_blocks_reused"]
        hit_rate = reused / (len(prompts) * shared_blocks)
        if kw["prefix_cache"]:
            if hit_rate != 1.0:
                fail("fastpath %s: prefix hit rate %r (reused %d of %d "
                     "blocks), expected 1.0" % (name, hit_rate, reused,
                                                len(prompts) * shared_blocks))
            if pst["blocks_cached"] < shared_blocks:
                fail("fastpath %s: %d blocks cached at the end, expected "
                     ">= %d" % (name, pst["blocks_cached"], shared_blocks))
        if kw["prefill_chunk"] and chunk_steps < 1:
            fail("fastpath %s: no chunk step ran" % name)
        if on_card:
            want = {1: L * (steps - chunk_steps),
                    kw["prefill_chunk"]: L * chunk_steps}
            want = {c: n for c, n in want.items() if n}
            if k2 != want:
                fail("fastpath %s: over %d steps (%d chunk steps) "
                     "paged_attention launched %r times by window; expected "
                     "%r" % (name, steps, chunk_steps, k2, want))
        ttft = np.array([r.ttft for r in reqs])
        lat = np.array([r.latency for r in reqs])
        tokens = sum(len(r.tokens) for r in reqs)
        legs[name] = {
            "leg": name, **kw, "requests": len(reqs),
            "generated_tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "steps": steps,
            "chunk_steps": chunk_steps,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "prefix_blocks_reused": reused, "prefix_hit_rate": hit_rate,
            "blocks_cached": pst["blocks_cached"],
            "reference_identical": len(refs),
            "paged_attention_launches_by_window": k2}
        print("fastpath " + json.dumps(legs[name]), flush=True)
    for name in legs:
        if outputs[name] != outputs["legacy"]:
            i = next(i for i, (a, b) in enumerate(zip(outputs[name],
                                                      outputs["legacy"]))
                     if a != b)
            fail("fastpath %s: request %d differs from the legacy leg"
                 % (name, i))
    for name in ("chunked", "fast"):
        if not legs[name]["ttft_p50_s"] < legs["legacy"]["ttft_p50_s"]:
            fail("fastpath %s: TTFT p50 %.4f s is not below legacy's %.4f s"
                 % (name, legs[name]["ttft_p50_s"],
                    legs["legacy"]["ttft_p50_s"]))
    if on_card:
        chunk_step_profile(torch, model)
    return legs


# phase 4d: bench.py's serving legs (bench_serving :553,
# bench_serving_fastpath :659, bench_serving_spec :731,
# bench_serving_quant :1242) through the port's bench, each at the
# flagship's full width with bench.py's own traffic (request counts,
# prompt lengths, max_new_tokens, max_batch, chunks, seeds)
BENCH_WIDTH = dict(vocab=32000, d_model=512, n_heads=8, n_layers=6,
                   d_ff=2048, max_seq_len=512)
BENCH_FUNCTIONS = ("bench_serving", "bench_serving_fastpath",
                   "bench_serving_spec", "bench_serving_quant")
# the legs of bench_serving_spec and bench_serving_quant that serve int8
BENCH_INT8_LEGS = {"bench_serving_spec": "int8", "bench_serving_quant": "int8"}


def engine_launches(L, legs, k2):
    """The launches a run must show over the engines it served with
    (``legs``: {leg: {"stats": the engine's step counts over the run,
    "drafter_chunk": its ModelDrafter's catch-up chunk or None}}), one a
    layer each: K2 at C=1 a one-token step, at C=chunk a chunk step, at
    C=k+1 a linear window; K3 a tree window. A ModelDrafter adds K2 at
    its catch-up chunk a catch-up and at C=1 ``spec_k - 1`` times a draft
    step; only their sum is counted (``spec_draft_steps``), so the split
    is read from ``k2`` and held to that sum. Returns (want_k2,
    want_k3)."""
    want, want_k3 = {1: 0}, 0
    drafted = {}       # (catch-up chunk, steps a draft step) -> draft steps
    for leg in legs.values():
        st = leg["stats"]["default"]
        steps, spec, chunk = (st["steps"], st["spec_steps"],
                              st["prefill_chunk_steps"])
        want[1] += L * (steps - spec - chunk)
        if chunk:
            c = st["prefill_chunk"]
            want[c] = want.get(c, 0) + L * chunk
        if st["spec_tree"]:
            want_k3 += L * spec
        elif st["spec_k"]:
            c = st["spec_k"] + 1
            want[c] = want.get(c, 0) + L * spec
        if leg["drafter_chunk"] and st["spec_draft_steps"]:
            key = (leg["drafter_chunk"], st["spec_k"] - 1)
            drafted[key] = drafted.get(key, 0) + st["spec_draft_steps"]
    if len(drafted) == 1:
        (c, n_new), draft_steps = next(iter(drafted.items()))
        extra_c = k2.get(c, 0) - want.get(c, 0)
        extra_1 = k2.get(1, 0) - want[1]
        catchups, scans = extra_c // L, extra_1 // max(L * n_new, 1)
        if (catchups * L, scans * L * n_new) == (extra_c, extra_1) and \
                catchups + scans == draft_steps:
            want[c] = want.get(c, 0) + L * catchups
            want[1] += L * n_new * scans
    elif drafted:
        fail("launch accounting: drafters of several shapes %r in one run"
             % sorted(drafted))
    return {c: n for c, n in want.items() if n}, want_k3


def bench_mismatch(name, legs, leg):
    """Fail naming the first request of ``leg`` whose tokens differ from
    ``reference_decode`` over its engine's model, with the reference's
    top-2 logit margin there (how near that token was to a tie)."""
    from paddle_tpu_torch.serving import reference_decode

    entry = legs[leg]
    for i, (prompt, got) in enumerate(zip(entry["prompts"],
                                          entry["outputs"])):
        margins = []
        ref = reference_decode(entry["model"], prompt, len(got),
                               margins=margins)
        if got != ref:
            at = next((j for j, (a, b) in enumerate(zip(got, ref))
                       if a != b), min(len(got), len(ref)))
            fail("bench %s %s: request %d differs from reference_decode at "
                 "generated token %d (got %r, reference %r; the reference's "
                 "top-2 logit margin there is %.3g)"
                 % (name, leg, i, at, got[at:at + 1], ref[at:at + 1],
                    margins[at] if at < len(margins) else float("nan")))
    fail("bench %s %s: outputs_match is false" % (name, leg))


def bench_leg_summary(leg, entry, L):
    st = entry["stats"]["default"]
    out = {"leg": leg, "tokens_per_s": entry["generated_tokens"]
           / entry["wall_s"], "requests": entry["requests"],
           "generated_tokens": entry["generated_tokens"],
           "wall_s": entry["wall_s"],
           "latency_p50_s": entry["latency_p50_s"],
           "latency_p99_s": entry["latency_p99_s"],
           "ttft_p50_s": entry["ttft_p50_s"],
           "ttft_p99_s": entry["ttft_p99_s"],
           # over the engine's life, warm-up and priming requests included
           "steps": st["steps"], "chunk_steps": st["prefill_chunk_steps"],
           "verify_windows": st["spec_steps"],
           "draft_steps": st["spec_draft_steps"],
           "tokens_per_step": st["generated_tokens"] / max(st["steps"], 1),
           "accept_rate": st["spec_accept_rate"],
           "prefix_blocks_reused": st["prefix_blocks_reused"],
           "weight_only_int8": st["weight_only_int8"]}
    if st["weight_only_int8"]:
        out["weight_store"] = st["weight_store"]
    return out


def bench_serving_phase(torch, pa_mod, pat_mod, device=None, width=None):
    """bench.py's four serving functions through the port's bench
    (``paddle_tpu_torch.bench``) at the flagship's width (device None:
    cuda:0; the tests pass "cpu" and a small width). Each call's K2 and
    K3 counts are zeroed just before it and read just after; on the card
    every launch must be accounted for by its engines' steps
    (``engine_launches``). Fatal unless every outputs_match is true (a
    mismatch names the request and the reference's top-2 logit margin),
    the fast path's prefix hit rate is 1.0 and both int8 legs served
    from the int8 store (``n_int8 == 2 + 4 n_layers``). Prints one
    ``bench_serving`` line a function. Returns ({function: its K2 counts
    by C}, {function: its K3 count})."""
    from paddle_tpu_torch import bench

    width = dict(BENCH_WIDTH if width is None else width)
    L = width["n_layers"]
    on_card = device is None or str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    k2_by_fn, k3_by_fn = {}, {}
    for name in BENCH_FUNCTIONS:
        fn = getattr(bench, name)
        sync()
        pa_mod.paged_attention.window_launches.clear()   # main path starts
        pat_mod.paged_attention_tree.launches = 0
        t0 = time.perf_counter()
        out = fn(place=device, **width)
        sync()
        wall = time.perf_counter() - t0
        k2 = dict(pa_mod.paged_attention.window_launches)
        k3 = pat_mod.paged_attention_tree.launches       # main path ends
        legs = dict(bench.last_serving)
        summary = {"function": name, "wall_s": wall,
                   "legs": [bench_leg_summary(leg, e, L)
                            for leg, e in legs.items()]}
        if name == "bench_serving":
            summary.update(batched_tokens_per_s=out[0],
                           serial_tokens_per_s=out[1],
                           outputs_match=out[2], latency_p50_s=out[3],
                           latency_p99_s=out[4], total_tokens=out[5],
                           batched_steps_per_s=out[6])
            if not out[2]:
                bench_mismatch(name, legs, "serial")
        elif name == "bench_serving_fastpath":
            summary.update({k: out[k] for k in ("ttft_speedup",
                                                "prefix_hit_rate",
                                                "outputs_match")})
            for leg in ("legacy", "fast"):
                summary[leg] = out[leg]
                if not out[leg]["outputs_match"]:
                    bench_mismatch(name, legs, leg)
            if out["prefix_hit_rate"] != 1.0:
                fail("bench %s: prefix hit rate %r, expected 1.0"
                     % (name, out["prefix_hit_rate"]))
        elif name == "bench_serving_spec":
            summary.update({k: out[k] for k in (
                "tree_shape", "tokens_per_step_speedup",
                "tree_speedup_vs_linear", "accept_rate", "outputs_match")})
            for leg in ("legacy", "spec", "tree", "int8"):
                summary[leg] = out[leg]
                if not out[leg]["outputs_match"]:
                    bench_mismatch(name, legs, leg)
        else:
            summary.update(int8_tokens_per_s=out[0],
                           fp32_tokens_per_s=out[1],
                           int8_over_fp32=out[0] / out[1],
                           outputs_match=out[2], token_agreement=out[3],
                           total_tokens=out[4])
            if not out[2]:
                bench_mismatch(name, legs, "int8")
        int8_leg = BENCH_INT8_LEGS.get(name)
        if int8_leg:
            st = legs[int8_leg]["stats"]["default"]
            n_int8 = st["weight_store"]["n_int8"]
            if not st["weight_only_int8"] or n_int8 != 2 + 4 * L:
                fail("bench %s %s: served weight_only_int8=%r with %d int8 "
                     "weights, expected the int8 store's %d"
                     % (name, int8_leg, st["weight_only_int8"], n_int8,
                        2 + 4 * L))
        if on_card:
            want_k2, want_k3 = engine_launches(L, legs, k2)
            if k2 != want_k2 or k3 != want_k3:
                fail("bench %s: paged_attention launched %r times by window "
                     "and paged_attention_tree %d; its engines' steps "
                     "account for %r and %d"
                     % (name, k2, k3, want_k2, want_k3))
        summary.update(paged_attention_launches_by_window=k2,
                       paged_attention_tree_launches=k3)
        k2_by_fn[name], k3_by_fn[name] = k2, k3
        print("bench_serving " + json.dumps(summary), flush=True)
    bench.last_serving.clear()
    return k2_by_fn, k3_by_fn


# phase 4e: the serving fleet and online hot swap — bench.py's
# bench_serving_fleet (:836) and bench_serving_online (:906) through the
# port's bench at the flagship's width with bench.py's own traffic, then a
# failover leg and a swap leg of the port's own
FLEET_DIE_AFTER = 6     # the failover leg kills a replica this many steps
                        # past the primers


def fleet_launches(L, routers):
    """The K2 launches a fleet run must show: every replica of every
    router in ``routers`` (router stats, each replica's engine under
    ``model:default``), dead ones included, one a layer a step
    (``engine_launches`` over the replicas as engines). Returns
    (want_k2, want_k3)."""
    legs = {}
    for i, st in enumerate(routers):
        for rep in st["replicas"]:
            legs["%d/%d" % (i, rep["idx"])] = {
                "stats": {"default": rep["model:default"]},
                "drafter_chunk": None}
    return engine_launches(L, legs, {})


def check_fleet_launches(name, L, routers, k2, k3, on_card):
    """Fail unless K2's launches by C (and K3's) are the replicas' steps'
    (on the card; the CPU route launches nothing). Returns the replicas'
    steps by router."""
    if on_card:
        want_k2, want_k3 = fleet_launches(L, routers)
        if k2 != want_k2 or k3 != want_k3:
            fail("fleet %s: paged_attention launched %r times by window "
                 "and paged_attention_tree %d; the replicas' steps account "
                 "for %r and %d" % (name, k2, k3, want_k2, want_k3))
    return [[rep["model:default"]["steps"] for rep in st["replicas"]]
            for st in routers]


def check_failover(st, dead, outputs, want):
    """The failover leg's gates: exactly one failover, no request lost or
    failed, exactly one dead replica whose pool drained empty and clean,
    every output equal to the unfailed run's. ``st`` is the router's
    stats, ``dead`` the dead replicas' engines."""
    lost = (st["requests_submitted"] - st["requests_completed"]
            - st["requests_failed"])
    if st["failovers"] != 1 or lost or st["requests_failed"]:
        fail("fleet failover: %d failovers, %d requests lost, %d failed; "
             "expected 1, 0 and 0" % (st["failovers"], lost,
                                      st["requests_failed"]))
    if len(dead) != 1:
        fail("fleet failover: %d dead replicas, expected 1" % len(dead))
    for w in dead[0]._workers.values():
        problems = w.pool.check_invariants()
        if problems or w.pool.blocks_in_use or w.pool.stats()[
                "blocks_reserved"]:
            fail("fleet failover: the dead replica's pool is not drained: "
                 "%r %r" % (w.pool.stats(), problems[:3]))
    if outputs != want:
        bad = next(i for i, (a, b) in enumerate(zip(outputs, want))
                   if a != b)
        fail("fleet failover: request %d gave %r, the unfailed run %r"
             % (bad, outputs[bad], want[bad]))


def check_versions(name, outputs, versions, prompts, models, max_new):
    """Every output equal to ``reference_decode`` under the weight version
    that served it."""
    from paddle_tpu_torch.serving import reference_decode

    for i, (out, v, p) in enumerate(zip(outputs, versions, prompts)):
        if v not in models:
            fail("fleet %s: request %d served by version %r, which has no "
                 "artifact" % (name, i, v))
        ref = reference_decode(models[v], p, max_new)
        if out != ref:
            fail("fleet %s: request %d (version %d) differs from "
                 "reference_decode: got %r, reference %r"
                 % (name, i, v, out, ref))


def fleet_phase(torch, pa_mod, pat_mod, device=None, width=None,
                online_kwargs=None):
    """Phase 4e at the flagship's width (device None: cuda:0; the tests
    pass "cpu", a small width and a small online program): the port's
    bench_serving_fleet and bench_serving_online, then a failover leg (2
    replicas, ``serve_die_at_step`` armed through ``set_global_injector``,
    on the fleet leg's prompts) and a swap leg (``swap_weights`` from the
    v1 artifact on a draining replica while the other serves). Each leg's
    K2/K3 counts are zeroed just before it and read just after. Fatal
    unless every output is token-identical to ``reference_decode`` (the
    online and swap legs under the version that served each request),
    both replicas stepped in every 2-replica leg, the failover leg passes
    ``check_failover``, the online leg lost nothing, published one
    version, swapped twice and ends on [1, 1], and (on the card) every
    K2 launch is accounted for by the replicas' steps. Prints one
    ``fleet`` line a leg. Returns K2's launches at C=1 over the phase."""
    import tempfile
    import warnings

    from paddle_tpu_torch import bench, resilience
    from paddle_tpu_torch.serving import ServingRouter

    width = dict(BENCH_WIDTH if width is None else width)
    L = width["n_layers"]
    on_card = device is None or str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = card_line() if on_card else None
    total_c1 = 0

    def start():
        sync()
        pa_mod.paged_attention.window_launches.clear()   # main path starts
        pat_mod.paged_attention_tree.launches = 0
        return time.perf_counter()

    def end(t0):
        sync()
        k2 = dict(pa_mod.paged_attention.window_launches)
        k3 = pat_mod.paged_attention_tree.launches       # main path ends
        return time.perf_counter() - t0, k2, k3

    def report(leg, summary, k2, k3):
        nonlocal total_c1
        total_c1 += k2.get(1, 0)
        summary.update(leg=leg, paged_attention_launches_by_window=k2,
                       paged_attention_tree_launches=k3, card=card)
        print("fleet " + json.dumps(summary), flush=True)

    def both_stepped(leg, steps):
        if any(s == 0 for s in steps):
            fail("fleet %s: a replica took no step (%r)" % (leg, steps))

    # bench_serving_fleet: 1 then 2 replicas
    t0 = start()
    out = bench.bench_serving_fleet(place=device, **width)
    wall, k2, k3 = end(t0)
    fleet = dict(bench.last_serving)
    if not out["outputs_match"]:
        fail("fleet bench_serving_fleet: outputs_match is false (1 "
             "replica: %r, 2: %r)" % (out["one"]["outputs_match"],
                                      out["two"]["outputs_match"]))
    steps = check_fleet_launches(
        "bench_serving_fleet", L, [fleet["1r"]["router"],
                                   fleet["2r"]["router"]], k2, k3, on_card)
    both_stepped("two", steps[1])
    report("bench_serving_fleet", {
        "wall_s": wall,
        "tokens_per_s_1r": out["one"]["tokens_per_sec"],
        "tokens_per_s_2r": out["two"]["tokens_per_sec"],
        "scaling": out["scaling"], "replica_steps": steps,
        "replicas_used": [out["one"]["replicas_used"],
                          out["two"]["replicas_used"]],
        "failovers": [out["one"]["failovers"], out["two"]["failovers"]],
        "outputs_match": out["outputs_match"]}, k2, k3)

    # failover: the fleet leg's prompts, one replica killed mid-stream
    model, prompts = fleet["2r"]["model"], fleet["2r"]["prompts"]
    want = fleet["2r"]["outputs"]
    t0 = start()
    router = ServingRouter(model, replicas=2, max_batch=4,
                           max_seq_len=width["max_seq_len"], block_size=16,
                           backoff_base=0.0, health_interval_s=0.02,
                           device=device)
    try:
        for p in [router.submit([1, 2], max_new_tokens=2)
                  for _ in range(2)]:
            p.wait(600)
        st0 = bench._settled_router_stats(router)
        die_at = max(r["model:default"]["steps"]
                     for r in st0["replicas"]) + FLEET_DIE_AFTER
        prev = resilience.set_global_injector(resilience.FaultInjector(
            "serve_die_at_step:%d" % die_at))
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                t1 = time.perf_counter()
                reqs = [router.submit(p, max_new_tokens=16)
                        for p in prompts]
                outs = [r.wait(600) for r in reqs]
                serve_s = time.perf_counter() - t1
        finally:
            resilience.set_global_injector(prev)
        dead = [r.engine for r in router._replicas if r.state == "dead"]
        for eng in dead:
            for w in eng._workers.values():
                w._thread.join(60)
        st = bench._settled_router_stats(router)
    finally:
        router.close()
    wall, k2, k3 = end(t0)
    check_failover(st, dead, outs, want)
    steps = check_fleet_launches("failover", L, [st], k2, k3, on_card)
    both_stepped("failover", steps[0])
    report("failover", {
        "wall_s": wall, "serve_s": serve_s,
        "tokens_per_s": sum(len(o) for o in outs) / serve_s,
        "die_at_step": die_at, "replica_steps": steps,
        "states": [r["state"] for r in st["replicas"]],
        "failovers": st["failovers"], "readmitted": st["readmitted"],
        "retries": st["retries"], "version_restarts":
            st["version_restarts"], "outputs_match": outs == want}, k2, k3)

    # bench_serving_online: steady, then v1 rolled mid-stream
    kw = dict(n_requests=24, max_new_tokens=12, vocab=width["vocab"],
              max_seq_len=width["max_seq_len"], max_batch=4, block_size=4,
              model_kwargs={})
    kw.update(online_kwargs or {})
    with tempfile.TemporaryDirectory(prefix="ptpu_smoke_online_") as work:
        t0 = start()
        out = bench.bench_serving_online(place=device, workdir=work, **kw)
        wall, k2, k3 = end(t0)
        online = bench.last_serving["online"]
        if not out["outputs_match"]:
            rolled = online["outputs"]
            check_versions("bench_serving_online",
                           rolled["steady"] + rolled["rollout"],
                           online["versions"]["steady"]
                           + online["versions"]["rollout"],
                           online["prompts"] * 2, online["models"],
                           kw["max_new_tokens"])
            fail("fleet bench_serving_online: outputs_match is false")
        if (out["requests_lost"], out["versions_published"], out["swaps"],
                out["final_versions"]) != (0, 1, 2, [1, 1]):
            fail("fleet bench_serving_online: %d lost, %d published, %d "
                 "swaps, final versions %r; expected 0, 1, 2, [1, 1]"
                 % (out["requests_lost"], out["versions_published"],
                    out["swaps"], out["final_versions"]))
        st = online["router"]
        steps = check_fleet_launches("bench_serving_online", L, [st], k2,
                                     k3, on_card)
        both_stepped("online", steps[0])
        report("bench_serving_online", {
            "wall_s": wall,
            "steady_tokens_per_s": out["steady_tokens_per_sec"],
            "rollout_tokens_per_s": out["rollout_tokens_per_sec"],
            "rollout_over_steady": out["rollout_throughput_ratio"],
            "replica_steps": steps, "failovers": st["failovers"],
            "readmitted": st["readmitted"],
            "version_restarts": st["version_restarts"],
            "rollout_versions": online["versions"]["rollout"],
            "updater": online["updater"],
            "outputs_match": out["outputs_match"]}, k2, k3)

        # swap: v1 onto a draining replica while the other serves
        models, sprompts = online["models"], online["prompts"]
        max_new = kw["max_new_tokens"]
        t0 = start()
        router = ServingRouter(online["v0_dir"], replicas=2, max_batch=4,
                               max_seq_len=kw["max_seq_len"], block_size=4,
                               backoff_base=0.0, health_interval_s=0.02,
                               device=device)
        try:
            for p in [router.submit([1, 2], max_new_tokens=2)
                      for _ in range(2)]:
                p.wait(600)
            router.drain(1)
            router.wait_drained(1, timeout=60)
            during = [router.submit(p, max_new_tokens=max_new)
                      for p in sprompts[:8]]
            t1 = time.perf_counter()
            version = router.replica_engine(1).swap_weights(
                online["v1_dir"], timeout=120)
            swap_s = time.perf_counter() - t1
            router.undrain(1)
            after = [router.submit(p, max_new_tokens=max_new)
                     for p in sprompts[8:16]]
            reqs = during + after
            outs = [r.wait(600) for r in reqs]
            vers = [r.weight_version for r in reqs]
            st = bench._settled_router_stats(router)
        finally:
            router.close()
        wall, k2, k3 = end(t0)
    check_versions("swap", outs, vers, sprompts[:16], models, max_new)
    final = [r["weight_version"] for r in st["replicas"]]
    if version != 1 or final != [0, 1] or any(v != 0 for v in
                                              vers[:8]) or 1 not in vers:
        fail("fleet swap: swap_weights gave version %r, replicas end on "
             "%r, requests served by %r; expected 1, [0, 1], the first 8 "
             "by 0 and some by 1" % (version, final, vers))
    steps = check_fleet_launches("swap", L, [st], k2, k3, on_card)
    both_stepped("swap", steps[0])
    report("swap", {
        "wall_s": wall, "swap_s": swap_s, "replica_steps": steps,
        "final_versions": final, "served_by_version": vers,
        "outputs_match": True}, k2, k3)
    bench.last_serving.clear()
    return total_c1


def int8_step_profile(torch, width=None, rows=16, position=100):
    """What dequantize-on-use costs: one ``decode_step`` of the flagship
    (``rows`` rows at ``position`` onwards, bench_serving's batch of 16)
    over fp32 weights and over the int8 store, each under torch.profiler
    tracing the card only: the host's wall time, the device's busy time
    and the kernels with the most device time, and the int8 step's
    device ms over the fp32 step's."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          KVBlockPool, blocks_needed)

    w = dict(BENCH_WIDTH if width is None else width)
    cfg = GenerationConfig(vocab_size=w["vocab"], d_model=w["d_model"],
                           n_heads=w["n_heads"], n_layers=w["n_layers"],
                           d_ff=w["d_ff"], max_seq_len=w["max_seq_len"])
    fp32 = GenerationModel.random(cfg, seed=0)
    bs = 16
    Mb = blocks_needed(cfg.max_seq_len, bs)
    pool = KVBlockPool(cfg.n_layers, cfg.n_heads, cfg.head_dim, bs,
                       rows * Mb, device=fp32.device)
    dev = fp32.device
    tables = torch.arange(1, rows * Mb + 1, dtype=torch.int32,
                          device=dev).view(rows, Mb)
    pos = torch.arange(position, position + rows, dtype=torch.int32,
                       device=dev)
    feed = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, rows).astype(np.int32)).to(dev)
    ones = torch.ones(rows, dtype=torch.bool, device=dev)
    report = {"rows": rows, "positions": "%d..%d" % (position,
                                                     position + rows - 1)}
    for label, model in (("fp32", fp32), ("int8", fp32.quantized())):
        def step():
            return model.decode_step(pool.k, pool.v, feed, ones, feed, pos,
                                     tables, ones)

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step().cpu()
            wall = time.perf_counter() - t0
        busy_s, top = kernel_times(prof, 1, top=10)
        report[label] = {"wall_ms": wall * 1e3,
                         "device_busy_ms": busy_s * 1e3,
                         "device_busy_share": busy_s / wall,
                         "top_kernels": top}
    report["int8_over_fp32_device_ms"] = (report["int8"]["device_busy_ms"]
                                          / report["fp32"]["device_busy_ms"])
    print("int8_step_profile " + json.dumps(report), flush=True)
    del pool
    return report


def chunk_step_profile(torch, model):
    """Where the time of one prefill-chunk step goes: ``prefill_step`` at
    the fast path's shape (8 rows, C=64, each row's fourth chunk of the
    shared prefix: positions 192..255) under torch.profiler, tracing the
    card only: the host's wall time, the device's busy time and share,
    K2's device time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import KVBlockPool, blocks_needed

    cfg = model.config
    B, bs, C = FAST["max_batch"], FAST["block_size"], FAST["chunk"]
    Mb = blocks_needed(cfg.max_seq_len, bs)
    pool = KVBlockPool(cfg.n_layers, cfg.n_heads, cfg.head_dim, bs, B * Mb,
                       device=model.device)
    dev = model.device
    rng = np.random.RandomState(5)
    pos = torch.full((B,), 3 * C, dtype=torch.int32, device=dev)
    tables = torch.arange(1, B * Mb + 1, dtype=torch.int32,
                          device=dev).view(B, Mb)
    feed = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, C))
                            .astype(np.int32)).to(dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    lengths = torch.full((B,), C, dtype=torch.int32, device=dev)
    prev = torch.zeros(B, dtype=torch.int32, device=dev)

    def step():
        return model.prefill_step(pool.k, pool.v, feed, ones, prev, pos,
                                  lengths, tables, ones)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step().cpu()
        wall = time.perf_counter() - t0
    busy_s, top = kernel_times(prof, 1, top=10)
    k2_ms = sum(device_us(e) for e in prof.key_averages()
                if "paged_attention_kernel" in e.key) / 1e3
    report = {"rows": B, "C": C, "positions": "%d..%d" % (3 * C, 4 * C - 1),
              "wall_ms": wall * 1e3, "device_busy_ms": busy_s * 1e3,
              "device_busy_share": busy_s / wall,
              "paged_attention_ms": k2_ms,
              "paged_attention_ms_per_layer": k2_ms / cfg.n_layers,
              "top_kernels": top}
    print("chunk_step_profile " + json.dumps(report), flush=True)
    del pool
    return report


def spec_tree_profile(torch, model, tree=(2, 6)):
    """Where the time of one tree verify window goes: ``spec_tree_step``
    at the tree leg's shape (8 rows, C=13, positions 12..54, as the
    spec traffic's rows sit) under torch.profiler, tracing the card
    only: the host's wall time of the window, the device's busy time and
    share, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import KVBlockPool, blocks_needed

    cfg = model.config
    B, bs = SPEC["max_batch"], SPEC["block_size"]
    C = 1 + tree[0] * tree[1]
    Mb = blocks_needed(cfg.max_seq_len, bs)
    pool = KVBlockPool(cfg.n_layers, cfg.n_heads, cfg.head_dim, bs, B * Mb,
                       device=model.device)
    dev = model.device
    rng = np.random.RandomState(3)
    pos = torch.tensor(12 + 6 * np.arange(B), dtype=torch.int32, device=dev)
    tables = torch.arange(1, B * Mb + 1, dtype=torch.int32,
                          device=dev).view(B, Mb)
    feed = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, C))
                            .astype(np.int32)).to(dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    lengths = torch.full((B,), C, dtype=torch.int32, device=dev)
    prev = torch.zeros(B, dtype=torch.int32, device=dev)

    def window():
        return model.spec_tree_step(pool.k, pool.v, feed, ones, prev, pos,
                                    lengths, tables, ones, tree)

    window()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = window()
        out.cpu()
        wall = time.perf_counter() - t0
    busy_s, top = kernel_times(prof, 1, top=10)
    report = {"window": "%dx%d" % tree, "rows": B, "C": C,
              "wall_ms": wall * 1e3, "device_busy_ms": busy_s * 1e3,
              "device_busy_share": busy_s / wall, "top_kernels": top}
    print("spec_tree_profile " + json.dumps(report), flush=True)
    del pool
    return report


def flash_inputs(torch, B, H, Tq, Tk, dtype, seed, Dh=64, packed=False):
    """q, k, v and an upstream grad dO as [B, H, T, Dh] views of
    [B, T, H, Dh] tensors (the layout the fused attention op hands the
    kernel), from a seeded generator on the card. With `packed` (Tq ==
    Tk), q, k and v are views of one [B, T, 3, H, Dh] tensor instead,
    the native flagship's QKV GEMM output (T stride 3·H·Dh)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def make(T, *mid):
        t = torch.randn(B, T, *mid, H, Dh, device="cuda", generator=gen)
        return t.to(dt)

    if packed:
        q, k, v = (t.transpose(1, 2) for t in make(Tq, 3).unbind(2))
        return q, k, v, make(Tq).transpose(1, 2)
    return tuple(make(T).transpose(1, 2) for T in (Tq, Tk, Tk, Tq))


def flash_counts(fa):
    """K1's launches by route, forward and backward, and its copies."""
    return (dict(fa.flash_attention_fwd.launches_by_route),
            dict(fa.flash_attention_bwd.launches_by_route),
            fa.flash_attention_fwd.copies + fa.flash_attention_bwd.copies)


def flash_check(torch, fa, B, H, Tq, Tk, causal, dtype, seed=0, Dh=64,
                packed=False):
    """K1's kernels against the plain version's forward and autograd on
    the same inputs; the call must go by its dtype's routes (bf16: "tc"
    both ways; fp32: "f32tc" both ways) without copying an operand, but
    for a head dim the kernels run padded (q, k, v and dO padded: 4
    copies); `packed` as ``flash_inputs``. Returns (inputs, max abs
    errors, shape label)."""
    q, k, v, g = flash_inputs(torch, B, H, Tq, Tk, dtype, seed, Dh, packed)
    f_route, b_route = FLASH_ROUTES[dtype]
    want_copies = 0 if fa.kernel_head_dim(Dh) == Dh else 4
    fwd0, bwd0, copies0 = flash_counts(fa)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, g)
    fwd1, bwd1, copies1 = flash_counts(fa)
    if (fwd1[f_route] - fwd0[f_route], bwd1[b_route] - bwd0[b_route],
            copies1 - copies0) != (1, 1, want_copies):
        fail("flash_attention %s Dh=%d: launches by route went from %r / %r "
             "to %r / %r, copies %d to %d (expected one %s forward and one "
             "%s backward launch, %d copies)"
             % (dtype, Dh, fwd0, bwd0, fwd1, bwd1, copies0, copies1,
                f_route, b_route, want_copies))
    ref_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    torch.cuda.synchronize()
    shape = "B=%d H=%d Tq=%d Tk=%d Dh=%d causal=%s %s, routes %s/%s%s" % (
        B, H, Tq, Tk, Dh, causal, dtype, f_route, b_route,
        ", q k v packed [B,T,3,H,Dh]" if packed else "")
    errs, report = {}, []
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                               (ref,) + ref_grads):
        atol, rtol = FLASH_TOL[dtype]["out" if name == "out" else "grads"]
        if got.dtype != q.dtype:
            fail("flash_attention %s: %s came back as %s"
                 % (dtype, name, got.dtype))
        got, want = got.detach().float(), want.detach().float()
        if not torch.isfinite(got).all():
            fail("flash_attention %s: non-finite %s" % (dtype, name))
        diff, mag = (got - want).abs(), want.abs()
        errs[name] = float(diff.max())
        ratio = float((diff / (atol + rtol * mag)).max())
        report.append("%s %.3g (%.3f of limit %g + %g|want|; |want| mean "
                      "%.3g, max %.3g)" % (name, errs[name], ratio, atol,
                                           rtol, float(mag.mean()),
                                           float(mag.max())))
        if ratio > 1:
            fail("flash_attention %s: %s disagrees with the plain version: "
                 "max abs err %.3g, %.3f of its limit %g + %g|want|"
                 % (shape, name, errs[name], ratio, atol, rtol))
    print("kernel flash_attention %s: max_abs_err %s" % (
        shape, "; ".join(report)), flush=True)
    return (q, k, v, g), errs, shape


def flash_bound_ms(B, H, T, Dh, elem_bytes, fwd, flops_per_s, products=1):
    """Least time for the work: each input read once and each output
    written once over the memory rate (forward: q, k, v in, o and the
    fp32 lse out; backward: q, k, v, o, dO and lse in, dq, dk, dv out),
    against the products over `flops_per_s` (the bf16 or TF32 tensor
    cores' or the fp32 SIMT rate), counting the T(T+1)/2 visible (query,
    key) pairs of causal attention per (b, h): forward QK^T and PV, 4 Dh
    flops a pair; backward QK^T, dO V^T, P^T dO, dS^T Q and dS K, 10 Dh
    flops a pair; each product done `products` times (3xTF32: 3)."""
    n = B * H * T * Dh * elem_bytes
    lse = B * H * T * 4
    nbytes = 4 * n + lse if fwd else 8 * n + lse
    pairs = B * H * T * (T + 1) // 2
    flops = (4 if fwd else 10) * Dh * pairs * products
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_phase(torch, fa):
    """K1 checked on small cases, then checked and timed at each path's
    shape, by route: head dim 64 in bf16 at the training path's B=160
    and at the native flagship's B=192 with its packed q, k, v, in fp32
    at the int8 path's B=32 (the forward's path; the fp32 backward's
    path is phase 7 at B=2, also checked and timed); head dim
    128 at the timing shapes bf16 B=80 and fp32 B=32 and at phase 6b's
    own B=WIDE_BATCH; fp16 (the "fp16" route) at head dim 64 at the
    amp_fp16 bench leg's B=160 and at 128 as bf16 (B=80, and phase 6b's
    B=WIDE_BATCH); head dim 256 at phase 6c's own shape; head dims 96
    and 192 through the pad and cross-attention cases checked; the fp32
    backward run twice on the same inputs, bitwise equal. Returns the
    kernels-line rows by name, each forward and backward kernel of each
    route and head dim (`path_*` keys: the path's shape where the row's
    ms is at another), and the rows of the wide kernels (head dims 512
    and 320, on no model's path)."""
    import torch.nn.functional as F

    flash_check(torch, fa, 4, 8, 512, 512, True, "float32", seed=1)
    flash_check(torch, fa, 16, 8, 128, 256, False, "bfloat16", seed=2)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = flash_timed_rows(torch, fa, F, flush, "bfloat16", 160, 64, 3)
    flash_path(rows, flash_timed_rows(torch, fa, F, flush, "bfloat16",
                                      NATIVE_BATCH, 64, 21, packed=True),
               ("flash_attention_tc_fwd", "flash_attention_tc_bwd"))
    rows.update(flash_timed_rows(torch, fa, F, flush, "float32",
                                 INT8["batch"], 64, 4))
    flash_path(rows, flash_timed_rows(torch, fa, F, flush, "float32", 2, 64,
                                      10), ("flash_attention_f32tc_bwd",))
    flash_deterministic(torch, fa, INT8["batch"], 64, 4)
    for dtype, seed in (("bfloat16", 8), ("float32", 9)):
        flash_check(torch, fa, 4, 8, 128, 256, False, dtype, seed=6, Dh=128)
        flash_check(torch, fa, 2, 8, 256, 256, True, dtype, seed=7, Dh=96)
        timed = flash_timed_rows(torch, fa, F, flush, dtype,
                                 80 if dtype == "bfloat16" else 32, 128, seed)
        flash_path(timed, flash_timed_rows(torch, fa, F, flush, dtype,
                                           WIDE_BATCH, 128, seed + 10),
                   timed)
        rows.update(timed)
    # fp16 (F3): at head dim 64 at the amp_fp16 bench leg's B=160, at 128
    # at bf16's timing shape B=80 and at phase 6b's fp16 leg's B=8;
    # cross-attention and a padded head dim checked
    flash_check(torch, fa, 16, 8, 128, 256, False, "float16", seed=16)
    flash_check(torch, fa, 2, 8, 256, 256, True, "float16", seed=17, Dh=96)
    rows.update(flash_timed_rows(torch, fa, F, flush, "float16", 160, 64,
                                 18))
    timed = flash_timed_rows(torch, fa, F, flush, "float16", 80, 128, 19)
    flash_path(timed, flash_timed_rows(torch, fa, F, flush, "float16",
                                       WIDE_BATCH, 128, 20), timed)
    rows.update(timed)
    for dtype in ("bfloat16", "float32"):
        flash_check(torch, fa, 2, 4, 256, 512, False, dtype, seed=11,
                    Dh=256)
        flash_check(torch, fa, 2, 4, 512, 512, True, dtype, seed=12, Dh=192)
        rows.update(flash_timed_rows(torch, fa, F, flush, dtype,
                                     WIDE256_BATCH, 256, 13))
    wide = {}
    for dtype in ("bfloat16", "float32"):
        wide.update(flash_timed_rows(torch, fa, F, flush, dtype, 2, 512, 14))
        wide.update(flash_timed_rows(torch, fa, F, flush, dtype, 2, 320, 15))
    flash_deterministic(torch, fa, 2, 512, 14)
    print("flash_wide_heads " + json.dumps(list(wide.values())), flush=True)
    return rows


def flash_deterministic(torch, fa, B, Dh, seed, H=8, T=512):
    """Two calls of the fp32 backward on the same inputs (B, H, T, causal,
    head dim Dh) must give bitwise-equal dq, dk, dv: the passes sum in a
    fixed order, with no atomics."""
    q, k, v, g = flash_inputs(torch, B, H, T, T, "float32", seed, Dh)
    scale = Dh ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    first = fa.flash_attention_bwd(q, k, v, o, lse, g, True, scale)
    again = fa.flash_attention_bwd(q, k, v, o, lse, g, True, scale)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(("dq", "dk", "dv"), first, again)
              if not torch.equal(a, b)]
    if differ:
        fail("flash_attention fp32 backward at B=%d Dh=%d: two calls on the "
             "same inputs differ in %s" % (B, Dh, differ))
    print("kernel flash_attention fp32 backward B=%d H=%d T=%d Dh=%d: two "
          "calls bitwise equal" % (B, H, T, Dh), flush=True)


def flash_path(rows, path_rows, names):
    """Set the `path_*` keys of rows[name] from the same kernel's row at
    its path's shape, for each of `names`."""
    for name in names:
        p = path_rows[name]
        rows[name].update(path_shape=p["shape"], path_ms=p["ms"],
                          path_max_abs_err=p["max_abs_err"],
                          path_bound_ms=p["bound_ms"],
                          path_plain_ms=p["plain_ms"],
                          path_library_ms=p["library_ms"])


def flash_timed_rows(torch, fa, F, flush, dtype, B, Dh, seed, H=8, T=512,
                     packed=False):
    """K1's forward and backward kernels of `dtype`'s routes at B, H=8,
    T=512, causal, head dim `Dh`, through the strided views the fused op
    (or with `packed` the native flagship) hands them: checked against
    the plain version, then kernel, plain version and SDPA (the library
    yardstick, on contiguous copies, in the same dtype) timed each way,
    and the bounds. Returns the two kernels-line rows by name."""
    (q, k, v, g), errs, shape = flash_check(torch, fa, B, H, T, T, True,
                                            dtype, seed=seed, Dh=Dh,
                                            packed=packed)
    scale = Dh ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    ms_fwd = time_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, True, scale), flush, iters=10)
    ms_bwd = time_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, g, True, scale), flush, iters=10)
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, True, scale), flush, iters=5)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_reference(*leaves, causal=True)
    plain_bwd = time_ms(torch, lambda: torch.autograd.grad(
        ref, leaves, g, retain_graph=True), flush, iters=5)
    del ref
    lib = [t.contiguous().detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        *lib, is_causal=True), flush, iters=10)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, lib, g, retain_graph=True), flush, iters=10)
    lib_err = float((lib_out.detach().float() - o.float()).abs().max())
    print("kernel flash_attention %s: fwd %.4f ms, bwd %.4f ms (plain "
          "fwd %.4f, bwd %.4f ms; SDPA fwd %.4f, bwd %.4f ms; factor to "
          "SDPA fwd %.2f, bwd %.2f; max |SDPA - kernel| %.3g)"
          % (shape, ms_fwd, ms_bwd, plain_fwd, plain_bwd, lib_fwd, lib_bwd,
             ms_fwd / lib_fwd, ms_bwd / lib_bwd, lib_err), flush=True)
    elem = 4 if dtype == "float32" else 2
    suffix = "" if Dh == 64 else "_dh%d" % Dh
    rows = {}
    for fwd, route, ms, plain, library, err in (
            (True, FLASH_ROUTES[dtype][0], ms_fwd, plain_fwd, lib_fwd,
             errs["out"]),
            (False, FLASH_ROUTES[dtype][1], ms_bwd, plain_bwd, lib_bwd,
             max(errs["dq"], errs["dk"], errs["dv"]))):
        rate, products = {"tc": (H100_BF16_FLOPS, 1),
                          "fp16": (H100_FP16_FLOPS, 1),
                          "f32tc": (H100_TF32_FLOPS, 3)}[route]
        bound_ms, bound_by = flash_bound_ms(B, H, T, Dh, elem, fwd, rate,
                                            products)
        name = "flash_attention_%s_%s%s" % (route, "fwd" if fwd else "bwd",
                                            suffix)
        rows[name] = {
            "name": name, "route": "cuda", "kernel_route": route,
            "head_dim": Dh, "dtype": dtype,
            "source": "paddle_tpu_torch/csrc/%s.cu" % (
                "flash_attention_tc" if route in ("tc", "fp16")
                else "flash_attention_f32tc" if fwd
                else "flash_attention_f32tc_bwd"),
            "replaces": ("paddle_tpu/ops/pallas_kernels.py:162" if fwd
                         else "paddle_tpu/ops/pallas_kernels.py:212"),
            "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rate": {"tc": "bf16 tensor cores, 989 TFLOP/s",
                           "fp16": "fp16 tensor cores, 989 TFLOP/s",
                           "f32tc": "TF32 tensor cores, 494.7 TFLOP/s, 3 "
                                    "products (3xTF32)"}[route],
            "library_ms": library, "factor_to_library": ms / library,
            "library": "F.scaled_dot_product_attention(is_causal=True) %s "
                       "in %s on contiguous copies (yardstick)"
                       % ("forward" if fwd else "backward", dtype)}
        if route == "f32tc":
            rows[name]["simt_rate_bound_ms"] = flash_bound_ms(
                B, H, T, Dh, elem, fwd, H100_FP32_FLOPS)[0]
        print("kernel %s: bound %.4f ms by %s" % (name, bound_ms, bound_by))
    del q, k, v, g, o, lse, leaves, lib, lib_out
    torch.cuda.empty_cache()
    return rows


TRAIN = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
             d_ff=2048, seq_len=512)


# the flagship widened to head dim 128 (d_model 1024 over 8 heads, the
# head width of Llama-family decoders), depth cut to 2 layers: the path
# of K1's Dh-128 kernels
WIDE = dict(TRAIN, d_model=1024, d_ff=4096, n_layers=2)
WIDE_BATCH = 8
# head dim 256 (d_model 2048 over 8 heads, the head width of Gemma-family
# decoders), depth cut to 2 layers: the path of K1's Dh-256 kernels
WIDE256 = dict(TRAIN, d_model=2048, d_ff=8192, n_layers=2)
WIDE256_BATCH = 4


def build_lm(fluid, dtype="bfloat16", cfg=None):
    """bench.py's headline program through the port's entry points (bf16
    under the legacy AMP decorator), or the same model in fp32 with plain
    SGD, or (dtype "float16") the fp32-stored model under
    ``amp.decorate(dtype="float16")`` (dynamic loss scaling); `cfg` the
    model's widths (default TRAIN)."""
    from paddle_tpu_torch.models import transformer_fluid

    cfg = TRAIN if cfg is None else cfg

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _, _, loss = transformer_fluid.build(
            remat=False, dtype="float32" if dtype == "float16" else dtype,
            **cfg)
        opt = fluid.optimizer.SGD(0.01)
        if dtype == "float16":
            opt = fluid.amp.decorate(opt, dtype="float16")
        elif dtype == "bfloat16":
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    return main, startup, loss


def lm_feed(torch, batch, device, seed=0, cfg=None):
    """bench.py's fixed batch: RandomState(0) tokens, labels shifted
    (another seed: another batch of the same kind); `cfg` the model's
    widths (default TRAIN)."""
    cfg = TRAIN if cfg is None else cfg
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg["vocab_size"],
                       (batch, cfg["seq_len"])).astype(np.int32)
    labs = np.roll(toks, -1, axis=1).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labs).to(device)}


def training_phase(torch, fa, fluid, program):
    from torch.profiler import ProfilerActivity, profile

    main, startup, loss = program
    batch, warmup, steps = 160, 3, 10
    exe = fluid.Executor()                     # place None: cuda:0
    if exe.device.type != "cuda":
        fail("the executor resolved to %s, not the card" % exe.device)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = lm_feed(torch, batch, exe.device)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()                          # main path starts
    losses, marks, host_ms = [], [], []
    for i in range(warmup + steps):
        if i == warmup:
            # the earlier phases' garbage (profiler traces, engines) is
            # collected here, not by a pause inside a timed step
            tg = time.perf_counter()
            gc.collect()
            gc_ms = (time.perf_counter() - tg) * 1e3
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        if i >= warmup:                        # each timed step's start
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        host_ms.append((time.perf_counter() - th) * 1e3)
        losses.append(out)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    clocks = gpu_clocks()                      # outside the timed window
    launches = (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd.launches)  # main path ends
    fwd_routes, bwd_routes, copies = flash_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x.float().cpu()[0]) for x in losses]
    n = warmup + steps
    if not all(np.isfinite(losses)):
        fail("training: non-finite loss %r" % losses)
    if not losses[-1] < losses[0]:
        fail("training: the loss did not fall: %r" % losses)
    want = TRAIN["n_layers"] * n
    if launches != (want, want):
        fail("training: flash attention launched %d forward / %d backward "
             "times over %d steps (expected %d each)"
             % (launches + (n, want)))
    tc_only = dict(dict.fromkeys(fwd_routes, 0), tc=want)
    if (fwd_routes, bwd_routes, copies) != (tc_only, tc_only, 0):
        fail("training: flash attention went by routes %r forward / %r "
             "backward with %d operand copies (expected %r each, none)"
             % (fwd_routes, bwd_routes, copies, tc_only))
    step_s = (t2 - t1) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tp = time.perf_counter()
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tp
    busy_s, top = kernel_times(prof, 2, top=10)
    # K1's kernels by name ("void (anonymous namespace)::flash_tc_...")
    k1_ms = {part: sum(device_us(e) for e in prof.key_averages()
                       if any(n in e.key for n in names)) / 1e3 / 2
             for part, names in (("fwd", ("flash_tc_fwd",)),
                                 ("bwd", ("flash_tc_delta", "flash_tc_dkdv",
                                          "flash_tc_dq")))}
    summary = {
        "model": "Fluid-API Transformer LM: vocab 32000, d_model 512, 8 "
                 "heads, 6 layers, d_ff 2048, seq 512, bf16, legacy AMP, "
                 "SGD(0.01)",
        "batch": batch, "warmup_steps": warmup, "timed_steps": steps,
        "startup_s": startup_s, "losses": losses, "ms_per_step": step_s * 1e3,
        "step_ms_each": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
        "host_ms_each": host_ms[warmup:],
        "gc_collect_ms_before_timed_steps": gc_ms,
        "clocks_after_timed_steps": clocks,
        "tokens_per_s": batch * TRAIN["seq_len"] / step_s,
        "flash_attention_launches": {"fwd": launches[0],
                                     "bwd": launches[1], "steps": n,
                                     "fwd_by_route": fwd_routes,
                                     "bwd_by_route": bwd_routes,
                                     "copies": copies},
        "max_memory_allocated_gib": peak / 2 ** 30}
    print("training " + json.dumps(summary), flush=True)
    print("training_profile " + json.dumps({
        "steps": 2, "wall_ms_per_step": wall * 1e3 / 2,
        "device_busy_ms_per_step": busy_s * 1e3 / 2,
        "device_busy_share": busy_s / wall,
        "flash_attention_ms_per_step": dict(k1_ms, total=sum(k1_ms.values())),
        "top_kernels": top}), flush=True)
    return launches


def wide_head_phase(torch, fa, fluid, cfg=WIDE, batch=WIDE_BATCH, steps=5,
                    fp16=False):
    """K1's path at a wider head (cfg's d_model over its heads), in three
    legs: the LM trained `steps` bf16 AMP steps on cuda:0, its fp32
    program's inference clone run `steps` steps, and the fp32 program
    trained `steps` steps with SGD; with `fp16` a fourth, the fp32-stored
    LM trained `steps` steps under ``amp.decorate(dtype="float16")``.
    Every loss finite, the training losses falling; flash attention
    launched once a layer a step by its routes: "tc" both ways in bf16
    training, "f32tc" forward only in inference, "f32tc" both ways in
    fp32 training, "fp16" both ways in fp16 training; no operand copied.
    Each leg's counts are zeroed before it and read after it. The fp32
    training leg then runs one step under torch.profiler for K1's device
    ms. Returns the launches by kernel ("tc_fwd", "tc_bwd", "f32tc_fwd"
    summed over both fp32 legs, "f32tc_bwd", and "fp16_fwd",
    "fp16_bwd")."""
    from torch.profiler import ProfilerActivity, profile

    exe = fluid.Executor()                     # place None: cuda:0
    L = cfg["n_layers"]
    Dh = cfg["d_model"] // cfg["n_heads"]
    n = L * steps
    legs = (("bfloat16", False, "bf16 training, legacy AMP, SGD(0.01)",
             ("tc", n), ("tc", n)),
            ("float32", True, "fp32 inference clone", ("f32tc", n),
             ("f32tc", 0)),
            ("float32", False, "fp32 training, SGD(0.01)", ("f32tc", n),
             ("f32tc", n)))
    if fp16:
        legs += (("float16", False, "fp16 training, amp.decorate(dtype="
                  "'float16'), SGD(0.01)", ("fp16", n), ("fp16", n)),)
    total = {}
    for dtype, for_test, label, (f_route, f_n), (b_route, b_n) in legs:
        main, startup, loss = build_lm(fluid, dtype, cfg)
        prog = main.clone(for_test=True) if for_test else main
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        feed = lm_feed(torch, batch, exe.device)
        torch.cuda.synchronize()
        fa.reset_counts()                      # the leg starts
        t0 = time.perf_counter()
        losses = [exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = flash_counts(fa)              # the leg ends
        losses = [float(x.float().cpu()[0]) for x in losses]
        if not all(np.isfinite(losses)):
            fail("head dim %d %s: non-finite loss %r" % (Dh, label, losses))
        if not for_test and not losses[-1] < losses[0]:
            fail("head dim %d %s: the loss did not fall: %r"
                 % (Dh, label, losses))
        zero = dict.fromkeys(counts[0], 0)
        want = (dict(zero, **{f_route: f_n}), dict(zero, **{b_route: b_n}),
                0)
        if counts != want:
            fail("head dim %d %s: flash attention launched %r (forward, "
                 "backward by route; copies) over %d steps; expected %r"
                 % (Dh, label, counts, steps, want))
        for key, c in (("%s_fwd" % f_route, counts[0][f_route]),
                       ("%s_bwd" % b_route, counts[1][b_route])):
            total[key] = total.get(key, 0) + c
        k1_ms = None
        if dtype == "float32" and not for_test:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                        return_numpy=False)
                torch.cuda.synchronize()
            # K1's kernels by name ("void (anonymous namespace)::flash_...")
            k1_ms = {part: sum(device_us(e) for e in prof.key_averages()
                               if any(k in e.key for k in names)) / 1e3
                     for part, names in (
                         ("fwd", ("flash_f32tc_fwd",)),
                         ("bwd", ("flash_f32tc_delta", "flash_f32tc_bwd")))}
        print("wide_head %s" % json.dumps({
            "model": "Fluid-API Transformer LM: vocab %d, d_model %d, %d "
                     "heads (head dim %d), %d layers, d_ff %d, seq %d"
                     % (cfg["vocab_size"], cfg["d_model"], cfg["n_heads"],
                        Dh, L, cfg["d_ff"], cfg["seq_len"]),
            "program": label, "batch": batch, "steps": steps,
            "losses": losses, "ms_per_step_first_included": ms,
            "flash_attention_launches": counts,
            "flash_attention_device_ms_one_profiled_step": k1_ms}),
            flush=True)
        del main, startup, prog, scope, feed
        torch.cuda.empty_cache()
    return total


# the bench legs phase: paddle_tpu_torch.bench.bench_transformer_fluid at
# bench.py's defaults (full width, batch 160, seq 512, 3 warm-up and 24
# timed steps), one call a leg: (name, keyword arguments, K1's route)
BENCH_LEGS = (
    ("async", dict(async_exec=True), "tc"),
    ("sync", dict(async_exec=False), "tc"),
    ("noopt", dict(async_exec=False, program_opt=False), "tc"),
    ("fp32", dict(async_exec=False, dtype="float32", amp=False), "f32tc"),
    ("amp", dict(async_exec=False, dtype="float32", amp=True), "tc"),
    ("amp_fp16", dict(async_exec=False, dtype="float32", amp="float16"),
     "fp16"),
)
# amp.decorate(dtype="float16")'s dynamic loss scaling: (initial scale,
# incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio)
AMP_FP16_SCALING = (2.0 ** 15, 1000, 2, 2.0, 0.5)


def loss_scaling_after(found_inf, init, incr_every, decr_every, incr_ratio,
                       decr_ratio):
    """(scale, good steps, bad steps) after the update_loss_scaling state
    machine (the JAX op, paddle_tpu/ops/quant_ops.py:177) saw the
    overflow flags `found_inf`, in fp32 as the op computes."""
    scale, good, bad = np.float32(init), 0, 0
    for inf in found_inf:
        good, bad = (0, bad + 1) if inf else (good + 1, 0)
        if not inf and good >= incr_every:
            scale, good = np.float32(scale * np.float32(incr_ratio)), 0
        elif inf and bad >= decr_every:
            scale = max(np.float32(scale * np.float32(decr_ratio)),
                        np.float32(1.0))
            bad = 0
    return float(scale), float(good), float(bad)


def pass_counts(metrics):
    return {k: v for k, v in metrics.registry().to_dict()["counters"].items()
            if k.startswith(("compiler/", "amp/"))}


def cpu_pass_counts(fluid, bench, metrics, kw):
    """The compiler/* and amp/* counts of the pass pipeline on the leg's
    programs (startup and main, fetching the loss), optimized on the CPU:
    what the tests pin for the same program at TINY widths."""
    from paddle_tpu_torch import ir_passes

    main, startup, loss, _ = bench.build_program(
        512, kw.get("dtype", "bfloat16"), kw.get("amp", "legacy"))
    metrics.reset()
    scope = fluid.Scope()
    ir_passes.optimize_for_execution(startup, [], scope, "cpu")
    ir_passes.optimize_for_execution(main, [loss.name], scope, "cpu")
    return pass_counts(metrics)


def bench_phase(torch, fa, fluid):
    """bench.py's training legs through ``paddle_tpu_torch.bench.
    bench_transformer_fluid`` on cuda:0 (BENCH_LEGS). Each leg zeroes
    K1's counts and the metrics before it and reads them after it; it
    fails unless every loss is finite and the loss fell over the leg, K1
    ran 6 forward and 6 backward launches a step by the leg's route with
    no operand copied, the pass counters equal the pipeline's on the CPU
    for the same program (none at all on the noopt leg), the async leg's
    window reached its 12 steps, and the amp_fp16 leg's loss scale and
    counters equal what update_loss_scaling gives for the overflows it
    saw. The fp32 leg runs at the largest batch of 160 / 2^k that fits
    (printed). Returns K1's launches by route over the legs."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.observability import metrics

    L = TRAIN["n_layers"]
    steps, warmup = 24, 3
    launches = {}
    metrics.enable()
    for name, kw, route in BENCH_LEGS:
        want_counts = {} if kw.get("program_opt") is False \
            else cpu_pass_counts(fluid, bench, metrics, kw)
        batch = 160
        while True:
            gc.collect()
            torch.cuda.empty_cache()
            metrics.reset()
            fa.reset_counts()                  # the leg starts
            try:
                tps, last, step_s, compile_s = bench.bench_transformer_fluid(
                    steps=steps, warmup=warmup, batch=batch, **kw)
                break
            except torch.cuda.OutOfMemoryError:
                if name != "fp32" or batch == 1:
                    raise
                batch //= 2
        counts = flash_counts(fa)              # the leg ends
        got_counts = pass_counts(metrics)
        stats = dict(bench.last_leg)
        losses = stats["losses"]
        n = L * (steps + warmup)
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            fail("bench %s: losses not finite and falling: %r"
                 % (name, losses))
        zero = dict.fromkeys(counts[0], 0)
        want = (dict(zero, **{route: n}), dict(zero, **{route: n}), 0)
        if counts != want:
            fail("bench %s: flash attention launched %r (forward, backward "
                 "by route; copies) over %d steps; expected %r"
                 % (name, counts, steps + warmup, want))
        if got_counts != want_counts:
            fail("bench %s: pass counters %r, the pipeline on the CPU gives "
                 "%r for the same program" % (name, got_counts,
                                              want_counts))
        if name == "async" and stats["window_peak"] != 12:
            fail("bench async: the in-flight window peaked at %d steps, "
                 "not its 12" % stats["window_peak"])
        scaling = stats.get("scaling")
        if name == "amp_fp16":
            want_s = loss_scaling_after(stats["found_inf"],
                                        *AMP_FP16_SCALING)
            got_s = (scaling["loss_scale"], scaling["good_steps"],
                     scaling["bad_steps"])
            if got_s != want_s:
                fail("bench amp_fp16: loss scale and good / bad steps %r "
                     "after overflows %r; update_loss_scaling gives %r"
                     % (got_s, stats["found_inf"], want_s))
        launches[route] = launches.get(route, 0) + counts[0][route]
        print("bench_leg " + json.dumps({
            "leg": name, "batch": batch, "steps": steps, "warmup": warmup,
            "tokens_per_s": tps, "ms_per_step": step_s * 1e3,
            "device_ms_per_step": float(np.mean(stats["step_ms"])),
            "host_ms_per_step": float(np.mean(stats["host_ms"])),
            "step_ms_each": stats["step_ms"],
            "host_ms_each": stats["host_ms"],
            "compile_time_s": compile_s, "last_loss": last,
            "first_loss": losses[0],
            "peak_gib": stats["peak_bytes"] / 2 ** 30,
            "flash_attention_launches": counts,
            "window_peak": stats["window_peak"],
            "pass_counters": got_counts,
            "found_inf": stats.get("found_inf"), "scaling": scaling}),
            flush=True)
    metrics.reset()
    metrics.disable()
    return launches


def ulp(x, mantissa_bits):
    """The spacing of floats with `mantissa_bits` stored fraction bits
    (bf16 7, fp32 23) at |x|."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - mantissa_bits).astype(np.float32)


# card vs CPU limits: losses to loss_rtol; step 1's grad of every
# parameter to grad_rtol of that tensor's largest grad plus a floor of
# floor_rel of the largest grad of any parameter (the floor covers grads
# that are zero in exact arithmetic, such as the attention key bias,
# where both devices return rounding noise); after step 2 every element
# of every parameter to 2 ulps of the largest magnitude it takes (a
# sub-ulp update may round the other way once a step) plus what the grad
# limit lets two SGD steps move it, 2 lr (grad_rtol max|grad| + floor).
# bf16: GEMMs and reductions round in other places on the two devices,
# and the kernel's backward uses the bf16-rounded O. fp32: only the
# summation order differs (TF32 is off).
STEP_TOL = {
    "bfloat16": dict(loss_rtol=2e-3, grad_rtol=5e-2, floor_rel=1e-3,
                     mantissa_bits=7),
    "float32": dict(loss_rtol=1e-5, grad_rtol=1e-3, floor_rel=1e-7,
                    mantissa_bits=23),
}


def card_vs_cpu_phase(torch, fluid, program, dtype,
                      devices=("cuda:0", "cpu")):
    """Two SGD steps of the same program from the same weights on cuda:0
    (the kernels) and on the CPU (the plain versions), batch 2, held to
    STEP_TOL[dtype]. Also reads what the parameter check would have said
    had the card skipped its updates (the card's parameters left at
    their start): in fp32 that reading must fail the check on most
    parameters, or the check could not see a lost update. `devices` is
    (card, reference); the tests pass two CPUs and plant faults in the
    first. Returns K1's launches in the run (forward and backward by
    route; copies): the card's, the CPU route counting none."""
    from paddle_tpu_torch.ops import flash_attention as fa

    main, startup, loss = program
    if dtype == "float32" and torch.backends.cuda.matmul.allow_tf32:
        fail("card vs CPU fp32: TF32 matmuls are on; the limits assume "
             "fp32 products")
    tol = STEP_TOL[dtype]
    lr, rel, bits = 0.01, tol["grad_rtol"], tol["mantissa_bits"]
    params = sorted(main.param_grad_map)
    fetch = [loss] + [main.param_grad_map[p] for p in params]
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    for n in scope_c.local_var_names():
        if n != "__step_counter__":
            scope_h.set(n, scope_c.get(n).to("cpu", copy=True))
    # a copy: sgd updates the scope's tensors in place, and .float() of
    # an fp32 tensor is the tensor itself
    start = {p: scope_h.get(p).float().numpy().copy() for p in params}
    t0 = time.perf_counter()
    fa.reset_counts()                          # the path starts
    runs = []
    for exe, scope in ((exe_c, scope_c), (exe_h, scope_h)):
        feed = lm_feed(torch, 2, exe.device)
        first = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        second, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        runs.append(([float(first[0][0]), float(second[0])],
                     dict(zip(params, first[1:]))))
    seconds = time.perf_counter() - t0
    k1 = flash_counts(fa)                      # the path ends
    (lc, gc), (lh, gh) = runs
    loss_rel = float(np.abs(np.array(lc) - np.array(lh)).max()
                     / np.abs(lh).max())
    floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                   for g in gh.values())
    worst_g, worst_p = (0.0, ""), (-np.inf, "")
    worst_skip, skip_caught = -np.inf, 0
    for p in params:
        g_lim = rel * float(np.abs(gh[p]).max()) + floor
        ratio = float(np.abs(gc[p] - gh[p]).max()) / g_lim
        worst_g = max(worst_g, (ratio, p))
        pc = scope_c.get(p).float().cpu().numpy()
        ph = scope_h.get(p).float().numpy()
        # each step rounds once, at most at the largest of the magnitudes
        mag = np.maximum(np.maximum(np.abs(pc), np.abs(ph)),
                         np.abs(start[p]))
        slack, p_lim = 2 * ulp(mag, bits), 2 * lr * g_lim
        excess = (np.abs(pc - ph) - slack) / p_lim
        i = int(np.argmax(excess))
        worst_p = max(worst_p, (float(excess.flat[i]), p, float(pc.flat[i]),
                                float(ph.flat[i]), float(start[p].flat[i])))
        skipped = float(((np.abs(start[p] - ph) - slack) / p_lim).max())
        worst_skip = max(worst_skip, skipped)
        skip_caught += skipped > 1
    report = {
        "dtype": dtype, "batch": 2, "steps": 2,
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss_cuda": lc, "loss_cpu": lh,
        "loss_max_rel_err": loss_rel, "loss_limit": tol["loss_rtol"],
        "loss_err_over_limit": loss_rel / tol["loss_rtol"],
        "grad_rtol": rel, "grad_floor": floor, "params": len(params),
        "worst_grad_err_over_limit": worst_g[0], "worst_grad": worst_g[1],
        "worst_param_excess_over_limit": worst_p[0],
        "worst_param": worst_p[1:],
        "skipped_update_worst_reading": worst_skip,
        "skipped_update_fails_params": skip_caught,
        "flash_attention_launches": k1, "seconds": seconds}
    print("card_vs_cpu " + json.dumps(report), flush=True)
    if not loss_rel <= tol["loss_rtol"]:
        fail("card vs CPU %s: losses %r vs %r (rel %.3g > %g)"
             % (dtype, lc, lh, loss_rel, tol["loss_rtol"]))
    if worst_g[0] > 1:
        fail("card vs CPU %s: the grad of %s differs by %.3g of its limit"
             % (dtype, worst_g[1], worst_g[0]))
    if worst_p[0] > 1:
        fail("card vs CPU %s: %s differs by %.3g of its limit after two "
             "steps" % (dtype, worst_p[1], worst_p[0]))
    if dtype == "float32" and 2 * skip_caught < len(params):
        fail("card vs CPU fp32: a skipped update would pass the parameter "
             "check on %d of %d parameters"
             % (len(params) - skip_caught, len(params)))
    return k1


# phase 6e: training as Fluid users configure it — the flagship with its
# own defaults (remat=True: three two-layer recompute segments), bf16
# under the legacy AMP decorator at its defaults (dynamic loss scaling),
# Adam with the Transformer recipe's beta2 0.98 and epsilon 1e-9
# (Vaswani et al. 2017) on a linear warmup over an exponential decay, L2
# decay and a global-norm clip
USER = dict(lr=1e-3, decay_steps=1000, decay_rate=0.9, warmup_steps=4,
            beta1=0.9, beta2=0.98, epsilon=1e-9, l2=1e-4, clip_norm=1.0)
# the legs: (name, build keywords, batch)
USER_LEGS = (("remat", {}, 160), ("no_remat", dict(remat=False), 160),
             ("dropout", dict(dropout_rate=0.1), 32))
USER_STEPS = (3, 12)            # warm-up, timed
# the card-vs-CPU Adam program's clip: at 2 layers the init grads' global
# norm is about 0.77 (a CPU run at full width), under the recipe's 1.0,
# so a clip of 1.0 would be the identity there and the check could not
# see it left out
USER_CVC_CLIP = 0.25


def user_schedule(fluid):
    """The recipe's learning rate: 0 -> 1e-3 over 4 runs, then
    1e-3 * 0.9^(t / 1000), t the run's @step_counter@."""
    L = fluid.layers
    return L.linear_lr_warmup(
        L.exponential_decay(USER["lr"], USER["decay_steps"],
                            USER["decay_rate"]),
        warmup_steps=USER["warmup_steps"], start_lr=0.0, end_lr=USER["lr"])


def user_lr_closed_form(t):
    if t < USER["warmup_steps"]:
        return USER["lr"] * t / USER["warmup_steps"]
    return USER["lr"] * USER["decay_rate"] ** (t / USER["decay_steps"])


def build_user_lm(fluid, dtype="bfloat16", cfg=None,
                  clip_norm=USER["clip_norm"], **build_kw):
    """The flagship as a user configures it (``transformer_fluid.build``
    with its defaults unless `build_kw` says otherwise; `cfg` the widths,
    default TRAIN) under Adam, the schedule, L2 decay and the global-norm
    clip; bf16 under ``contrib.mixed_precision.decorate`` at its
    defaults. Built under a fresh name counter, with the op seeds from a
    fixed start, so two builds name their vars alike and draw the same
    dropout masks. Returns (main, startup, loss, learning-rate var)."""
    from paddle_tpu_torch import layer_helper
    from paddle_tpu_torch.models import transformer_fluid

    layer_helper._op_seed_counter[0] = 1000
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = transformer_fluid.build(
            dtype=dtype, **dict(TRAIN if cfg is None else cfg), **build_kw)
        lr = user_schedule(fluid)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm))
        opt = fluid.optimizer.Adam(
            learning_rate=lr, beta1=USER["beta1"], beta2=USER["beta2"],
            epsilon=USER["epsilon"],
            regularization=fluid.regularizer.L2Decay(USER["l2"]))
        if dtype == "bfloat16":
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss, lr


def adam_ops(main):
    """{parameter name: its adam op} of a program."""
    return {op.inputs["Param"][0].name: op
            for op in main.global_block().ops if op.type == "adam"}


def user_leg(torch, fa, fluid, name, build_kw, batch, device=None):
    """One leg of phase 6e: build, startup, USER_STEPS runs on fixed
    seeded tokens with K1's counts zeroed just before the runs and read
    just after. Returns what the gates and the train_user line read."""
    main, startup, loss, lr = build_user_lm(fluid, **build_kw)
    exe = fluid.Executor(device)
    on_card = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = lm_feed(torch, batch, exe.device)
    warmup, steps = USER_STEPS
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()                          # the main path starts
    outs, marks, host_ms = [], [], []
    for i in range(warmup + steps):
        if on_card and i >= warmup:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss, lr],
                            scope=scope, return_numpy=False))
        host_ms.append((time.perf_counter() - th) * 1e3)
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    k1 = flash_counts(fa)                      # the main path ends
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    b1 = {p: float(scope.get(op.inputs["Beta1Pow"][0].name).float()[0])
          for p, op in adam_ops(main).items()}
    leg = {"leg": name, "batch": batch, "warmup": warmup, "steps": steps,
           "runs": warmup + steps,
           "losses": [float(o[0].float().cpu()[0]) for o in outs],
           "lr_last": float(outs[-1][1].float().cpu()[0]),
           "step_counter": int(scope.get("@step_counter@").cpu()[0]),
           "beta1_pow": b1, "flash_attention_launches": k1,
           "host_ms_each": host_ms[warmup:], "step_ms_each": step_ms}
    if on_card:
        dev = float(np.mean(step_ms))
        leg.update(device_ms_per_step=dev,
                   host_ms_per_step=float(np.mean(host_ms[warmup:])),
                   tokens_per_s=batch * TRAIN["seq_len"] / dev * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if name == "remat":   # outside the counted and timed runs
            leg["update_profile"] = update_cost_profile(
                torch, exe, main, feed, [loss, lr], scope)
    del exe, scope
    return leg


# the convolutions' kernels by name: cuDNN's (bf16: the forward, dgrad
# and wgrad engines and its layout transforms) and the fp32 route's
# (im2col, col2im and cuBLAS's fp32 GEMMs; an fp32 product elsewhere in
# the step counts too: the image head's fc)
CONV_KERNEL_NAMES = ("conv", "cudnn", "fprop", "dgrad", "wgrad", "im2col",
                     "col2im", "sgemm", "f32f32")


def update_cost_profile(torch, exe, main, feed, fetch, scope):
    """One more step of a leg under torch.profiler, each op of the run in
    a ``ptpu_op:<type>`` range (``core.lowering.execute_op`` wrapped for
    this step only): the step's kernel launches (the runtime's launch
    calls), device busy ms and memcpy and stream-sync calls, and for the
    update section (the ops after the last grad op: unscale, clip,
    decay, the Adam updates) and for the adam ops alone their launches
    and host ms; the device ms of the convolutions (kernels named by
    CONV_KERNEL_NAMES), of the adam ops (their ranges) and of the rest,
    the forward ops' device ms by type (a grad op's kernels are launched
    by autograd's own thread, outside its range) and the top kernels."""
    import bisect

    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.core import lowering

    # the optimized clone the executor runs for this fetch list (cached
    # by the leg's runs)
    names = [v.name for v in fetch]
    ops = next(st.program for st in exe._cache.values()
               if st.fetch_names == names).global_block().ops
    last_grad = max(i for i, op in enumerate(ops)
                    if "__fwd_op__" in op.attrs)
    update_ids = {id(op) for op in ops[last_grad + 1:]}
    inner = lowering.execute_op

    def traced(op, env, ctx):
        tag = "update" if id(op) in update_ids else "other"
        with record_function("ptpu_op:%s:%s" % (tag, op.type)):
            inner(op, env, ctx)

    lowering.execute_op = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
    finally:
        lowering.execute_op = inner
    # the host's events (a record_function range also shows on the
    # device's timeline, under the same name)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    launches = sorted(e.time_range.start for e in events
                      if "LaunchKernel" in e.name)
    # the device's own rows: with the host traced too, an op's row also
    # carries its kernels' time
    busy_us = sum(device_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ptpu_op:"))
    # copies and stream syncs the step asks of the runtime (a pageable
    # host-to-device copy waits for the stream)
    out = {"launches_per_step": len(launches),
           "device_busy_ms": busy_us / 1e3,
           "runtime_calls": {k: sum(k in e.name for e in events)
                             for k in ("cudaMemcpyAsync",
                                       "cudaStreamSynchronize")}}
    for group, match in (("update", lambda t, k: t == "update"),
                         ("adam", lambda t, k: k == "adam")):
        ranges = [e.time_range for e in events
                  if e.name.startswith("ptpu_op:")
                  and match(*e.name.split(":")[1:])]
        out[group] = {
            "ops": len(ranges),
            "host_ms": sum(r.end - r.start for r in ranges) / 1e3,
            "launches": sum(bisect.bisect_right(launches, r.end)
                            - bisect.bisect_left(launches, r.start)
                            for r in ranges)}
    cuda = torch.autograd.DeviceType.CUDA
    # the kernels' own rows (a range's row on the device timeline and an
    # aten op's row would count them again)
    kernels = sorted(((device_us(e) / 1e3, e.count, e.key)
                      for e in prof.key_averages() if e.device_type == cuda
                      and not e.key.startswith(("ptpu_op:", "aten::"))),
                     reverse=True)
    by_op = {}
    for e in prof.key_averages():
        if e.device_type != cuda and e.key.startswith("ptpu_op:"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            key = e.key.split(":", 2)[2]
            by_op[key] = by_op.get(key, 0.0) + us / 1e3
    conv_ms = sum(ms for ms, _, k in kernels
                  if any(n in k.lower() for n in CONV_KERNEL_NAMES))
    adam_ms = by_op.get("adam", 0.0)
    out["device_ms"] = {"convolutions": conv_ms, "adam": adam_ms,
                        "rest": out["device_busy_ms"] - conv_ms - adam_ms}
    out["forward_device_ms_by_op"] = {
        k: round(v, 4) for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])
        if not k.endswith("_grad")}
    out["top_kernels"] = [{"kernel": k[:90], "calls": n, "ms": ms}
                          for ms, n, k in kernels[:10]]
    return out


def user_k1_per_step(name):
    """K1's (forward, backward) launches a step on the card: under remat
    each layer's forward runs in the forward pass and again in its
    segment's re-run; the dropout path has no flash attention."""
    L = TRAIN["n_layers"]
    return {"remat": (2 * L, L), "no_remat": (L, L),
            "dropout": (0, 0)}[name]


def check_user_leg(leg, k1_per_step=None):
    """Phase 6e's gates on one leg: the loss finite and falling; with
    `k1_per_step` (the card) K1's launches by the "tc" route, no copy;
    every parameter's beta1_pow_acc at beta1^(runs + 1) as fp32 forms it
    (Adam ran on every parameter in every run); the learning rate at the
    schedule's closed form for the last run; @step_counter@ at the runs."""
    name, n, losses = leg["leg"], leg["runs"], leg["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail("train_user %s: losses not finite and falling: %r"
             % (name, losses))
    if k1_per_step is not None:
        fwd, bwd, copies = leg["flash_attention_launches"]
        want = (dict(dict.fromkeys(fwd, 0), tc=k1_per_step[0] * n),
                dict(dict.fromkeys(bwd, 0), tc=k1_per_step[1] * n), 0)
        if (fwd, bwd, copies) != want:
            fail("train_user %s: flash attention launched %r (forward, "
                 "backward by route; copies) over %d steps; expected %r"
                 % (name, leg["flash_attention_launches"], n, want))
    b1 = np.float32(USER["beta1"])
    want_b1 = b1
    for _ in range(n):
        want_b1 = np.float32(want_b1 * b1)
    stale = sorted(p for p, v in leg["beta1_pow"].items()
                   if v != float(want_b1))
    if stale or not leg["beta1_pow"]:
        fail("train_user %s: beta1_pow_acc is not beta1^%d = %r for %r"
             % (name, n + 1, float(want_b1), stale[:5]))
    want_lr = user_lr_closed_form(n)
    if abs(leg["lr_last"] - want_lr) > 1e-6 * want_lr:
        fail("train_user %s: the learning rate reads %r at run %d; the "
             "schedule gives %r" % (name, leg["lr_last"], n, want_lr))
    if leg["step_counter"] != n:
        fail("train_user %s: @step_counter@ reads %d after %d runs"
             % (name, leg["step_counter"], n))


def check_remat_memory(remat_leg, plain_leg):
    if not remat_leg["peak_gib"] < plain_leg["peak_gib"]:
        fail("train_user: the remat leg peaked at %.3f GiB, not below the "
             "no-remat leg's %.3f GiB: recompute kept the activations"
             % (remat_leg["peak_gib"], plain_leg["peak_gib"]))


def dropout_remat_grads(torch, fluid, devices=("cuda:0", "cuda:0"),
                        batch=32, tol=None):
    """One step of the dropout program under remat and without, from the
    same weights and op seeds: the loss and every parameter's grad held
    to bf16's STEP_TOL (the re-run redrew the forward's masks). Returns
    (the worst grad error over its limit, bitwise equal)."""
    tol = tol or STEP_TOL["bfloat16"]
    runs, start = [], None
    for remat, device in zip((True, False), devices):
        main, startup, loss, _ = build_user_lm(fluid, dropout_rate=0.1,
                                               remat=remat)
        exe, scope = fluid.Executor(device), fluid.Scope()
        exe.run(startup, scope=scope)
        if start is None:
            start = {n: scope.get(n).clone()
                     for n in scope.local_var_names()
                     if n != "__step_counter__"}
        else:
            for n, t in start.items():
                scope.set(n, t.to(exe.device, copy=True))
        params = sorted(main.param_grad_map)
        out = exe.run(main, feed=lm_feed(torch, batch, exe.device),
                      fetch_list=[loss] + [main.param_grad_map[p]
                                           for p in params], scope=scope)
        runs.append((float(out[0][0]), dict(zip(params, out[1:]))))
        del exe, scope
    (la, ga), (lb, gb) = runs
    if abs(la - lb) > tol["loss_rtol"] * abs(lb):
        fail("train_user dropout: remat loss %r vs %r without" % (la, lb))
    floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                   for g in gb.values())
    worst = max((float(np.abs(ga[p] - gb[p]).max())
                 / (tol["grad_rtol"] * float(np.abs(gb[p]).max()) + floor),
                 p) for p in gb)
    if worst[0] > 1:
        fail("train_user dropout: the grad of %s under remat differs from "
             "the no-remat build's by %.3g of its limit" % (worst[1],
                                                            worst[0]))
    bitwise = la == lb and all(np.array_equal(ga[p], gb[p]) for p in gb)
    return worst[0], bitwise


def user_training_phase(torch, fa, fluid):
    """Phase 6e on cuda:0: the three legs, each gated and printed on a
    train_user line, the remat leg's peak below the no-remat leg's, and
    the dropout program's grads equal across remat. Returns K1's "tc"
    launches (forward, backward) over the legs."""
    legs = {}
    for name, kw, batch in USER_LEGS:
        gc.collect()
        torch.cuda.empty_cache()
        leg = user_leg(torch, fa, fluid, name, kw, batch)
        check_user_leg(leg, user_k1_per_step(name))
        legs[name] = leg
        b1 = sorted(set(leg["beta1_pow"].values()))
        print("train_user " + json.dumps(dict(
            leg, card=card_line(),
            beta1_pow={"params": len(leg["beta1_pow"]), "values": b1})),
            flush=True)
    check_remat_memory(legs["remat"], legs["no_remat"])
    worst, bitwise = dropout_remat_grads(torch, fluid)
    r, p = legs["remat"], legs["no_remat"]
    print("train_user_remat " + json.dumps({
        "peak_gib_remat_over_no_remat": r["peak_gib"] / p["peak_gib"],
        "device_ms_remat_over_no_remat":
            r["device_ms_per_step"] / p["device_ms_per_step"],
        "dropout_grads_worst_err_over_limit": worst,
        "dropout_grads_bitwise": bitwise}), flush=True)
    fwd = sum(l["flash_attention_launches"][0]["tc"] for l in legs.values())
    bwd = sum(l["flash_attention_launches"][1]["tc"] for l in legs.values())
    return fwd, bwd


def adam_param_limit(g_ref, g_err, lrs, beta1, beta2):
    """How far Adam can move an element apart over len(lrs) steps when
    each step's grad (the one the op reads) may differ from `g_ref` by
    `g_err` (lists of arrays, one a step). The update is lr * r, r =
    m_hat / sqrt(v_hat): r is homogeneous of degree 0 in the grads, and
    with the bias-corrected weights w (of m) and u (of v) of a step,
    |dr/dg_j| <= (w_j + sqrt(sum w^2/u) sqrt(u_j)) / sqrt(v_hat) (Cauchy-
    Schwarz), |r| <= sqrt(sum w^2/u); so a step's r moves by at most the
    smaller of that sum over the grads' errors and twice |r|'s bound.
    epsilon only damps r and is left out."""
    limit = np.zeros_like(g_ref[0], dtype=np.float64)
    for s in range(1, len(lrs) + 1):
        w = np.array([(1 - beta1) * beta1 ** (s - j) for j in range(1, s + 1)])
        u = np.array([(1 - beta2) * beta2 ** (s - j) for j in range(1, s + 1)])
        w, u = w / (1 - beta1 ** s), u / (1 - beta2 ** s)
        r_max = np.sqrt((w * w / u).sum())
        v_hat = sum(uj * np.asarray(g, np.float64) ** 2
                    for uj, g in zip(u, g_ref[:s]))
        sens = sum((wj + r_max * np.sqrt(uj)) * np.asarray(e, np.float64)
                   for wj, uj, e in zip(w, u, g_err[:s]))
        with np.errstate(divide="ignore", invalid="ignore"):
            dr = np.where(v_hat > 0, sens / np.sqrt(v_hat), np.inf)
        limit += lrs[s - 1] * np.minimum(dr, 2 * r_max)
    return limit


def adam_card_vs_cpu_phase(torch, fluid, program, devices=("cuda:0", "cpu")):
    """Phase 6e's program in fp32 (no AMP) at 2 layers, two steps from
    the same weights on cuda:0 and on the CPU, held to fp32's STEP_TOL:
    the losses; step by step the learning rate (2 ulps), the global-norm
    clip's scale (loss_rtol: one sum over every grad), each parameter's
    raw grad, its clipped grad and the grad Adam reads (clipped plus
    decay) to grad_rtol of that tensor's largest plus the floor (at step
    2 plus the decay of what step 1 may have moved the parameter apart),
    and step 1's decay term itself (2 ulps: coeff * the same param);
    after step 2 every parameter to 2 ulps of its largest magnitude plus
    what the grads' errors let Adam move it (``adam_param_limit``). The
    clip must bind (scale below 0.99), or a clip left out could not
    show. A skipped update must fail the parameter check on most
    parameters. Returns K1's launches in the run (forward, backward by
    route; copies)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    main, startup, loss, lr = program
    if torch.backends.cuda.matmul.allow_tf32:
        fail("card vs CPU Adam: TF32 matmuls are on; the limits assume "
             "fp32 products")
    tol = STEP_TOL["float32"]
    rel, bits = tol["grad_rtol"], tol["mantissa_bits"]
    block = main.global_block()
    producer = {n: op for op in block.ops for n in op.output_names()}
    params = sorted(adam_ops(main))
    names = {}   # param -> (raw grad, clipped grad, Adam's grad, decay)
    for p, op in adam_ops(main).items():
        g_adam = op.inputs["Grad"][0].name
        add = producer[g_adam]
        g_clip, decay = add.inputs["X"][0].name, add.inputs["Y"][0].name
        names[p] = (main.param_grad_map[p], g_clip, g_adam, decay)
    mul = producer[names[params[0]][1]]
    scale = mul.inputs["Y"][0].name
    fetch = [loss, lr, scale] + [n for p in params for n in names[p]]
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    for n in scope_c.local_var_names():
        if n != "__step_counter__":
            scope_h.set(n, scope_c.get(n).to("cpu", copy=True))
    start = {p: scope_h.get(p).float().numpy().copy() for p in params}
    t0 = time.perf_counter()
    fa.reset_counts()                          # the path starts
    runs = []
    for exe, scope in ((exe_c, scope_c), (exe_h, scope_h)):
        feed = lm_feed(torch, 2, exe.device)
        steps = []
        for _ in range(2):
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            steps.append((float(out[0][0]), float(out[1][0]),
                          float(out[2][0]),
                          {p: out[3 + 4 * i: 7 + 4 * i]
                           for i, p in enumerate(params)}))
        runs.append(steps)
    seconds = time.perf_counter() - t0
    k1 = flash_counts(fa)                      # the path ends
    card, ref = runs
    worst = {"loss": 0.0, "lr": 0.0, "clip_scale": 0.0, "grad": (0.0, ""),
             "decay": (0.0, ""), "param": (-np.inf, "")}
    g_ref, g_err = {p: [] for p in params}, {p: [] for p in params}
    moved = {p: 0.0 for p in params}   # how far step 1 may part a param
    for step, ((lc, lrc, sc, gc_), (lh, lrh, sh, gh)) in enumerate(
            zip(card, ref)):
        worst["loss"] = max(worst["loss"], abs(lc - lh) / abs(lh))
        worst["lr"] = max(worst["lr"], abs(lrc - lrh) / (2 * float(
            ulp(lrh, bits))))
        worst["clip_scale"] = max(worst["clip_scale"], abs(sc - sh) / sh)
        floor = tol["floor_rel"] * max(float(np.abs(g[0]).max())
                                       for g in gh.values())
        for p in params:
            for k, label in ((0, "raw"), (1, "clipped"), (2, "adam")):
                lim = rel * float(np.abs(gh[p][k]).max()) + floor
                if k == 2:   # the decay of params step 1 moved apart
                    lim += USER["l2"] * moved[p]
                err = float(np.abs(gc_[p][k] - gh[p][k]).max()) / lim
                worst["grad"] = max(worst["grad"],
                                    (err, "%s %s" % (p, label)))
            if step == 0:    # coeff * the same start: bitwise but for ulps
                derr = float((np.abs(gc_[p][3] - gh[p][3])
                              / (2 * ulp(gh[p][3], bits))).max())
                worst["decay"] = max(worst["decay"], (derr, p))
            g_ref[p].append(gh[p][2])
            g_err[p].append(rel * np.abs(gh[p][2]).max() + floor)
            moved[p] = float((adam_param_limit(
                g_ref[p], g_err[p], [lrh], USER["beta1"], USER["beta2"])
                + 2 * ulp(start[p], bits)).max())
    lrs = [s[1] for s in ref]
    worst_skip, skip_caught = -np.inf, 0
    for p in params:
        pc = scope_c.get(p).float().cpu().numpy()
        ph = scope_h.get(p).float().numpy()
        mag = np.maximum(np.maximum(np.abs(pc), np.abs(ph)),
                         np.abs(start[p]))
        slack = 2 * ulp(mag, bits)
        p_lim = adam_param_limit(g_ref[p], g_err[p], lrs, USER["beta1"],
                                 USER["beta2"]) + slack
        excess = np.abs(pc - ph) / p_lim
        i = int(np.argmax(excess))
        worst["param"] = max(worst["param"], (float(excess.flat[i]), p))
        skipped = float((np.abs(start[p] - ph) / p_lim).max())
        worst_skip = max(worst_skip, skipped)
        skip_caught += skipped > 1
    report = {
        "dtype": "float32", "optimizer": "adam", "batch": 2, "steps": 2,
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss_cuda": [s[0] for s in card], "loss_cpu": [s[0] for s in ref],
        "lr_cpu": lrs, "clip_scale_cpu": [s[2] for s in ref],
        "loss_max_rel_err": worst["loss"], "loss_limit": tol["loss_rtol"],
        "lr_err_over_2ulp": worst["lr"],
        "clip_scale_rel_err": worst["clip_scale"],
        "worst_grad_err_over_limit": worst["grad"][0],
        "worst_grad": worst["grad"][1],
        "worst_decay_err_over_2ulp": worst["decay"][0],
        "worst_param_err_over_limit": worst["param"][0],
        "worst_param": worst["param"][1], "params": len(params),
        "skipped_update_worst_reading": worst_skip,
        "skipped_update_fails_params": skip_caught,
        "flash_attention_launches": k1, "seconds": seconds}
    print("card_vs_cpu " + json.dumps(report), flush=True)
    if worst["loss"] > tol["loss_rtol"]:
        fail("card vs CPU Adam: losses %r vs %r"
             % (report["loss_cuda"], report["loss_cpu"]))
    if worst["lr"] > 1:
        fail("card vs CPU Adam: the learning rate differs by %.3g of 2 "
             "ulps" % worst["lr"])
    if not max(report["clip_scale_cpu"]) < 0.99:
        fail("card vs CPU Adam: the clip does not bind (scales %r), so a "
             "clip left out could not show" % report["clip_scale_cpu"])
    if worst["clip_scale"] > tol["loss_rtol"]:
        fail("card vs CPU Adam: the clip's scale differs by %.3g"
             % worst["clip_scale"])
    if worst["grad"][0] > 1:
        fail("card vs CPU Adam: the %s grad differs by %.3g of its limit"
             % (worst["grad"][1], worst["grad"][0]))
    if worst["decay"][0] > 1:
        fail("card vs CPU Adam: the decay of %s differs by %.3g of 2 ulps"
             % (worst["decay"][1], worst["decay"][0]))
    if worst["param"][0] > 1:
        fail("card vs CPU Adam: %s differs by %.3g of its limit after two "
             "steps" % (worst["param"][1], worst["param"][0]))
    if 2 * skip_caught < len(params):
        fail("card vs CPU Adam: a skipped update would pass the parameter "
             "check on %d of %d parameters"
             % (len(params) - skip_caught, len(params)))
    return k1


# phase 6f: the stacked flagship — examples/train_transformer_fluid.py
# --stacked uncut: transformer_fluid.build_stacked (the layer stack as ONE
# StaticRNN(remat=True) over stacked [n_layers, ...] weights, K1 bare in
# the no-grad scan and again, forward and backward, in its replay) at full
# width, bf16, Adam 3e-4 under the legacy decorator with a static loss
# scale of 1.0, batch 64; against the same example without --stacked
# (build() at its defaults: remat=True)
STACKED_BATCH = 64
STACKED_STEPS = (3, 8)            # warm-up, timed
# the card-vs-CPU leg: the stacked program in fp32 at 2 layers, Adam on a
# piecewise_decay whose boundary falls inside the runs, under
# GradientMergeOptimizer(k_steps=2) (updates at runs 2 and 4, one at each
# rate), with an ExponentialMovingAverage of the parameters
STACKED_CVC = dict(boundaries=[3], values=[1e-3, 5e-4], k_steps=2,
                   ema_decay=0.999, runs=4, batch=2, beta1=0.9, beta2=0.999)


def build_example_lm(fluid, stacked):
    """examples/train_transformer_fluid.py's program at TRAIN's widths:
    build_stacked (or build() at its defaults) in bf16 under contrib
    decorate with a static loss scale of 1.0, Adam(3e-4)."""
    from paddle_tpu_torch import layer_helper
    from paddle_tpu_torch.models import transformer_fluid

    layer_helper._op_seed_counter[0] = 1000
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        build = (transformer_fluid.build_stacked if stacked
                 else transformer_fluid.build)
        _, _, loss = build(dtype="bfloat16", **TRAIN)
        fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Adam(3e-4), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(loss)
    return main, startup, loss


def stacked_leg(torch, fa, fluid, stacked, batch=STACKED_BATCH,
                device=None):
    """One leg of phase 6f: STACKED_STEPS runs of the example's program
    on seeded tokens, K1's counts and the predicate reads zeroed just
    before the runs and read just after."""
    from paddle_tpu_torch.ops import controlflow

    main, startup, loss = build_example_lm(fluid, stacked)
    exe = fluid.Executor(device)
    on_card = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = lm_feed(torch, batch, exe.device)
    warmup, steps = STACKED_STEPS
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()                          # the main path starts
    controlflow.reset_counts()
    outs, marks, host_ms = [], [], []
    for i in range(warmup + steps):
        if on_card and i >= warmup:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope, return_numpy=False))
        host_ms.append((time.perf_counter() - th) * 1e3)
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    k1 = flash_counts(fa)                      # the main path ends
    leg = {"leg": "stacked" if stacked else "unrolled", "batch": batch,
           "warmup": warmup, "steps": steps, "runs": warmup + steps,
           "params": len(main.param_grad_map),
           "losses": [float(o[0].float().cpu()[0]) for o in outs],
           "flash_attention_launches": k1,
           "host_syncs": dict(controlflow.host_syncs),
           "host_ms_each": host_ms[warmup:],
           "step_ms_each": [a.elapsed_time(b)
                            for a, b in zip(marks, marks[1:])]}
    if on_card:
        dev = float(np.mean(leg["step_ms_each"]))
        leg.update(device_ms_per_step=dev,
                   host_ms_per_step=float(np.mean(host_ms[warmup:])),
                   tokens_per_s=batch * TRAIN["seq_len"] / dev * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        # outside the counted and timed runs: the launches a step, and
        # the update section's (Adam over 16 stacked or 100 parameters)
        leg["update_profile"] = update_cost_profile(
            torch, exe, main, feed, [loss], scope)
    del exe, scope
    return leg


def check_stacked_leg(leg, k1_per_step=None):
    """Phase 6f's gates on a leg: the loss finite and falling; with
    `k1_per_step` (the card) K1's launches a step by the "tc" route —
    both builds run each layer's forward twice (the scan or segment, then
    its replay) and its backward once — with no operand copied (a copy
    is named by its count); no predicate read on the host."""
    name, n, losses = leg["leg"], leg["runs"], leg["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail("train_stacked %s: losses not finite and falling: %r"
             % (name, losses))
    if leg["host_syncs"] != {"cond": 0, "while": 0}:
        fail("train_stacked %s: predicates read on the host: %r"
             % (name, leg["host_syncs"]))
    if k1_per_step is None:
        return
    fwd, bwd, copies = leg["flash_attention_launches"]
    if copies:
        fail("train_stacked %s: K1 copied %d operands over %d steps (the "
             "split q, k, v views): expected none" % (name, copies, n))
    want = (dict(dict.fromkeys(fwd, 0), tc=k1_per_step[0] * n),
            dict(dict.fromkeys(bwd, 0), tc=k1_per_step[1] * n))
    if (fwd, bwd) != want:
        fail("train_stacked %s: flash attention launched %r (forward, "
             "backward by route) over %d steps; expected %r"
             % (name, (fwd, bwd), n, want))


def stacked_phase(torch, fa, fluid):
    """Phase 6f's stacked and unrolled legs on cuda:0, gated and printed
    on train_stacked lines, and their ratios. Returns K1's "tc" launches
    (forward, backward) over both."""
    L = TRAIN["n_layers"]
    legs = {}
    for stacked in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        leg = stacked_leg(torch, fa, fluid, stacked)
        check_stacked_leg(leg, (2 * L, L))
        legs[leg["leg"]] = leg
        print("train_stacked " + json.dumps(dict(leg, card=card_line())),
              flush=True)
    s, u = legs["stacked"], legs["unrolled"]
    print("train_stacked_ratio " + json.dumps({
        "device_ms_stacked_over_unrolled":
            s["device_ms_per_step"] / u["device_ms_per_step"],
        "host_ms_stacked_over_unrolled":
            s["host_ms_per_step"] / u["host_ms_per_step"],
        "peak_gib_stacked_over_unrolled": s["peak_gib"] / u["peak_gib"]}),
        flush=True)
    return (sum(l["flash_attention_launches"][0]["tc"] for l in legs.values()),
            sum(l["flash_attention_launches"][1]["tc"] for l in legs.values()))


def build_stacked_cvc(fluid):
    """Phase 6f's card-vs-CPU program: build_stacked in fp32 at TRAIN's
    widths and 2 layers, Adam on piecewise_decay(STACKED_CVC) under
    GradientMergeOptimizer, and an ExponentialMovingAverage update after
    it. Returns (main, startup, loss, lr, {param: its shadow's name})."""
    from paddle_tpu_torch import layer_helper
    from paddle_tpu_torch.models import transformer_fluid

    c = STACKED_CVC
    layer_helper._op_seed_counter[0] = 1000
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = transformer_fluid.build_stacked(
            dtype="float32", **dict(TRAIN, n_layers=2))
        lr = fluid.layers.piecewise_decay(c["boundaries"], c["values"])
        fluid.optimizer.GradientMergeOptimizer(
            fluid.optimizer.Adam(lr, beta1=c["beta1"], beta2=c["beta2"]),
            k_steps=c["k_steps"]).minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(c["ema_decay"])
        ema.update()
    return main, startup, loss, lr, {p: s.name
                                     for p, s in ema._shadows.items()}


def stacked_lr(run):
    """piecewise_decay(STACKED_CVC) at run `run` (1-based)."""
    c = STACKED_CVC
    for bound, value in zip(c["boundaries"], c["values"]):
        if run < bound:
            return value
    return c["values"][-1]


def stacked_card_vs_cpu_phase(torch, fluid, program,
                              devices=("cuda:0", "cpu")):
    """Phase 6f's fp32 program, STACKED_CVC["runs"] runs from the same
    weights on cuda:0 and on the CPU, held to fp32's STEP_TOL: each run's
    loss; its learning rate to rtol 1e-6 of the piecewise closed form on
    both; every raw grad (each layer's slice of a stacked weight on its
    own) to grad_rtol of that slice's largest plus the floor; after each
    run every parameter within what the merged grads' errors let the
    updates move it (Adam under the merge reads moments and beta powers
    at their start values at every update: the cond lists only the
    parameters and the buffers as outputs, as in the JAX package), and
    the runs' parameters unmoved on the odd runs; each EMA shadow to rtol
    1e-6 of the recurrence over its own device's parameters, and across
    the devices within (1 - decay) times the parameters' limits. On the
    card: the predicates read on the host (2 Switch conds and the merge
    a run), and K1's launches. A skipped update must fail the parameter
    check on most parameters. Returns K1's launches (forward, backward
    by route; copies)."""
    from paddle_tpu_torch.ops import controlflow
    from paddle_tpu_torch.ops import flash_attention as fa

    main, startup, loss, lr, shadows = program
    c = STACKED_CVC
    if torch.backends.cuda.matmul.allow_tf32:
        fail("card vs CPU stacked: TF32 matmuls are on; the limits assume "
             "fp32 products")
    tol = STEP_TOL["float32"]
    rel, bits = tol["grad_rtol"], tol["mantissa_bits"]
    params = sorted(main.param_grad_map)
    fetch = ([loss, lr] + [main.param_grad_map[p] for p in params]
             + params + [shadows[p] for p in params])
    n_p = len(params)
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    for n in scope_c.local_var_names():
        if n != "__step_counter__":
            scope_h.set(n, scope_c.get(n).to("cpu", copy=True))
    start = {p: scope_h.get(p).float().numpy().copy() for p in params}
    t0 = time.perf_counter()
    fa.reset_counts()                          # the path starts
    runs, syncs = [], None
    for exe, scope in ((exe_c, scope_c), (exe_h, scope_h)):
        feed = lm_feed(torch, c["batch"], exe.device)
        controlflow.reset_counts()
        steps = []
        for _ in range(c["runs"]):
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            steps.append((float(out[0][0]), float(out[1][0]),
                          out[2:2 + n_p], out[2 + n_p:2 + 2 * n_p],
                          out[2 + 2 * n_p:]))
        if syncs is None:
            syncs = dict(controlflow.host_syncs)
        runs.append(steps)
    seconds = time.perf_counter() - t0
    k1 = flash_counts(fa)                      # the path ends
    card, ref = runs
    d = np.float32(c["ema_decay"])
    worst = {"loss": 0.0, "lr": 0.0, "grad": (0.0, ""),
             "param": (-np.inf, ""), "unmoved": (0.0, ""),
             "shadow_own": (0.0, ""), "shadow": (-np.inf, "")}
    limit = {p: np.zeros_like(start[p], dtype=np.float64) for p in params}
    merged = {p: [] for p in params}           # (grad, its error) a run
    shadow_lim = {p: np.zeros_like(start[p], dtype=np.float64)
                  for p in params}
    own = [{p: np.zeros_like(start[p]) for p in params} for _ in runs]
    skipped = 0
    keep = np.float32(1.0 - c["ema_decay"])
    for run, (cs, hs) in enumerate(zip(card, ref), 1):
        (lc, lrc, gc_, pc, sc), (lh, lrh, gh, ph, sh) = cs, hs
        worst["loss"] = max(worst["loss"], abs(lc - lh) / abs(lh))
        want_lr = stacked_lr(run)
        worst["lr"] = max(worst["lr"], abs(lrc - want_lr) / want_lr,
                          abs(lrh - want_lr) / want_lr)
        floor = tol["floor_rel"] * max(float(np.abs(g).max()) for g in gh)
        for i, p in enumerate(params):
            slices = (zip(gc_[i], gh[i]) if p.startswith("st_")
                      else [(gc_[i], gh[i])])
            for k, (a, b) in enumerate(slices):
                lim = rel * float(np.abs(b).max()) + floor
                err = float(np.abs(a - b).max()) / lim
                worst["grad"] = max(worst["grad"], (err, "%s[%d] run %d"
                                                    % (p, k, run)))
            merged[p].append((gh[i], rel * np.abs(gh[i]).max() + floor))
        update = run % c["k_steps"] == 0
        for i, p in enumerate(params):
            if update:                         # a first-step Adam update
                g = sum(m[0] for m in merged[p]) / c["k_steps"]
                e = sum(m[1] for m in merged[p]) / c["k_steps"]
                limit[p] = limit[p] + adam_param_limit(
                    [g], [np.full_like(g, e)], [lrh], c["beta1"],
                    c["beta2"])
                merged[p] = []
            mag = np.maximum(np.maximum(np.abs(pc[i]), np.abs(ph[i])),
                             np.abs(start[p]))
            p_lim = limit[p] + 2 * ulp(mag, bits)
            excess = np.abs(pc[i] - ph[i]) / p_lim
            j = int(np.argmax(excess))
            worst["param"] = max(worst["param"],
                                 (float(excess.flat[j]), "%s run %d"
                                  % (p, run)))
            if not update:                     # the cond did not run
                for dev, now in ((0, pc[i]), (1, ph[i])):
                    was = (start[p] if run == 1
                           else (card, ref)[dev][run - 2][3][i])
                    moved = float(np.abs(now - was).max())
                    worst["unmoved"] = max(worst["unmoved"],
                                           (moved, "%s run %d" % (p, run)))
            elif run == c["k_steps"]:
                # a skipped first update, read against this limit
                skipped += float((np.abs(start[p] - ph[i])
                                  / p_lim).max()) > 1
            # each device's shadow against the recurrence over its own
            # parameters, and across the devices
            for dev, (par, sha) in enumerate(((pc[i], sc[i]),
                                              (ph[i], sh[i]))):
                own[dev][p] = d * own[dev][p] + keep * par
                err = float((np.abs(sha - own[dev][p])
                             / (1e-6 * np.abs(own[dev][p]) + 1e-30)).max())
                worst["shadow_own"] = max(worst["shadow_own"],
                                          (err, "%s run %d" % (p, run)))
            shadow_lim[p] = float(d) * shadow_lim[p] + (1 - float(d)) * p_lim
            s_excess = np.abs(sc[i] - sh[i]) / (
                shadow_lim[p] + 2 * ulp(np.abs(sh[i]), bits))
            worst["shadow"] = max(worst["shadow"],
                                  (float(s_excess.max()), p))
    report = {
        "dtype": "float32", "optimizer": "adam, gradient merge k=2, ema",
        "batch": c["batch"], "runs": c["runs"],
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss_cuda": [s[0] for s in card], "loss_cpu": [s[0] for s in ref],
        "lr_cpu": [s[1] for s in ref],
        "loss_max_rel_err": worst["loss"], "loss_limit": tol["loss_rtol"],
        "lr_max_rel_err": worst["lr"],
        "worst_grad_err_over_limit": worst["grad"][0],
        "worst_grad": worst["grad"][1],
        "worst_param_err_over_limit": worst["param"][0],
        "worst_param": worst["param"][1],
        "moved_on_a_merge_only_run": worst["unmoved"][0],
        "worst_shadow_own_err_over_1e-6": worst["shadow_own"][0],
        "worst_shadow_err_over_limit": worst["shadow"][0],
        "params": n_p, "skipped_update_fails_params": skipped,
        "host_syncs": syncs, "flash_attention_launches": k1,
        "seconds": seconds}
    print("card_vs_cpu_stacked " + json.dumps(report), flush=True)
    if worst["loss"] > tol["loss_rtol"]:
        fail("card vs CPU stacked: losses %r vs %r"
             % (report["loss_cuda"], report["loss_cpu"]))
    if worst["lr"] > 1e-6:
        fail("card vs CPU stacked: the learning rate reads %r (card) / %r "
             "(CPU); the schedule gives %r"
             % ([s[1] for s in card], report["lr_cpu"],
                [stacked_lr(r) for r in range(1, c["runs"] + 1)]))
    if worst["grad"][0] > 1:
        fail("card vs CPU stacked: the grad of %s differs by %.3g of its "
             "limit" % (worst["grad"][1], worst["grad"][0]))
    if worst["unmoved"][0] > 0:
        fail("card vs CPU stacked: %s moved by %.3g on a run that only "
             "merges" % (worst["unmoved"][1], worst["unmoved"][0]))
    if worst["param"][0] > 1:
        fail("card vs CPU stacked: %s differs by %.3g of its limit"
             % (worst["param"][1], worst["param"][0]))
    if worst["shadow_own"][0] > 1:
        fail("card vs CPU stacked: the EMA shadow of %s is not the "
             "recurrence over its parameters (%.3g of rtol 1e-6)"
             % (worst["shadow_own"][1], worst["shadow_own"][0]))
    if worst["shadow"][0] > 1:
        fail("card vs CPU stacked: the EMA shadow of %s differs by %.3g "
             "of its limit" % (worst["shadow"][1], worst["shadow"][0]))
    if 2 * skipped < n_p:
        fail("card vs CPU stacked: a skipped update would pass the "
             "parameter check on %d of %d parameters" % (n_p - skipped,
                                                          n_p))
    want_syncs = {"cond": (len(c["boundaries"]) + 2) * c["runs"],
                  "while": 0}
    if syncs != want_syncs:
        fail("card vs CPU stacked: predicates read on the host %r; "
             "expected %r (the Switch's cases and default and the merge, "
             "one a run)" % (syncs, want_syncs))
    return k1


# full-int8 inference (phase 8): the fp32 LM's inference clone under
# quant.decorate(mode="full_int8") at bench.py's width, batch 32
INT8 = dict(batch=32, calib_batches=4, warmup=3, steps=10)
# K4's edge matrix: every (M, K, N) of these: tails, and one either side
# of the product's tile edges (128 rows and columns a block, k 32 an mma,
# 128 a stage; N 8 an mma)
INT8_EDGES = dict(M=(1, 7, 33, 127, 129), K=(1, 5, 31, 33, 129, 2048),
                  N=(1, 3, 7, 9, 127, 129, 32000))


def int8_path_shapes():
    """K4's (M, K, N) on the int8 LM path a step, with its launches a
    step: the two FFN layers of each layer and the lm_head's chunks."""
    B, T = INT8["batch"], TRAIN["seq_len"]
    D, F, V = TRAIN["d_model"], TRAIN["d_ff"], TRAIN["vocab_size"]
    chunk = min(T, 256)              # transformer_fluid's head chunk
    L = TRAIN["n_layers"]
    return {"ffn1": ((B * T, D, F), L), "ffn2": ((B * T, F, D), L),
            "lm_head": ((B * chunk, D, V), T // chunk)}


def int8_inputs(torch, M, K, N, seed, x=None):
    """K4's inputs on the card: x ~ 1.5 N(0, 1) (a few past the int8
    range at act_scale 127/3), w over the whole int8 range with -128 at
    every 7th element, a positive per-channel dq."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if x is None:
        x = 1.5 * torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randint(-128, 128, (K, N), dtype=torch.int8, device="cuda",
                      generator=gen)
    w.view(-1)[::7] = -128
    dq = (torch.rand(N, device="cuda", generator=gen) + 0.1) * (3 / 127 ** 2)
    return x, w, dq, 127.0 / 3.0


def int8_check(torch, im, x, w, dq, s, label):
    """K4 against its plain version, bitwise (fp32 bit patterns)."""
    got = im.int8_matmul(x, w, dq, s)
    want = im.int8_matmul_reference(x, w, dq, s)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        diff = (got - want).abs()
        fail("int8_matmul %s differs from its plain version: max |diff| "
             "%.3g, %d elements" % (label, float(diff.max()),
                                    int((diff > 0).sum())))
    return got


def int8_kernel_phase(torch, im):
    """K4 against its plain version on the card, bitwise: the edge
    matrix, ties and saturation, strided and unaligned x, then the
    path's three shapes, where kernel, plain version, torch._int_mm
    (the product alone, on pre-quantized operands: the library
    yardstick) and the fp32 torch.matmul the fp32 program pays are
    timed."""
    n = 0
    for M in INT8_EDGES["M"]:
        for K in INT8_EDGES["K"]:
            for N in INT8_EDGES["N"]:
                int8_check(torch, im, *int8_inputs(torch, M, K, N, seed=n),
                           label="M=%d K=%d N=%d" % (M, K, N))
                n += 1
    # ties: x * 2 lands on k + 0.5; saturation past +-127.5 and +-inf
    k = torch.arange(-300, 300, device="cuda", dtype=torch.float32)
    _, w, dq, _ = int8_inputs(torch, 6, 100, 40, seed=100)
    int8_check(torch, im, (k / 2 + 0.25).view(6, 100), w, dq, 2.0, "ties")
    sat = torch.tensor([127.49, 127.5, 127.51, 300.0, 1e30, float("inf"),
                        -127.5, -128.49, -128.5, -128.51, -300.0,
                        -float("inf")], device="cuda")
    _, w, dq, _ = int8_inputs(torch, 2, 12, 40, seed=101)
    int8_check(torch, im, torch.stack([sat, sat.flip(0)]), w, dq, 1.0,
               "saturation")
    # strided: a sequence slice of [B, T, K] (16-byte rows), and a 2-D
    # view with odd row stride and a 4-byte offset (the scalar loads)
    base = 1.5 * torch.randn(4, 64, 132, device="cuda")
    _, w, dq, s = int8_inputs(torch, 4 * 32, 132, 72, seed=102)
    int8_check(torch, im, base[:, 32:], w, dq, s, "3-D sequence slice")
    base = 1.5 * torch.randn(33, 131, device="cuda")
    _, w, dq, s = int8_inputs(torch, 33, 129, 129, seed=103)
    int8_check(torch, im, base[:, 1:130], w, dq, s, "unaligned 2-D view")
    print("kernel int8_matmul: %d edge shapes (M %s, K %s, N %s), ties, "
          "saturation, strided and unaligned x: bitwise its plain version"
          % (n, INT8_EDGES["M"], INT8_EDGES["K"], INT8_EDGES["N"]),
          flush=True)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    B, T = INT8["batch"], TRAIN["seq_len"]
    for i, (name, ((M, K, N), _)) in enumerate(int8_path_shapes().items()):
        if name == "lm_head":   # chunk 0's rows of h, read in place
            h = 1.5 * torch.randn(B, T, K, device="cuda")
            x = h[:, :M // B]
        else:
            x = 1.5 * torch.randn(B, T, K, device="cuda")
        shape = "%s M=%d K=%d N=%d%s" % (
            name, M, K, N, " (x a strided view)" if name == "lm_head" else "")
        rows.append(int8_timed_row(torch, im, name, shape, x, (M, K, N),
                                   200 + i, flush))
        del x
    torch.cuda.empty_cache()
    return rows


def int8_timed_row(torch, im, name, shape, x, mkn, seed, flush):
    """K4 at one path shape (x [.., K] on the card): checked bitwise
    against its plain version, then kernel, plain version, the library
    yardstick (torch._int_mm on pre-quantized operands, where it takes
    the shape; else null) and the fp32 torch.matmul timed. Returns the
    kernels line's row."""
    M, K, N = mkn
    _, w, dq, s = int8_inputs(torch, M, K, N, seed=seed, x=x)
    got = int8_check(torch, im, x, w, dq, s, shape)
    x2 = x.reshape(M, K)
    qa = torch.clamp(torch.round(x2 * float(np.float32(s))), -128,
                     127).to(torch.int8)
    w32 = w.float()
    ms = time_ms(torch, lambda: im.int8_matmul(x, w, dq, s), flush)
    plain_ms = time_ms(torch, lambda: im.int8_matmul_reference(
        x, w, dq, s), flush, iters=5)
    fp32_ms = time_ms(torch, lambda: torch.matmul(x2, w32), flush)
    # library yardstick: the int8 product alone, int32 out (cuBLASLt's
    # int8 GEMM takes M > 16 and K, N multiples of 8)
    library_ms = None
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        if not torch.equal((torch._int_mm(qa, w).float() * dq)
                           .view(torch.int32),
                           got.reshape(M, N).view(torch.int32)):
            fail("library yardstick torch._int_mm disagrees at %s" % name)
        library_ms = time_ms(torch, lambda: torch._int_mm(qa, w), flush)
    nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 2 * M * K * N / \
        H100_INT8_OPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print("kernel int8_matmul %s: bitwise, %.4f ms (plain %.4f ms, "
          "library %s ms, fp32 matmul %.4f ms, bound %.4f ms by %s)"
          % (shape, ms, plain_ms, "%.4f" % library_ms
             if library_ms is not None else "n/a", fp32_ms, bound_ms,
             bound_by), flush=True)
    return {
        "name": "int8_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:598",
        "path_shape": name, "mkn": [M, K, N], "shape": shape,
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "torch._int_mm on pre-quantized int8 operands: the "
                   "product alone (yardstick)" if library_ms is not None
                   else "none: torch._int_mm takes M > 16 and K, N "
                        "multiples of 8",
        "fp32_matmul_ms": fp32_ms}


def dense_sites(program):
    """[(activation, weight, output)] of every mul of the program: the
    dense layers quant_rewrite turns into fused int8 matmuls; the
    lm_head chunks' read the weight lm_head_w and output the logits."""
    return [(op.input_names("X")[0], op.input_names("Y")[0],
             op.output_names("Out")[0])
            for op in program.global_block().ops if op.type == "mul"]


def baked(scope, suffix):
    """The one value quant_rewrite baked into `scope` for `suffix`
    ("<weight>.int8", "<output>.qdq")."""
    names = [n for n in scope.local_var_names()
             if n.startswith("__quant__.") and n.endswith("." + suffix)]
    if len(names) != 1:
        fail("int8: %d baked scope entries end in %r" % (len(names), suffix))
    return scope.get(names[0])


def int8_phase(torch, fluid, im, fa, program):
    """The fp32 LM's inference clone at batch 32, calibrated on 4 batches
    and decorated full_int8, against the same clone in fp32: 3 warm-up
    and 10 timed steps each on bench.py's batch. Every loss finite, K4
    launched exactly once a dense layer a step at the path's shapes (none
    by the fp32 program), the int8 loss within 1% of the fp32 loss; then
    the logits of both, the quant/* counters and a profiled int8 step.
    K1's fp32 forward must launch once a layer a step by the SIMT route
    in both programs. Returns K4's launches by (M, K, N) and K1's SIMT
    forward launches in the int8 run."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import quant
    from paddle_tpu_torch.observability import metrics

    main, startup, loss = program
    B, warmup, steps = INT8["batch"], INT8["warmup"], INT8["steps"]
    metrics.enable()
    exe = fluid.Executor()                     # place None: cuda:0
    if exe.device.type != "cuda":
        fail("the executor resolved to %s, not the card" % exe.device)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    infer = main.clone(for_test=True)
    calib = [lm_feed(torch, B, exe.device, seed=s)
             for s in range(1, 1 + INT8["calib_batches"])]
    t0 = time.perf_counter()
    table = quant.calibrate(infer, calib, scope=scope)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    del calib
    int8 = quant.decorate(main.clone(for_test=True), "full_int8", table)
    feed = lm_feed(torch, B, exe.device)
    n = warmup + steps
    want = {mkn: per_step * n
            for mkn, per_step in int8_path_shapes().values()}
    runs = {}
    for name, prog in (("fp32", infer), ("int8", int8)):
        torch.cuda.synchronize()
        im.int8_matmul.launches.clear()            # main path starts
        fa.reset_counts()
        losses = []
        for i in range(n):
            if i == warmup:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            out, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
            losses.append(out)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(im.int8_matmul.launches)   # main path ends
        k1 = flash_counts(fa)
        losses = [float(x.cpu()[0]) for x in losses]
        if not all(np.isfinite(losses)):
            fail("int8 inference: non-finite %s loss %r" % (name, losses))
        if launches != (want if name == "int8" else {}):
            fail("int8 inference: the %s program launched int8_matmul %r "
                 "times by (M, K, N) over %d steps; expected %r"
                 % (name, launches, n, want if name == "int8" else {}))
        zero = dict.fromkeys(k1[0], 0)
        k1_want = (dict(zero, f32tc=TRAIN["n_layers"] * n), zero, 0)
        if k1 != k1_want:
            fail("int8 inference: the %s program launched flash attention "
                 "%r (forward, backward by route; copies) over %d steps; "
                 "expected %r" % (name, k1, n, k1_want))
        step_s = (t2 - t1) / steps
        runs[name] = {"losses": losses, "ms_per_step": step_s * 1e3,
                      "tokens_per_s": B * TRAIN["seq_len"] / step_s,
                      "launches": launches,
                      "flash_attention_f32tc_fwd_launches": k1[0]["f32tc"]}
    l32, l8 = runs["fp32"]["losses"][-1], runs["int8"]["losses"][-1]
    logits = [out for _, w, out in dense_sites(infer) if w == "lm_head_w"]
    lo32 = exe.run(infer, feed=feed, fetch_list=logits, scope=scope,
                   return_numpy=False)
    lo8 = exe.run(int8, feed=feed, fetch_list=logits, scope=scope,
                  return_numpy=False)
    err = max(float((a - b).abs().max()) for a, b in zip(lo8, lo32))
    top1 = float(sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                     for a, b in zip(lo8, lo32))
                 / sum(a[..., 0].numel() for a in lo8))
    del lo32, lo8
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tp = time.perf_counter()
        for _ in range(2):
            exe.run(int8, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tp
    busy_s, top = kernel_times(prof, 2, top=10)
    k4_s = sum(device_us(e) for e in prof.key_averages()
               if "int8_mm" in e.key) / 1e6
    counters = {k: v for k, v in metrics.registry().to_dict()["counters"]
                .items() if k.startswith("quant/")}
    metrics.disable()
    summary = {
        "model": "Fluid-API Transformer LM, fp32 inference clone: vocab "
                 "32000, d_model 512, 8 heads, 6 layers, d_ff 2048, seq 512",
        "batch": B, "calib_batches": INT8["calib_batches"],
        "calib_s": calib_s, "warmup_steps": warmup, "timed_steps": steps,
        "loss_rel_diff": abs(l8 - l32) / abs(l32),
        "logits_max_abs_err": err, "top1_agreement": top1,
        "quant_counters": counters,
        "int8_over_fp32_step": (runs["int8"]["ms_per_step"]
                                / runs["fp32"]["ms_per_step"]),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    for name in runs:   # JSON keys: "MxKxN"
        summary[name] = dict(runs[name], launches={
            "x".join(map(str, k)): v
            for k, v in runs[name]["launches"].items()})
    print("int8_inference " + json.dumps(summary), flush=True)
    print("int8 inference: %.2f ms a step against the fp32 clone's %.2f "
          "(int8 / fp32 %.3f); K4 %.2f ms a profiled step, %.3f of the "
          "card's busy time" % (runs["int8"]["ms_per_step"],
                                runs["fp32"]["ms_per_step"],
                                summary["int8_over_fp32_step"],
                                k4_s * 1e3 / 2, k4_s / busy_s), flush=True)
    print("int8_profile " + json.dumps({
        "steps": 2, "wall_ms_per_step": wall * 1e3 / 2,
        "device_busy_ms_per_step": busy_s * 1e3 / 2,
        "device_busy_share": busy_s / wall,
        "int8_matmul_ms_per_step": k4_s * 1e3 / 2,
        "int8_matmul_share_of_busy": k4_s / busy_s,
        "top_kernels": top}), flush=True)
    if not abs(l8 - l32) <= 0.01 * abs(l32):
        fail("int8 inference: loss %r is not within 1%% of the fp32 loss %r"
             % (l8, l32))
    return (runs["int8"]["launches"],
            runs["int8"]["flash_attention_f32tc_fwd_launches"])


def int8_logits_excess(lo_got, lo_want, dq):
    """(largest |diff| over its limit, share of rows that differ) of one
    lm_head chunk's logits [B, T, V], against the bound
    tests/test_torch_quant.py holds the port to the JAX package with: at
    most 1 in 32 rows may differ, and those by at most 1e-5 + 16 * 127 *
    dq[n]. The two sides run the
    fp32 parts of the network (layer norms, attention, gelu, the GEMMs)
    in other summation orders; quantizing turns that into an int8 step
    only where x * act_scale lies that close to a rounding tie; one step
    moves each of the row's outputs by at most 127 dq[n], and a step in
    an FFN layer moves the rows after it, so a differing row may hold
    several. A wrong quantization scale moves almost every row."""
    diff = np.abs(lo_got - lo_want).reshape(-1, lo_got.shape[-1])
    limit = 1e-5 + 16 * 127 * np.asarray(dq, np.float32)[None, :]
    return (float((diff / limit).max()),
            float((diff > 0).any(axis=1).mean()))


def int8_card_vs_cpu_phase(torch, fluid, im, program,
                           devices=("cuda:0", "cpu")):
    """The int8 program from one set of weights and one table (made on
    the card from its own batch), at batch 2, on cuda:0 (K4) and on the
    CPU (the plain version). Every dense layer's output on the card must
    be bitwise the plain version's on the card's own input, with the
    weights, scales and dequantize vectors the CPU run baked; the loss to
    rtol 1e-4; and both lm_head chunks' logits are read against
    `int8_logits_excess`'s bound. A run on the card with every activation
    range 1% too large must fail the layer check at every layer, or the
    check could not see a wrong scale. `devices` is (card, reference);
    the tests pass two CPUs."""
    from paddle_tpu_torch import quant

    main, startup, loss = program
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    for name in scope_c.local_var_names():
        if name != "__step_counter__":
            scope_h.set(name, scope_c.get(name).to("cpu", copy=True))
    infer = main.clone(for_test=True)
    sites = dense_sites(infer)
    heads = [out for _, w, out in sites if w == "lm_head_w"]
    n = len(sites)
    fetch = [loss] + [a for a, _, _ in sites] + [o for _, _, o in sites]
    feed = lm_feed(torch, 2, exe_c.device)
    table = quant.calibrate(infer, [feed], scope=scope_c, place=devices[0])
    t0 = time.perf_counter()
    card = exe_c.run(quant.decorate(main.clone(for_test=True), "full_int8",
                                    table),
                     feed=feed, fetch_list=fetch, scope=scope_c)
    host = exe_h.run(quant.decorate(main.clone(for_test=True), "full_int8",
                                    table),
                     feed=lm_feed(torch, 2, exe_h.device), fetch_list=fetch,
                     scope=scope_h)
    seconds = time.perf_counter() - t0
    wrong = quant.CalibrationTable.from_dict(table.to_dict())
    wrong.acts = {k: v * 1.01 for k, v in wrong.acts.items()}
    fault = exe_c.run(quant.decorate(main.clone(for_test=True), "full_int8",
                                     wrong),
                      feed=feed, fetch_list=fetch, scope=scope_c)

    def layers_differing(run):
        """Sites whose output is not bitwise the plain version's on the
        run's own input, with the right table."""
        bad = []
        for i, (act, w, out) in enumerate(sites):
            want = im.int8_matmul_reference(
                torch.from_numpy(run[1 + i]), baked(scope_h, w + ".int8"),
                baked(scope_h, out + ".qdq"),
                127.0 / max(table.acts[act], 1e-8)).numpy()
            if not np.array_equal(run[1 + n + i].view(np.int32),
                                  want.view(np.int32)):
                bad.append(out)
        return bad

    bad, fault_caught = layers_differing(card), layers_differing(fault)
    loss_rel = abs(float(card[0][0]) - float(host[0][0])) / abs(
        float(host[0][0]))
    chunks = [int8_logits_excess(card[1 + n + i], host[1 + n + i],
                                 baked(scope_h, out + ".qdq").numpy())
              for i, (_, _, out) in enumerate(sites) if out in heads]
    report = {"batch": 2, "dense_layers": n, "layers_not_bitwise": bad,
              "loss_cuda": float(card[0][0]), "loss_cpu": float(host[0][0]),
              "loss_rel_diff": loss_rel,
              "logits_excess_and_rows_differing": chunks,
              "act_scale_1pct_fault_layers_caught": len(fault_caught),
              "seconds": seconds}
    print("int8_card_vs_cpu " + json.dumps(report), flush=True)
    if bad:
        fail("int8 card vs CPU: %d of %d dense layers are not bitwise the "
             "plain version on their own input: %s" % (len(bad), n, bad))
    if not loss_rel <= 1e-4:
        fail("int8 card vs CPU: losses %r vs %r (rel %.3g > 1e-4)"
             % (float(card[0][0]), float(host[0][0]), loss_rel))
    if len(fault_caught) != n:
        fail("int8 card vs CPU: a 1%% act-scale fault passes the layer check "
             "at %d of %d layers" % (n - len(fault_caught), n))


# phase 9: image classification — benchmark/fluid_benchmark.py's
# run_static_model recipe (:223-300) through the port: a builder of
# models/, Adam(0.01) (--use_amp: contrib decorate with a static loss
# scale of 1.0), minimize, Executor.run on cuda:0 with the loss fetched
# every step, on _feeds' RandomState(0) batch (:79-104) staged once on
# the card, skip_batch_num 5 warm-up steps then timed steps
IMAGE_LR = 0.01
IMAGE_BATCH = 64                  # _DEFAULT_BATCH["resnet"]
IMAGE_STEPS = (5, 10)             # skip_batch_num, timed
# builder -> (build(models), feed shape, classes)
IMAGE_BUILDERS = {
    "resnet50_imagenet": (lambda m: m.resnet.build(dataset="imagenet"),
                          (3, 224, 224), 1000),
    "mnist_mlp": (lambda m: m.mnist.build(arch="mlp"), (784,), 10),
    "mnist_cnn": (lambda m: m.mnist.build(arch="cnn"), (1, 28, 28), 10),
    "resnet32_cifar": (lambda m: m.resnet.build(dataset="cifar10"),
                       (3, 32, 32), 10),
    "vgg16_cifar": (lambda m: m.vgg.build(dataset="cifar10"), (3, 32, 32),
                    10),
    "se_resnext50_cifar": (lambda m: m.se_resnext.build(class_dim=10),
                           (3, 32, 32), 10),
}
# 9b: each other builder at its _DEFAULT_BATCH
IMAGE_OTHERS = (("mnist_mlp", 128), ("mnist_cnn", 128),
                ("resnet32_cifar", 64), ("vgg16_cifar", 64),
                ("se_resnext50_cifar", 32))
# 9c: the fp32 cifar ResNet at depth 8 plus one bottleneck stage, batch 8,
# two Adam steps on the card and on the CPU, each from one state
# (image_card_vs_cpu_phase)
IMAGE_CVC = dict(batch=8, steps=2)


def build_image(fluid, name, amp=False):
    """(main, startup, loss, test clone) of builder `name` under
    Adam(IMAGE_LR), the clone taken before minimize, as a training script
    takes it."""
    from paddle_tpu_torch import models

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, _, loss, _ = IMAGE_BUILDERS[name][0](models)
        test = main.clone(for_test=True)
        opt = fluid.optimizer.Adam(IMAGE_LR)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    return main, startup, loss, test


def image_feed(torch, shape, classes, batch, device):
    """_feeds' batch: RandomState(0), img uniform [0, 1), int64 labels,
    as tensors on `device` (staged once)."""
    rng = np.random.RandomState(0)
    img = rng.rand(batch, *shape).astype(np.float32)
    label = rng.randint(0, classes, (batch, 1)).astype(np.int64)
    return {"img": torch.from_numpy(img).to(device),
            "label": torch.from_numpy(label).to(device)}


def moving_stats(main):
    return sorted(op.outputs[s][0].name for op in main.global_block().ops
                  if op.type == "batch_norm"
                  for s in ("MeanOut", "VarianceOut"))


def kernel_launch_totals(fa, pa, pat, im):
    """K1 (both ways), K2, K3 and K4's launch counts as they stand."""
    return {"K1": fa.flash_attention_fwd.launches
            + fa.flash_attention_bwd.launches,
            "K2": sum(pa.paged_attention.window_launches.values()),
            "K3": pat.paged_attention_tree.launches,
            "K4": sum(im.int8_matmul.launches.values())}


def image_leg(torch, fluid, name, amp, batch, steps=IMAGE_STEPS,
              device=None):
    """One leg of phase 9a: IMAGE_STEPS runs of the builder's program
    (loss fetched each step) on its fixed staged batch; then the test
    clone once. Returns what the gates and the image_train line read."""
    main, startup, loss, test = build_image(fluid, name, amp)
    exe = fluid.Executor(device)
    on_card = exe.device.type == "cuda"
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    shape, classes = IMAGE_BUILDERS[name][1:]
    feed = image_feed(torch, shape, classes, batch, exe.device)
    stats = moving_stats(main)
    start = {n: scope.get(n).clone() for n in stats}
    warmup, timed = steps
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    outs, marks, host_ms = [], [], []
    for i in range(warmup + timed):
        if on_card and i >= warmup:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            return_numpy=False))
        host_ms.append((time.perf_counter() - th) * 1e3)
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    after = {n: scope.get(n).clone() for n in stats}
    leg = {"leg": name + ("_amp" if amp else "_fp32"), "batch": batch,
           "warmup": warmup, "steps": timed, "runs": warmup + timed,
           "params": len(main.param_grad_map), "batch_norms": len(stats) // 2,
           "losses": [float(o[0].float().cpu()[0]) for o in outs],
           "stats_finite": all(bool(torch.isfinite(t).all())
                               for t in after.values()),
           "stats_unmoved": sorted(n for n in stats
                                   if torch.equal(after[n], start[n])),
           "host_ms_each": host_ms[warmup:],
           "step_ms_each": [a.elapsed_time(b)
                            for a, b in zip(marks, marks[1:])]}
    if on_card:
        dev = float(np.mean(leg["step_ms_each"]))
        leg.update(device_ms_per_step=dev,
                   host_ms_per_step=float(np.mean(host_ms[warmup:])),
                   images_per_s=batch / dev * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   cudnn_benchmark=torch.backends.cudnn.benchmark,
                   profile=update_cost_profile(
                       torch, exe, main, feed, [loss], scope))
        # the card's busy share of a timed step: kernel time over step time
        leg["busy_share"] = leg["profile"]["device_busy_ms"] / dev
    # the test clone once, on the trained weights: it reads the moving
    # statistics and leaves them bitwise as they were
    before = {n: scope.get(n).clone() for n in stats}
    out, = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
    leg["test_loss"] = float(out[0])
    leg["test_clone_moved"] = sorted(n for n in stats
                                     if not torch.equal(scope.get(n),
                                                        before[n]))
    del exe, scope
    return leg


def check_image_leg(leg):
    """Phase 9a's gates on one leg: the loss finite and falling over the
    runs (the batch is fixed); every moving statistic finite and moved
    from its start; the test clone's loss finite and its run leaving the
    statistics bitwise unmoved."""
    name, losses = leg["leg"], leg["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail("image_train %s: losses not finite and falling: %r"
             % (name, losses))
    if not leg["stats_finite"]:
        fail("image_train %s: a moving statistic is not finite" % name)
    if leg["stats_unmoved"]:
        fail("image_train %s: %d moving statistics never moved from their "
             "start (%r)" % (name, len(leg["stats_unmoved"]),
                             leg["stats_unmoved"][:4]))
    if not np.isfinite(leg["test_loss"]):
        fail("image_train %s: the test clone's loss is %r"
             % (name, leg["test_loss"]))
    if leg["test_clone_moved"]:
        fail("image_train %s: the test clone moved %r" % (
            name, leg["test_clone_moved"][:4]))


def conv_tf32_check(torch, fluid):
    """The conv op at a ResNet-50 shape (batch 64, 64 -> 64 channels, 3x3
    over 56x56), forward and both grads, with TF32 on and off (cuDNN's
    and cuBLAS's switches both): bitwise equal, and the switches left as
    they were; plain F.conv2d under TF32 differs (so this card's cuDNN
    does take the switch)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.core.lowering import LoweringContext
    from paddle_tpu_torch.ops import registry

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda", 0)
    x = torch.randn(64, 64, 56, 56, device=dev, generator=gen)
    w = torch.randn(64, 64, 3, 3, device=dev, generator=gen) * 0.05
    g = torch.randn(64, 64, 56, 56, device=dev, generator=gen)
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1}
    impl = registry.get("conv2d").impl
    switches = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [m.allow_tf32 for m in switches] + [
        torch.backends.cudnn.deterministic]
    torch.backends.cudnn.deterministic = True
    runs, plain = [], []
    try:
        for tf32 in (True, False):
            for m in switches:
                m.allow_tf32 = tf32
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = impl(LoweringContext(dev), {"Input": [xl], "Filter": [wl]},
                       attrs)["Output"][0]
            runs.append([out.detach()] + list(torch.autograd.grad(
                out, [xl, wl], g)))
            if any(m.allow_tf32 is not tf32 for m in switches):
                fail("conv tf32: the op left a TF32 switch changed")
            plain.append(F.conv2d(x, w, padding=1))
        # cuDNN's own fp32 convolution, TF32 off (the last setting), for
        # comparison
        cudnn_fp32 = [plain[1]] + list(torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])[:2])
    finally:
        for m, v in zip(switches, saved):
            m.allow_tf32 = v
        torch.backends.cudnn.deterministic = saved[-1]
    equal = [bool(torch.equal(a, b)) for a, b in zip(*runs)]

    # out, dx and dw in float64
    ref = [F.conv2d(x.double(), w.double(), padding=1)] + list(
        torch.ops.aten.convolution_backward(
            g.double(), x.double(), w.double(), None, [1, 1], [1, 1],
            [1, 1], False, [0, 0], 1, [True, True, False])[:2])

    def off_float64(got):
        """Each of out, dx, dw off float64, over the tensor's largest."""
        return [float((a.double() - r).abs().max() / r.abs().max())
                for a, r in zip(got, ref)]

    report = {"serving_imported": "paddle_tpu_torch.serving.model"
                                  in sys.modules,
              "allow_tf32_now": [m.allow_tf32 for m in switches],
              "op_bitwise_out_dx_dw": equal,
              "plain_conv_tf32_max_abs_diff": float(
                  (plain[0] - plain[1]).abs().max()),
              "op_off_float64_out_dx_dw": off_float64(runs[1]),
              "cudnn_fp32_off_float64_out_dx_dw": off_float64(cudnn_fp32)}
    print("image_conv_tf32 " + json.dumps(report), flush=True)
    if not all(equal):
        fail("conv tf32: the fp32 conv op's output / grads depend on "
             "the TF32 switches: %r" % equal)


def image_phase(torch, fluid):
    """Phase 9a and 9b on cuda:0: the fp32 conv op against the TF32
    switch, ResNet-50 (ImageNet) at batch 64 in the fp32 and amp legs,
    gated and printed on image_train lines, then one step of each other
    builder at its default batch."""
    conv_tf32_check(torch, fluid)
    legs = {}
    for amp in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        leg = image_leg(torch, fluid, "resnet50_imagenet", amp, IMAGE_BATCH)
        check_image_leg(leg)
        legs[leg["leg"]] = leg
        print("image_train " + json.dumps(dict(leg, card=card_line())),
              flush=True)
    f, a = legs["resnet50_imagenet_fp32"], legs["resnet50_imagenet_amp"]
    print("image_train_ratio " + json.dumps({
        "device_ms_amp_over_fp32":
            a["device_ms_per_step"] / f["device_ms_per_step"],
        "host_ms_amp_over_fp32":
            a["host_ms_per_step"] / f["host_ms_per_step"],
        "peak_gib_amp_over_fp32": a["peak_gib"] / f["peak_gib"]}),
        flush=True)
    for row in image_builders_phase(torch, fluid):
        print("image_builder " + json.dumps(row), flush=True)


def image_builders_phase(torch, fluid, builders=IMAGE_OTHERS, device=None):
    """Phase 9b: one Adam step of each builder at its batch on a fresh
    scope; each loss must be finite."""
    rows = []
    for name, batch in builders:
        gc.collect()
        main, startup, loss, _ = build_image(fluid, name)
        exe, scope = fluid.Executor(device), fluid.Scope()
        exe.run(startup, scope=scope)
        shape, classes = IMAGE_BUILDERS[name][1:]
        feed = image_feed(torch, shape, classes, batch, exe.device)
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        row = {"builder": name, "batch": batch, "loss": float(out[0]),
               "params": len(main.param_grad_map),
               "first_step_s": time.perf_counter() - t0}
        if not np.isfinite(row["loss"]):
            fail("image_builder %s: loss %r" % (name, row["loss"]))
        rows.append(row)
        del exe, scope
    return rows


def resnet8_bottleneck(models):
    """The cifar ResNet at depth 8 (three basic-block stages) plus one
    bottleneck stage (64 -> 4 x 32 channels, stride 2), a global average
    pool and the softmax head: a builder's returns."""
    r, layers = models.resnet, models.resnet.layers
    img = layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    x = r.conv_bn_layer(img, ch_out=16, filter_size=3, stride=1, padding=1)
    x = r.layer_warp(r.basicblock, x, 16, 16, 1, 1)
    x = r.layer_warp(r.basicblock, x, 16, 32, 1, 2)
    x = r.layer_warp(r.basicblock, x, 32, 64, 1, 2)
    x = r.layer_warp(r.bottleneck, x, 64, 32, 1, 2)
    pool = layers.pool2d(input=x, pool_type="avg", global_pooling=True)
    predict = layers.fc(input=pool, size=10, act="softmax")
    cost = layers.mean(layers.cross_entropy(input=predict, label=label))
    return img, label, predict, cost, layers.accuracy(predict, label)


IMAGE_BUILDERS["resnet8_bottleneck"] = (resnet8_bottleneck, (3, 32, 32), 10)


def build_image_cvc(fluid):
    """Phase 9c's program: `resnet8_bottleneck` in fp32 under
    Adam(IMAGE_LR)."""
    return build_image(fluid, "resnet8_bottleneck")


def image_card_vs_cpu_phase(torch, fluid, program,
                            devices=("cuda:0", "cpu")):
    """Phase 9c: IMAGE_CVC's Adam steps on cuda:0 and on the CPU, each
    from the same state: the startup's weights, and before each later
    step the CPU's whole state (parameters, moments, beta powers, moving
    statistics) set on the card. Why: Adam's first step moves an element
    by the rate whatever its grad, so where a grad is rounding noise the
    devices' weights part by up to twice the rate, and a second step's
    grads from weights so far apart differ past any fp32 limit. The
    CPU's relus take the card's branches, x * (x_card != 0): where a
    pre-activation lies within fp32's rounding of 0 the two devices may
    put it on either side, and one such element moves a weight grad that
    is a cancelling sum by up to 18% of its largest (one element in 4 of
    16 init draws; PERF.md §6); how many elements the CPU would have put
    on the other side is read. Each step is held to fp32's STEP_TOL: its
    loss to loss_rtol, every grad to grad_rtol of the tensor's largest
    plus the floor, every moving statistic after it to loss_rtol of the
    tensor's largest, and every parameter after it within 2 ulps plus
    what grads that far apart let Adam move it (``adam_param_limit``). A
    skipped step-1 update must fail the parameter check on most
    parameters. `devices` is (card, reference); the tests pass two CPUs
    and plant faults in the first."""
    from paddle_tpu_torch.ops import registry

    main, startup, loss, _ = program
    tol = STEP_TOL["float32"]
    rel, bits = tol["grad_rtol"], tol["mantissa_bits"]
    params = sorted(main.param_grad_map)
    stats = moving_stats(main)
    fetch = [loss] + [main.param_grad_map[p] for p in params]
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    state = [n for n in scope_c.local_var_names() if n != "__step_counter__"]
    for n in state:
        scope_h.set(n, scope_c.get(n).to("cpu", copy=True))
    worst = {k: (0.0, "") for k in ("loss", "grad", "stat", "param")}
    g_ref = {p: [] for p in params}
    worst_skip, skip_caught = -np.inf, 0
    relu = registry.get("relu")
    relu_impl, branches, crossed = relu.impl, [], [0]

    def record(ctx, ins, attrs):
        out = relu_impl(ctx, ins, attrs)
        branches.append(out["Out"][0].detach() != 0)
        return out

    def replay(ctx, ins, attrs):
        x, card = ins["X"][0], branches.pop(0).to(exe_h.device)
        crossed[0] += int(((x.detach() > 0) != card).sum())
        return {"Out": [x * card.to(x.dtype)]}

    t0 = time.perf_counter()
    for step in range(IMAGE_CVC["steps"]):
        if step:
            for n in state:
                scope_c.set(n, scope_h.get(n).to(exe_c.device, copy=True))
        start = {p: scope_h.get(p).float().numpy().copy() for p in params}
        outs = []
        try:
            for exe, scope, impl in ((exe_c, scope_c, record),
                                     (exe_h, scope_h, replay)):
                relu.impl = impl
                outs.append(exe.run(main, feed=image_feed(
                    torch, (3, 32, 32), 10, IMAGE_CVC["batch"], exe.device),
                    fetch_list=fetch, scope=scope))
        finally:
            relu.impl = relu_impl
        c, h = outs
        tag = "@%d" % (step + 1)
        worst["loss"] = max(worst["loss"], (abs(float(c[0][0]) - float(
            h[0][0])) / abs(float(h[0][0])), "loss" + tag))
        floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                       for g in h[1:])
        for p, gc_, gh in zip(params, c[1:], h[1:]):
            lim = rel * float(np.abs(gh).max()) + floor
            worst["grad"] = max(worst["grad"], (
                float(np.abs(gc_ - gh).max()) / lim, p + tag))
            g_ref[p].append(gh)
            # the earlier steps' grads are the same on both: one state
            g_err = [np.zeros_like(gh)] * step + [np.full_like(gh, lim)]
            pc = scope_c.get(p).float().cpu().numpy()
            ph = scope_h.get(p).float().numpy()
            mag = np.maximum(np.maximum(np.abs(pc), np.abs(ph)),
                             np.abs(start[p]))
            p_lim = adam_param_limit(g_ref[p], g_err,
                                     [IMAGE_LR] * (step + 1), 0.9, 0.999) \
                + 2 * ulp(mag, bits)
            worst["param"] = max(worst["param"], (
                float((np.abs(pc - ph) / p_lim).max()), p + tag))
            if step == 0:
                skipped = float((np.abs(start[p] - ph) / p_lim).max())
                worst_skip = max(worst_skip, skipped)
                skip_caught += skipped > 1
        for n in stats:
            hs = scope_h.get(n).float().numpy()
            worst["stat"] = max(worst["stat"], (float(np.abs(
                scope_c.get(n).float().cpu().numpy() - hs).max()) / (
                    tol["loss_rtol"] * float(np.abs(hs).max())), n + tag))
    seconds = time.perf_counter() - t0
    report = {
        "dtype": "float32", "model": "cifar ResNet-8 + a bottleneck stage",
        "batch": IMAGE_CVC["batch"], "steps": IMAGE_CVC["steps"],
        "params": len(params), "moving_stats": len(stats),
        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "loss_rel_err": worst["loss"][0], "loss_limit": tol["loss_rtol"],
        "grad_rtol": rel,
        "worst_grad_err_over_limit": worst["grad"][0],
        "worst_grad": worst["grad"][1],
        "worst_stat_err_over_limit": worst["stat"][0],
        "worst_stat": worst["stat"][1],
        "worst_param_err_over_limit": worst["param"][0],
        "worst_param": worst["param"][1],
        "skipped_update_worst_reading": worst_skip,
        "skipped_update_fails_params": skip_caught,
        "relu_elements_the_cpu_would_cross": crossed[0],
        "seconds": seconds}
    print("card_vs_cpu_image " + json.dumps(report), flush=True)
    if worst["loss"][0] > tol["loss_rtol"]:
        fail("card vs CPU image: the %s differs by %.3g (rel > %g)"
             % (worst["loss"][1], worst["loss"][0], tol["loss_rtol"]))
    for k, what in (("grad", "the grad of"), ("stat", "the moving statistic"),
                    ("param", "the parameter")):
        if worst[k][0] > 1:
            fail("card vs CPU image: %s %s differs by %.3g of its limit"
                 % (what, worst[k][1], worst[k][0]))
    if 2 * skip_caught < len(params):
        fail("card vs CPU image: a skipped update would pass the parameter "
             "check on %d of %d parameters"
             % (len(params) - skip_caught, len(params)))

# phase 10: the inference predictor — a model saved with
# io.save_inference_model and served by inference.AnalysisPredictor on
# cuda:0 (the load-time passes conv_bn_fold, dropout_remove and
# conv_elementwise_add_fuse; enable_quantize), on a fixed batch staged on
# the card: 10a ResNet-50 (ImageNet) at batch 64 in four legs, 10b the
# mnist cnn through a full_int8 predictor at batch 128 against the same
# predictor on the CPU, 10c bench.py's bench_quant_predictor through the
# port's bench
PREDICT = dict(batch=64, warmup=3, runs=10, calib_batches=4)
PREDICT_MNIST_BATCH = 128
# 10a's legs: (name, switch_ir_optim, enable_quantize mode)
PREDICT_LEGS = (("fp32_no_ir_optim", False, None), ("fp32", True, None),
                ("full_int8", True, "full_int8"),
                ("weight_only", True, "weight_only"))
# folded against unfolded fp32 ResNet-50, |p_fold - p| on the softmax
# output: the fold rounds W * gamma / std once and turns conv -> affine
# into conv -> shift, a few fp32 roundings a layer that the ~50 layers
# carry to the logits (CPU, batch 4, std 1.34: 1.28e-4 at most) and a
# probability moves by at most 2 p |dz| (p <= 0.03: 7.7e-6): 2e-5 leaves
# 2.6x that; a fault of the fold's algebra moves the logits by whole
# percents. A row whose two top probabilities lie closer than the limit
# may change its top-1.
PREDICT_FOLD_ATOL = 2e-5
# 10b, the mnist cnn in full_int8, card against CPU on the softmax output:
# every op before the softmax is exact or elementwise (the int8
# convolutions and K4 exact in integers, quantize, dequantize, bias, relu
# and max pool one rounding each, the same on both devices), so only the
# softmax's exp and sum differ: a few ulps of p <= 1, limit 16 ulps of 1
PREDICT_CARD_CPU_ATOL = 16 * 2.0 ** -24


def build_predictor_model(fluid, name):
    """(train-mode main, startup, its clone(for_test=True), predict) of
    builder `name`, with no optimizer: main's forward updates nothing but
    the batch norms' moving statistics."""
    from paddle_tpu_torch import models

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, predict, _, _ = IMAGE_BUILDERS[name][0](models)
        test = main.clone(for_test=True)
    return main, startup, test, test.global_block().var(predict.name)


def predictor_feed(torch, name, batch, device, seed=0):
    """A batch of `name`'s images (uniform [0, 1), RandomState(seed)) as
    a tensor on `device`, staged once."""
    shape = IMAGE_BUILDERS[name][1]
    img = np.random.RandomState(seed).rand(batch, *shape).astype(np.float32)
    return torch.from_numpy(img).to(device)


def save_predictor_model(torch, fluid, name, batch, device, dirname):
    """Save builder `name`'s inference model (target: the softmax
    `predict`) into `dirname` from a scope whose batch norms moved: each
    norm's scale drawn from U(0.5, 1.5) and shift from 0.1 N(0, 1)
    (RandomState(0)), and its moving mean and variance set to the batch
    statistics of the train-mode forward on RandomState(0)'s batch, the
    values a trained model's moving statistics approach. The fold is not
    the identity. Returns the moving statistics' names."""
    main, startup, test, predict = build_predictor_model(fluid, name)
    exe, scope = fluid.Executor(device), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    bns = [op for op in main.global_block().ops if op.type == "batch_norm"]
    for op in bns:
        for slot, draw in (("Scale", lambda c: rng.uniform(0.5, 1.5, c)),
                           ("Bias", lambda c: 0.1 * rng.randn(c))):
            n = op.input_names(slot)[0]
            t = scope.get(n)
            scope.set(n, torch.from_numpy(draw(t.shape[0]).astype(
                np.float32)).to(t.device))
    feed = {"img": predictor_feed(torch, name, batch, exe.device)}
    if any(v.name == "label" for v in main.global_block().vars.values()):
        feed["label"] = torch.zeros(batch, 1, dtype=torch.int64,
                                    device=exe.device)
    fetch = [op.output_names(slot)[0] for op in bns
             for slot in ("SavedMean", "SavedVariance")]
    stats = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False) if fetch else []
    moving = []
    for i, op in enumerate(bns):
        for j, slot in enumerate(("Mean", "Variance")):
            n = op.input_names(slot)[0]
            scope.set(n, stats[2 * i + j].detach().clone())
            moving.append(n)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(dirname, ["img"], [predict], exe,
                                      main_program=test)
    del exe, scope
    return moving


def predictor(dirname, device, ir_optim=True, mode=None, table=None):
    """An AnalysisPredictor of `dirname` on `device` (None: the config's
    own cuda:0)."""
    from paddle_tpu_torch import inference

    cfg = inference.AnalysisConfig(dirname)
    if device is not None and str(device) == "cpu":
        cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    if mode:
        cfg.enable_quantize(mode, calibration_table=table)
    return inference.create_paddle_predictor(cfg)


def mkn_keys(launches):
    """K4's launches by (M, K, N) with JSON keys "MxKxN"."""
    return {"x".join(map(str, k)): v for k, v in launches.items()}


def predictor_profile(torch, pred, feed, runs=2):
    """`runs` more runs of the predictor under torch.profiler, each op in a
    ``ptpu_op:<type>`` range: the launches a run (the runtime's launch
    calls), the card's busy ms a run and its share of the wall time, the
    device ms a run by op type, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.core import lowering

    inner = lowering.execute_op

    def traced(op, env, ctx):
        with record_function("ptpu_op:" + op.type):
            inner(op, env, ctx)

    lowering.execute_op = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                pred.run_dict({"img": feed})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        lowering.execute_op = inner
    cuda = torch.autograd.DeviceType.CUDA
    launches = sum("LaunchKernel" in e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU)
    kernels = sorted(((device_us(e) / 1e3, e.count, e.key)
                      for e in prof.key_averages() if e.device_type == cuda
                      and not e.key.startswith(("ptpu_op:", "aten::"))),
                     reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    by_op = {}
    for e in prof.key_averages():
        if e.device_type != cuda and e.key.startswith("ptpu_op:"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            by_op[e.key[8:]] = by_op.get(e.key[8:], 0.0) + us / 1e3 / runs
    return {"runs": runs, "launches_per_run": launches / runs,
            "device_busy_ms_per_run": busy_ms / runs,
            "wall_ms_per_run": wall * 1e3 / runs,
            "busy_share": busy_ms / 1e3 / wall,
            "device_ms_per_run_by_op": {k: round(v, 4) for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])},
            "top_kernels": [{"kernel": k[:90], "calls": n, "ms": ms}
                            for ms, n, k in kernels[:8]]}


def predictor_leg(torch, im, pred, name, feed, warmup, runs):
    """`warmup` then `runs` timed runs of `pred` on the staged batch
    `feed`, K4's launches counted over all of them (the main path: the
    counts zeroed just before, read just after). Returns what the gates
    and the `predictor` line read, and the last output."""
    on_card = feed.device.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    im.int8_matmul.launches.clear()            # main path starts
    host_ms, marks, out = [], [], None
    for i in range(warmup + runs):
        if on_card and i >= warmup:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        out, = pred.run_dict({"img": feed})
        if i >= warmup:
            host_ms.append((time.perf_counter() - th) * 1e3)
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    launches = dict(im.int8_matmul.launches)   # main path ends
    ops = [op.type for op in pred._program.global_block().ops]
    leg = {"leg": name, "batch": int(feed.shape[0]), "warmup": warmup,
           "runs": runs, "k4_launches": launches,
           "ops": {t: ops.count(t) for t in sorted(set(ops))},
           "finite": bool(np.isfinite(out).all()),
           "host_ms_per_batch": float(np.mean(host_ms))}
    if on_card:
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        leg.update(ms_per_batch=float(np.mean(ms)),
                   images_per_s=leg["batch"] / float(np.mean(ms)) * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   profile=predictor_profile(torch, pred, feed))
        leg["busy_share"] = leg["profile"]["busy_share"]
        leg["launches_per_run"] = leg["profile"]["launches_per_run"]
    return leg, out


def classifier_bitwise(torch, im, pred, feed, table):
    """The full-int8 predictor's classifier (each fused int8 matmul of its
    compiled program) on its own input, fetched from one more run, against
    K4's plain version on the CPU with the baked weight and dequantize
    vector and the table's act scale: [(output, bitwise)]."""
    from paddle_tpu_torch import quant

    sites = dense_sites(pred._program)
    fetch = [a for a, _, _ in sites] + [o for _, _, o in sites]
    outs = pred._exe.run(pred._program, feed={"img": feed},
                         fetch_list=fetch, scope=pred._scope)
    n, res = len(sites), []
    for i, (act, w, out) in enumerate(sites):
        want = im.int8_matmul_reference(
            torch.from_numpy(outs[i]).reshape(outs[i].shape[0], -1),
            baked(pred._scope, w + ".int8").cpu(),
            baked(pred._scope, out + ".qdq").cpu(),
            quant._QMAX / max(table.acts[act], quant._EPS)).numpy()
        res.append((out, bool(np.array_equal(
            outs[n + i].reshape(want.shape).view(np.int32),
            want.view(np.int32)))))
    return res


def fold_agreement(p_fold, p_plain, atol=PREDICT_FOLD_ATOL):
    """(max |p_fold - p_plain|, rows whose top-1 differs while the
    unfolded output's top-2 margin is at least `atol`)."""
    top2 = np.sort(p_plain, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    differs = p_fold.argmax(1) != p_plain.argmax(1)
    return (float(np.abs(p_fold - p_plain).max()),
            [int(r) for r in np.nonzero(differs & (margin >= atol))[0]])


def check_predictor_legs(legs, checks, on_card, k4_mkn):
    """10a's gates: every output finite; no batch_norm after the passes;
    the folded fp32 output within PREDICT_FOLD_ATOL of the unfolded one
    and its top-1 equal but where the unfolded top-2 margin is below it;
    the classifier bitwise K4's plain version; on the card K4 launched
    once a run at `k4_mkn` by full_int8 and by no other leg."""
    for name, leg in legs.items():
        if not leg["finite"]:
            fail("predictor %s: the output is not finite" % name)
        if name != "fp32_no_ir_optim" and leg["ops"].get("batch_norm"):
            fail("predictor %s: %d batch_norm ops left after the load-time "
                 "passes" % (name, leg["ops"]["batch_norm"]))
        if on_card:
            want = ({tuple(k4_mkn): leg["warmup"] + leg["runs"]}
                    if name == "full_int8" else {})
            if leg["k4_launches"] != want:
                fail("predictor %s: K4 launched %r times by (M, K, N); "
                     "expected %r" % (name, leg["k4_launches"], want))
    if not legs["fp32_no_ir_optim"]["ops"].get("batch_norm"):
        fail("predictor: the unoptimized leg has no batch_norm")
    if not checks["fold_max_abs_diff"] <= PREDICT_FOLD_ATOL:
        fail("predictor: the folded fp32 output differs from the unfolded "
             "one by %.3g (> %g)" % (checks["fold_max_abs_diff"],
                                     PREDICT_FOLD_ATOL))
    if checks["fold_top1_rows_differing"]:
        fail("predictor: the folded fp32 top-1 differs at rows %r, whose "
             "top-2 margin is at least %g"
             % (checks["fold_top1_rows_differing"], PREDICT_FOLD_ATOL))
    bad = [o for o, ok in checks["classifier_bitwise"] if not ok]
    if not checks["classifier_bitwise"] or bad:
        fail("predictor full_int8: the classifier is not bitwise K4's "
             "plain version on its own input: %r"
             % (bad or "no fused int8 matmul"))


def predictor_resnet_phase(torch, fluid, im, name="resnet50_imagenet",
                           batch=PREDICT["batch"], device=None):
    """Phase 10a: builder `name`'s inference model saved (moved batch
    norms, ``save_predictor_model``), then four predictors on one staged
    batch — fp32 with switch_ir_optim(False), fp32, full_int8 (calibrated
    on the fp32 predictor over 4 batches) and weight_only — each
    PREDICT's warm-up and timed runs, gated (``check_predictor_legs``)
    and printed on `predictor` lines. Returns K4's launches by (M, K, N)
    of the full_int8 leg."""
    import shutil
    import tempfile

    from paddle_tpu_torch import quant

    dirname = tempfile.mkdtemp(prefix="ptpu_predictor_")
    try:
        save_predictor_model(torch, fluid, name, batch, device, dirname)
        preds = {"fp32_no_ir_optim": predictor(dirname, device,
                                               ir_optim=False),
                 "fp32": predictor(dirname, device)}
        dev = preds["fp32"]._exe.device
        on_card = dev.type == "cuda"
        feed = predictor_feed(torch, name, batch, dev)
        t0 = time.perf_counter()
        table = quant.calibrate(
            preds["fp32"]._program,
            [{"img": predictor_feed(torch, name, batch, dev, seed=s)}
             for s in range(1, 1 + PREDICT["calib_batches"])],
            scope=preds["fp32"]._scope, place=dev)
        calib_s = time.perf_counter() - t0
        preds["full_int8"] = predictor(dirname, device,
                                       mode="full_int8", table=table)
        preds["weight_only"] = predictor(dirname, device,
                                         mode="weight_only")
        legs, outs = {}, {}
        for leg_name, _, _ in PREDICT_LEGS:
            legs[leg_name], outs[leg_name] = predictor_leg(
                torch, im, preds[leg_name], leg_name, feed,
                PREDICT["warmup"], PREDICT["runs"])
        sites = dense_sites(preds["fp32"]._program)
        fold_diff, fold_rows = fold_agreement(outs["fp32"],
                                              outs["fp32_no_ir_optim"])
        checks = {"fold_max_abs_diff": fold_diff,
                  "fold_limit": PREDICT_FOLD_ATOL,
                  "fold_top1_rows_differing": fold_rows,
                  "classifier_bitwise": classifier_bitwise(
                      torch, im, preds["full_int8"], feed, table)}
        w8, w32 = preds["weight_only"]._scope, preds["fp32"]._scope
        fp32_bytes = saved = 0
        for w in table.weights:
            q = w8.get(w + ".int8")
            if q is not None:
                fp32_bytes += w32.get(w).numel() * 4
                saved += w32.get(w).numel() * 4 - q.numel()
        full = legs["full_int8"]
        full.update(
            top1_agreement=float((outs["full_int8"].argmax(1)
                                  == outs["fp32"].argmax(1)).mean()),
            max_abs_err=float(np.abs(outs["full_int8"]
                                     - outs["fp32"]).max()),
            weight_bytes_saved_ratio=saved / fp32_bytes,
            calib_s=calib_s, calib_batches=PREDICT["calib_batches"])
        for leg in legs.values():
            print("predictor " + json.dumps(dict(
                leg, k4_launches=mkn_keys(leg["k4_launches"]), model=name,
                card=card_line() if on_card else None)), flush=True)
        print("predictor_checks " + json.dumps(dict(
            checks, classifier=sites, model=name)), flush=True)
        check_predictor_legs(legs, checks, on_card,
                             (batch,) + tuple(preds["fp32"]._program
                                              .global_block().var(
                                                  sites[-1][1]).shape))
        return legs["full_int8"]["k4_launches"]
    finally:
        shutil.rmtree(dirname, ignore_errors=True)


def predictor_mnist_phase(torch, fluid, im, batch=PREDICT_MNIST_BATCH,
                          devices=("cuda:0", "cpu")):
    """Phase 10b: the mnist cnn saved (``save_predictor_model``) and
    served by a full_int8 predictor on the card and on the CPU from one
    table (calibrated on the card's fp32 predictor over 4 batches): its
    two convolutions run on int8 operands (quantize, the float64 route of
    ``ops/conv.py``, dequantize) and its fc on K4 at N=10. Fatal unless
    both outputs are finite, the classifier on the card is bitwise K4's
    plain version on its own input, the softmax outputs agree within
    PREDICT_CARD_CPU_ATOL and, on the card, K4 launched once a run.
    Prints a `predictor_mnist` line with the int8 convolutions' device ms
    a run. Returns K4's launches by (M, K, N)."""
    import shutil
    import tempfile

    from paddle_tpu_torch import quant

    name = "mnist_cnn"
    dirname = tempfile.mkdtemp(prefix="ptpu_predictor_")
    try:
        save_predictor_model(torch, fluid, name, batch, devices[0], dirname)
        fp32 = predictor(dirname, devices[0])
        dev = fp32._exe.device
        table = quant.calibrate(
            fp32._program,
            [{"img": predictor_feed(torch, name, batch, dev, seed=s)}
             for s in range(1, 1 + PREDICT["calib_batches"])],
            scope=fp32._scope, place=dev)
        card = predictor(dirname, devices[0], mode="full_int8",
                         table=table)
        host = predictor(dirname, devices[1], mode="full_int8",
                         table=table)
        feed = predictor_feed(torch, name, batch, dev)
        leg, got = predictor_leg(torch, im, card, "mnist_full_int8", feed,
                                 PREDICT["warmup"], PREDICT["runs"])
        want, = host.run_dict({"img": feed.cpu()})
        compiled = [op.type for st in card._exe._cache.values()
                    for op in st.program.global_block().ops]
        report = dict(
            leg, model=name, card_vs_cpu_max_abs_diff=float(
                np.abs(got - want).max()),
            card_vs_cpu_limit=PREDICT_CARD_CPU_ATOL,
            int8_convolutions=sum(
                op.type == "conv2d" and op.attrs.get("__quant_int8__", False)
                for st in card._exe._cache.values()
                for op in st.program.global_block().ops),
            compiled_ops={t: compiled.count(t) for t in sorted(set(compiled))},
            classifier_bitwise=classifier_bitwise(torch, im, card, feed,
                                                  table))
        if dev.type == "cuda":
            report["int8_conv_ms_per_run"] = report["profile"][
                "device_ms_per_run_by_op"].get("conv2d")
            report["card"] = card_line()
        print("predictor_mnist " + json.dumps(dict(
            report, k4_launches=mkn_keys(leg["k4_launches"]))), flush=True)
        if not (leg["finite"] and np.isfinite(want).all()):
            fail("predictor mnist: an output is not finite")
        if not report["int8_convolutions"]:
            fail("predictor mnist: no convolution ran on int8 operands")
        bad = [o for o, ok in report["classifier_bitwise"] if not ok]
        if not report["classifier_bitwise"] or bad:
            fail("predictor mnist: the classifier is not bitwise K4's plain "
                 "version on its own input: %r"
                 % (bad or "no fused int8 matmul"))
        if not report["card_vs_cpu_max_abs_diff"] <= PREDICT_CARD_CPU_ATOL:
            fail("predictor mnist: card and CPU outputs differ by %.3g (> "
                 "%.3g)" % (report["card_vs_cpu_max_abs_diff"],
                            PREDICT_CARD_CPU_ATOL))
        if dev.type == "cuda":
            _, w_fc, _ = dense_sites(card._program)[-1]
            K, N = card._program.global_block().var(w_fc).shape
            want_k4 = {(batch, K, N): leg["warmup"] + leg["runs"]}
            if leg["k4_launches"] != want_k4:
                fail("predictor mnist: K4 launched %r; expected %r"
                     % (leg["k4_launches"], want_k4))
        return leg["k4_launches"]
    finally:
        shutil.rmtree(dirname, ignore_errors=True)


# bench_quant_predictor's MLP (bench.py:1146 defaults): its three fc
# layers' (M, K, N) and the runs that launch K4 (3 warm-up, 24 timed)
QUANT_BENCH_MKN = ((64, 64, 256), (64, 256, 256), (64, 256, 16))
QUANT_BENCH_RUNS = 3 + 24
QUANT_BENCH_KEYS = ("fp32_examples_per_sec", "int8_examples_per_sec",
                    "speedup_vs_fp32", "max_abs_err", "top1_agreement",
                    "weight_bytes_saved_ratio")


def quant_bench_phase(im, place=None):
    """Phase 10c: the port's bench_quant_predictor with bench.py's
    defaults; its keys printed on a `quant_predictor_bench` line. Fatal
    unless every key is there and finite and, on the card, K4 launched
    once a layer a run of the int8 predictor. Returns K4's launches."""
    from paddle_tpu_torch import bench

    im.int8_matmul.launches.clear()            # main path starts
    t0 = time.perf_counter()
    res = bench.bench_quant_predictor(place=place)
    launches = dict(im.int8_matmul.launches)   # main path ends
    print("quant_predictor_bench " + json.dumps(dict(
        res, seconds=time.perf_counter() - t0,
        k4_launches=mkn_keys(launches))), flush=True)
    if sorted(res) != sorted(QUANT_BENCH_KEYS) or not all(
            np.isfinite(res[k]) for k in QUANT_BENCH_KEYS):
        fail("quant predictor bench: keys %r" % (res,))
    if place is None:
        want = dict.fromkeys(QUANT_BENCH_MKN, QUANT_BENCH_RUNS)
        if launches != want:
            fail("quant predictor bench: K4 launched %r; expected %r"
                 % (launches, want))
    return launches


def predictor_phase(torch, fluid, im, pa, pat, fa):
    """Phase 10: 10a, 10b and 10c, none of K1-K3 launched. Returns K4's
    launches on the phase's paths by (M, K, N)."""
    t0 = time.perf_counter()
    before = kernel_launch_totals(fa, pa, pat, im)
    k4 = dict(predictor_resnet_phase(torch, fluid, im))
    gc.collect()
    torch.cuda.empty_cache()
    for part in (predictor_mnist_phase(torch, fluid, im),
                 quant_bench_phase(im)):
        for mkn, n in part.items():
            k4[mkn] = k4.get(mkn, 0) + n
    after = kernel_launch_totals(fa, pa, pat, im)
    others = [k for k in ("K1", "K2", "K3") if after[k] != before[k]]
    print("predictor_phase " + json.dumps({
        "seconds": time.perf_counter() - t0, "k4_launches": mkn_keys(k4),
        "launches_before": before, "launches_after": after}), flush=True)
    if others:
        fail("phase 10 launched %s: %r -> %r" % (others, before, after))
    return k4


def predictor_kernel_rows(torch, im, launches):
    """K4's rows at phase 10's shapes, checked and timed
    (``int8_timed_row``), each with its launches on phase 10's paths."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    shapes = [("resnet50_classifier", (PREDICT["batch"], 2048, 1000)),
              ("mnist_cnn_fc", (PREDICT_MNIST_BATCH, 800, 10))] + [
        ("quant_bench_fc%d" % i, mkn)
        for i, mkn in enumerate(QUANT_BENCH_MKN)]
    rows = []
    for i, (name, (M, K, N)) in enumerate(shapes):
        x = 1.5 * torch.randn(M, K, device="cuda")
        row = int8_timed_row(torch, im, name, "%s M=%d K=%d N=%d"
                             % (name, M, K, N), x, (M, K, N), 300 + i, flush)
        row["launches"] = launches.get((M, K, N), 0)
        rows.append(row)
    return rows



# phase 11: the rest of benchmark/fluid's model set through the port's
# own harness, paddle_tpu_torch.fluid_benchmark (run_static_model: the
# JAX harness's recipe, :223-300), at full width and each model's
# _DEFAULT_BATCH; then word2vec and the beam decoder; then two Adam steps
# of reduced DeepFM and stacked-LSTM programs on the card and on the CPU
BENCH_MODELS = ("deepfm", "stacked_dynamic_lstm", "machine_translation")
BENCH_STEPS = (5, 10)               # skip_batch_num, iterations
WORD2VEC_BATCH = 64                 # the JAX book test's
BEAM_BATCH = 16
# 11c: program name -> (build(models), batch)
BENCH_CVC = {
    "deepfm": (lambda m: m.deepfm.build(
        sparse_feature_dim=1000, num_fields=26, dense_dim=13, embed_dim=16,
        mlp_dims=(64, 64))[2:], 64),
    "stacked_lstm": (lambda m: (m.stacked_lstm.build(
        dict_size=1000, emb_dim=32, hid_dim=32, stacked_num=2,
        seq_len=16)[4], None), 8),
}
BENCH_CVC_LR = 0.01


def pin_init_draw():
    """Start the port's process-wide init counters where a fresh process
    starts them (``initializer._global_seed_counter`` 0,
    ``layer_helper._op_seed_counter`` 1000): a program built next draws
    the same weights whatever ran before in the process."""
    from paddle_tpu_torch import initializer, layer_helper

    initializer._global_seed_counter[0] = 0
    layer_helper._op_seed_counter[0] = 1000


def auc_stats(main):
    """(AUC var, [StatPos, StatNeg] names) of the program's auc op, or
    None."""
    for op in main.global_block().ops:
        if op.type == "auc":
            return op.outputs["AUC"][0], [op.inputs["StatPos"][0].name,
                                          op.inputs["StatNeg"][0].name]
    return None


def bench_model_leg(torch, model, steps=BENCH_STEPS, argv=(), profile=True):
    """One leg of phase 11a: ``fluid_benchmark.run_static_model`` on
    `model` (its examples/sec line and, with --json, the harness's JSON
    line), then for a program with an auc op one more run fetching the
    AUC. Returns what the gates and the bench_model line read."""
    from paddle_tpu_torch import fluid_benchmark

    warmup, timed = steps
    args = fluid_benchmark.parse_args(
        ["--model", model, "--skip_batch_num", str(warmup), "--iterations",
         str(timed), "--json"] + list(argv))
    record = {}
    pin_init_draw()
    rec = fluid_benchmark.run_static_model(args, record)
    print(json.dumps(rec), flush=True)
    exe, main, scope = record["exe"], record["program"], record["scope"]
    on_card = exe.device.type == "cuda"
    leg = {"leg": model, "batch": record["batch"], "warmup": warmup,
           "steps": timed, "runs": warmup + timed,
           "params": len(main.param_grad_map), "losses": record["losses"],
           "harness": rec, "host_ms_each": record["host_ms"]}
    auc = auc_stats(main)
    if auc is not None:
        out, = exe.run(main, feed=record["feed"], fetch_list=[auc[0]],
                       scope=scope)
        leg["auc"] = float(out[0])
        leg["auc_runs"] = leg["runs"] + 1
        leg["auc_stats_total"] = sum(float(scope.get(n).sum())
                                     for n in auc[1])
    if on_card:
        dev = float(np.mean(record["step_ms"]))
        leg.update(device_ms_per_step=dev,
                   host_ms_per_step=float(np.mean(record["host_ms"])),
                   examples_per_s=leg["batch"] / dev * 1e3,
                   harness_examples_per_s=record["examples_per_sec"],
                   peak_gib=record["peak_bytes"] / 2 ** 30,
                   step_ms_each=record["step_ms"])
        if profile:
            leg["profile"] = update_cost_profile(
                torch, exe, main, record["feed"], [record["loss"]], scope)
            leg["launches_per_step"] = leg["profile"]["launches_per_step"]
            # the card's busy share of a timed step
            leg["busy_share"] = leg["profile"]["device_busy_ms"] / dev
    record.clear()
    del exe, scope
    return leg


def check_bench_leg(leg):
    """Phase 11's gates on a training leg: the losses finite and falling
    over the runs (the batch is fixed); with an auc op, the AUC finite
    and in [0, 1] and the histograms' counts the batch times the runs."""
    name, losses = leg["leg"], leg["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail("bench_model %s: losses not finite and falling: %r"
             % (name, losses))
    if "auc" in leg:
        if not (np.isfinite(leg["auc"]) and 0.0 <= leg["auc"] <= 1.0):
            fail("bench_model %s: AUC %r" % (name, leg["auc"]))
        want = leg["batch"] * leg["auc_runs"]
        if leg["auc_stats_total"] != want:
            fail("bench_model %s: StatPos + StatNeg hold %r counts, not "
                 "batch x runs = %d" % (name, leg["auc_stats_total"], want))


def word2vec_leg(torch, fluid, device=None, batch=WORD2VEC_BATCH,
                 steps=BENCH_STEPS):
    """Phase 11b's word2vec: `build()`'s defaults (dict 2073, embed 32,
    hidden 256) under Adam(0.01), the book test's next-word batch (the
    next word is the context's sum mod dict_size) staged once, the
    harness's warm-up and timed steps."""
    from paddle_tpu_torch.models import word2vec

    pin_init_draw()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words, _, loss = word2vec.build()
        fluid.optimizer.Adam(0.01).minimize(loss)
    exe, scope = fluid.Executor(device), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    ctx = rng.randint(0, 2073, (batch, 4)).astype(np.int64)
    nxt = (ctx.sum(1) % 2073).astype(np.int64)[:, None]
    cols = [ctx[:, i:i + 1] for i in range(4)] + [nxt]
    feed = {w.name: torch.from_numpy(c).to(exe.device)
            for w, c in zip(words, cols)}
    on_card = exe.device.type == "cuda"
    warmup, timed = steps
    outs, marks = [], []
    for i in range(warmup + timed):
        if on_card and i >= warmup:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                            return_numpy=False))
    leg = {"leg": "word2vec", "batch": batch, "warmup": warmup,
           "steps": timed,
           "losses": [float(o[0].float().cpu()[0]) for o in outs]}
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        dev = float(np.mean([a.elapsed_time(b)
                             for a, b in zip(marks, marks[1:])]))
        leg.update(device_ms_per_step=dev,
                   examples_per_s=batch / dev * 1e3)
    return leg


def beam_decoder_leg(torch, fluid, device=None, batch=BEAM_BATCH):
    """Phase 11b's beam decoder: ``build_beam_decoder()`` at its defaults
    (dict 30000, beam 2, 8 steps, source length 8) on a RandomState(0)
    source batch, lane 0 live and the other at -1e9; fetches the
    sentences and the stacked per-step ids and parents the decode op
    reads (``check_beam_decode``)."""
    from paddle_tpu_torch.models import machine_translation as mt

    pin_init_draw()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, sent_ids, sent_scores = mt.build_beam_decoder()
    beam = 2
    decode = next(op for op in main.global_block().ops
                  if op.type == "beam_search_decode")
    exe, scope = fluid.Executor(device), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    scores = np.full((batch, beam), -1e9, np.float32)
    scores[:, 0] = 0.0
    feed = {"bd_src": rng.randint(2, 30000, (batch, 8)).astype(np.int64),
            "bd_init_ids": np.full((batch, beam), 2, np.int64),
            "bd_init_scores": scores}
    fetch = [sent_ids, sent_scores, decode.inputs["Ids"][0],
             decode.inputs["Parents"][0]]
    t0 = time.perf_counter()
    ids, sc, step_ids, parents = exe.run(main, feed=feed, fetch_list=fetch,
                                         scope=scope)
    return {"leg": "beam_decoder", "batch": batch, "beam": beam,
            "ids": ids, "scores": sc, "step_ids": step_ids,
            "parents": parents, "run_s": time.perf_counter() - t0}


def check_beam_decode(leg):
    """The decoder's sentences equal a numpy backtrack of the per-step
    ids and parents ([T, batch, beam]) it stacked; every parent lies in
    [0, beam); the scores are finite."""
    ids, parents, beam = leg["step_ids"], leg["parents"], leg["beam"]
    T, B, W = ids.shape
    if parents.min() < 0 or parents.max() >= beam:
        fail("beam decoder: a parent index outside [0, %d): %r"
             % (beam, (int(parents.min()), int(parents.max()))))
    want = np.zeros((B, W, T), np.int64)
    ptr = np.tile(np.arange(W), (B, 1))
    for t in range(T - 1, -1, -1):
        want[:, :, t] = np.take_along_axis(ids[t], ptr, axis=1)
        ptr = np.take_along_axis(parents[t], ptr, axis=1)
    if not np.array_equal(leg["ids"], want):
        bad = np.argwhere(leg["ids"] != want)[0]
        fail("beam decoder: sentence ids differ from the backtrack of the "
             "per-step ids at %r" % (bad.tolist(),))
    if not np.isfinite(leg["scores"]).all():
        fail("beam decoder: scores not finite")


def bench_models_phase(torch, fluid, device=None, models=BENCH_MODELS,
                       steps=BENCH_STEPS, argv=()):
    """Phases 11a and 11b on `device` (None: cuda:0): each model through
    the harness, gated and printed on a bench_model line, then word2vec
    and the beam decoder."""
    for model in models:
        gc.collect()
        if device is None:
            torch.cuda.empty_cache()
        leg = bench_model_leg(torch, model, steps, argv,
                              profile=device is None)
        check_bench_leg(leg)
        print("bench_model " + json.dumps(dict(
            {k: v for k, v in leg.items() if k != "profile"},
            profile={k: leg["profile"][k] for k in (
                "launches_per_step", "device_busy_ms", "runtime_calls",
                "update", "top_kernels")} if "profile" in leg else None,
            card=card_line() if device is None else None)), flush=True)
    leg = word2vec_leg(torch, fluid, device, steps=steps)
    check_bench_leg(leg)
    print("bench_model " + json.dumps(leg), flush=True)
    leg = beam_decoder_leg(torch, fluid, device)
    check_beam_decode(leg)
    print("beam_decoder " + json.dumps({
        "batch": leg["batch"], "beam": leg["beam"],
        "steps": int(leg["step_ids"].shape[0]), "run_s": leg["run_s"],
        "first_sentence": leg["ids"][0, 0].tolist(),
        "first_scores": leg["scores"][0].tolist()}), flush=True)


def build_bench_cvc(fluid, name):
    """Phase 11c's program `name` in fp32 under Adam(BENCH_CVC_LR):
    (main, startup, loss, auc)."""
    from paddle_tpu_torch import models

    pin_init_draw()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, auc = BENCH_CVC[name][0](models)
        fluid.optimizer.Adam(BENCH_CVC_LR).minimize(loss)
    return main, startup, loss, auc


def bench_cvc_feed(torch, name, device):
    """Phase 11c's fixed batch for program `name` (RandomState(0)), as
    tensors on `device`."""
    rng = np.random.RandomState(0)
    batch = BENCH_CVC[name][1]
    if name == "deepfm":
        f = {"sparse_ids": rng.randint(0, 1000, (batch, 26)),
             "dense_x": rng.rand(batch, 13).astype(np.float32),
             "label": rng.randint(0, 2, (batch, 1))}
    else:
        f = {"words": rng.randint(0, 1000, (batch, 16)),
             "label": rng.randint(0, 2, (batch, 1)),
             "seq_len": rng.randint(4, 17, (batch, 1))}
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in f.items()}


def bench_card_vs_cpu_phase(torch, fluid, name, devices=("cuda:0", "cpu"),
                            steps=2):
    """Phase 11c for program `name`: `steps` Adam steps on devices[0]
    (the card) and devices[1] (the CPU), each from the same state (the
    startup's on the card copied to the CPU; before each later step the
    CPU's whole state set on the card). Each step is held to fp32's
    STEP_TOL: the loss to loss_rtol, every grad to grad_rtol of its
    tensor's largest plus floor_rel of the largest of all, every
    parameter after it within 2 ulps plus what grads that far apart let
    Adam move it (``adam_param_limit``), and an auc op's StatPos /
    StatNeg bitwise. The tests pass two CPUs and plant faults in the
    first."""
    main, startup, loss, _ = build_bench_cvc(fluid, name)
    tol = STEP_TOL["float32"]
    rel, bits = tol["grad_rtol"], tol["mantissa_bits"]
    params = sorted(main.param_grad_map)
    auc = auc_stats(main)
    stats = auc[1] if auc else []
    fetch = [loss] + [main.param_grad_map[p] for p in params]
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    state = [n for n in scope_c.local_var_names() if n != "__step_counter__"]
    for n in state:
        scope_h.set(n, scope_c.get(n).to("cpu", copy=True))
    worst = {k: (0.0, "") for k in ("loss", "grad", "param")}
    stats_differ = []
    g_ref = {p: [] for p in params}
    t0 = time.perf_counter()
    for step in range(steps):
        if step:
            for n in state:
                scope_c.set(n, scope_h.get(n).to(exe_c.device, copy=True))
        start = {p: scope_h.get(p).float().numpy().copy() for p in params}
        c = exe_c.run(main, feed=bench_cvc_feed(torch, name, exe_c.device),
                      fetch_list=fetch, scope=scope_c)
        h = exe_h.run(main, feed=bench_cvc_feed(torch, name, exe_h.device),
                      fetch_list=fetch, scope=scope_h)
        tag = "@%d" % (step + 1)
        worst["loss"] = max(worst["loss"], (abs(float(c[0][0]) - float(
            h[0][0])) / abs(float(h[0][0])), "loss" + tag))
        floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                       for g in h[1:])
        for p, gc_, gh in zip(params, c[1:], h[1:]):
            lim = rel * float(np.abs(gh).max()) + floor
            worst["grad"] = max(worst["grad"], (
                float(np.abs(gc_ - gh).max()) / lim, p + tag))
            g_ref[p].append(gh)
            # the earlier steps' grads are the same on both: one state
            g_err = [np.zeros_like(gh)] * step + [np.full_like(gh, lim)]
            pc = scope_c.get(p).float().cpu().numpy()
            ph = scope_h.get(p).float().numpy()
            mag = np.maximum(np.maximum(np.abs(pc), np.abs(ph)),
                             np.abs(start[p]))
            p_lim = adam_param_limit(g_ref[p], g_err,
                                     [BENCH_CVC_LR] * (step + 1), 0.9,
                                     0.999) + 2 * ulp(mag, bits)
            worst["param"] = max(worst["param"], (
                float((np.abs(pc - ph) / p_lim).max()), p + tag))
        for n in stats:
            if not torch.equal(scope_c.get(n).cpu(), scope_h.get(n)):
                stats_differ.append(n + tag)
    report = {"program": name, "batch": BENCH_CVC[name][1], "steps": steps,
              "params": len(params), "loss_rel_err": worst["loss"][0],
              "loss_limit": tol["loss_rtol"], "grad_rtol": rel,
              "worst_grad_err_over_limit": worst["grad"][0],
              "worst_grad": worst["grad"][1],
              "worst_param_err_over_limit": worst["param"][0],
              "worst_param": worst["param"][1],
              "auc_stats_checked": len(stats) * steps,
              "auc_stats_differ": stats_differ,
              "seconds": time.perf_counter() - t0}
    print("card_vs_cpu_bench " + json.dumps(report), flush=True)
    if worst["loss"][0] > tol["loss_rtol"]:
        fail("card vs CPU %s: the %s differs by %.3g (rel > %g)"
             % (name, worst["loss"][1], worst["loss"][0], tol["loss_rtol"]))
    for k, what in (("grad", "the grad of"), ("param", "the parameter")):
        if worst[k][0] > 1:
            fail("card vs CPU %s: %s %s differs by %.3g of its limit"
                 % (name, what, worst[k][1], worst[k][0]))
    if stats_differ:
        fail("card vs CPU %s: the AUC histograms differ: %r"
             % (name, stats_differ))
    return report


def bench_phase_11(torch, fluid, fa, pa, pat, im):
    """Phase 11 on cuda:0: 11a and 11b (``bench_models_phase``), then 11c
    for both programs; none of K1-K4 may launch."""
    t11 = time.perf_counter()
    before = kernel_launch_totals(fa, pa, pat, im)
    bench_models_phase(torch, fluid)
    for name in sorted(BENCH_CVC):
        bench_card_vs_cpu_phase(torch, fluid, name)
    after = kernel_launch_totals(fa, pa, pat, im)
    print("bench_phase " + json.dumps({
        "seconds": time.perf_counter() - t11, "launches_before": before,
        "launches_after": after}), flush=True)
    if after != before:
        fail("phase 11 launched a hand-written kernel: %r -> %r"
             % (before, after))


# phase 12: the native flagship (models/transformer.py) through bench.py's
# bench_transformer at its operating point, the graft entry's forward,
# and two native steps card vs CPU in fp32 and bf16
NATIVE_STEPS = (3, 24)              # warm-up, timed: bench_transformer's
NATIVE_BATCH = 192
NATIVE_SEQ = 512
ENTRY_SHAPE = (8, 512)              # __graft_entry__.entry()'s tokens
NATIVE_CVC = dict(batch=4, seq=256, n_layers=2)
# kernel names of the profiled step's groups (cuBLAS's GEMMs, K1)
GEMM_KERNEL_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")
# 12c's limit on the forward's fp32 logits, of their largest magnitude:
# fp32 differs in summation order only; bf16 rounds in other places
# (STEP_TOL's grad limit)
NATIVE_LOGITS_RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
NATIVE_CE_RANGE = "ptpu_native:ce_head"
NATIVE_UPDATE_RANGE = "ptpu_native:update"


def native_step_flops(cfg, B, T):
    """The products of one native training step at batch B, length T:
    the forward (a layer's QKV, output and FFN GEMMs and attention's two
    products, K1's without causal discount; the head), the backward
    (twice each), and under remat each layer's forward again but its
    last FFN GEMM (the recompute stops once every residual the backward
    reads is back). The count a step's FlopCounterMode and kernel
    wrappers must give (``observability/cost.py``)."""
    D, H, L, Fd, V = (cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff,
                      cfg.vocab_size)
    w2 = 2 * B * T * Fd * D
    layer = (2 * B * T * D * 3 * D + 2 * B * T * D * D + 2 * B * T * D * Fd
             + w2 + 4 * B * H * T * T * (D // H))
    head = 2 * B * T * D * V
    return (3 * (L * layer + head)
            + (L * (layer - w2) if cfg.remat else 0))


def native_train_leg(torch, fa, device=None, batch=NATIVE_BATCH,
                     seq=NATIVE_SEQ, steps=NATIVE_STEPS):
    """Phase 12a: ``bench.bench_transformer`` (its warm-up and timed
    steps) with metrics on, so its first step is counted; K1's launches
    by route zeroed before it and read after. Returns what the gates and
    the native_train line read."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.observability import cost, metrics

    warmup, timed = steps
    fa.reset_counts()
    was = metrics.enabled()
    metrics.enable()
    try:
        tps, last = bench.bench_transformer(
            steps=timed, warmup=warmup, batch=batch, seq=seq, device=device)
    finally:
        if not was:
            metrics.disable()
    rec = bench.last_native
    fwd, bwd, copies = flash_counts(fa)
    cfg = rec["config"]
    leg = {"leg": "native_train", "batch": batch, "seq": seq,
           "remat": cfg.remat, "layers": cfg.n_layers, "warmup": warmup,
           "steps": timed, "runs": warmup + timed,
           "losses": rec["losses"], "last_loss": last,
           "wall_tokens_per_s": tps, "host_ms_each": rec["host_ms"],
           "step_flops": rec["step_flops"],
           "step_flops_closed_form": native_step_flops(cfg, batch, seq),
           "k1_fwd": fwd, "k1_bwd": bwd, "k1_copies": copies}
    if rec["step_ms"] is not None:
        dev = float(np.mean(rec["step_ms"]))
        leg.update(device_ms_per_step=dev,
                   host_ms_per_step=float(np.mean(rec["host_ms"])),
                   tokens_per_s=batch * seq / dev * 1e3,
                   step_ms_each=rec["step_ms"],
                   peak_gib=rec["peak_bytes"] / 2 ** 30,
                   mfu_pct=cost.mfu_pct(rec["step_flops"], 1e3 / dev,
                                        torch.device("cuda", 0)),
                   peak_flops=cost.peak_flops(torch.device("cuda", 0)))
    return leg


def native_k1_per_step(leg):
    """K1's (forward, backward) launches a native step: under remat each
    layer's forward runs again in its recompute."""
    L = leg["layers"]
    return (2 * L if leg["remat"] else L), L


def check_native_leg(leg, on_card):
    """Phase 12a's gates: the losses finite and falling over the runs
    (the batch is fixed); the first step's count equal to its closed
    form; on the card, K1 launched by the "tc" route only, the remat
    forward count and the backward count a step, no operand copied."""
    losses = leg["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail("native_train: losses not finite and falling: %r" % losses)
    if leg["step_flops"] != leg["step_flops_closed_form"]:
        fail("native_train: the counted step has %r FLOPs, its closed form "
             "%r" % (leg["step_flops"], leg["step_flops_closed_form"]))
    if not on_card:
        return
    f, b = native_k1_per_step(leg)
    runs = leg["runs"]
    want = ({"tc": f * runs, "fp16": 0, "f32tc": 0},
            {"tc": b * runs, "fp16": 0, "f32tc": 0}, 0)
    got = (leg["k1_fwd"], leg["k1_bwd"], leg["k1_copies"])
    if got != want:
        fail("native_train: flash attention launched %r (forward, backward "
             "by route; copies) over %d steps; expected %r (%d forward and "
             "%d backward a step)" % (got, runs, want, f, b))


def native_profile(torch, device=None, batch=NATIVE_BATCH, seq=NATIVE_SEQ):
    """One native step under torch.profiler after a warm one, on a fresh
    bench state and batch: the step's kernel launches, the card's busy
    ms, and its device ms by group — cuBLAS's GEMMs, K1, the CE head
    (``_HardLabelCE`` forward in a range, its backward node), the update
    (``native_adam`` in a range) and the rest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer

    cfg = bench.native_config(batch, seq)
    state = list(bench.native_state(cfg, device))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    tokens = torch.from_numpy(toks).to(state[3].device)
    labels = torch.from_numpy(np.roll(toks, -1, axis=1)).to(tokens.device)
    ce = transformer._HardLabelCE

    class RangedCE:
        @staticmethod
        def apply(*args):
            with record_function(NATIVE_CE_RANGE):
                return ce.apply(*args)

    def step():
        loss, grads = bench.native_grads(state[0], tokens, labels, cfg)
        with record_function(NATIVE_UPDATE_RANGE):
            state[3] = bench.native_adam(state[0], grads, state[1],
                                         state[2], state[3])
        return loss

    step()
    torch.cuda.synchronize()
    transformer._HardLabelCE = RangedCE
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        transformer._HardLabelCE = ce
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    launches = sum("LaunchKernel" in e.name for e in events)
    kernels = [(device_us(e) / 1e3, e.count, e.key)
               for e in prof.key_averages() if e.device_type == cuda
               and not e.key.startswith(("ptpu_native:", "aten::"))]
    busy = sum(ms for ms, _, _ in kernels)
    k1 = sum(ms for ms, _, k in kernels if "flash_" in k)
    gemm = sum(ms for ms, _, k in kernels if "flash_" not in k
               and any(n in k.lower() for n in GEMM_KERNEL_NAMES))

    def range_ms(*names):
        total = 0.0
        for e in prof.key_averages():
            if e.device_type != cuda and e.key in names:
                us = getattr(e, "device_time_total", None)
                total += (getattr(e, "cuda_time_total", 0) if us is None
                          else us) / 1e3
        return total

    ce_ms = range_ms(NATIVE_CE_RANGE, "autograd::engine::evaluate_function: "
                     "_HardLabelCEBackward")
    update_ms = range_ms(NATIVE_UPDATE_RANGE)
    return {"launches_per_step": launches, "device_busy_ms": busy,
            "device_ms": {"gemm": gemm, "k1": k1, "ce_head": ce_ms,
                          "update": update_ms,
                          "rest": busy - gemm - k1 - ce_ms - update_ms},
            "top_kernels": [{"kernel": k[:90], "calls": n, "ms": ms}
                            for ms, n, k in sorted(kernels,
                                                   reverse=True)[:10]]}


def entry_forward_leg(torch, fa, device=None, shape=ENTRY_SHAPE, runs=5):
    """Phase 12b: ``__graft_entry__.entry()``'s forward — the flagship in
    bf16 with remat off over fp32 parameters (``init_params`` from seed
    0), zero tokens — once with K1's counts zeroed before it, then
    `runs` more timed on the card. Returns the logits and what the gates
    read."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer

    batch, seq = shape
    cfg = bench.native_config(batch, seq, remat=False)
    params = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device=device)
    tokens = torch.zeros(shape, dtype=torch.int32,
                         device=params["embed"].device)
    fa.reset_counts()
    with torch.no_grad():
        logits = transformer.single_chip_forward(params, tokens, cfg)
    fwd, bwd, copies = flash_counts(fa)
    leg = {"leg": "native_entry", "shape": list(shape),
           "layers": cfg.n_layers, "logits_shape": list(logits.shape),
           "logits_dtype": str(logits.dtype).split(".")[1],
           "finite": bool(torch.isfinite(logits).all()),
           "k1_fwd": fwd, "k1_bwd": bwd, "k1_copies": copies}
    if logits.device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(runs + 1)]
        with torch.no_grad():
            marks[0].record()
            for i in range(runs):
                transformer.single_chip_forward(params, tokens, cfg)
                marks[i + 1].record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                transformer.single_chip_forward(params, tokens, cfg)
                torch.cuda.synchronize()
        leg["ms_each"] = [a.elapsed_time(b)
                          for a, b in zip(marks, marks[1:])]
        leg["ms"] = float(np.mean(leg["ms_each"]))
        busy_s, top = kernel_times(prof, 1, top=8)
        leg.update(device_busy_ms=busy_s * 1e3, top_kernels=top)
    return logits, leg


def check_entry_forward(leg, vocab, on_card):
    """Phase 12b's gates: fp32 logits [B, T, V], every one finite; on the
    card K1 once a layer forward by the "tc" route, no backward, no
    copy."""
    want = leg["shape"] + [vocab]
    if leg["logits_shape"] != want or leg["logits_dtype"] != "float32":
        fail("native_entry: logits %s %s, expected float32 %s"
             % (leg["logits_dtype"], leg["logits_shape"], want))
    if not leg["finite"]:
        fail("native_entry: non-finite logits")
    if on_card:
        zero = {"tc": 0, "fp16": 0, "f32tc": 0}
        want_k1 = (dict(zero, tc=leg["layers"]), zero, 0)
        got = (leg["k1_fwd"], leg["k1_bwd"], leg["k1_copies"])
        if got != want_k1:
            fail("native_entry: flash attention launched %r; expected %r"
                 % (got, want_k1))


def native_device_step(torch, state, tokens, labels, cfg):
    """One device's share of a phase 12c step on `state` [params, m, v,
    t] (updated in place): the embedding's output (held bitwise across
    the devices: gather, the scale rounded to the dtype, the positions)
    and the forward's fp32 logits (``single_chip_forward``), then
    ``bench.native_grads`` and ``bench.native_adam``. Returns
    (embedding, logits, loss, grads)."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer

    with torch.no_grad():
        emb = transformer.embed_tokens(state[0], tokens, cfg)
        logits = transformer.single_chip_forward(state[0], tokens, cfg)
    loss, grads = bench.native_grads(state[0], tokens, labels, cfg)
    state[3] = bench.native_adam(state[0], grads, state[1], state[2],
                                 state[3])
    return emb, logits, loss, grads


def native_card_vs_cpu_phase(torch, fa, dtype, devices=("cuda:0", "cpu"),
                             steps=2, **kw):
    """Phase 12c in `dtype`: `steps` native steps (remat on) of bench.py's
    configuration at NATIVE_CVC's depth, batch and length (`kw` replaces
    any of them or of the config's fields) on devices[0] (the card) and
    devices[1] (the CPU), each from the same state (bench's, made on the
    CPU and copied; before each later step the CPU's whole state set on
    the card). Each step is held to STEP_TOL[dtype]: the embedding's
    output bitwise, the loss to loss_rtol, every grad to grad_rtol of its
    tensor's largest plus floor_rel of the largest of all, every
    parameter after it within 2 ulps plus what those grads let Adam move
    it (``adam_param_limit``), and the forward's fp32 logits to
    NATIVE_LOGITS_RTOL of their largest. Returns K1's launches on devices[0]
    (forward and backward by route, copies). The tests pass two CPUs and
    plant faults in the first."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer

    opts = dict(NATIVE_CVC, **kw)
    batch, seq = opts.pop("batch"), opts.pop("seq")
    cfg = bench.native_config(batch, seq, remat=True, dtype=dtype, **opts)
    tol = STEP_TOL[dtype]
    lr, b1, b2 = (bench.NATIVE_ADAM[k] for k in ("lr", "b1", "b2"))
    rel, bits = tol["grad_rtol"], tol["mantissa_bits"]
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labs = np.roll(toks, -1, axis=1)
    state_h = list(bench.native_state(cfg, devices[1]))

    def to(dev, tree):
        return transformer.tree_map(lambda x: x.to(dev, copy=True), tree)

    feeds = [(torch.from_numpy(toks).to(d), torch.from_numpy(labs).to(d))
             for d in devices]
    names = []

    def walk(tree, path):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + k + ".")
            else:
                names.append(path + k)

    walk(state_h[0], "")
    before = flash_counts(fa)
    worst = {k: (0.0, "") for k in ("logits", "loss", "grad", "param")}
    emb_differ, g_ref = [], [[] for _ in names]
    t0 = time.perf_counter()
    for step in range(steps):
        state_c = [to(devices[0], x) for x in state_h]
        start = [x.float().numpy().copy()
                 for x in transformer.tree_leaves(state_h[0])]
        e_c, o_c, l_c, g_c = native_device_step(torch, state_c, *feeds[0],
                                                cfg)
        e_h, o_h, l_h, g_h = native_device_step(torch, state_h, *feeds[1],
                                                cfg)
        tag = "@%d" % (step + 1)
        if not torch.equal(e_c.cpu(), e_h):
            emb_differ.append("embedding" + tag)
        worst["logits"] = max(worst["logits"], (
            float((o_c.cpu() - o_h).abs().max() / o_h.abs().max()),
            "logits" + tag))
        worst["loss"] = max(worst["loss"], (
            abs(float(l_c) - float(l_h)) / abs(float(l_h)), "loss" + tag))
        g_h = [g.float().numpy() for g in g_h]
        floor = tol["floor_rel"] * max(float(np.abs(g).max()) for g in g_h)
        for i, (name, gc_, gh, pc, ph, s) in enumerate(zip(
                names, g_c, g_h, transformer.tree_leaves(state_c[0]),
                transformer.tree_leaves(state_h[0]), start)):
            lim = rel * float(np.abs(gh).max()) + floor
            worst["grad"] = max(worst["grad"], (
                float(np.abs(gc_.float().cpu().numpy() - gh).max()) / lim,
                name + tag))
            g_ref[i].append(gh)
            g_err = [np.zeros_like(gh)] * step + [np.full_like(gh, lim)]
            pc, ph = pc.float().cpu().numpy(), ph.float().numpy()
            mag = np.maximum(np.maximum(np.abs(pc), np.abs(ph)), np.abs(s))
            p_lim = adam_param_limit(g_ref[i], g_err, [lr] * (step + 1), b1,
                                     b2) + 2 * ulp(mag, bits)
            worst["param"] = max(worst["param"], (
                float((np.abs(pc - ph) / p_lim).max()), name + tag))
    after = flash_counts(fa)
    k1 = ({r: after[0][r] - before[0][r] for r in after[0]},
          {r: after[1][r] - before[1][r] for r in after[1]},
          after[2] - before[2])
    report = {"dtype": dtype, "batch": batch, "seq": seq,
              "layers": cfg.n_layers, "steps": steps,
              "logits_rel_err": worst["logits"][0],
              "logits_limit": NATIVE_LOGITS_RTOL[dtype],
              "loss_rel_err": worst["loss"][0],
              "loss_limit": tol["loss_rtol"], "grad_rtol": rel,
              "worst_grad_err_over_limit": worst["grad"][0],
              "worst_grad": worst["grad"][1],
              "worst_param_err_over_limit": worst["param"][0],
              "worst_param": worst["param"][1],
              "embedding_differs": emb_differ, "k1": k1,
              "seconds": time.perf_counter() - t0}
    print("card_vs_cpu_native " + json.dumps(report), flush=True)
    if emb_differ:
        fail("card vs CPU native %s: the embedding's output differs: %r"
             % (dtype, emb_differ))
    for k, lim in (("logits", NATIVE_LOGITS_RTOL[dtype]),
                   ("loss", tol["loss_rtol"])):
        if worst[k][0] > lim:
            fail("card vs CPU native %s: the %s differs by %.3g (rel > %g)"
                 % (dtype, worst[k][1], worst[k][0], lim))
    for k, what in (("grad", "the grad of"), ("param", "the parameter")):
        if worst[k][0] > 1:
            fail("card vs CPU native %s: %s %s differs by %.3g of its limit"
                 % (dtype, what, worst[k][1], worst[k][0]))
    return k1


def native_phase(torch, fa):
    """Phase 12 on cuda:0: 12a (``native_train_leg``, gated, then one
    profiled step), 12b (the entry's forward) and 12c (card vs CPU in
    fp32 and bf16). Returns K1's launches on the phase's main paths by
    kernel row name."""
    t12 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    leg = native_train_leg(torch, fa)
    check_native_leg(leg, on_card=True)
    f, b = native_k1_per_step(leg)
    launches = {"flash_attention_tc_fwd": leg["k1_fwd"]["tc"],
                "flash_attention_tc_bwd": leg["k1_bwd"]["tc"]}
    leg["profile"] = native_profile(torch)
    leg["busy_share"] = (leg["profile"]["device_busy_ms"]
                         / leg["device_ms_per_step"])
    print("native_train " + json.dumps(dict(
        {k: v for k, v in leg.items() if k not in ("k1_fwd", "k1_bwd")},
        k1_per_step={"fwd": f, "bwd": b}, card=card_line())), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    logits, entry = entry_forward_leg(torch, fa)
    check_entry_forward(entry, logits.shape[-1], on_card=True)
    launches["flash_attention_tc_fwd"] += entry["k1_fwd"]["tc"]
    del logits
    print("native_entry " + json.dumps(dict(entry, card=card_line())),
          flush=True)
    for dtype, route in (("float32", "f32tc"), ("bfloat16", "tc")):
        gc.collect()
        torch.cuda.empty_cache()
        k1 = native_card_vs_cpu_phase(torch, fa, dtype)
        n = 2 * NATIVE_CVC["n_layers"]       # two steps
        zero = {"tc": 0, "fp16": 0, "f32tc": 0}
        want = (dict(zero, **{route: 3 * n}), dict(zero, **{route: n}), 0)
        if k1 != want:
            fail("card vs CPU native %s: flash attention launched %r "
                 "(forward, backward by route; copies); expected %r (each "
                 "layer's forward in the logits' forward, in the step and "
                 "in its recompute)" % (dtype, k1, want))
        for way, n_way in (("fwd", k1[0][route]), ("bwd", k1[1][route])):
            key = "flash_attention_%s_%s" % (route, way)
            launches[key] = launches.get(key, 0) + n_way
    print("native_phase " + json.dumps({
        "seconds": time.perf_counter() - t12, "k1_launches": launches}),
        flush=True)
    return launches


# phase 13: the Fluid LM trained from recordio shards and kept alive —
# QueueDataset's resumable stream under ResilientTrainer at the headline
# operating point (bench.py's program, bf16 under the legacy decorator,
# batch 160, seq 512): 4 shards of 320 records (two plain, two deflate),
# 8 batches an epoch, 2 epochs from DatasetCursor(seed=3)
DATA = dict(cfg=TRAIN, shards=4, records=320, batch=160, epochs=2, seed=3,
            guard_every=4, checkpoint_every=4, kill_step=5, nan_step=10,
            tokens=4)
# 13e: card vs CPU through train_from_dataset, 2 layers at full width,
# batch 4, seq 256, 3 steps (one shard of 12 records)
DATA_CVC = dict(cfg=dict(TRAIN, n_layers=2, seq_len=256), batch=4, steps=3)
CHILD_FLAG = "--phase13-child"


def build_data_lm(fluid, dtype="bfloat16", cfg=None):
    """`build_lm` under a fresh unique-name scope: the same parameter
    names in every process, whatever it built before (a child restores
    the parent's saved state by name)."""
    with fluid.unique_name.guard():
        return build_lm(fluid, dtype, cfg=cfg)


def lm_samples(shard, records, cfg):
    """Shard `shard`'s records: RandomState(shard) tokens int32 [seq]
    and labels the tokens rolled by one. The tokens are drawn from the
    first DATA["tokens"] ids: a unigram that SGD 0.01 on bf16 weights
    learns within 16 steps (over a wider draw its updates round away
    and the loss stays at ln(vocab)), so the state moves from step to
    step and each batch's loss falls from one epoch to the next."""
    rng = np.random.RandomState(shard)
    toks = rng.randint(0, DATA["tokens"],
                       (records, cfg["seq_len"])).astype(np.int32)
    return [(t, np.roll(t, -1)) for t in toks]


def write_lm_shards(fluid, directory, shards, records, cfg):
    """Write the shards with the port's writer, the odd ones deflate;
    returns their paths."""
    paths = []
    for i in range(shards):
        path = os.path.join(directory, "lm%02d.rec" % i)
        samples = lm_samples(i, records, cfg)
        fluid.convert_reader_to_recordio_file(
            path, lambda s=samples: iter(s),
            compressor="deflate" if i % 2 else None)
        paths.append(path)
    return paths


def lm_dataset(fluid, main, paths, batch, thread=2):
    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_filelist(paths)
    ds.set_batch_size(batch)
    ds.set_use_var([main.global_block().var(n)
                    for n in ("tokens", "labels")])
    ds.set_thread(thread)
    return ds


def shards_phase(fluid, main, paths, records, cfg, batch):
    """13a's gate: the shards read back through QueueDataset
    (set_thread(2), no seed: filelist order) equal what was written,
    record for record. Returns (records, seconds)."""
    t0 = time.perf_counter()
    got = list(lm_dataset(fluid, main, paths, batch).resumable_batches(
        fluid.DatasetCursor(), epochs=1))
    seconds = time.perf_counter() - t0
    want = [s for i in range(len(paths)) for s in lm_samples(i, records,
                                                              cfg)]
    toks = np.concatenate([f["tokens"] for f in got])
    labs = np.concatenate([f["labels"] for f in got])
    if toks.shape != (len(want), cfg["seq_len"]) or not (
            np.array_equal(toks, np.stack([s[0] for s in want]))
            and np.array_equal(labs, np.stack([s[1] for s in want]))):
        fail("13a: the shards read back through QueueDataset differ from "
             "the %d records written" % len(want))
    return len(want), seconds


def save_init_state(fluid, program, device, directory):
    """Run the startup program once and save the scope it leaves (the
    one initial state every 13b-13d run loads: the init draws follow
    process-wide counters, so two processes must not draw their own)."""
    main, startup, _ = program
    exe = fluid.Executor(device)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.checkpoint.save_checkpoint(directory, dict(scope.items()), 0)
    exe.close()


def load_state(torch, scope, state, device):
    for name, value in state.items():
        if isinstance(value, torch.Tensor):
            value = value.to(device)
        scope.set(name, value)
    scope.set("__step_counter__",
              int(np.asarray(scope.get("__step_counter__")).item()))


def resilient_lm_run(torch, fluid, program, paths, init_dir, device=None,
                     batch=DATA["batch"], ckpt_dir=None, restore=False,
                     injector=None, nan_step=None):
    """One ResilientTrainer run over the resumable stream (2 epochs from
    DatasetCursor(seed=3), or from the restored scope's cursor) in a
    fresh executor and scope holding the initial state; `ckpt_dir`
    checkpoints every DATA["checkpoint_every"] steps. `nan_step` is 13d's
    fault: as the trainer takes that batch, a NaN is written into the
    first parameter, so the step and the state it leaves are poisoned
    (the trainer's ``nan_at_step`` poisons a float feed value, and the
    LM's feeds hold none). Returns what the run saw: losses, the
    result's ledger, the records the trainer took and a key of each
    batch (its tokens' CRC32), the cursor it started from and where it
    ended, seconds."""
    from paddle_tpu_torch import checkpoint

    main, _, loss = program
    exe = fluid.Executor(device)
    scope = fluid.Scope()
    load_state(torch, scope, checkpoint.restore_checkpoint(init_dir),
               exe.device)
    trainer = fluid.ResilientTrainer(
        exe, main, fetch_list=[loss], scope=scope,
        guard_every=DATA["guard_every"], checkpoint_dir=ckpt_dir,
        checkpoint_every=DATA["checkpoint_every"] if ckpt_dir else 0,
        fault_injector=injector)
    cursor = fluid.DatasetCursor(seed=DATA["seed"])
    if restore:
        if trainer.restore() is None:
            fail("13c: no checkpoint to restore under %s" % ckpt_dir)
        cursor = fluid.DatasetCursor.from_scope(scope)
    start = cursor.to_array().tolist()
    records = [0]
    pulls = []                 # when the trainer took each batch
    keys = []
    poison = main.global_block().all_parameters()[0].name

    def counted(batches):
        for feed in batches:
            pulls.append(time.perf_counter())
            records[0] += feed["tokens"].shape[0]
            keys.append(zlib.crc32(np.ascontiguousarray(
                feed["tokens"]).tobytes()))
            if len(pulls) - 1 == nan_step:
                value = scope.get(poison).clone()
                value.view(-1)[0] = float("nan")
                scope.set(poison, value)
            yield feed

    stream = lm_dataset(fluid, main, paths, batch).resumable_batches(
        cursor, epochs=DATA["epochs"], scope=scope)
    t0 = time.perf_counter()
    result = trainer.run(counted(stream))
    exe.sync()
    seconds = time.perf_counter() - t0
    # host ms from the run's start to the first pull (the run-start
    # snapshot), between pulls (a step; every guard_every-th with the
    # boundary's validation, snapshot and checkpoint copy), and from the
    # last pull to the end (the last window, the final save)
    marks = [t0] + pulls + [t0 + seconds]
    out = {"losses": result.losses, "step": result.step,
           "preempted": result.preempted, "anomalies": result.anomalies,
           "rollbacks": result.rollbacks, "retries": result.retries,
           "skipped_steps": result.skipped_steps,
           "checkpoints_saved": result.checkpoints_saved,
           "records": records[0], "batch_keys": keys,
           "cursor_start": start,
           "cursor_end": cursor.to_array().tolist(),
           "scope_cursor": np.asarray(scope.get(
               "__data_cursor__")).tolist(),
           "seconds": seconds,
           "host_ms": [(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
           "device": str(exe.device)}
    exe.close()
    del trainer, scope
    return out


def loss_bits(losses):
    return np.asarray(losses, np.float32).view(np.uint32).tolist()


def run_child(args, env_extra=None, timeout=600):
    """Run ``chip_smoke.py --phase13-child`` with `args` in a process of
    its own; returns the run's result (its ``phase13_child`` line)."""
    env = dict(os.environ, **(env_extra or {}))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), CHILD_FLAG,
         json.dumps(args)], capture_output=True, text=True, env=env,
        timeout=timeout)
    lines = [x for x in out.stdout.splitlines()
             if x.startswith("phase13_child ")]
    if out.returncode != 0 or not lines:
        fail("13c: the child (%s) exited %d: %s" % (
            args.get("name"), out.returncode, out.stderr[-3000:]))
    got = json.loads(lines[-1].split(" ", 1)[1])
    got["process_seconds"] = time.perf_counter() - t0
    return got


def child_main(args):
    """A 13c child: the port on `args["device"]`, the LM at `args["cfg"]`
    (bf16 under the legacy decorator), one `resilient_lm_run`; prints one
    ``phase13_child`` line."""
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if args["device"] == "cpu":
        torch.set_num_threads(1)
    import paddle_tpu_torch as fluid

    program = build_data_lm(fluid, cfg=args["cfg"])
    out = resilient_lm_run(torch, fluid, program, args["paths"],
                           args["init_dir"], device=args["device"],
                           batch=args["batch"], ckpt_dir=args["ckpt_dir"],
                           restore=args["restore"])
    print("phase13_child " + json.dumps(out), flush=True)


def check_kill_resume(oracle, killed, resumed, records_total):
    """13c's gates: the killed run preempted with its emergency
    checkpoint, the resumed run starting at the cursor the killed one
    wrote, the two loss streams put together bitwise the oracle's, the
    records taken 2 epochs' worth."""
    if not killed["preempted"] or killed["checkpoints_saved"] < 1:
        fail("13c: the SIGTERM'd run did not drain into a checkpoint: %r"
             % {k: killed[k] for k in ("preempted", "checkpoints_saved")})
    if resumed["preempted"] or resumed["cursor_start"] != \
            killed["cursor_end"]:
        fail("13c: the resumed run started at cursor %r, the killed run "
             "wrote %r" % (resumed["cursor_start"], killed["cursor_end"]))
    if loss_bits(killed["losses"] + resumed["losses"]) != \
            loss_bits(oracle["losses"]):
        fail("13c: kill + resume losses %r are not bitwise the oracle's %r"
             % (killed["losses"] + resumed["losses"], oracle["losses"]))
    if killed["records"] + resumed["records"] != records_total:
        fail("13c: the two runs took %d + %d records, not %d"
             % (killed["records"], resumed["records"], records_total))


def epoch_falls(run, per_epoch):
    """Each batch of the last epoch against the same records in the
    first (paired by the batch keys; the shard order differs): the
    first epoch's loss less the last's."""
    keys, losses = run["batch_keys"], run["losses"]
    first = dict(zip(keys[:per_epoch], losses[:per_epoch]))
    return [first[k] - x for k, x in zip(keys[-per_epoch:],
                                         losses[-per_epoch:])]


def check_oracle(oracle, steps, epochs=DATA["epochs"]):
    """13b's gates: `steps` finite losses; every batch's loss lower in
    the last epoch than on the same records in the first (a run whose
    state does not move gives equal losses and fails); the cursor at
    the stream's end. Returns the falls."""
    if len(oracle["losses"]) != steps or not np.all(
            np.isfinite(oracle["losses"])):
        fail("13b: %d losses over %d steps, or one not finite: %r"
             % (len(oracle["losses"]), steps, oracle["losses"]))
    per_epoch = steps // epochs
    if sorted(oracle["batch_keys"][:per_epoch]) != \
            sorted(oracle["batch_keys"][-per_epoch:]):
        fail("13b: the last epoch's batches are not the first's")
    falls = epoch_falls(oracle, per_epoch)
    if not min(falls) > 0:
        fail("13b: a batch's loss did not fall from the first epoch to "
             "the last: falls %r, losses %r" % (falls, oracle["losses"]))
    if oracle["cursor_end"][1:4] != [DATA["epochs"], 0, 0]:
        fail("13b: the cursor ended at %r" % oracle["cursor_end"])
    return falls


def data_train_phase(torch, fa, fluid, device=None, size=None,
                     workdir=None, on_card=True):
    """13a-13d (module docstring). `size` overrides DATA's cfg, shards,
    records and batch (the CPU tests' small LM); `workdir` holds the
    shards and checkpoints (default a temporary directory). Returns
    (K1 launches (forward, backward) over 13b and 13d, the phase's
    report)."""
    import shutil
    import tempfile

    from paddle_tpu_torch import resilience

    size = dict(DATA, **(size or {}))
    cfg, batch = size["cfg"], size["batch"]
    base = workdir or tempfile.mkdtemp(prefix="ptpu_phase13_")
    try:
        program = build_data_lm(fluid, cfg=cfg)
        main = program[0]
        paths = write_lm_shards(fluid, base, size["shards"],
                                size["records"], cfg)
        n_records, read_s = shards_phase(fluid, main, paths,
                                         size["records"], cfg, batch)
        init_dir = os.path.join(base, "init")
        save_init_state(fluid, program, device, init_dir)
        steps = size["epochs"] * (-(-n_records // batch))
        # 13b: the oracle
        fa.reset_counts()                      # the main path starts
        oracle = resilient_lm_run(torch, fluid, program, paths, init_dir,
                                  device=device, batch=batch,
                                  ckpt_dir=os.path.join(base, "ck_oracle"),
                                  injector=resilience.FaultInjector(""))
        k1_oracle = flash_counts(fa)           # the main path ends
        falls = check_oracle(oracle, steps, size["epochs"])
        check_k1_per_step("13b", k1_oracle, steps, cfg, on_card)
        # 13c: killed at DATA["kill_step"], resumed, two processes
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        child = dict(cfg=cfg, paths=paths, init_dir=init_dir,
                     device="cuda:0" if on_card else "cpu", batch=batch,
                     ckpt_dir=os.path.join(base, "ck_kill"))
        killed = run_child(dict(child, name="killed", restore=False),
                           {"PTPU_FAULT_INJECT": "sigterm_at_step:%d"
                            % DATA["kill_step"]})
        resumed = run_child(dict(child, name="resumed", restore=True),
                            {"PTPU_FAULT_INJECT": ""})
        check_kill_resume(oracle, killed, resumed,
                          size["epochs"] * n_records)
        # 13d: a NaN at DATA["nan_step"] rolled back in process
        fa.reset_counts()                      # the main path starts
        rolled = resilient_lm_run(
            torch, fluid, program, paths, init_dir, device=device,
            batch=batch, injector=resilience.FaultInjector(""),
            nan_step=DATA["nan_step"])
        k1_rolled = flash_counts(fa)           # the main path ends
        if (rolled["anomalies"], rolled["rollbacks"]) != (1, 1) or \
                loss_bits(rolled["losses"]) != loss_bits(oracle["losses"]):
            fail("13d: %d anomalies / %d rollbacks, losses %r against the "
                 "oracle's %r" % (rolled["anomalies"], rolled["rollbacks"],
                                  rolled["losses"], oracle["losses"]))
        # the window of the NaN replayed: its steps run twice
        check_k1_per_step("13d", k1_rolled, steps + DATA["guard_every"],
                          cfg, on_card)
        report = {"records": n_records, "read_back_s": read_s,
                  "read_back_records_per_s": n_records / read_s,
                  "steps": steps, "oracle": oracle,
                  "epoch_fall": {"mean": float(np.mean(falls)),
                                 "least": float(min(falls)),
                                 "first_to_last": oracle["losses"][0]
                                 - oracle["losses"][-1]},
                  "killed": killed,
                  "resumed": resumed, "rollback": rolled,
                  "k1": {"13b": k1_oracle, "13d": k1_rolled}}
        launches = tuple(k1_oracle[i]["tc"] + k1_rolled[i]["tc"]
                         for i in (0, 1))
        return launches, report
    finally:
        if workdir is None:
            shutil.rmtree(base, ignore_errors=True)


def check_k1_per_step(label, k1, steps, cfg, on_card):
    """K1 6 + 6 "tc" launches a step (one a layer each way), no copy; on
    the CPU (the tests) the plain version counts none."""
    n = cfg["n_layers"] * steps if on_card else 0
    zero = {"tc": 0, "fp16": 0, "f32tc": 0}
    want = (dict(zero, tc=n), dict(zero, tc=n), 0)
    if k1 != want:
        fail("%s: flash attention launched %r (forward, backward by route; "
             "copies) over %d steps; expected %r" % (label, k1, steps, want))


def data_card_vs_cpu_phase(torch, fluid, dtype, devices=("cuda:0", "cpu"),
                           size=None):
    """13e in `dtype`: DATA_CVC["steps"] steps of
    ``Executor.train_from_dataset`` with a DatasetCursor(seed=3) over one
    shard, from one carried state, on devices[0] and devices[1]; held to
    STEP_TOL[dtype]: the last step's loss, its grads, every parameter
    after the run (the per-step ulps and grad limit times the steps) and
    the cursors (the object's and its scope mirror) equal. `size`
    overrides DATA_CVC (the CPU tests). Returns K1's launches."""
    import shutil
    import tempfile

    from paddle_tpu_torch.ops import flash_attention as fa

    size = dict(DATA_CVC, **(size or {}))
    cfg, batch, steps = size["cfg"], size["batch"], size["steps"]
    program = build_data_lm(fluid, dtype, cfg=cfg)
    main, startup, loss = program
    tol = STEP_TOL[dtype]
    lr, rel, bits = 0.01, tol["grad_rtol"], tol["mantissa_bits"]
    params = sorted(main.param_grad_map)
    fetch = [loss] + [main.param_grad_map[p] for p in params]
    base = tempfile.mkdtemp(prefix="ptpu_phase13e_")
    try:
        paths = write_lm_shards(fluid, base, 1, batch * steps, cfg)
        exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
        scope_c, scope_h = fluid.Scope(), fluid.Scope()
        exe_c.run(startup, scope=scope_c)
        for n in scope_c.local_var_names():
            if n != "__step_counter__":
                scope_h.set(n, scope_c.get(n).to("cpu", copy=True))
        start = {p: scope_h.get(p).float().numpy().copy() for p in params}
        t0 = time.perf_counter()
        fa.reset_counts()                      # the path starts
        runs = []
        for exe, scope in ((exe_c, scope_c), (exe_h, scope_h)):
            cursor = fluid.DatasetCursor(seed=DATA["seed"])
            last = exe.train_from_dataset(
                main, lm_dataset(fluid, main, paths, batch), scope=scope,
                fetch_list=fetch, cursor=cursor, epochs=1)
            runs.append((float(np.asarray(last[0]).ravel()[0]),
                         dict(zip(params, last[1:])), cursor.position(),
                         np.asarray(scope.get("__data_cursor__")).tolist()))
        seconds = time.perf_counter() - t0
        k1 = flash_counts(fa)                  # the path ends
    finally:
        shutil.rmtree(base, ignore_errors=True)
    (lc, gc_, cc, mc), (lh, gh, ch, mh) = runs
    loss_rel = abs(lc - lh) / abs(lh)
    floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                   for g in gh.values())
    worst_g, worst_p = (0.0, ""), (-np.inf, "")
    for p in params:
        g_lim = rel * float(np.abs(gh[p]).max()) + floor
        worst_g = max(worst_g, (float(np.abs(gc_[p] - gh[p]).max())
                                / g_lim, p))
        pc = scope_c.get(p).float().cpu().numpy()
        ph = scope_h.get(p).float().numpy()
        mag = np.maximum(np.maximum(np.abs(pc), np.abs(ph)),
                         np.abs(start[p]))
        excess = (np.abs(pc - ph) - steps * ulp(mag, bits)) \
            / (steps * lr * g_lim)
        worst_p = max(worst_p, (float(excess.max()), p))
    report = {"dtype": dtype, "batch": batch, "steps": steps,
              "seq": cfg["seq_len"], "layers": cfg["n_layers"],
              "loss_cuda": lc, "loss_cpu": lh, "loss_max_rel_err": loss_rel,
              "loss_limit": tol["loss_rtol"],
              "worst_grad_err_over_limit": worst_g[0],
              "worst_grad": worst_g[1],
              "worst_param_excess_over_limit": worst_p[0],
              "worst_param": worst_p[1], "cursors": [cc, ch],
              "flash_attention_launches": k1, "seconds": seconds}
    print("card_vs_cpu_data " + json.dumps(report), flush=True)
    if not loss_rel <= tol["loss_rtol"]:
        fail("13e %s: last loss %r vs %r (rel %.3g > %g)"
             % (dtype, lc, lh, loss_rel, tol["loss_rtol"]))
    if worst_g[0] > 1:
        fail("13e %s: the grad of %s differs by %.3g of its limit"
             % (dtype, worst_g[1], worst_g[0]))
    if worst_p[0] > 1:
        fail("13e %s: %s differs by %.3g of its limit after %d steps"
             % (dtype, worst_p[1], worst_p[0], steps))
    if (cc, mc) != (ch, mh) or cc != (1, 0, 0):
        fail("13e %s: cursors %r / %r differ or did not finish the epoch"
             % (dtype, (cc, mc), (ch, mh)))
    return k1


def data_costs_phase(torch, fluid, device=None, size=None, steps=8,
                     ingestion=None):
    """13f at 13b's operating point: the step time unguarded and guarded
    (ResilientTrainer, no checkpoint dir) over the same `steps` dataset
    batches at one sync cadence (the losses copied to the host every
    DATA["guard_every"] steps), a scope snapshot's bytes and ms, an
    async checkpoint's ms in the caller (the host copy) and until
    ``wait`` returns (the write), and bench.py's ingestion legs
    (``bench.bench_data_ingestion`` at its defaults, or `ingestion`'s
    keywords). Returns the report."""
    import shutil
    import tempfile

    from paddle_tpu_torch import bench, checkpoint, resilience
    from paddle_tpu_torch.async_engine import as_numpy

    size = dict(DATA, **(size or {}))
    cfg, batch, every = size["cfg"], size["batch"], size["guard_every"]
    base = tempfile.mkdtemp(prefix="ptpu_phase13f_")
    try:
        program = build_data_lm(fluid, cfg=cfg)
        main, startup, loss = program
        paths = write_lm_shards(fluid, base, 1, batch * steps, cfg)
        feeds = list(lm_dataset(fluid, main, paths, batch).resumable_batches(
            fluid.DatasetCursor(), epochs=1))
        exe = fluid.Executor(device)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)

        def sync():
            exe.sync()
            if exe.device.type == "cuda":
                torch.cuda.synchronize(exe.device)

        def unguarded():
            pending = []
            for feed in feeds:
                out, = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)
                pending.append(out)
                if len(pending) >= every:
                    as_numpy(pending)
                    pending = []
            as_numpy(pending)

        trainer = fluid.ResilientTrainer(exe, main, fetch_list=[loss],
                                         scope=scope, guard_every=every)

        def guarded():
            trainer.run(iter(feeds))

        times = {}
        for name, fn in (("warmup", unguarded), ("unguarded", unguarded),
                         ("guarded", guarded), ("unguarded_again",
                                                unguarded),
                         ("guarded_again", guarded)):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times[name] = (time.perf_counter() - t0) * 1e3 / steps
        sync()
        t0 = time.perf_counter()
        snap = resilience.snapshot_scope(scope)
        snap_ms = (time.perf_counter() - t0) * 1e3
        mgr = checkpoint.CheckpointManager(os.path.join(base, "ck"),
                                           async_save=True)
        t0 = time.perf_counter()
        mgr.save(dict(scope.items()), 1)
        t1 = time.perf_counter()
        mgr.wait()
        t2 = time.perf_counter()
        exe.close()
        del trainer, scope
        gc.collect()
        ing = bench.bench_data_ingestion(place=device, **(ingestion or {}))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    ms = {k: v for k, v in times.items() if k != "warmup"}
    guarded_ms = (ms["guarded"] + ms["guarded_again"]) / 2
    unguarded_ms = (ms["unguarded"] + ms["unguarded_again"]) / 2
    return {"batch": batch, "steps": steps, "sync_every": every,
            "step_ms": ms, "step_ms_unguarded": unguarded_ms,
            "step_ms_guarded": guarded_ms,
            "guard_overhead_pct": 100 * (guarded_ms - unguarded_ms)
            / unguarded_ms,
            "snapshot_bytes": snap.nbytes, "snapshot_ms": snap_ms,
            "checkpoint_caller_ms": (t1 - t0) * 1e3,
            "checkpoint_write_ms": (t2 - t1) * 1e3,
            "ingestion": ing}


def data_phase(torch, fa, fluid):
    """Phase 13 on cuda:0 (module docstring): 13a-13d, 13e in fp32 and
    bf16, 13f; the ``data_plane`` and ``resilient_train`` lines. Returns
    K1's launches on the phase's main paths by kernel row name."""
    t13 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    (fwd, bwd), report = data_train_phase(torch, fa, fluid)
    launches = {"flash_attention_tc_fwd": fwd,
                "flash_attention_tc_bwd": bwd}
    for dtype, route in (("float32", "f32tc"), ("bfloat16", "tc")):
        gc.collect()
        torch.cuda.empty_cache()
        k1 = data_card_vs_cpu_phase(torch, fluid, dtype)
        n = DATA_CVC["steps"] * DATA_CVC["cfg"]["n_layers"]
        zero = {"tc": 0, "fp16": 0, "f32tc": 0}
        want = (dict(zero, **{route: n}), dict(zero, **{route: n}), 0)
        if k1 != want:
            fail("13e %s: flash attention launched %r (forward, backward "
                 "by route; copies); expected %r" % (dtype, k1, want))
        for way, n_way in (("fwd", k1[0][route]), ("bwd", k1[1][route])):
            key = "flash_attention_%s_%s" % (route, way)
            launches[key] = launches.get(key, 0) + n_way
    gc.collect()
    torch.cuda.empty_cache()
    costs = data_costs_phase(torch, fluid)
    card = card_line()
    print("data_plane " + json.dumps({
        "shards": DATA["shards"], "records": report["records"],
        "read_back_records_per_s": report["read_back_records_per_s"],
        "ingestion": costs.pop("ingestion"), "card": card}), flush=True)
    oracle = report["oracle"]
    print("resilient_train " + json.dumps({
        "batch": DATA["batch"], "steps": report["steps"],
        "oracle_ms_per_step": oracle["seconds"] * 1e3 / report["steps"],
        "oracle_host_ms": oracle["host_ms"],
        "oracle_losses": oracle["losses"],
        "epoch_fall": report["epoch_fall"],
        "killed": {k: report["killed"][k] for k in (
            "losses", "step", "checkpoints_saved", "records", "cursor_end",
            "seconds", "process_seconds")},
        "resumed": {k: report["resumed"][k] for k in (
            "losses", "step", "records", "cursor_start", "seconds",
            "process_seconds")},
        "rollback": {k: report["rollback"][k] for k in (
            "anomalies", "rollbacks", "retries", "seconds")},
        "k1": report["k1"], "costs": costs, "card": card,
        "seconds": time.perf_counter() - t13}), flush=True)
    return launches


# phase 14: data-parallel training through CompiledProgram /
# ParallelExecutor / the fleet's collective mode, one child process a
# rank (a visible card each, up to 4) over NCCL. 14a the headline LM,
# 14b ResNet-50 through the port's harness, 14c the fleet regression.
# 14a's tokens are drawn from the first `tokens` ids (as phase 13's):
# over a wide draw SGD 0.01's bf16 updates round away and the loss stays
# at ln(vocab) to 1e-5, so "falling" would be noise; here it must fall by
# `min_fall` nats over the run
PARALLEL = dict(batch=160, warmup=3, steps=8, tokens=4, min_fall=0.1,
                image_model="resnet", image_data_set="imagenet",
                image_batch=64, image_skip=2, image_iters=5, fleet_steps=10,
                max_world=4)
RANK_FLAG = "--phase14-rank"


def _snapshot(scope):
    return {n: scope.get(n).clone() for n in scope.local_var_names()
            if hasattr(scope.get(n), "clone")}


def _restore(fluid, state):
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set(n, t.clone())
    return scope


def dp_vs_exe_check(torch, fluid, program, pe_cls, device, state, feed,
                    dtype):
    """Two steps from one state through ParallelExecutor (every rank of
    the group) and through Executor.run of the global batch on this
    rank's device, held to STEP_TOL[dtype] as
    phase 7 holds the card to the CPU: losses, step 1's grads, and the
    parameters after step 2. Returns the report (its `ok`, the largest
    differences and whether the runs are bitwise equal)."""
    main, startup, loss = program
    tol = STEP_TOL[dtype]
    lr, rel, bits = 0.01, tol["grad_rtol"], tol["mantissa_bits"]
    params = sorted(main.param_grad_map)
    fetch = [loss.name] + [main.param_grad_map[p] for p in params]
    start = {p: state[p].float().cpu().numpy() for p in params}
    runs = []
    for way in ("pe", "exe"):
        scope = _restore(fluid, state)
        if way == "pe":
            pe = pe_cls(use_cuda=device != "cpu", loss_name=loss.name,
                        main_program=main, scope=scope)
            run = lambda f: pe.run(f, feed=feed)  # noqa: E731
        else:
            exe = fluid.Executor(device)
            run = lambda f: exe.run(main, feed=feed,  # noqa: E731
                                    fetch_list=f, scope=scope)
        first = run(fetch)
        second, = run([loss.name])
        runs.append(([float(np.asarray(first[0]).ravel()[0]),
                      float(np.asarray(second).ravel()[0])],
                     dict(zip(params, first[1:])),
                     {p: scope.get(p).float().cpu().numpy()
                      for p in params}))
    (lp, gp, pp), (le, ge, pe_) = runs
    loss_rel = float(np.abs(np.array(lp) - np.array(le)).max()
                     / np.abs(le).max())
    floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                   for g in ge.values())
    worst_g, worst_p, bitwise = 0.0, -np.inf, lp == le
    max_grad_diff = max_param_diff = 0.0
    for p in params:
        g_lim = rel * float(np.abs(ge[p]).max()) + floor
        d = float(np.abs(gp[p] - ge[p]).max())
        max_grad_diff = max(max_grad_diff, d)
        worst_g = max(worst_g, d / g_lim)
        mag = np.maximum(np.maximum(np.abs(pp[p]), np.abs(pe_[p])),
                         np.abs(start[p]))
        diff = np.abs(pp[p] - pe_[p])
        max_param_diff = max(max_param_diff, float(diff.max()))
        worst_p = max(worst_p, float(((diff - 2 * ulp(mag, bits))
                                      / (2 * lr * g_lim)).max()))
        bitwise = bitwise and np.array_equal(gp[p], ge[p]) \
            and np.array_equal(pp[p], pe_[p])
    return {"dtype": dtype, "steps": 2, "loss_pe": lp, "loss_exe": le,
            "loss_max_rel_err": loss_rel, "loss_limit": tol["loss_rtol"],
            "max_grad_abs_diff": max_grad_diff,
            "worst_grad_err_over_limit": worst_g,
            "max_param_abs_diff": max_param_diff,
            "worst_param_excess_over_limit": worst_p, "bitwise": bitwise,
            "ok": loss_rel <= tol["loss_rtol"] and worst_g <= 1
            and worst_p <= 1}


def parallel_lm_leg(device=None, cfg=None, batch=None, warmup=None,
                    steps=None, compare=True):
    """14a on this rank: bench.py's headline program (``build_lm``)
    through ``fluid.ParallelExecutor(loss_name=loss.name)``, every rank
    fed the same global batch; warm-up then timed steps. Returns the
    losses, times, K1's launches, the collective counts a step beside
    the plan's prediction and, with `compare`, `dp_vs_exe_check` (the
    data-parallel step against Executor.run of the global batch on this
    rank's card)."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import collective

    cfg = cfg or TRAIN
    batch = batch or PARALLEL["batch"]
    warmup = PARALLEL["warmup"] if warmup is None else warmup
    steps = steps or PARALLEL["steps"]
    program = build_lm(fluid, cfg=cfg)
    main, startup, loss = program
    scope = fluid.Scope()
    pe = fluid.ParallelExecutor(use_cuda=device != "cpu",
                                loss_name=loss.name, main_program=main,
                                scope=scope)
    dev = pe.device
    on_card = dev.type == "cuda"
    fluid.Executor(dev).run(startup, scope=scope)
    state = _snapshot(scope)
    toks = np.random.RandomState(0).randint(
        0, PARALLEL["tokens"], (batch, cfg["seq_len"])).astype(np.int32)
    global_feed = {"tokens": torch.from_numpy(toks).to(dev),
                   "labels": torch.from_numpy(
                       np.roll(toks, -1, axis=1)).to(dev)}
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_counts()                          # main path starts
    collective.reset_counts()
    outs, marks = [], []
    t1 = None
    for i in range(warmup + steps):
        if i == warmup:
            if on_card:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            if on_card:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
        out, = pe.run([loss.name], feed=global_feed, return_numpy=False)
        outs.append(out)
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    k1 = flash_counts(fa)                      # main path ends
    counts = dict(collective.counts)
    n = warmup + steps
    step = next(iter(pe._compiled._compiled_steps.values()))
    calls, nbytes = step.expected_collectives()
    ms = (marks[0].elapsed_time(marks[1]) / steps if on_card
          else (t2 - t1) * 1e3 / steps)
    leg = {
        "leg": "14a", "rank": pe._group.rank, "world": pe.device_count,
        "device": str(dev), "backend": pe._group.backend, "batch": batch,
        "rank_rows": batch // pe.device_count, "warmup": warmup,
        "steps": steps,
        "losses": [float(torch.as_tensor(o).float().cpu().reshape(-1)[0])
                   for o in outs],
        "ms_per_step": ms,
        "tokens_per_s": batch * cfg["seq_len"] * steps / (t2 - t1),
        "rank_tokens_per_s": (batch // pe.device_count) * cfg["seq_len"]
        * steps / (t2 - t1),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if on_card else None),
        "k1_fwd": k1[0], "k1_bwd": k1[1], "k1_copies": k1[2],
        "n_layers": cfg["n_layers"], "run_steps": n,
        "collective_calls_per_step": counts["all_reduce"] / n,
        "collective_bytes_per_step": counts["all_reduce_bytes"] / n,
        "expected_calls_per_step": calls,
        "expected_bytes_per_step": nbytes}
    if compare:
        leg["vs_executor"] = dp_vs_exe_check(
            torch, fluid, program, fluid.ParallelExecutor, dev, state,
            global_feed, "bfloat16")
    return leg


def parallel_image_leg(device=None, model=None, data_set=None, batch=None,
                       skip=None, iters=None):
    """14b on this rank: ``fluid_benchmark.run_static_model`` with
    ``update_method="nccl2"`` (ResNet-50, ImageNet, fp32, Adam(0.01)).
    Returns the losses, images/s and ms a step, the moving statistics'
    state and K1-K4's launches over the leg."""
    import torch

    from paddle_tpu_torch import fluid_benchmark
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import paged_attention_tree as pat

    argv = ["--model", model or PARALLEL["image_model"],
            "--batch_size", str(batch or PARALLEL["image_batch"]),
            "--skip_batch_num", str(PARALLEL["image_skip"]
                                    if skip is None else skip),
            "--iterations", str(iters or PARALLEL["image_iters"]),
            "--update_method", "nccl2",
            "--device", "CPU" if device == "cpu" else "GPU"]
    ds = PARALLEL["image_data_set"] if data_set is None else data_set
    if ds:
        argv += ["--data_set", ds]
    before = kernel_launch_totals(fa, pa, pat, im)
    rec = {}
    out = fluid_benchmark.run_static_model(fluid_benchmark.parse_args(argv),
                                           rec)
    after = kernel_launch_totals(fa, pa, pat, im)
    stats = moving_stats(rec["program"])
    scope = rec["scope"]
    vals = {n: scope.get(n) for n in stats}
    pe = rec["pe"]
    return {
        "leg": "14b", "rank": pe._group.rank, "world": pe.device_count,
        "backend": pe._group.backend, "model": " ".join(argv[:2]),
        "batch": rec["batch"], "losses": rec["losses"],
        "images_per_s": rec["examples_per_sec"],
        "ms_per_step": (float(np.mean(rec["step_ms"])) if rec["step_ms"]
                        else float(np.mean(rec["host_ms"]))),
        "n_chips": out["n_chips"], "stats": len(stats),
        "stats_finite": all(bool(torch.isfinite(t).all())
                            for t in vals.values()),
        # moving means start at 0 and variances at 1 (the startup's
        # constants)
        "stats_unmoved": sorted(
            n for n, t in vals.items()
            if bool((t == (0.0 if n.endswith("w_1") else 1.0)).all())),
        "launches_before": before, "launches_after": after}


def parallel_fleet_leg(device=None, steps=None):
    """14c on this rank: ``incubate.fleet.collective.fleet.init()`` and
    ``distributed_optimizer(SGD(0.1))`` on tests/test_distributed.py's
    regression, ``steps`` data-parallel steps."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.incubate.fleet.collective import fleet as cfleet

    cfleet.init(device=device)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="cx", shape=[4], dtype="float32")
        y = fluid.layers.data(name="cy", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        cfleet.distributed_optimizer(fluid.optimizer.SGD(0.1)).minimize(loss)
    exe, scope = fluid.Executor(cfleet.device), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 4).astype(np.float32)
    feed = {"cx": xs, "cy": (xs.sum(1, keepdims=True) * 0.5).astype(
        np.float32)}
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0])
              for _ in range(steps or PARALLEL["fleet_steps"])]
    cfleet.barrier_worker()
    return {"leg": "14c", "rank": cfleet.worker_index(),
            "world": cfleet.worker_num(), "backend": cfleet._group.backend,
            "losses": losses, "fleet_opt": main._fleet_opt}


def check_parallel(legs, on_card, min_fall=None):
    """Phase 14's gates over every rank's legs ({"14a": [rank results],
    ...}): a list of failures (empty: the phase passed). 14a's loss
    must fall by `min_fall` nats (default PARALLEL["min_fall"])."""
    min_fall = PARALLEL["min_fall"] if min_fall is None else min_fall
    bad = []
    backend = "nccl" if on_card else "gloo"
    for leg, ranks in sorted(legs.items()):
        for r in ranks:
            tag = "%s rank %d" % (leg, r["rank"])
            losses = r["losses"]
            if r["backend"] != backend:
                bad.append("%s: backend %s, not %s" % (tag, r["backend"],
                                                        backend))
            if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
                bad.append("%s: losses not finite and falling: %r"
                           % (tag, losses))
            if leg == "14a":
                if not losses[0] - losses[-1] > min_fall:
                    bad.append("%s: the loss fell %r nats, not more than %r"
                               % (tag, losses[0] - losses[-1], min_fall))
                n = r["n_layers"] * r["run_steps"]
                want = {"tc": n} if on_card else {}
                got = ({k: v for k, v in r["k1_fwd"].items() if v},
                       {k: v for k, v in r["k1_bwd"].items() if v},
                       r["k1_copies"])
                if got != (want, want, 0):
                    bad.append("%s: K1 launched %r (forward, backward by "
                               "route; copies), expected %r each and no "
                               "copy" % (tag, got, want))
                if (r["collective_calls_per_step"],
                        r["collective_bytes_per_step"]) != (
                            r["expected_calls_per_step"],
                            r["expected_bytes_per_step"]):
                    bad.append("%s: %r all-reduce calls and %r bytes a "
                               "step, the plan predicts %r and %r" % (
                                   tag, r["collective_calls_per_step"],
                                   r["collective_bytes_per_step"],
                                   r["expected_calls_per_step"],
                                   r["expected_bytes_per_step"]))
                vs = r.get("vs_executor")
                if vs is not None and not vs["ok"]:
                    bad.append("%s: the step is off Executor.run's on the "
                               "global batch: %r" % (tag, vs))
            if leg == "14b":
                if not r["stats_finite"] or r["stats_unmoved"] \
                        or not r["stats"]:
                    bad.append("%s: moving statistics finite %s, unmoved %r"
                               % (tag, r["stats_finite"],
                                  r["stats_unmoved"][:4]))
                if r["launches_after"] != r["launches_before"]:
                    bad.append("%s: launched a hand-written kernel: %r -> %r"
                               % (tag, r["launches_before"],
                                  r["launches_after"]))
            if leg == "14c" and not losses[-1] < 0.5 * losses[0]:
                bad.append("%s: the last loss %r is not below half the "
                           "first %r" % (tag, losses[-1], losses[0]))
        if ranks and any(x["losses"] != ranks[0]["losses"]
                         for x in ranks[1:]):
            bad.append("%s: the ranks' losses differ" % leg)
    return bad


def parallel_rank_main(args):
    """One rank of phase 14 (a child of `parallel_phase`): the legs in
    order, one ``phase14_rank`` line."""
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    out = {"14a": parallel_lm_leg(device=args.get("device"))}
    gc.collect()
    torch.cuda.empty_cache()
    out["14b"] = parallel_image_leg(device=args.get("device"))
    out["14c"] = parallel_fleet_leg(device=args.get("device"))
    from paddle_tpu_torch.parallel.mesh import destroy_data_group

    destroy_data_group()
    print("phase14_rank " + json.dumps(out), flush=True)


def run_ranks(flag, tag, world, timeout, args=None):
    """`world` child processes of this script (`flag`, `args` as JSON),
    the fleet's env contract naming each its rank, the world and the
    rendezvous: each rank's last `tag` line, parsed, in rank order. Fails
    the run if a rank exits non-zero, prints no such line or outlives
    `timeout` seconds (every child is killed then)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(rank),
                   PADDLE_TRAINERS_NUM=str(world),
                   PADDLE_TRAINER_ENDPOINTS="127.0.0.1:%d" % port,
                   PADDLE_CURRENT_ENDPOINT="127.0.0.1:%d" % (port + rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag,
             json.dumps(args or {})], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    results, errors = [], []
    deadline = time.time() + timeout
    for rank, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("%s: rank %d did not finish in %d s" % (tag, rank, timeout))
        lines = [x for x in out.splitlines() if x.startswith(tag + " ")]
        if p.returncode != 0 or not lines:
            errors.append("rank %d exited %d: %s" % (rank, p.returncode,
                                                     err[-3000:]))
            continue
        results.append(json.loads(lines[-1].split(" ", 1)[1]))
    if errors:
        for q in procs:
            if q.poll() is None:
                q.kill()
        fail("%s: %s" % (tag, "; ".join(errors)))
    return results


def parallel_phase(torch, fa, timeout=900):
    """Phase 14: one child process a visible card (up to
    PARALLEL["max_world"]) over NCCL, the fleet's env contract naming
    the rank, the world and the rendezvous (``run_ranks``). Every rank
    must exit 0 and every gate hold (`check_parallel`). Prints one
    ``parallel`` line a leg; returns K1's launches on 14a's path, summed
    over the ranks."""
    t14 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    world = min(torch.cuda.device_count(), PARALLEL["max_world"])
    results = run_ranks(RANK_FLAG, "phase14_rank", world, timeout)
    legs = {leg: [r[leg] for r in results] for leg in ("14a", "14b", "14c")}
    card = card_line()
    for leg, ranks in sorted(legs.items()):
        print("parallel " + json.dumps({
            "leg": leg, "world": world, "card": card, "ranks": ranks}),
            flush=True)
    bad = check_parallel(legs, on_card=True)
    if bad:
        fail("14: " + "; ".join(bad))
    print("parallel_phase " + json.dumps({
        "world": world, "seconds": time.perf_counter() - t14}), flush=True)
    return (sum(r["k1_fwd"].get("tc", 0) for r in legs["14a"]),
            sum(r["k1_bwd"].get("tc", 0) for r in legs["14a"]))


# phase 15: the telemetry plane on the card — the headline Fluid LM under
# a profiler session (the device table by Fluid op), the flagship decoder
# served traced with the live endpoint, the same leg in a child under
# PTPU_LOCK_CHECK=1, and the two waits PERF.md section 7 had not located
TELEMETRY = dict(lm_batch=160, lm_steps=2, overhead_steps=3,
                 serve_cfg=dict(vocab_size=32000, d_model=512, n_heads=8,
                                n_layers=6, d_ff=2048, max_seq_len=512),
                 serve_seed=0, requests=16, prompt_len=(4, 12), max_new=16,
                 max_batch=8, block_size=16, native_batch=NATIVE_BATCH,
                 native_steps=3, first_steps=3, min_attributed_pct=95.0,
                 bench_argv=("--model", "transformer", "--profile",
                             "--iterations", "8"))
PROFILE_FLAG = "--phase15-profile"
LOCK_FLAG = "--phase15-lockcheck"
FIRST_FLAG = "--phase15-first-program"
# K1's kernels by name, and the Fluid op whose kernel it is
K1_FWD_KERNELS = ("flash_tc_fwd",)
K1_BWD_KERNELS = ("flash_tc_delta", "flash_tc_dkdv", "flash_tc_dq")
K1_BWD_LAUNCH_KERNEL = "flash_tc_dkdv"     # one a backward launch
K1_OP = "fused_multihead_attention"


def _is_k1(name, names):
    return any(n in name for n in names)


def timed_steps(torch, exe, main, feed, loss, scope, steps):
    """`steps` runs with the loss read after the last: (wall ms a step,
    host enqueue ms a step)."""
    from paddle_tpu_torch.async_engine import as_numpy

    if exe.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = 0.0
    out = None
    for _ in range(steps):
        th = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        host += time.perf_counter() - th
    as_numpy(out)
    return ((time.perf_counter() - t0) * 1e3 / steps, host * 1e3 / steps)


def profiled_lm_leg(torch, fa, fluid, program, batch, steps, device=None,
                    overhead_steps=TELEMETRY["overhead_steps"], cfg=None):
    """15a: phase 6's program (the headline LM) — the overhead of spans
    and metrics on against off (alternating legs of `overhead_steps`),
    then `steps` steps inside ``profiler.profiler()``: K1's launches
    zeroed before them and read after, every kernel's attribution and
    the device table by Fluid op; then one step with the session closed
    under a plain torch.profiler, for the fluid/ ranges it entered."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import profiler

    main, startup, loss = program
    exe, scope = fluid.Executor(device), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = lm_feed(torch, batch, exe.device, cfg=cfg)
    on_card = exe.device.type == "cuda"
    timed_steps(torch, exe, main, feed, loss, scope, 1)       # warm
    overhead = {"off": [], "spans": []}
    was_m, was_t = obs.metrics.enabled(), obs.tracing.enabled()
    try:
        for mode in ("off", "spans", "off", "spans"):
            (obs.enable if mode == "spans" else obs.disable)()
            overhead[mode].append(timed_steps(torch, exe, main, feed, loss,
                                              scope, overhead_steps))
    finally:
        (obs.metrics.enable if was_m else obs.metrics.disable)()
        (obs.tracing.enable if was_t else obs.tracing.disable)()
        obs.tracing.reset()
    t0 = time.perf_counter()
    with profiler.profiler("All"):
        fa.reset_counts()                      # main path starts
        session = timed_steps(torch, exe, main, feed, loss, scope, steps)
        launches = (fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd.launches)  # main path ends
    session_s = time.perf_counter() - t0
    records = profiler.kernel_attribution()
    rows = profiler.device_op_profile()
    by_type = {}
    for r in rows:
        by_type[r["type"]] = round(by_type.get(r["type"], 0.0)
                                   + r["share_pct"], 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        timed_steps(torch, exe, main, feed, loss, scope, 1)
    closed = sorted({e["name"] for e in profiler.trace_events(prof)
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith("fluid/")})
    exe.close()

    def mean(pairs, i):
        return float(np.mean([p[i] for p in pairs]))

    return {"batch": batch, "steps": steps, "on_card": on_card,
            "layers": (cfg or TRAIN)["n_layers"],
            "k1_fwd": launches[0], "k1_bwd": launches[1],
            "records": records, "rows": rows[:25],
            "share_pct_by_type": dict(sorted(by_type.items(),
                                             key=lambda kv: -kv[1])),
            "closed_session_ranges": closed,
            "session_wall_ms_per_step": session[0],
            "session_host_ms_per_step": session[1],
            "session_s": session_s,
            "overhead": {mode: {"wall_ms_per_step": mean(v, 0),
                                "host_ms_per_step": mean(v, 1),
                                "legs": v}
                         for mode, v in overhead.items()}}


def profile_child_main(args):
    """A 15a child: phase 6's program (or `args["cfg"]`'s) through
    ``profiled_lm_leg`` in a process of its own; prints the leg. (In the
    long-lived parent, after the earlier phases' sessions, torch's
    profiler was seen to lose card records at a session's start, which
    the K1 gate counts.)"""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa

    program = build_lm(fluid, cfg=args.get("cfg"))
    leg = profiled_lm_leg(torch, fa, fluid, program, args["batch"],
                          args["steps"], device=args.get("device"),
                          overhead_steps=args.get(
                              "overhead_steps", TELEMETRY["overhead_steps"]),
                          cfg=args.get("cfg"))
    print("phase15_profile " + json.dumps(leg), flush=True)


def check_k1_attribution(records, fwd_launches, bwd_launches):
    """15a's K1 gates on a session's kernel records: the attention op's
    forward rows hold one forward kernel a K1 forward launch, its grad
    rows one dK/dV kernel a backward launch, and the two hold all of
    K1's kernel time."""
    def typ(r):
        return None if r["op"] is None else r["op"].split("__", 1)[0]

    fwd = [r for r in records if _is_k1(r["kernel"], K1_FWD_KERNELS)]
    bwd = [r for r in records if _is_k1(r["kernel"], K1_BWD_KERNELS)]
    n_fwd = sum(typ(r) == K1_OP for r in fwd)
    n_bwd = sum(typ(r) == K1_OP + "_grad" for r in bwd
                if K1_BWD_LAUNCH_KERNEL in r["kernel"])
    if (n_fwd, n_bwd) != (fwd_launches, bwd_launches) or not fwd_launches:
        held_by = {}
        for r in fwd + bwd:
            key = "%s:%s" % (r["kernel"][:40], typ(r))
            held_by[key] = held_by.get(key, 0) + 1
        fail("15a: %d K1 forward kernels under %s rows and %d dK/dV "
             "kernels under its grad rows; K1 launched %d forward and %d "
             "backward; K1's kernels by op type: %r"
             % (n_fwd, K1_OP, n_bwd, fwd_launches, bwd_launches, held_by))
    # every K1 kernel under its row, judged kernel by kernel: two float
    # sums of the same times in different orders need not be equal
    total = math.fsum(r["us"] for r in fwd + bwd)
    stray = ([r for r in fwd if typ(r) != K1_OP]
             + [r for r in bwd if typ(r) != K1_OP + "_grad"])
    if stray:
        fail("15a: %d of K1's kernels (%.3f of its %.3f us) lie outside "
             "the attention rows: %r"
             % (len(stray), math.fsum(r["us"] for r in stray), total,
                [(r["kernel"][:40], r["op"]) for r in stray[:4]]))
    return total


def check_profiled_lm(leg, min_pct=TELEMETRY["min_attributed_pct"]):
    """15a's gates: the closed session entered no fluid/ range; on the
    card the Fluid op rows cover at least `min_pct` of the window's
    kernel time and K1 is held by the attention rows, 6 + 6 a step."""
    if leg["closed_session_ranges"]:
        fail("15a: a step with the session closed entered fluid/ ranges: "
             "%r" % leg["closed_session_ranges"][:4])
    if not leg["on_card"]:
        if leg["records"] or leg["rows"]:
            fail("15a: CUDA kernels in a CPU session: %r" % leg["rows"][:2])
        return {}
    total = sum(r["us"] for r in leg["records"])
    attributed = sum(r["us"] for r in leg["records"] if r["op"] is not None)
    pct = 100.0 * attributed / total if total else 0.0
    if pct < min_pct:
        fail("15a: the Fluid op rows hold %.2f%% of the window's %.1f us "
             "of kernel time (at least %.0f%% wanted)"
             % (pct, total, min_pct))
    per_step = leg["layers"] * leg["steps"]
    if (leg["k1_fwd"], leg["k1_bwd"]) != (per_step, per_step):
        fail("15a: K1 launched %d / %d times over %d profiled steps "
             "(%d each wanted)" % (leg["k1_fwd"], leg["k1_bwd"],
                                   leg["steps"], per_step))
    k1_us = check_k1_attribution(leg["records"], leg["k1_fwd"],
                                 leg["k1_bwd"])
    return {"kernel_us": total, "attributed_pct": pct, "k1_us": k1_us}


def print_op_table(rows):
    """The device table by Fluid op, on lines of its own."""
    print("%-44s %8s %14s %12s %8s" % ("Event", "Calls", "Total(us)",
                                       "Ave(us)", "Ratio."))
    for r in rows:
        print("%-44s %8d %14.3f %12.3f %7.2f%%" % (
            r["op"][:44], r["calls"], r["total_us"], r["avg_us"],
            r["share_pct"]), flush=True)


def fluid_benchmark_profile_leg(argv=TELEMETRY["bench_argv"], timeout=600):
    """15a: ``python -m paddle_tpu_torch.fluid_benchmark ... --profile``
    in a process of its own: its exit code, the event table's
    ``iteration`` row and the device table's rows."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "paddle_tpu_torch.fluid_benchmark"] + list(argv),
                         capture_output=True, text=True, cwd=root,
                         timeout=timeout)
    lines = out.stdout.splitlines()
    head = next((i for i, ln in enumerate(lines)
                 if ln.split()[:2] == ["Event", "Calls"]
                 and "Ratio." in ln), None)
    rows = []
    if head is not None:
        for ln in lines[head + 1:]:
            parts = ln.split()
            if len(parts) != 5 or not parts[-1].endswith("%"):
                break
            rows.append(parts)
    return {"argv": list(argv), "returncode": out.returncode,
            "seconds": time.perf_counter() - t0,
            "iteration_rows": [ln for ln in lines
                               if ln.startswith("iteration ")],
            "device_rows": rows, "stderr_tail": out.stderr[-2000:]}


def check_fluid_benchmark_profile(leg, on_card=True):
    if leg["returncode"] != 0:
        fail("15a: fluid_benchmark --profile exited %d: %s"
             % (leg["returncode"], leg["stderr_tail"]))
    if not leg["iteration_rows"] or (on_card and not leg["device_rows"]):
        fail("15a: fluid_benchmark --profile printed no event table or no "
             "device table (%d / %d rows)" % (len(leg["iteration_rows"]),
                                              len(leg["device_rows"])))


def serving_prompts(n, vocab, lens, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(lens[0], lens[1] + 1))
            .tolist() for _ in range(n)]


def submit_all(engine, prompts, max_new):
    """Submit every prompt before the worker's next admission (hold its
    condition once nothing is queued, scheduled or in flight), so the
    batch is the same in every leg."""
    w = engine._workers["default"]
    with w._cv:
        while len(w.queue) or w.scheduler.has_work() or w._inflight:
            w._cv.wait(timeout=0.005)
        return [engine.submit(p, max_new_tokens=max_new) for p in prompts]


def _scrape(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def traced_serving_leg(torch, pa, device=None, cfg=None, seed=None,
                       requests=None, max_new=None, traced=True,
                       reverse_locks=False):
    """15b (and, in a child, 15c): the flagship decoder (phase 3's width,
    random weights from `seed`) behind ``ServingEngine`` serving
    `requests` pinned requests; with `traced`, metrics and tracing on and
    the endpoint on port 0, scraped at /metrics, /varz and /healthz while
    the requests are in flight and /varz after. Returns the tokens, each
    request's event counts, the spans and the scrapes. `reverse_locks`
    (a fault the tests plant in a child) takes two of the engine's lock
    sites in both orders."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import endpoint
    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          ServingEngine)

    T = TELEMETRY
    cfg = GenerationConfig(**(cfg or T["serve_cfg"]))
    n = requests or T["requests"]
    max_new = max_new or T["max_new"]
    model = GenerationModel.random(
        cfg, seed=T["serve_seed"] if seed is None else seed, device=device)
    prompts = serving_prompts(n, cfg.vocab_size, T["prompt_len"])
    was_m, was_t = obs.metrics.enabled(), obs.tracing.enabled()
    scrapes = {}
    if traced:
        obs.registry().reset()
        obs.tracing.reset()
        obs.enable()
        endpoint.start(port=0)
    pa.paged_attention.window_launches.clear()
    t0 = time.perf_counter()
    try:
        with ServingEngine(model, max_batch=T["max_batch"],
                           max_seq_len=cfg.max_seq_len,
                           block_size=T["block_size"],
                           device=device) as eng:
            worker = eng._workers["default"]
            reqs = submit_all(eng, prompts, max_new)
            if traced:
                # scraped in flight, once the first step is counted
                deadline = time.perf_counter() + 300
                while "serving/steps" not in obs.registry().metrics() and \
                        time.perf_counter() < deadline:
                    time.sleep(0.001)
                for route in ("/metrics", "/varz", "/healthz"):
                    scrapes[route] = _scrape(endpoint.url(route))
            tokens = [r.wait(900) for r in reqs]
            steps = eng.stats()["default"]["steps"]
            if traced:
                scrapes["/varz_after"] = _scrape(endpoint.url("/varz"))
            if reverse_locks:
                with worker.pool._lock, worker._cv:
                    pass
                with worker._cv, worker.pool._lock:
                    pass
        wall = time.perf_counter() - t0
        by_c = dict(pa.paged_attention.window_launches)
        events = obs.tracing.events() if traced else []
    finally:
        if traced:
            endpoint.stop()
            (obs.metrics.enable if was_m else obs.metrics.disable)()
            (obs.tracing.enable if was_t else obs.tracing.disable)()
            obs.tracing.reset()
    windows = []
    for r in reqs:
        counts = {}
        for e in events:
            if e.get("args", {}).get("trace_id") == r.trace_id:
                counts[e["name"]] = counts.get(e["name"], 0) + 1
        windows.append(counts)
    leg = {"requests": n, "max_new": max_new, "traced": traced,
           "prompt_lens": [len(p) for p in prompts], "tokens": tokens,
           "windows": windows, "steps": steps, "wall_s": wall,
           "serving_step_spans": sum(e["name"] == "serving_step"
                                     for e in events),
           "k2_by_window": {str(c): k for c, k in by_c.items()},
           "layers": cfg.n_layers}
    if traced:
        status, body = scrapes["/healthz"]
        leg["healthz"] = {"status": status, "doc": json.loads(body)}
        leg["metrics_lines"] = len(scrapes["/metrics"][1].splitlines())
        leg["metrics_status"] = scrapes["/metrics"][0]
        leg["metrics_has_steps"] = \
            "ptpu_serving_steps_total" in scrapes["/metrics"][1]
        leg["varz_status"] = scrapes["/varz"][0]
        leg["varz_after_steps"] = json.loads(
            scrapes["/varz_after"][1])["counters"].get("serving/steps")
    return leg


def check_traced_serving(leg, plain_tokens, on_card):
    """15b's gates: every request's trace holds its queue_wait and admit
    and one prefill_chunk a prompt token but the last and one
    decode_window a generated token; the serving_step spans are the
    engine's dispatches (and /varz's serving/steps after); /healthz 200
    and /metrics and /varz served while the requests were in flight; the
    tokens the untraced run's; on the card K2 once a layer a step."""
    for i, (counts, plen) in enumerate(zip(leg["windows"],
                                           leg["prompt_lens"])):
        want = {"queue_wait": 1, "admit": 1, "prefill_chunk": plen - 1,
                "decode_window": leg["max_new"]}
        if {k: counts.get(k, 0) for k in want} != want:
            fail("15b: request %d's trace holds %r, not %r"
                 % (i, counts, want))
    if not leg["serving_step_spans"] == leg["steps"] == \
            leg["varz_after_steps"]:
        fail("15b: %d serving_step spans, %d dispatched steps, /varz "
             "serving/steps %r" % (leg["serving_step_spans"], leg["steps"],
                                   leg["varz_after_steps"]))
    if leg["healthz"]["status"] != 200 or \
            leg["healthz"]["doc"]["status"] != "ok":
        fail("15b: /healthz answered %r" % (leg["healthz"],))
    if (leg["metrics_status"], leg["varz_status"]) != (200, 200) or \
            not leg["metrics_has_steps"]:
        fail("15b: /metrics %r (serving steps %r), /varz %r"
             % (leg["metrics_status"], leg["metrics_has_steps"],
                leg["varz_status"]))
    if leg["tokens"] != plain_tokens:
        bad = [i for i, (a, b) in enumerate(zip(leg["tokens"],
                                                plain_tokens)) if a != b]
        fail("15b: the traced run's tokens differ from the untraced run's "
             "for requests %r" % bad[:8])
    if on_card and leg["k2_by_window"] != {"1": leg["layers"] * leg["steps"]}:
        fail("15b: K2 launched %r over %d steps (C=1: %d a step wanted)"
             % (leg["k2_by_window"], leg["steps"], leg["layers"]))


def run_lockcheck_child(args, timeout=600):
    """15c: ``chip_smoke.py --phase15-lockcheck`` with PTPU_LOCK_CHECK=1
    set before the process makes any lock; returns its result line."""
    env = dict(os.environ, PTPU_LOCK_CHECK="1")
    env.pop("PTPU_LOCK_HOLD_MS", None)
    return _child(LOCK_FLAG, "phase15_lockcheck", args, env, timeout)


def _child(flag, tag, args, env, timeout):
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), flag, json.dumps(args)],
        capture_output=True, text=True, env=env, timeout=timeout)
    lines = [x for x in out.stdout.splitlines() if x.startswith(tag + " ")]
    if out.returncode != 0 or not lines:
        fail("15: the child %s exited %d: %s"
             % (flag, out.returncode, out.stderr[-3000:]))
    got = json.loads(lines[-1].split(" ", 1)[1])
    got["process_seconds"] = time.perf_counter() - t0
    return got


def lockcheck_child_main(args):
    """A 15c child: the traced serving leg under the tracker, then the
    tracker's violations and counters."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    from paddle_tpu_torch.analysis import concurrency
    from paddle_tpu_torch.ops import paged_attention as pa

    if not concurrency.tracking_enabled():
        fail("15c: the child runs without PTPU_LOCK_CHECK")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        leg = traced_serving_leg(torch, pa, **args)
    concurrency.publish_metrics()
    leg["lockcheck"] = dict(concurrency.stats(), violations_list=[
        repr(v)[:400] for v in concurrency.violations()])
    print("phase15_lockcheck " + json.dumps(leg), flush=True)


def check_lockcheck(leg, plain_tokens, on_card):
    st = leg["lockcheck"]
    if st["violations"] or st["violations_list"]:
        fail("15c: %d lock-check violations: %s" % (
            st["violations"], "; ".join(st["violations_list"][:3])))
    if st["locks_tracked"] < 3 or not st["acquisitions"]:
        fail("15c: the tracker saw %r: no tracked lock sites" % (st,))
    check_traced_serving(leg, plain_tokens, on_card)


def native_wait_leg(torch, fa, device=None, batch=None, steps=None,
                    seq=NATIVE_SEQ):
    """15d: the native step (phase 12a's bench_transformer step) `steps`
    times, the loss read after each, with spans and a profiler session
    on: the span durations of each step's enqueue and its loss read, and
    the longest host events inside each step's enqueue."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import profiler

    batch = batch or TELEMETRY["native_batch"]
    steps = steps or TELEMETRY["native_steps"]
    cfg = bench.native_config(batch, seq)
    state = list(bench.native_state(cfg, device))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    tokens = torch.from_numpy(toks).to(state[3].device)
    labels = torch.from_numpy(np.roll(toks, -1, axis=1)).to(tokens.device)
    *state, loss = bench.native_train_step(*state, tokens, labels, cfg)
    float(loss)                                 # warm
    was_t = obs.tracing.enabled()
    obs.tracing.reset()
    obs.tracing.enable()
    fa.reset_counts()
    try:
        with profiler.profiler("All"):
            for _ in range(steps):
                with obs.span("native_step"):
                    *state, loss = bench.native_train_step(
                        *state, tokens, labels, cfg)
                with obs.span("loss_read"):
                    float(loss)
        spans = [e for e in obs.tracing.events()
                 if e["name"] in ("native_step", "loss_read")]
    finally:
        (obs.tracing.enable if was_t else obs.tracing.disable)()
        obs.tracing.reset()
    k1 = flash_counts(fa)
    events = profiler.trace_events(None)
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e["name"] == "native_step"),
                    key=lambda e: e["ts"])
    per_step = []
    for r in ranges:
        inside = [e for e in events if e.get("ph") == "X"
                  and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        per_step.append(dict(
            enqueue_ms=r["dur"] / 1e3,
            **host_waits(inside, main=(r["pid"], r["tid"]))))
    spans_ms = {name: [e["dur"] / 1e3 for e in spans if e["name"] == name]
                for name in ("native_step", "loss_read")}
    return {"batch": batch, "steps": steps, "spans_ms": spans_ms,
            "per_step": per_step, "k1_fwd": k1[0], "k1_bwd": k1[1],
            "k1_copies": k1[2], "remat": cfg.remat,
            "layers": cfg.n_layers}


LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
BLOCKED_LAUNCH_US = 100.0   # a launch this long waited for a queue slot


def host_waits(events, main=None, k=6):
    """Where a window's host time went, from a torch.profiler trace's
    events inside it (every host thread): the CUDA runtime and driver
    calls summed by name, the kernel launches and those that blocked
    (longer than BLOCKED_LAUNCH_US: the launch queue was full, so the
    host waited on the card), the longest fluid/ op ranges and the
    longest host ops of thread `main` (pid, tid)."""
    runtime = [e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    by_name = {}
    for e in runtime:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    launches = [e for e in runtime if e["name"] in LAUNCH_NAMES]
    blocked = [e for e in launches if e["dur"] > BLOCKED_LAUNCH_US]

    def top(evs):
        return [{"name": e["name"][:80], "ms": e["dur"] / 1e3}
                for e in sorted(evs, key=lambda e: -e["dur"])[:k]]

    return {"runtime_ms_by_name": dict(sorted(
                by_name.items(), key=lambda kv: -kv[1])[:k]),
            "launches": len(launches),
            "launch_ms": sum(e["dur"] for e in launches) / 1e3,
            "blocked_launches": len(blocked),
            "blocked_launch_ms": sum(e["dur"] for e in blocked) / 1e3,
            "op_ranges_top": top(e for e in events
                                 if e.get("cat") == "user_annotation"
                                 and e["name"].startswith("fluid/")),
            "main_ops_top": top(e for e in events
                                if e.get("cat") == "cpu_op" and main
                                == (e.get("pid"), e.get("tid")))}


def first_program_main(args):
    """A 15d child: a fresh process's first program (phase 13's: the
    headline LM), `steps` steps with tracing on, each step's fetch read
    in a span of its own; prints each step's split."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    t_import = time.perf_counter()
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.async_engine import as_numpy

    from paddle_tpu_torch import profiler

    import_s = time.perf_counter() - t_import
    obs.tracing.enable()
    main, startup, loss = build_lm(fluid, cfg=args.get("cfg"))
    exe, scope = fluid.Executor(args.get("device")), fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    startup_s = time.perf_counter() - t0
    feed = lm_feed(torch, args["batch"], exe.device, cfg=args.get("cfg"))
    steps = []
    for i in range(args["steps"]):
        obs.tracing.reset()
        # the first step inside a profiler session (opened before it:
        # the session's own start is not the step's)
        if i == 0:
            profiler.start_profiler("All")
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        with obs.span("fetch"):
            as_numpy(out)
        wall = (time.perf_counter() - t0) * 1e3
        if i == 0:
            profiler.stop_profiler()
        split = {}
        for e in obs.tracing.events():
            split[e["name"]] = split.get(e["name"], 0.0) + e["dur"] / 1e3
        steps.append(dict(split, wall_ms=wall))
    events = profiler.trace_events(None)
    step = next((e for e in events if e.get("cat") == "user_annotation"
                 and e["name"] == "step"), {})
    waits = host_waits(events, main=(step.get("pid"), step.get("tid")))
    print("phase15_first " + json.dumps({
        "import_s": import_s, "startup_s": startup_s,
        "batch": args["batch"], "steps": steps,
        "first_step_host": waits}), flush=True)


def check_first_program(got):
    for i, s in enumerate(got["steps"]):
        missing = [k for k in ("step", "execute", "fetch") if k not in s]
        if missing or (i == 0 and not ("lower" in s and "compile" in s)):
            fail("15d: step %d of the first program has spans %r"
                 % (i, sorted(s)))


def telemetry_phase(torch, fa, pa, fluid):
    """Phase 15 on cuda:0: 15a (the profiled headline step, the device
    table by Fluid op, the tracing and session overheads, the harness's
    --profile), 15b (traced serving with the live endpoint), 15c (the
    same leg under PTPU_LOCK_CHECK=1 in a child), 15d (the native step's
    waits and a fresh process's first-program split). Returns the
    kernels' launches on the phase's main paths by kernel row name."""
    T = TELEMETRY
    t15 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    leg = _child(PROFILE_FLAG, "phase15_profile",
                 {"batch": T["lm_batch"], "steps": T["lm_steps"]},
                 dict(os.environ), 600)
    print_op_table(leg["rows"])
    sums = check_profiled_lm(leg)
    ov = leg["overhead"]
    print("telemetry_lm " + json.dumps(dict(
        {k: v for k, v in leg.items() if k not in ("records", "rows")},
        gates=sums, top_rows=leg["rows"][:10],
        spans_over_off_wall=(ov["spans"]["wall_ms_per_step"]
                             / ov["off"]["wall_ms_per_step"]),
        session_over_off_wall=(leg["session_wall_ms_per_step"]
                               / ov["off"]["wall_ms_per_step"]),
        card=card_line())), flush=True)
    launches = {"flash_attention_tc_fwd": leg["k1_fwd"],
                "flash_attention_tc_bwd": leg["k1_bwd"]}
    bench_leg = fluid_benchmark_profile_leg()
    check_fluid_benchmark_profile(bench_leg)
    print("telemetry_bench_profile " + json.dumps(
        {k: v for k, v in bench_leg.items() if k != "stderr_tail"}),
        flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    plain = traced_serving_leg(torch, pa, traced=False)
    traced = traced_serving_leg(torch, pa)
    check_traced_serving(traced, plain["tokens"], on_card=True)
    k2 = traced["k2_by_window"].get("1", 0)
    print("telemetry_serving " + json.dumps(dict(
        {k: v for k, v in traced.items() if k != "tokens"},
        plain_wall_s=plain["wall_s"], card=card_line())), flush=True)
    child = run_lockcheck_child({})
    check_lockcheck(child, plain["tokens"], on_card=True)
    k2 += child["k2_by_window"].get("1", 0)
    print("telemetry_lockcheck " + json.dumps(dict(
        {k: v for k, v in child.items() if k not in ("tokens", "windows")},
        card=card_line())), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    native = native_wait_leg(torch, fa)
    f, b = (2 if native["remat"] else 1) * native["layers"], native["layers"]
    want = ({"tc": f * native["steps"], "fp16": 0, "f32tc": 0},
            {"tc": b * native["steps"], "fp16": 0, "f32tc": 0}, 0)
    if (native["k1_fwd"], native["k1_bwd"], native["k1_copies"]) != want:
        fail("15d: the native steps launched K1 %r, %r (%d copies); "
             "expected %r" % (native["k1_fwd"], native["k1_bwd"],
                              native["k1_copies"], want))
    launches["flash_attention_tc_fwd"] += native["k1_fwd"]["tc"]
    launches["flash_attention_tc_bwd"] += native["k1_bwd"]["tc"]
    print("telemetry_native_wait " + json.dumps(dict(native,
                                                     card=card_line())),
          flush=True)
    first = _child(FIRST_FLAG, "phase15_first",
                   {"batch": T["lm_batch"], "steps": T["first_steps"]},
                   dict(os.environ), 600)
    check_first_program(first)
    print("telemetry_first_program " + json.dumps(dict(first,
                                                       card=card_line())),
          flush=True)
    print("telemetry_phase " + json.dumps({
        "seconds": time.perf_counter() - t15, "k1_launches": launches,
        "k2_c1_launches": k2}), flush=True)
    return launches, k2


# phase 16: the SPMD Transformer trainer (parallel/transformer.py's
# SPMDTrainer). 16a: the flagship at mesh (1, 1, 1) at phase 12a's
# operating point (full width, batch 192, seq 512, bf16, remat), then a
# 2-layer fp32 leg on the card and on the CPU; 16b: the same model with a
# 4-expert switch MoE (ep = 1); 16c: one child process a visible card (4,
# or 2 with two or three; NCCL), each leg of SPMD_LEGS[world] at full
# width with a small fp32 twin held to mesh (1, 1, 1)
SPMD = dict(batch=192, seq=512, warmup=3, steps=8, moe_steps=4, experts=4,
            cvc=dict(batch=4, seq=256, n_layers=2, steps=2),
            multi_batch=192, multi_warmup=2, multi_steps=4,
            twin=dict(vocab_size=256, d_model=64, n_heads=4, d_ff=128,
                      max_seq_len=32, dtype="float32", remat=True),
            twin_batch=8, twin_steps=2, twin_lr=1e-2)
# 16c's legs by world: (name, mesh, config overrides, microbatches). The
# pipeline leg at pp = 4 takes 8 layers so that pp divides the depth
SPMD_LEGS = {
    4: [("dense_1x2x2", (1, 2, 2), {}, 4),
        ("moe_2x1x2", (2, 1, 2), {"n_experts": 4}, None),
        ("pipe_1x4x1", (1, 4, 1), {"n_layers": 8}, 8)],
    2: [("dense_1x1x2", (1, 1, 2), {}, None),
        ("moe_2x1x1", (2, 1, 1), {"n_experts": 4}, None),
        ("pipe_1x2x1", (1, 2, 1), {}, 4)],
}
# each full-width leg's first loss (16a-c) against the plain reference on
# the same parameters and batch (``spmd_plain_loss``: single_chip_loss,
# or with experts a plain MoE loop): the hidden states are one
# computation, up to where its sums round; single_chip_loss rounds each
# logit to bf16 before its cross-entropy (1 ulp is 2^-8 of a logit of up
# to ~5 here), the trainer keeps them fp32; across ranks each tp rank's
# partial block output is rounded to bf16 before the reduce-scatter adds
# them. Unbiased roundings over 98,304 tokens move the mean by ~1e-4
# nats; 1e-3 of the loss (~1e-2 nats) holds 100x that, and a wrong layer
# or collective moves it by whole percents
SPMD_REF_RTOL = 1e-3
# fp32 limits, cross-mesh and card against CPU: the losses to the JAX
# suite's cross-mesh rtol (tests/test_spmd_transformer.py:41); each
# parameter leaf's difference after the steps, in the 2-norm, to 1% of
# the leaf's whole move over them. Adam moves every element by about lr
# whatever its grad's size, so an element whose grad is a near-cancelling
# sum may land a fraction of lr off (4e-4 at lr 1e-2, one element in
# 36,288, against the JAX package on the CPU); such elements are few and
# the norm ratio stays under 2.1e-4 there. A grad summed over too few
# ranks or microbatches flips the sign of many elements' moves
SPMD_LOSS_RTOL = 2e-3
SPMD_PARAM_RATIO = 1e-2
SPMD_RANK_FLAG = "--phase16-rank"


def spmd_batch(torch, cfg, batch, seq, device, seed=0):
    """RandomState(seed) tokens over the vocabulary, labels rolled by
    one, on `device`."""
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return (torch.from_numpy(toks).to(device),
            torch.from_numpy(np.roll(toks, -1, axis=1)).to(device))


def plain_moe(torch, mp, h, cfg, dp, tp):
    """The trainer's top-1 switch MoE (pp = 1: after the layers) on h
    [B, T, D] as a plain loop with no collective: each (dp, tp) rank's
    tokens (its rows, its sequence chunk) routed on their own, as the
    ranks route them (the fp32 router softmax, the first of ties, the
    capacity int(factor · N / E) + 1 filled in token order), each kept
    token through its expert's GELU FFN in the dtype, times its fp32
    gate, added to the stream."""
    import torch.nn.functional as F

    B, T_, D = h.shape
    E, dt = cfg.n_experts, cfg.dtype
    b, t = B // dp, T_ // tp
    out = h.clone()
    for d in range(dp):
        for s in range(tp):
            rows, cols = slice(d * b, (d + 1) * b), slice(s * t, (s + 1) * t)
            x = h[rows, cols].reshape(-1, D)
            gates = torch.softmax(x.float() @ mp["router"].float(), dim=-1)
            expert = gates.argmax(-1)
            gate = gates.gather(-1, expert[:, None])[:, 0]
            cap = int(cfg.expert_capacity_factor * x.shape[0] / E) + 1
            y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for e in range(E):
                idx = (expert == e).nonzero()[:cap, 0]
                a = F.gelu(x[idx] @ mp["w1"][e].to(dt), approximate="tanh")
                y[idx] = (a @ mp["w2"][e].to(dt)).float() * gate[idx, None]
            out[rows, cols] += y.to(dt).view(b, t, D)
    return out


def spmd_plain_loss(torch, params, tokens, labels, cfg, dp=1, tp=1):
    """The plain reference of a pp = 1 or dense leg's first loss on the
    full tree `params` and the global batch, with no collective: the
    port's ``single_chip_loss``; with experts, the same layers, then
    ``plain_moe`` as mesh (dp, ·, tp) routes, the final layer norm and
    fp32 logits 128 positions at a time."""
    from paddle_tpu_torch.models import transformer as T

    with torch.no_grad():
        if not cfg.n_experts:
            return float(T.single_chip_loss(params, tokens, labels, cfg))
        h = T.embed_tokens(params, tokens, cfg)
        for i in range(cfg.n_layers):
            h = T._layer(h, {k: v[i] for k, v in params["layers"].items()},
                         cfg.dtype)
        h = plain_moe(torch, params["moe"], h, cfg, dp, tp)
        h = T.layer_norm(h, params["final_ln_scale"],
                         params["final_ln_bias"])
        total = 0.0
        for s in range(0, h.shape[1], 128):
            logp = torch.log_softmax(T.lm_logits(params, h[:, s:s + 128],
                                                 cfg), dim=-1)
            total += float(logp.gather(
                -1, labels[:, s:s + 128].long()[..., None]).sum())
        return -total / labels.numel()


def spmd_logits_grad_check(torch, device="cuda", N=4096, seed=3):
    """``lm_logits``'s bf16 grads on the card (``logits_grads`` with the
    cotangent rounded to bf16 first) against JAX's transpose, the exact
    products rounded to bf16 (fp64 here), on one set of operands at the
    flagship's head width (D 512, V 32000, N tokens): each grad's error
    in the 2-norm within LOGITS_GRAD_RTOL of its norm. Returns the
    report."""
    from paddle_tpu_torch.models import transformer as T

    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(N, 512, generator=gen).to(device, torch.bfloat16)
    w = (torch.randn(512, 32000, generator=gen) / 512 ** 0.5).to(
        device, torch.bfloat16)
    cot = (torch.randn(N, 32000, generator=gen) / N).to(device)
    leaves = [h.requires_grad_(), w.requires_grad_()]
    out = T.lm_logits({"lm_head": w}, h, T.TransformerConfig())
    got = torch.autograd.grad(out, leaves, cot)
    with torch.no_grad():
        want = ((cot.double() @ w.double().t()).to(torch.bfloat16),
                (h.double().t() @ cot.double()).to(torch.bfloat16))
    rel = [float((a.double() - b.double()).norm() / b.double().norm())
           for a, b in zip(got, want)]
    report = {"N": N, "rel_err_h": rel[0], "rel_err_w": rel[1],
              "limit": T.LOGITS_GRAD_RTOL}
    print("spmd_logits_grad " + json.dumps(report), flush=True)
    if not max(rel) <= T.LOGITS_GRAD_RTOL:
        fail("16a: lm_logits's bf16 grads are %r of their norm off the "
             "exact transpose's (limit %g)" % (rel, T.LOGITS_GRAD_RTOL))
    return report


def spmd_k1_shapes(legs):
    """K1's [B, H] on each leg of 16c's `legs` at full width: a rank's
    rows (a microbatch's with pp > 1) and its H/tp heads."""
    out = []
    for _, (dp, pp, tp), _, M in legs:
        shape = (SPMD["multi_batch"] // dp // (M if pp > 1 else 1),
                 8 // tp)
        if shape not in out:
            out.append(shape)
    return out


def spmd_k1_per_step(layers_per_stage, pp, M, remat):
    """K1's (forward, backward) launches a step on one rank: pp == 1, each
    layer's forward (again in its remat recompute) and backward once;
    pp > 1, each microbatch's forward unit, the backward unit's
    recompute of the stage, its remat recompute and its backward."""
    S = layers_per_stage
    if pp == 1:
        return (2 if remat else 1) * S, S
    return (3 if remat else 2) * S * M, S * M


def k1_gate(got, layers_per_stage, pp, M, remat, route, runs):
    """K1's gate on a leg's main path: `got` (forward and backward
    launches by route, operand copies) must be the schedule's count a
    step (``spmd_k1_per_step``) over `runs` steps by `route` only, with
    no copy. A failure's text, or None."""
    f, b = spmd_k1_per_step(layers_per_stage, pp, M, remat)
    zero = {"tc": 0, "fp16": 0, "f32tc": 0}
    want = (dict(zero, **{route: f * runs}),
            dict(zero, **{route: b * runs}), 0)
    if tuple(got) != want:
        return ("flash attention launched %r (forward, backward by route; "
                "copies) over %d steps; the schedule's count is %r"
                % (tuple(got), runs, want))
    return None


def leaf_ratios(got, ref, start):
    """The worst leaf's ||got - ref|| / ||ref - start|| (flat dicts of
    numpy arrays) and its name."""
    worst = (0.0, "")
    for k in ref:
        move = float(np.linalg.norm(ref[k] - start[k]))
        diff = float(np.linalg.norm(got[k] - ref[k]))
        r = diff / move if move > 0 else (0.0 if diff == 0 else math.inf)
        worst = max(worst, (r, k))
    return worst


def host_leaves(torch, tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(host_leaves(torch, tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k].detach().float().cpu().numpy()
    return out


def collective_calls(C, runs, host0, steps):
    """The axis collectives' calls a run (over all `runs`) and the host's
    ms inside them a timed step (since `host0`, a copy of
    ``host_seconds`` taken as the `steps` timed steps began: a group's
    first calls set up its connections)."""
    return ({k: v / runs for k, v in C.counts.items()
             if v and not k.endswith("_bytes")
             and k.split("_bwd")[0] in C.AXIS_KINDS},
            {k: (v - host0[k]) * 1e3 / steps
             for k, v in C.host_seconds.items() if v})


def spmd_train_leg(torch, fa, device=None, batch=None, seq=None,
                   warmup=None, steps=None, ref=True, **over):
    """16a (16b with ``n_experts``): ``SPMDTrainer`` at mesh (1, 1, 1) on
    bench.py's native configuration (``over`` replaces fields), the port's
    init from seed 0, `warmup` + `steps` steps on one RandomState(0)
    batch; the first step counted (``observability/cost.py``), the
    timed ones by CUDA events. With `ref`, ``spmd_plain_loss`` on the
    same parameters and batch first. K1's and the collectives' counts
    are zeroed just before the steps and read just after."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.observability import cost
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.transformer import SPMDTrainer

    batch = batch or SPMD["batch"]
    seq = seq or SPMD["seq"]
    warmup = SPMD["warmup"] if warmup is None else warmup
    steps = steps or SPMD["steps"]
    cfg = bench.native_config(batch, seq, remat=True, **over)
    tr = SPMDTrainer(cfg, (1, 1, 1), device=device)
    dev = tr.device
    on_card = dev.type == "cuda"
    state = tr.init(0)
    tokens, labels = spmd_batch(torch, cfg, batch, seq, dev)
    ref_loss = (spmd_plain_loss(torch, state[0], tokens, labels, cfg)
                if ref else None)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_counts()                          # main path starts
    C.reset_counts()
    losses, marks, host_ms, step_flops = [], [], [], None
    t0 = host0 = None
    for i in range(warmup + steps):
        if i == warmup:
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host0 = dict(C.host_seconds)
        if on_card and i >= warmup:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        if i == 0:
            with cost.count_flops(dev) as count:
                state, loss = tr.step(state, tokens, labels)
            step_flops = count.flops
        else:
            state, loss = tr.step(state, tokens, labels)
        if i >= warmup:
            host_ms.append((time.perf_counter() - th) * 1e3)
        losses.append(loss)
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    k1 = flash_counts(fa)                      # main path ends
    runs = warmup + steps
    calls, host = collective_calls(C, runs, host0, steps)
    ms = (marks[0].elapsed_time(marks[-1]) / steps if on_card
          else wall * 1e3 / steps)
    leg = {"leg": "spmd_moe" if cfg.n_experts else "spmd_train",
           "mesh": [1, 1, 1], "batch": batch, "seq": seq,
           "layers": cfg.n_layers, "experts": cfg.n_experts,
           "remat": cfg.remat, "dtype": str(cfg.dtype).split(".")[1],
           "warmup": warmup, "steps": steps, "runs": runs,
           "losses": [float(x) for x in losses], "ref_loss": ref_loss,
           "ms_per_step": ms, "host_ms_per_step": float(np.mean(host_ms)),
           "tokens_per_s": batch * seq / ms * 1e3,
           "step_flops": step_flops,
           "mfu_pct": cost.mfu_pct(step_flops, 1e3 / ms, dev),
           "k1_fwd": k1[0], "k1_bwd": k1[1], "k1_copies": k1[2],
           "collective_calls_per_step": calls,
           "collective_host_ms_per_step": host,
           "embed_calls": tr.counts["embed"], "head_calls": tr.counts["head"],
           "device": str(dev)}
    if on_card:
        leg["step_ms_each"] = [a.elapsed_time(b)
                               for a, b in zip(marks, marks[1:])]
        leg["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return leg


def check_spmd_train_leg(leg, on_card):
    """16a's and 16b's gates: the losses finite and falling; the first
    loss within SPMD_REF_RTOL of the plain reference's; the embedding and
    the head once a step; on the card K1 launched by the "tc" route only,
    the schedule's count a step, no operand copied; 16b's all-to-all
    calls a step 2 forward (and 2 more in the remat recompute) and 2
    backward."""
    tag = leg["leg"]
    losses = leg["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail("%s: losses not finite and falling: %r" % (tag, losses))
    if leg["ref_loss"] is not None:
        err = abs(losses[0] - leg["ref_loss"]) / abs(leg["ref_loss"])
        if not err <= SPMD_REF_RTOL:
            fail("%s: the first loss %r is %.3g (rel) off the plain "
                 "reference's %r (limit %g)" % (tag, losses[0], err,
                                                leg["ref_loss"],
                                                SPMD_REF_RTOL))
    runs = leg["runs"]
    if (leg["embed_calls"], leg["head_calls"]) != (runs, runs):
        fail("%s: the embedding ran %d times and the head %d over %d steps"
             % (tag, leg["embed_calls"], leg["head_calls"], runs))
    calls = leg["collective_calls_per_step"]
    if leg["experts"]:
        want = (2 * (2 if leg["remat"] else 1), 2)
        got = (calls.get("all_to_all", 0), calls.get("all_to_all_bwd", 0))
        if got != want:
            fail("%s: %r all-to-all calls a step (forward, backward); "
                 "expected %r for one MoE block" % (tag, got, want))
    if on_card:
        bad = k1_gate((leg["k1_fwd"], leg["k1_bwd"], leg["k1_copies"]),
                      leg["layers"], 1, 1, leg["remat"], "tc", runs)
        if bad:
            fail("%s: %s" % (tag, bad))


def spmd_card_vs_cpu(torch, fa, devices=("cuda:0", "cpu"), batch=None,
                     seq=None, n_layers=None, steps=None):
    """16a's fp32 leg: ``SPMDTrainer`` at mesh (1, 1, 1), bench.py's
    configuration in fp32 at SPMD["cvc"]'s depth, batch and length, on
    devices[0] and devices[1] from one parameter tree, `steps` steps on
    one batch: each step's loss to STEP_TOL's fp32 loss_rtol, every
    parameter leaf after them within SPMD_PARAM_RATIO of its move.
    Returns the report (with K1's launches on devices[0])."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel.transformer import SPMDTrainer

    o = SPMD["cvc"]
    batch, seq = batch or o["batch"], seq or o["seq"]
    steps = steps or o["steps"]
    cfg = bench.native_config(batch, seq, remat=True, dtype="float32",
                              n_layers=n_layers or o["n_layers"])
    full = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    start = host_leaves(torch, full)
    runs = []
    before = flash_counts(fa)
    for dev in devices:
        tr = SPMDTrainer(cfg, (1, 1, 1), device=dev)
        state = tr.init(params=full)
        tokens, labels = spmd_batch(torch, cfg, batch, seq, tr.device)
        losses = []
        for _ in range(steps):
            state, loss = tr.step(state, tokens, labels)
            losses.append(float(loss))
        runs.append((losses, host_leaves(torch, state[0])))
        if len(runs) == 1:
            after = flash_counts(fa)
    (l_c, p_c), (l_h, p_h) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_c, l_h))
    ratio, leaf = leaf_ratios(p_c, p_h, start)
    report = {"leg": "spmd_card_vs_cpu", "devices": list(devices),
              "batch": batch, "seq": seq, "layers": cfg.n_layers,
              "steps": steps, "losses": l_c, "losses_ref": l_h,
              "loss_rel_err": loss_err,
              "loss_limit": STEP_TOL["float32"]["loss_rtol"],
              "worst_leaf_ratio": ratio, "worst_leaf": leaf,
              "leaf_ratio_limit": SPMD_PARAM_RATIO,
              "k1_fwd": {r: after[0][r] - before[0][r] for r in after[0]},
              "k1_bwd": {r: after[1][r] - before[1][r] for r in after[1]},
              "k1_copies": after[2] - before[2]}
    report["ok"] = (loss_err <= report["loss_limit"]
                    and ratio <= SPMD_PARAM_RATIO)
    return report


def spmd_twin(torch, shape, over, M, device, steps=None):
    """A leg's small fp32 twin: SPMD["twin"] with the leg's layers and
    experts at its mesh and microbatches, `steps` steps from the port's
    seed-0 tree, then the same at mesh (1, 1, 1) on this rank's device:
    the losses, the worst leaf's ratio (``leaf_ratios``) and the
    trainer's counts. An MoE twin's capacity factor is its expert count,
    so no token is dropped: the capacity is taken over each rank's own
    tokens (as in the JAX package), so where tokens are dropped a mesh
    that splits the batch over dp computes another function than one
    rank does."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel.transformer import (SPMDTrainer,
                                                       gather_params)

    steps = steps or SPMD["twin_steps"]
    experts = over.get("n_experts", 0)
    cfg = T.TransformerConfig(**dict(
        SPMD["twin"], n_layers=over.get("n_layers", 6), n_experts=experts,
        expert_capacity_factor=float(experts or 2)))
    full = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    start = host_leaves(torch, full)
    out = {}
    for key, mesh_shape in (("mesh", shape), ("ref", (1, 1, 1))):
        tr = SPMDTrainer(cfg, mesh_shape, num_microbatches=M,
                         learning_rate=SPMD["twin_lr"], device=device)
        try:
            state = tr.init(params=full)
            tokens, labels = spmd_batch(torch, cfg, SPMD["twin_batch"],
                                        cfg.max_seq_len, tr.device, seed=1)
            losses = []
            for _ in range(steps):
                state, loss = tr.step(state, tokens, labels)
                losses.append(float(loss))
            out[key] = (losses, host_leaves(torch, gather_params(
                state[0], tr.specs, tr.mesh)), dict(tr.counts))
        finally:
            tr.mesh.close()
    (l_m, p_m, counts), (l_r, p_r, _) = out["mesh"], out["ref"]
    ratio, leaf = leaf_ratios(p_m, p_r, start)
    return {"losses": l_m, "losses_ref": l_r,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(l_m, l_r)),
            "worst_leaf_ratio": ratio, "worst_leaf": leaf, "counts": counts}


def spmd_rank_legs(device=None, legs=None, batch=None, seq=None,
                   warmup=None, steps=None, width=None):
    """16c on this rank: each leg of SPMD_LEGS[world] (or `legs`) at full
    width (`width` replaces config fields; `seq` the length) on the
    global batch: the plain reference's loss (``spmd_plain_loss`` on
    this rank's device, from the tree gathered back from the shards),
    then warm-up and timed steps, K1's and the collectives' counts
    zeroed just before and read just after; then its fp32 twin
    (``spmd_twin``). Returns this rank's results."""
    import torch

    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.mesh import init_data_group
    from paddle_tpu_torch.parallel.transformer import (SPMDTrainer,
                                                       gather_params)

    g = init_data_group(device)
    legs = legs or SPMD_LEGS[g.world]
    batch = batch or SPMD["multi_batch"]
    seq = seq or SPMD["seq"]
    warmup = SPMD["multi_warmup"] if warmup is None else warmup
    steps = steps or SPMD["multi_steps"]
    dev = g.device
    on_card = dev.type == "cuda"
    out = {"rank": g.rank, "world": g.world, "backend": g.backend,
           "device": str(dev), "legs": {}}
    for name, shape, over, M in legs:
        cfg = bench.native_config(batch, seq, remat=True,
                                  **dict(over, **(width or {})))
        tr = SPMDTrainer(cfg, shape, num_microbatches=M, device=dev)
        try:
            state = tr.init(0)
            tokens, labels = spmd_batch(torch, cfg, batch,
                                        cfg.max_seq_len, dev)
            full = gather_params(state[0], tr.specs, tr.mesh)
            ref_loss = spmd_plain_loss(torch, full, tokens, labels, cfg,
                                       dp=shape[0], tp=shape[2])
            del full
            if on_card:
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            fa.reset_counts()                  # main path starts
            C.reset_counts()
            losses, t0, host0 = [], None, None
            for i in range(warmup + steps):
                if i == warmup:
                    if on_card:
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    host0 = dict(C.host_seconds)
                state, loss = tr.step(state, tokens, labels)
                losses.append(loss)
            if on_card:
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            k1 = flash_counts(fa)              # main path ends
            runs = warmup + steps
            calls, host = collective_calls(C, runs, host0, steps)
            leg = {"mesh": list(shape), "microbatches": tr.M,
                   "coords": [tr.mesh.axis_index(a) for a in
                              ("dp", "pp", "tp")],
                   "layers": cfg.n_layers, "experts": cfg.n_experts,
                   "remat": cfg.remat, "batch": batch,
                   "seq": cfg.max_seq_len, "runs": runs,
                   "losses": [float(x) for x in losses],
                   "ref_loss": ref_loss,
                   "ms_per_step": wall * 1e3 / steps,
                   "tokens_per_s": batch * cfg.max_seq_len * steps / wall,
                   "k1_fwd": k1[0], "k1_bwd": k1[1], "k1_copies": k1[2],
                   "collective_calls_per_step": calls,
                   "collective_host_ms_per_step": host,
                   "counts": dict(tr.counts),
                   "peak_gib": (torch.cuda.max_memory_allocated(dev)
                                / 2 ** 30 if on_card else None)}
        finally:
            tr.mesh.close()
        leg["twin"] = spmd_twin(torch, shape, over, M, dev)
        out["legs"][name] = leg
    return out


def check_spmd_ranks(results, on_card):
    """16c's gates over every rank's results: a list of failures (empty:
    the phase passed). Each leg: the backend the device's; the losses
    finite, falling and every rank's the same; the first loss within
    SPMD_REF_RTOL of the plain reference's; the embedding counted only on
    stage 0 and the head only on the last stage (the full-width leg and
    the twin), the stash at most 2·pp inputs; the twin's losses within
    SPMD_LOSS_RTOL of mesh (1, 1, 1)'s and its leaves within
    SPMD_PARAM_RATIO; on the card, K1 by the "tc" route at the
    schedule's count a step, no operand copied."""
    bad = []
    backend = "nccl" if on_card else "gloo"
    for r in results:
        if r["backend"] != backend:
            bad.append("rank %d: backend %s, not %s" % (r["rank"],
                                                        r["backend"],
                                                        backend))
    for name in results[0]["legs"]:
        ranks = [r["legs"][name] for r in results]
        if any(x["losses"] != ranks[0]["losses"] for x in ranks[1:]):
            bad.append("%s: the ranks' losses differ" % name)
        for rank, leg in zip((r["rank"] for r in results), ranks):
            tag = "%s rank %d" % (name, rank)
            pp, p = leg["mesh"][1], leg["coords"][1]
            losses = leg["losses"]
            if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
                bad.append("%s: losses not finite and falling: %r"
                           % (tag, losses))
            err = abs(losses[0] - leg["ref_loss"]) / abs(leg["ref_loss"])
            if not err <= SPMD_REF_RTOL:
                bad.append("%s: the first loss %r is %.3g (rel) off the "
                           "plain reference's %r (limit %g)" % (
                               tag, losses[0], err, leg["ref_loss"],
                               SPMD_REF_RTOL))
            for what, counts in (("leg", leg["counts"]),
                                 ("twin", leg["twin"]["counts"])):
                if (counts["embed"] > 0) != (p == 0) \
                        or (counts["head"] > 0) != (p == pp - 1):
                    bad.append("%s: the %s's embedding ran %d times and its "
                               "head %d on stage %d of %d" % (
                                   tag, what, counts["embed"],
                                   counts["head"], p, pp))
                if counts["stash_peak"] > 2 * pp:
                    bad.append("%s: the %s's stash held %d inputs, more "
                               "than 2pp = %d" % (tag, what,
                                                  counts["stash_peak"],
                                                  2 * pp))
            twin = leg["twin"]
            if not twin["loss_rel_err"] <= SPMD_LOSS_RTOL:
                bad.append("%s: the twin's losses %r are %.3g (rel) off mesh "
                           "(1, 1, 1)'s %r" % (tag, twin["losses"],
                                               twin["loss_rel_err"],
                                               twin["losses_ref"]))
            if not twin["worst_leaf_ratio"] <= SPMD_PARAM_RATIO:
                bad.append("%s: the twin's %s is %.3g of its move off mesh "
                           "(1, 1, 1)'s" % (tag, twin["worst_leaf"],
                                            twin["worst_leaf_ratio"]))
            k1 = on_card and k1_gate(
                (leg["k1_fwd"], leg["k1_bwd"], leg["k1_copies"]),
                leg["layers"] // pp, pp, leg["microbatches"], leg["remat"],
                "tc", leg["runs"])
            if k1:
                bad.append("%s: %s" % (tag, k1))
    return bad


def spmd_rank_main(args):
    """One rank of 16c (a child of `spmd_phase`): one ``phase16_rank``
    line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    out = spmd_rank_legs(device=args.get("device"))
    from paddle_tpu_torch.parallel.mesh import destroy_data_group

    destroy_data_group()
    print("phase16_rank " + json.dumps(out), flush=True)


def spmd_phase(torch, fa, timeout=900):
    """Phase 16: 16a (``spmd_train_leg``, ``spmd_card_vs_cpu`` and
    ``spmd_logits_grad_check``) and 16b on cuda:0, K1 checked at 16c's
    tp-local shapes, then 16c over min(visible cards, 4) ranks (with one
    card, one line saying so). Returns K1's launches on the phase's main
    paths by kernel row name."""
    t16 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2 if cards >= 2 else 1
    # K1 on the four-card legs' (and two cards' legs') rank shapes, q, k,
    # v packed as their QKV GEMM lays them out: [B, T, 3, H/tp, Dh]
    for i, (B, H) in enumerate(spmd_k1_shapes(
            SPMD_LEGS[4] + SPMD_LEGS[2] * (world == 2))):
        flash_check(torch, fa, B, H, SPMD["seq"], SPMD["seq"], True,
                    "bfloat16", seed=40 + i, packed=True)
    leg = spmd_train_leg(torch, fa)
    check_spmd_train_leg(leg, on_card=True)
    launches = {"flash_attention_tc_fwd": leg["k1_fwd"]["tc"],
                "flash_attention_tc_bwd": leg["k1_bwd"]["tc"]}
    print("spmd_train " + json.dumps(dict(leg, card=card)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cvc = spmd_card_vs_cpu(torch, fa)
    print("spmd_card_vs_cpu " + json.dumps(cvc), flush=True)
    if not cvc["ok"]:
        fail("16a: the fp32 leg on the card is off the CPU's: %r" % cvc)
    bad = k1_gate((cvc["k1_fwd"], cvc["k1_bwd"], cvc["k1_copies"]),
                  cvc["layers"], 1, 1, True, "f32tc", cvc["steps"])
    if bad:
        fail("16a: the fp32 leg: %s" % bad)
    spmd_logits_grad_check(torch)
    launches["flash_attention_f32tc_fwd"] = cvc["k1_fwd"]["f32tc"]
    launches["flash_attention_f32tc_bwd"] = cvc["k1_bwd"]["f32tc"]
    gc.collect()
    torch.cuda.empty_cache()
    moe = spmd_train_leg(torch, fa, steps=SPMD["moe_steps"], warmup=0,
                         n_experts=SPMD["experts"])
    check_spmd_train_leg(moe, on_card=True)
    launches["flash_attention_tc_fwd"] += moe["k1_fwd"]["tc"]
    launches["flash_attention_tc_bwd"] += moe["k1_bwd"]["tc"]
    print("spmd_moe " + json.dumps(dict(moe, card=card)), flush=True)
    if world == 1:
        print("spmd_multi " + json.dumps({
            "world": 1, "cards": cards, "ran": False,
            "why": "one card visible: no multi-rank mesh (16a-b carry the "
                   "gates)"}), flush=True)
    else:
        gc.collect()
        torch.cuda.empty_cache()
        results = run_ranks(SPMD_RANK_FLAG, "phase16_rank", world, timeout)
        for name in results[0]["legs"]:
            print("spmd_multi " + json.dumps({
                "leg": name, "world": world, "card": card,
                "ranks": [dict(r["legs"][name], rank=r["rank"])
                          for r in results]}), flush=True)
        bad = check_spmd_ranks(results, on_card=True)
        if bad:
            fail("16c: " + "; ".join(bad))
        for r in results:
            for leg_r in r["legs"].values():
                launches["flash_attention_tc_fwd"] += leg_r["k1_fwd"]["tc"]
                launches["flash_attention_tc_bwd"] += leg_r["k1_bwd"]["tc"]
    print("spmd_phase " + json.dumps({
        "world": world, "seconds": time.perf_counter() - t16,
        "k1_launches": launches}), flush=True)
    return launches


# phase 17: Fluid tensor parallelism and ZeRO-1 through
# CompiledProgram.with_data_parallel (the planner's Megatron walk,
# tensor_parallel_degree, ReduceStrategy.Reduce) on the (dp, tp) mesh.
# 17a (one card): the plan of bench.py's headline program at full width
# at meshes (2, 2) and (1, 4) against TP_TABLE (the JAX planner's, pinned
# by tests/test_torch_tensor_parallel.py), its predicted collectives a
# step, and K1 at the tp-local shapes with the fused op's strides; 17b
# and 17c (four cards, one child a card, ``--phase17-rank``): the
# headline program at (2, 2) and (1, 4) under SGD, and the LM under Adam
# and ReduceStrategy.Reduce at (2, 2) with its AllReduce twin
TP = dict(batch=160, warmup=3, steps=8, reduce_steps=2, tokens=4,
          world=4, k1_shapes=((80, 4), (160, 2)))
# (name, (dp, tp), optimizer, Reduce)
TP_LEGS = [("bench_2x2", (2, 2), "sgd", False),
           ("bench_1x4", (1, 4), "sgd", False),
           ("adam_reduce_2x2", (2, 2), "adam", True)]
TP_TABLE = os.path.join("tests", "data", "tp_plan_headline.json")
TP_KINDS = ("reduce_tp", "gather_tp", "enter_tp_bwd", "zero_gather")
TP_ADAM_LR = 1e-3
TP_RANK_FLAG = "--phase17-rank"
# the ops of attention, the FFN, the embedding and the CE head: each runs
# on the rank's shards under its TpRule, so none may gather (a seam)
TP_NO_SEAM = ("fused_multihead_attention", "flash_attention", "mul",
              "lookup_table", "softmax_with_cross_entropy")


def build_tp_lm(fluid, cfg, opt, dropout=0.0):
    """The program of a phase 17 leg: bench.py's headline program
    (``bench.build_program``: bf16-stored params, remat off, the legacy
    AMP decorator over SGD(0.01), the compile-pipeline receipt) at the
    widths `cfg`; with `opt` "adam" the same LM under the decorator over
    Adam(TP_ADAM_LR); `dropout` > 0 takes attention's fc + split path.
    Built under a fresh name scope: the vars carry the names the JAX
    planner's table holds, whatever this process built before."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer_fluid

    cfg = dict(cfg)
    seq = cfg.pop("seq_len")
    if opt == "sgd" and not dropout:
        with fluid.unique_name.guard():
            main, startup, loss, _ = bench.build_program(seq, "bfloat16",
                                                         "legacy", cfg)
        return main, startup, loss
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = transformer_fluid.build(
            seq_len=seq, remat=False, dtype="bfloat16",
            dropout_rate=dropout, **cfg)
        base = fluid.optimizer.Adam(TP_ADAM_LR) if opt == "adam" \
            else fluid.optimizer.SGD(0.01)
        fluid.contrib.mixed_precision.decorate(
            base, init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(loss)
    return main, startup, loss


def tp_plan_check(fluid):
    """17a's plan: the headline program's `plan_program` summary at (2,
    2) and (1, 4), computed without groups, against TP_TABLE, and the
    step's predicted collectives (``plan_batch`` at TP["batch"] rows).
    Returns one report a mesh; fails on a difference."""
    from paddle_tpu_torch.parallel.planner import (plan_batch, plan_program,
                                                   state_layout)

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TP_TABLE)) as f:
        table = json.load(f)
    main, _, _ = build_tp_lm(fluid, TRAIN, "sgd")
    out = {}
    for key, (dp, tp) in (("2x2", (2, 2)), ("1x4", (1, 4))):
        plan = plan_program(main, {"dp": dp, "tp": tp})
        got = {n: list(s) for n, s in plan.summary().items()}
        if got != table[key]:
            diff = sorted(n for n in set(got) | set(table[key])
                          if got.get(n) != table[key].get(n))
            fail("17a: the plan at (%d, %d) differs from the JAX planner's "
                 "table at %r" % (dp, tp, diff[:8]))
        layout, zero = state_layout(main, plan, tp, dp)
        bp = plan_batch(main, ["labels", "tokens"], dp, tp=tp,
                        layout=layout, zero=zero, rows=TP["batch"])
        out[key] = {"mesh": [dp, tp], "specs": len(got),
                    "tp_sharded": len(layout), "seams": bp.seams,
                    "expected_dp": bp.expected(main.global_block()),
                    "expected_tp": bp.expected_tp()}
    return out


def tp_feed(torch, cfg, batch, device, tokens=None):
    """bench.py's kind of batch: RandomState(0) tokens, labels shifted;
    `tokens` ids only (a loss that falls within the steps)."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, tokens or cfg["vocab_size"],
                       (batch, cfg["seq_len"])).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1)).to(device)}


def _digest(torch, t):
    """A checksum of `t`'s bytes."""
    return zlib.crc32(t.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes())


def tp_sharded_run(torch, fluid, fa, C, main, loss, init, feed, mesh,
                   reduce_, runs, warmup, device):
    """`runs` steps of ``CompiledProgram.with_data_parallel`` at `mesh`
    (Reduce or AllReduce) from `init` on the global batch `feed`, K1's
    and the collectives' counts zeroed just before and read just after
    (the main path), the steps after `warmup` timed. Returns (report,
    scope, step)."""
    from paddle_tpu_torch.compiler import BuildStrategy

    exe = fluid.Executor(device)
    scope = _restore(fluid, init)
    bs = BuildStrategy()
    bs.tensor_parallel_degree = mesh[1]
    if reduce_:
        bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    fa.reset_counts()                          # main path starts
    C.reset_counts()
    losses, t0 = [], None
    for i in range(runs):
        if i == warmup:
            if on_card:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        out, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(out).ravel()[0]))
    wall = time.perf_counter() - t0 if t0 is not None else None
    k1 = flash_counts(fa)                      # main path ends
    counts = dict(C.counts)
    step = next(iter(prog._compiled_steps.values()))
    timed = runs - warmup
    rep = {"mesh": list(mesh), "reduce": reduce_, "runs": runs,
           "losses": losses,
           "ms_per_step": wall * 1e3 / timed if wall else None,
           "tokens_per_s": (feed["tokens"].numel() * timed / wall
                            if wall else None),
           "k1_fwd": k1[0], "k1_bwd": k1[1], "k1_copies": k1[2],
           "counts": {k: counts[k] for k in
                      ("all_reduce", "all_reduce_bytes") + TP_KINDS
                      + tuple(k + "_bytes" for k in TP_KINDS)},
           "expected_dp": list(step.expected_collectives()),
           "expected_tp": {k: list(v) for k, v in
                           step.expected_tp().items()},
           "seams": [list(s) for s in step.plan.seams],
           "layout": dict(step.layout), "zero": sorted(step.zero),
           "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                        if on_card else None)}
    return rep, scope, step


def tp_rank_legs(device=None, legs=None, cfg=None, batch=None, warmup=None,
                 steps=None, tokens=None, dropout=0.0):
    """17b/17c on this rank: each leg of TP_LEGS (or `legs`) at `cfg`
    (default TRAIN) on the global batch `batch`: the init drawn by the
    startup program (the same on every rank), Executor.run's first loss
    on the global batch on this rank's device (the plain reference),
    then warm-up and timed steps through CompiledProgram (the Reduce leg:
    TP["reduce_steps"] steps, then its AllReduce twin from the same
    init, and the gathered parameters compared). Returns this rank's
    results."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.compiler import gather_persistables
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.mesh import init_data_group

    g = init_data_group(device)
    cfg = TRAIN if cfg is None else cfg
    legs = legs or TP_LEGS
    batch = batch or TP["batch"]
    warmup = TP["warmup"] if warmup is None else warmup
    steps = steps or TP["steps"]
    dev = g.device
    out = {"rank": g.rank, "world": g.world, "backend": g.backend,
           "device": str(dev), "legs": {}}
    feed = tp_feed(torch, cfg, batch, dev, tokens or TP["tokens"])
    for name, mesh, opt, reduce_ in legs:
        main, startup, loss = build_tp_lm(fluid, cfg, opt, dropout)
        exe = fluid.Executor(dev)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        init = _snapshot(scope)
        del scope
        # from the snapshot, as the sharded runs start: the step counter
        # (which seeds dropout's masks) at 0
        ref, = exe.run(main, feed=feed, fetch_list=[loss],
                       scope=_restore(fluid, init))
        runs = TP["reduce_steps"] if reduce_ else warmup + steps
        rep, scope, step = tp_sharded_run(
            torch, fluid, fa, C, main, loss, init, feed, mesh, reduce_, runs,
            0 if reduce_ else warmup, dev)
        rep.update(name=name, ref_loss=float(np.asarray(ref).ravel()[0]),
                   layers=cfg["n_layers"], heads=cfg["n_heads"],
                   coords=[g.rank // mesh[1], g.rank % mesh[1]])
        params = sorted(main.param_grad_map)
        rep["digests"] = {n: _digest(torch, scope.get(n)) for n in params}
        wq = [n for n in params if n.endswith("_wq")]
        rep["local_heads"] = [int(scope.get(n).shape[1]) for n in wq]
        if reduce_:
            got = gather_persistables(scope, params)
            held = {n: scope.get(n).numel() * scope.get(n).element_size()
                    for n in rep["zero"]}
            del scope
            twin, tscope, _ = tp_sharded_run(
                torch, fluid, fa, C, main, loss, init, feed, mesh, False,
                runs, 0, dev)
            want = gather_persistables(tscope, params)
            rep["twin_losses"] = twin["losses"]
            rep["zero_bytes"] = sum(held.values())
            rep["allreduce_bytes_of_zero_state"] = sum(
                tscope.get(n).numel() * tscope.get(n).element_size()
                for n in held)
            start = {n: init[n].float() for n in params}
            largest = max(float((want[n].float() - start[n].to(
                want[n].device)).abs().max()) for n in params)
            worst, worst_name = -np.inf, None
            for n in params:
                a, b = got[n].float().cpu().numpy(), want[n].float().cpu() \
                    .numpy()
                s = start[n].cpu().numpy()
                mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(s))
                excess = float((np.abs(a - b) - 2 * ulp(mag, 7)).max()
                               / (largest / 128))
                if excess > worst:
                    worst, worst_name = excess, n
            rep["param_excess_over_limit"] = worst
            rep["param_worst"] = worst_name
            rep["largest_update"] = largest
            del tscope, got, want
        else:
            del scope
        del init
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["legs"][name] = rep
    return out


def check_tp_ranks(results, on_card):
    """17b/17c's gates over every rank's results: a list of failures
    (empty: the phase passed). Each leg: the backend the device's; the
    losses finite, falling and every rank's the same; the first loss
    within SPMD_REF_RTOL of Executor.run's on the same init and global
    batch; each replicated parameter bitwise equal on every rank and
    each tp shard equal across its dp replicas; the collectives counted
    (data line's all-reduces, tp line's calls, ZeRO-1's gathers; calls
    and bytes) equal to the plan's prediction times the runs; no seam;
    the fused attention on H/tp heads; on the card K1 by the "tc" route
    once a layer a step each way, no operand copied. The Reduce leg:
    its gathered parameters within the bf16 update limit of its
    AllReduce twin's (2 bf16 ulps plus 1/128 of the largest update, as
    tests/test_torch_data_parallel.py holds the bf16 LM), the ZeRO-1
    state held at half its AllReduce bytes."""
    bad = []
    backend = "nccl" if on_card else "gloo"
    for r in results:
        if r["backend"] != backend:
            bad.append("rank %d: backend %s, not %s" % (
                r["rank"], r["backend"], backend))
    for name in results[0]["legs"]:
        ranks = [r["legs"][name] for r in results]
        if any(x["losses"] != ranks[0]["losses"] for x in ranks[1:]):
            bad.append("%s: the ranks' losses differ" % name)
        dp, tp = ranks[0]["mesh"]
        layout = ranks[0]["layout"]
        for n in ranks[0]["digests"]:
            if n in layout:
                groups = {}
                for x in ranks:
                    groups.setdefault(x["coords"][1], set()).add(
                        x["digests"][n])
                if any(len(v) > 1 for v in groups.values()):
                    bad.append("%s: the tp shards of %r differ across their "
                               "dp replicas" % (name, n))
            elif len({x["digests"][n] for x in ranks}) > 1:
                bad.append("%s: the replicated %r differs across the ranks"
                           % (name, n))
        for x, rank in zip(ranks, (r["rank"] for r in results)):
            tag = "%s rank %d" % (name, rank)
            losses = x["losses"]
            if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
                bad.append("%s: losses not finite and falling: %r"
                           % (tag, losses))
            err = abs(losses[0] - x["ref_loss"]) / abs(x["ref_loss"])
            if not err <= SPMD_REF_RTOL:
                bad.append("%s: the first loss %r is %.3g (rel) off "
                           "Executor.run's %r (limit %g)" % (
                               tag, losses[0], err, x["ref_loss"],
                               SPMD_REF_RTOL))
            runs = x["runs"]
            c = x["counts"]
            want_dp = [runs * v for v in x["expected_dp"]]
            if [c["all_reduce"], c["all_reduce_bytes"]] != want_dp:
                bad.append("%s: data-line all-reduces %r, the plan %r"
                           % (tag, [c["all_reduce"], c["all_reduce_bytes"]],
                              want_dp))
            got = {k: [c[k], c[k + "_bytes"]] for k in TP_KINDS if c[k]}
            want = {k: [runs * v[0], runs * v[1]]
                    for k, v in x["expected_tp"].items()}
            if got != want:
                bad.append("%s: tp collectives %r, the plan %r"
                           % (tag, got, want))
            hot = [sm for sm in x["seams"] if sm[0] in TP_NO_SEAM]
            if hot:
                bad.append("%s: the step gathers %r" % (tag, hot))
            if any(h != x["heads"] // tp for h in x["local_heads"]):
                bad.append("%s: attention ran on %r heads, not H/tp = %d"
                           % (tag, x["local_heads"], x["heads"] // tp))
            if on_card:
                n = x["layers"] * runs
                if (x["k1_fwd"].get("tc", 0), x["k1_bwd"].get("tc", 0),
                        x["k1_copies"]) != (n, n, 0):
                    bad.append("%s: K1 %r / %r, %d copies; expected %d "
                               "\"tc\" each way, no copy" % (
                                   tag, x["k1_fwd"], x["k1_bwd"],
                                   x["k1_copies"], n))
            if x["reduce"]:
                if not x["param_excess_over_limit"] <= 1:
                    bad.append("%s: %r is %.3g of the bf16 limit off the "
                               "AllReduce twin's" % (
                                   tag, x["param_worst"],
                                   x["param_excess_over_limit"]))
                if not x["zero"] or 2 * x["zero_bytes"] \
                        != x["allreduce_bytes_of_zero_state"]:
                    bad.append("%s: the ZeRO-1 state holds %d bytes, not "
                               "half of AllReduce's %d" % (
                                   tag, x["zero_bytes"],
                                   x["allreduce_bytes_of_zero_state"]))
    return bad


def tp_rank_main(args):
    """One rank of 17b/17c (a child of `tp_phase`; `args`
    `tp_rank_legs`'s keywords): one ``phase17_rank`` line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    out = tp_rank_legs(**args)
    from paddle_tpu_torch.parallel.mesh import destroy_data_group

    destroy_data_group()
    print("phase17_rank " + json.dumps(out), flush=True)


def tp_phase(torch, fa, fluid, timeout=900):
    """Phase 17: 17a on cuda:0 (the plan against TP_TABLE, the predicted
    collectives, K1 checked and timed at the tp-local shapes), then 17b
    and 17c over four ranks when four cards are visible (with fewer, one
    ``tp_multi`` line saying they need four). Returns K1's launches on
    the phase's main paths by kernel row name."""
    import torch.nn.functional as F

    t17 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    plans = tp_plan_check(fluid)
    print("tp_plan " + json.dumps(dict(plans, card=card)), flush=True)
    flush = torch.empty(50 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for i, (B, H) in enumerate(TP["k1_shapes"]):
        rows = flash_timed_rows(torch, fa, F, flush, "bfloat16", B, 64,
                                seed=60 + i, H=H)
        print("tp_k1 " + json.dumps({"B": B, "H": H, "card": card,
                                     "rows": list(rows.values())}),
              flush=True)
    del flush
    launches = {"flash_attention_tc_fwd": 0, "flash_attention_tc_bwd": 0}
    cards = torch.cuda.device_count()
    if cards < TP["world"]:
        print("tp_multi " + json.dumps({
            "cards": cards, "ran": False,
            "why": "17b and 17c need four cards (--chips 4): no (dp, tp) "
                   "mesh ran"}), flush=True)
    else:
        gc.collect()
        torch.cuda.empty_cache()
        results = run_ranks(TP_RANK_FLAG, "phase17_rank", TP["world"],
                            timeout)
        for name in results[0]["legs"]:
            print("tp_multi " + json.dumps({
                "leg": name, "world": TP["world"], "card": card,
                "ranks": [dict(r["legs"][name], rank=r["rank"])
                          for r in results]}), flush=True)
        bad = check_tp_ranks(results, on_card=True)
        if bad:
            fail("17: " + "; ".join(bad))
        for r in results:
            for leg in r["legs"].values():
                launches["flash_attention_tc_fwd"] += leg["k1_fwd"]["tc"]
                launches["flash_attention_tc_bwd"] += leg["k1_bwd"]["tc"]
    print("tp_phase " + json.dumps({
        "cards": cards, "seconds": time.perf_counter() - t17,
        "k1_launches": launches}), flush=True)
    return launches


# phase 18: the ZeRO ladder (``parallel/zero.py``'s ShardedAdam) training
# the native flagship at full width (``bench.native_config(192, 512)``)
# from fp32 leaves (``transformer.init_params``, seed 0: with bf16-stored
# leaves stages 1/2 would round each update to bf16 while stage 3 keeps
# fp32 shards) on bench.py's batch, Adam at ZERO["lr"]. 18a on cuda:0
# (world 1), 18b over four cards (``--phase18-rank``, one child a card,
# NCCL; 48 rows a rank, plus an fp32 twin at 2 layers), 18c bench.py's
# bench_zero receipt on cuda:0. A bucket of 25 MiB splits the ~142 MB of
# fp32 leaves into 7 buckets, the 65.5 MB embedding alone in one
ZERO = dict(batch=192, seq=512, warmup=2, steps=4, bucket_mb=25, lr=1e-3,
            world=4, k1_shape=(48, 8),
            twin=dict(n_layers=2, dtype="float32", batch=64, steps=2,
                      bucket_mb=4))
# (name, ShardedAdam keywords; bucket_mb is added to all but per_leaf)
ZERO_LEGS = [("per_leaf", {}),
             ("bucketed", {}),
             ("zero2_overlap", {"zero_stage": 2, "overlap": True}),
             ("zero3_overlap", {"zero_stage": 3, "overlap": True}),
             ("offload", {"offload": True}),
             ("zero2_bf16", {"zero_stage": 2, "overlap": True,
                             "grad_dtype": "bfloat16"})]
# the bucketed rungs with an fp32 wire: bitwise equal on one rank; at
# more ranks bitwise where their bucket plans agree (a ring reduce-scatter
# sums an element in an order set by the rank that owns its shard, which
# another plan moves), and between plans within SPMD_PARAM_RATIO
ZERO_FP32_WIRE = ("bucketed", "zero2_overlap", "zero3_overlap", "offload")
# a bf16 wire against the fp32 one: tests/test_zero.py's limit (:259-270),
# reported with the share of elements beyond it. At full width it does
# not hold everywhere: the bf16 forward turns a last-bit change of a
# weight into a change of its bf16 copy, an element whose grad nearly
# cancels can change sign, and Adam moves it by lr the other way (67 of
# 35,549,184 elements on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 6); so the gate is each leaf within SPMD_PARAM_RATIO of its
# move, the twins' norm limit
ZERO_BF16_ATOL, ZERO_BF16_RTOL = 1e-3, 1e-2
ZERO_RANK_FLAG = "--phase18-rank"
# stage 2's peak against stage 1's: the peak is the activations' (~20.9 GB
# at batch 192), and the two legs' bookkeeping around the backward moves
# it by well under a MiB (+820 KB on an NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 6); 0.1% of it holds that, and a full grad set kept
# past its bucket (142 MB) breaks it
ZERO_PEAK_SLACK = 1e-3


def zero_fault(fault):
    """Plant a known fault in this process's ShardedAdam: 'no_divide' (the
    reduce-scattered grads not divided by the world), 'drop_m' (stage 2
    keeps the old m), 'forward_order' (overlap plans and issues its
    buckets in forward order), 'no_copy_back' (offload never copies m/v
    back to the host) or 'gather_back' (stage 3 gathers each updated
    shard back: a counted extra collective). Returns the undo."""
    from paddle_tpu_torch.async_engine import HostStateStager
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import zero

    if fault == "forward_order":
        saved = zero.amp.plan_buckets

        def forward(leaves, bucket_bytes, **kw):
            return saved(leaves, bucket_bytes, **dict(kw, order="forward"))

        zero.amp.plan_buckets = forward
        return lambda: setattr(zero.amp, "plan_buckets", saved)
    if fault == "no_copy_back":
        saved = HostStateStager.stage_out
        HostStateStager.stage_out = lambda self, tensors, hosts: hosts
        return lambda: setattr(HostStateStager, "stage_out", saved)
    saved = zero.ShardedAdam._local_update

    def planted(self, g, p, m, v, t):
        if fault == "no_divide":
            g = g * self._group.world
        p_new, m_new, v_new = saved(self, g, p, m, v, t)
        if fault == "drop_m" and self._plan["stage"] == 2:
            m_new = m
        if fault == "gather_back" and self._plan["stage"] == 3:
            C.zero_all_gather(p_new, self._group)
        return p_new, m_new, v_new

    zero.ShardedAdam._local_update = planted
    return lambda: setattr(zero.ShardedAdam, "_local_update", saved)


def zero_leg(torch, fa, mesh, name, kw, cfg, init, tokens, labels, warmup,
             steps, bucket_mb):
    """One leg of phase 18: ShardedAdam(`kw`) on the flagship loss from
    `init` (cloned), `warmup` + `steps` steps on the global batch, K1's
    and the collectives' counts zeroed just before the steps and read
    just after, the timed steps by CUDA events on the card. Returns (the
    leg's report, its parameters as host arrays by leaf index)."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import ShardedAdam
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.zero import _flatten

    group = mesh.group
    dev = group.device
    on_card = dev.type == "cuda"
    opt = ShardedAdam(learning_rate=ZERO["lr"],
                      bucket_mb=0 if name == "per_leaf" else bucket_mb, **kw)
    p = T.tree_map(torch.clone, init)
    st = opt.init_state(p, mesh)
    stage3 = opt._plan["stage"] == 3
    if stage3:
        p = opt.shard_params(p, mesh)
    step = opt.make_step(mesh, lambda q, x, y: T.single_chip_loss(q, x, y,
                                                                  cfg))
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_counts()                          # main path starts
    C.reset_counts()
    losses, marks, host_ms, records = [], [], [], []
    runs = warmup + steps
    for i in range(runs):
        if i == warmup:
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host0 = dict(C.host_seconds)
        if on_card and i >= warmup:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        p, st, loss = step(p, st, tokens, labels)
        if i >= warmup:
            host_ms.append((time.perf_counter() - th) * 1e3)
        losses.append(loss)
        records.append(step.issue_record)
    if on_card:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    k1 = flash_counts(fa)                      # main path ends
    counts = {k: C.counts[k] for k in C.ZERO_KINDS}
    host = {k: (C.host_seconds[k] - host0[k]) * 1e3 / steps
            for k in C.ZERO_KINDS}
    ms = (marks[0].elapsed_time(marks[-1]) / steps if on_card
          else wall * 1e3 / steps)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card
            else None)
    if getattr(step, "close", None):
        step.close()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    full = opt.gather_params(p) if stage3 else p
    leaves = T.tree_leaves(full)
    g = opt.gather_state(st)
    ls = opt.leaf_state(g)
    layout = opt._layout
    rep = {"leg": name, "world": group.world, "rank": group.rank,
           "stage": opt._plan["stage"], "overlap": opt._plan["overlap"],
           "offload": opt._plan["offload"],
           "grad_dtype": str(opt.grad_dtype), "runs": runs,
           "steps": steps, "batch": int(tokens.shape[0]),
           "layers": cfg.n_layers, "remat": cfg.remat,
           "losses": [float(x) for x in losses],
           "ms_per_step": ms, "host_ms_per_step": float(np.mean(host_ms)),
           "tokens_per_s": tokens.numel() / ms * 1e3, "peak_gib": peak,
           "k1_fwd": k1[0], "k1_bwd": k1[1], "k1_copies": k1[2],
           "counts": counts, "host_ms_by_kind": host,
           "leaves": len(leaves),
           "plan": None if layout is None else [
               [list(b.indices), b.padded] for b in layout],
           "buckets": None if layout is None else len(layout),
           "pad_elems": (0 if layout is None
                         else sum(b.padded - b.size for b in layout)),
           "state_bytes": nbytes(_flatten(st["m"])[0]
                                 + _flatten(st["v"])[0]),
           "plan_state_bytes": nbytes(g["m"] + g["v"]),
           "world1_state_bytes": 2 * 4 * sum(x.numel() for x in leaves),
           "param_bytes": nbytes(p if stage3 else leaves),
           "world1_param_bytes": 4 * sum(x.numel() for x in leaves),
           "record": records[-1],
           "records_equal": all(r == records[-1] for r in records),
           "digests": {"params": [_digest(torch, x) for x in leaves],
                       "m": [_digest(torch, x) for x in ls["m"]],
                       "v": [_digest(torch, x) for x in ls["v"]]}}
    host_params = {str(i): x.detach().float().cpu().numpy()
                   for i, x in enumerate(leaves)}
    del p, st, full, leaves, g, ls
    return rep, host_params


def param_excess(got, ref, start):
    """Phase 17's bf16 update limit between two runs (flat dicts of host
    arrays): the worst element's |got - ref| less 2 bf16 ulps of the
    largest magnitude it takes, over 1/128 of the largest update of
    `ref` from `start`. Returns (excess, leaf)."""
    largest = max(float(np.abs(ref[k] - start[k]).max()) for k in ref)
    worst = (-np.inf, "")
    for k in ref:
        mag = np.maximum(np.maximum(np.abs(got[k]), np.abs(ref[k])),
                         np.abs(start[k]))
        excess = float((np.abs(got[k] - ref[k]) - 2 * ulp(mag, 7)).max()
                       / (largest / 128))
        worst = max(worst, (excess, k))
    return worst


def zero_twin(torch, mesh, width=None, seq=None):
    """18b's fp32 twin: the flagship in fp32 at ZERO["twin"]'s depth
    (`width` replaces config fields), ShardedAdam stage 2 over `mesh`
    against one rank's per-leaf run on a line of one (this rank's
    device) on the global batch, from one seed-1 tree: both runs'
    losses, the worst leaf's ratio (``leaf_ratios``) of the params, and
    of m and v (``leaf_ratios`` from zero: the difference over the
    reference's norm)."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import ShardedAdam
    from paddle_tpu_torch.parallel.mesh import DataGroup, Mesh

    o = ZERO["twin"]
    seq = seq or ZERO["seq"]
    group = mesh.group
    over = dict(width or {}, n_layers=o["n_layers"], dtype=o["dtype"])
    cfg = bench.native_config(o["batch"], seq, remat=True, **over)
    init = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                         device=group.device)
    start = {str(i): x.cpu().numpy() for i, x in
             enumerate(T.tree_leaves(init))}
    tokens, labels = spmd_batch(torch, cfg, o["batch"], seq, group.device,
                                seed=1)
    solo = Mesh(DataGroup(None, 0, 1, group.device, group.backend))
    out = {}
    for key, m_, kw in (("mesh", mesh, {"zero_stage": 2,
                                        "bucket_mb": o["bucket_mb"]}),
                        ("ref", solo, {"bucket_mb": 0})):
        opt = ShardedAdam(learning_rate=ZERO["lr"], **kw)
        p = T.tree_map(torch.clone, init)
        st = opt.init_state(p, m_)
        step = opt.make_step(m_, lambda q, x, y: T.single_chip_loss(
            q, x, y, cfg))
        losses = []
        for _ in range(o["steps"]):
            p, st, loss = step(p, st, tokens, labels)
            losses.append(float(loss))
        ls = opt.leaf_state(opt.gather_state(st))
        out[key] = (losses,
                    {str(i): x.cpu().numpy()
                     for i, x in enumerate(T.tree_leaves(p))},
                    {k: {str(i): x.cpu().numpy() for i, x in
                         enumerate(ls[k])} for k in ("m", "v")})
    (l_m, p_m, s_m), (l_r, p_r, s_r) = out["mesh"], out["ref"]
    ratio, leaf = leaf_ratios(p_m, p_r, start)
    state = max(leaf_ratios(s_m[k], s_r[k], {i: 0 * x for i, x in
                                             s_r[k].items()}) + (k,)
                for k in ("m", "v"))
    return {"losses": l_m, "losses_ref": l_r,
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(l_m, l_r)),
            "worst_leaf_ratio": ratio, "worst_leaf": leaf,
            "worst_state_ratio": state[0],
            "worst_state_leaf": "%s %s" % (state[2], state[1]),
            "layers": cfg.n_layers, "dtype": o["dtype"],
            "batch": o["batch"]}


def zero_rank_legs(device=None, legs=None, width=None, batch=None,
                   seq=None, warmup=None, steps=None, bucket_mb=None,
                   twin=None):
    """18a (world 1) or 18b (this rank of world > 1): each leg of
    ZERO_LEGS (or those named in `legs`) on bench.py's native
    configuration (`width` replaces config fields) from one fp32 tree,
    on the global batch; single_chip_loss on the same tree and batch
    first (the plain reference); then the comparisons between the legs
    on this rank and, at world > 1 (or with `twin`), the fp32 twin.
    Returns this rank's results."""
    import torch

    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.mesh import Mesh, init_data_group

    group = init_data_group(device)
    mesh = Mesh(group)
    dev = group.device
    batch = batch or ZERO["batch"]
    seq = seq or ZERO["seq"]
    warmup = ZERO["warmup"] if warmup is None else warmup
    steps = steps or ZERO["steps"]
    cfg = bench.native_config(batch, seq, remat=True, **(width or {}))
    init = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=dev)
    start = {str(i): x.cpu().numpy() for i, x in
             enumerate(T.tree_leaves(init))}
    tokens, labels = spmd_batch(torch, cfg, batch, seq, dev)
    with torch.no_grad():
        ref_loss = float(T.single_chip_loss(init, tokens, labels, cfg))
    out = {"rank": group.rank, "world": group.world,
           "backend": group.backend, "device": str(dev),
           "ref_loss": ref_loss, "legs": {}, "compare": {}}
    held = {}
    for name, kw in ZERO_LEGS:
        if legs is not None and name not in legs:
            continue
        rep, params = zero_leg(
            torch, fa, mesh, name, kw, cfg, init, tokens, labels, warmup,
            steps, bucket_mb or ZERO["bucket_mb"])
        out["legs"][name] = rep
        held[name] = params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    cmp_ = out["compare"]
    if "per_leaf" in held and "bucketed" in held:
        cmp_["per_leaf_excess"] = param_excess(held["per_leaf"],
                                               held["bucketed"], start)
        cmp_["per_leaf_ratio"] = leaf_ratios(held["per_leaf"],
                                             held["bucketed"], start)
    if "zero2_bf16" in held and "zero2_overlap" in held:
        a, b = held["zero2_bf16"], held["zero2_overlap"]
        over = {k: np.abs(a[k] - b[k]) / (ZERO_BF16_ATOL
                                          + ZERO_BF16_RTOL * np.abs(b[k]))
                for k in b}
        cmp_["bf16_excess"] = max((float(x.max()), k)
                                  for k, x in over.items())
        cmp_["bf16_outside"] = [int(sum((x > 1).sum() for x in
                                        over.values())),
                                int(sum(x.size for x in over.values()))]
        cmp_["bf16_ratio"] = leaf_ratios(a, b, start)
    wire = [n for n in ZERO_FP32_WIRE if n in held]
    cmp_["cross_plan_ratio"] = max(
        [leaf_ratios(held[a], held[b], start) for a in wire for b in wire
         if a < b] or [(0.0, "")])
    del held
    if twin if twin is not None else group.world > 1:
        out["twin"] = zero_twin(torch, mesh, width, seq)
    return out


def check_zero_ranks(results, on_card):
    """18a's and 18b's gates over every rank's results: a list of
    failures (empty: the phase passed). Each leg: the backend the
    device's; the losses finite and falling, every rank's the same, the
    first within SPMD_REF_RTOL of single_chip_loss on the same tree and
    global batch; the counted ZeRO collectives a step the plan's (per
    leaf L reduce-scatters and L gathers, bucketed B and B, stage 3 B
    parameter gathers and B reduce-scatters with no gather-back, one loss
    all-reduce); m and v 1/world of the plan's padded state (a quarter
    of world 1's bytes but the pad), stage 3's parameters too; under
    overlap every bucket issued in segment order and all but the last
    with backward work still to come; replicated parameters bitwise
    equal on every rank; on the card K1 12 + 6 "tc" a step, no copy.
    Across the legs: the fp32-wire bucketed rungs' parameters, m and v
    bitwise equal where their plans agree (every plan at world 1), and
    between plans within SPMD_PARAM_RATIO; per-leaf within the bf16
    update limit of bucketed (phase 17's) at world 1, within
    SPMD_PARAM_RATIO beyond; at world 1 each leaf of the bf16 wire within
    SPMD_PARAM_RATIO of its move off the fp32 wire's (ZERO_BF16_ATOL/RTOL
    elementwise reported; beyond world 1 the ratio is reported only: an
    element whose ranks' grads nearly cancel changes sign with the
    wire's rounding); on the card stage 2's peak at most stage 1's (with
    ZERO_PEAK_SLACK). The
    twin: losses within SPMD_LOSS_RTOL, params and the twin's m/v within
    SPMD_PARAM_RATIO of the one-rank per-leaf run's."""
    bad = []
    backend = "nccl" if on_card else "gloo"
    world = results[0]["world"]
    for r in results:
        if r["backend"] != backend:
            bad.append("rank %d: backend %s, not %s" % (r["rank"],
                                                        r["backend"],
                                                        backend))
    for name in results[0]["legs"]:
        ranks = [r["legs"][name] for r in results]
        if any(x["losses"] != ranks[0]["losses"] for x in ranks[1:]):
            bad.append("%s: the ranks' losses differ" % name)
        if ranks[0]["stage"] < 3 and any(
                x["digests"]["params"] != ranks[0]["digests"]["params"]
                for x in ranks[1:]):
            bad.append("%s: the replicated params differ across the ranks"
                       % name)
        for x, r in zip(ranks, results):
            tag = "%s rank %d" % (name, r["rank"])
            losses = x["losses"]
            if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
                bad.append("%s: losses not finite and falling: %r"
                           % (tag, losses))
            err = abs(losses[0] - r["ref_loss"]) / abs(r["ref_loss"])
            if not err <= SPMD_REF_RTOL:
                bad.append("%s: the first loss %r is %.3g (rel) off "
                           "single_chip_loss's %r (limit %g)" % (
                               tag, losses[0], err, r["ref_loss"],
                               SPMD_REF_RTOL))
            runs, L, B = x["runs"], x["leaves"], x["buckets"]
            n = L if B is None else B
            want = {"zero_reduce_scatter": runs * n,
                    "zero_gather": 0 if x["stage"] == 3 else runs * n,
                    "zero_param_gather": runs * n if x["stage"] == 3 else 0,
                    "zero_loss": runs}
            if x["counts"] != want:
                bad.append("%s: ZeRO collectives %r, the plan %r"
                           % (tag, x["counts"], want))
            if world * x["state_bytes"] != x["plan_state_bytes"] or (
                    B is not None and x["plan_state_bytes"]
                    != x["world1_state_bytes"] + 8 * x["pad_elems"]):
                bad.append("%s: m and v hold %d bytes a rank, not 1/%d of "
                           "the plan's %d (world 1: %d)" % (
                               tag, x["state_bytes"], world,
                               x["plan_state_bytes"],
                               x["world1_state_bytes"]))
            if x["stage"] == 3 and world * x["param_bytes"] != \
                    x["world1_param_bytes"] + 4 * x["pad_elems"]:
                bad.append("%s: stage 3 holds %d parameter bytes a rank, "
                           "not 1/%d of %d" % (tag, x["param_bytes"], world,
                                               x["world1_param_bytes"]))
            if x["overlap"]:
                rec = x["record"]
                overlapped = sum(h > 0 for h in rec["hooks_after"])
                if rec["segments"] != list(range(B)) \
                        or overlapped < B - 1 or not x["records_equal"]:
                    bad.append("%s: overlap issued %r with %r leaf grads "
                               "still to come (%d of %d buckets overlapped)"
                               % (tag, rec["segments"], rec["hooks_after"],
                                  overlapped, B))
            if on_card:
                msg = k1_gate((x["k1_fwd"], x["k1_bwd"], x["k1_copies"]),
                              x["layers"], 1, 1, x["remat"], "tc", runs)
                if msg:
                    bad.append("%s: %s" % (tag, msg))
    legs = results[0]["legs"]
    for r in results:
        wire = [n for n in ZERO_FP32_WIRE if n in r["legs"]]
        for a in wire:
            for b in wire:
                la, lb = r["legs"][a], r["legs"][b]
                if a < b and (world == 1 or la["plan"] == lb["plan"]) \
                        and la["digests"] != lb["digests"]:
                    bad.append("rank %d: the bucketed rungs %s and %s are "
                               "not bitwise equal" % (r["rank"], a, b))
        c = r["compare"]
        if c["cross_plan_ratio"][0] > SPMD_PARAM_RATIO:
            bad.append("rank %d: leaf %s of two bucket plans is %.3g of its "
                       "move apart (limit %g)" % (
                           r["rank"], c["cross_plan_ratio"][1],
                           c["cross_plan_ratio"][0], SPMD_PARAM_RATIO))
        if "per_leaf_excess" in c:
            if world == 1 and not c["per_leaf_excess"][0] <= 1:
                bad.append("rank %d: per-leaf's leaf %s is %.3g of the bf16 "
                           "limit off bucketed's" % (
                               r["rank"], c["per_leaf_excess"][1],
                               c["per_leaf_excess"][0]))
            if world > 1 and not c["per_leaf_ratio"][0] <= SPMD_PARAM_RATIO:
                bad.append("rank %d: per-leaf's leaf %s is %.3g of its move "
                           "off bucketed's" % (r["rank"],
                                               c["per_leaf_ratio"][1],
                                               c["per_leaf_ratio"][0]))
        if world == 1 and "bf16_ratio" in c \
                and not c["bf16_ratio"][0] <= SPMD_PARAM_RATIO:
            bad.append("rank %d: the bf16 wire's leaf %s is %.3g of its "
                       "move off the fp32 wire's (limit %g)" % (
                           r["rank"], c["bf16_ratio"][1],
                           c["bf16_ratio"][0], SPMD_PARAM_RATIO))
        t = r.get("twin")
        if t is not None:
            if not t["loss_rel_err"] <= SPMD_LOSS_RTOL:
                bad.append("rank %d: the twin's losses %r are %.3g off the "
                           "one-rank run's %r" % (r["rank"], t["losses"],
                                                  t["loss_rel_err"],
                                                  t["losses_ref"]))
            if not t["worst_leaf_ratio"] <= SPMD_PARAM_RATIO:
                bad.append("rank %d: the twin's leaf %s is %.3g of its move "
                           "off the one-rank run's" % (
                               r["rank"], t["worst_leaf"],
                               t["worst_leaf_ratio"]))
            if not t["worst_state_ratio"] <= SPMD_PARAM_RATIO:
                bad.append("rank %d: the twin's m/v %s is %.3g of its norm "
                           "off the one-rank run's" % (
                               r["rank"], t["worst_state_leaf"],
                               t["worst_state_ratio"]))
    if on_card and "zero2_overlap" in legs and "bucketed" in legs:
        for r in results:
            a = r["legs"]["zero2_overlap"]["peak_gib"]
            b = r["legs"]["bucketed"]["peak_gib"]
            if a > b * (1 + ZERO_PEAK_SLACK):
                bad.append("rank %d: stage 2's peak %.4f GiB is above stage "
                           "1's %.4f GiB (slack %g)" % (r["rank"], a, b,
                                                        ZERO_PEAK_SLACK))
    return bad


def zero_rank_main(args):
    """One rank of 18b (a child of `zero_phase`): one ``phase18_rank``
    line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    out = zero_rank_legs(**args)
    from paddle_tpu_torch.parallel.mesh import destroy_data_group

    destroy_data_group()
    print("phase18_rank " + json.dumps(out), flush=True)


def zero_lines(tag, results, card):
    """One `tag` line a leg (every rank's numbers, no digests)."""
    for name in results[0]["legs"]:
        ranks = []
        for r in results:
            leg = dict(r["legs"][name])
            leg.pop("digests")
            ranks.append(leg)
        print(tag + " " + json.dumps({"leg": name, "world": len(results),
                                      "card": card, "ranks": ranks}),
              flush=True)


def zero_phase(torch, fa, timeout=900):
    """Phase 18: K1 checked and timed at 18b's rank shape, 18a (every leg
    on cuda:0, world 1), 18c (bench.py's bench_zero receipt on cuda:0),
    then 18b over four ranks when four cards are visible (with fewer,
    one ``zero_multi`` line saying it needs four). Returns K1's launches
    on the phase's main paths by kernel row name."""
    import torch.nn.functional as F

    from paddle_tpu_torch import bench
    from paddle_tpu_torch.parallel.mesh import destroy_data_group

    t18 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    B, H = ZERO["k1_shape"]
    flash_check(torch, fa, B, H, ZERO["seq"], ZERO["seq"], True,
                "bfloat16", seed=70, packed=True)
    flush = torch.empty(50 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = flash_timed_rows(torch, fa, F, flush, "bfloat16", B, 64,
                            seed=71, H=H, packed=True)
    del flush
    print("zero_k1 " + json.dumps({"B": B, "H": H, "card": card,
                                   "rows": list(rows.values())}), flush=True)
    launches = {"flash_attention_tc_fwd": 0, "flash_attention_tc_bwd": 0}
    try:
        res = zero_rank_legs(device="cuda:0")
        zero_lines("zero_train", [res], card)
        print("zero_compare " + json.dumps(dict(
            res["compare"], ref_loss=res["ref_loss"])), flush=True)
        bad = check_zero_ranks([res], on_card=True)
        if bad:
            fail("18a: " + "; ".join(bad))
        for leg in res["legs"].values():
            launches["flash_attention_tc_fwd"] += leg["k1_fwd"]["tc"]
            launches["flash_attention_tc_bwd"] += leg["k1_bwd"]["tc"]
        del res
        gc.collect()
        torch.cuda.empty_cache()
        receipt = bench.bench_zero(place="cuda:0")
        line = bench.zero_line(receipt)
        print("bench_zero " + json.dumps(line), flush=True)
        if not (line["zero2_close"] and line["zero3_close"]
                and line["offload_close"] and line["loss_decreasing"]):
            fail("18c: bench_zero's rungs are not close to bucketed ZeRO-1 "
                 "or a loss did not fall: %r" % line)
    finally:
        destroy_data_group()
    cards = torch.cuda.device_count()
    if cards < ZERO["world"]:
        print("zero_multi " + json.dumps({
            "cards": cards, "ran": False,
            "why": "18b needs four cards (--chips 4): no dp = 4 ZeRO "
                   "ladder ran"}), flush=True)
    else:
        gc.collect()
        torch.cuda.empty_cache()
        results = run_ranks(ZERO_RANK_FLAG, "phase18_rank", ZERO["world"],
                            timeout)
        zero_lines("zero_multi", results, card)
        for r in results:
            print("zero_multi_compare " + json.dumps(dict(
                r["compare"], rank=r["rank"], ref_loss=r["ref_loss"],
                twin=r.get("twin"))), flush=True)
        bad = check_zero_ranks(results, on_card=True)
        if bad:
            fail("18b: " + "; ".join(bad))
        for r in results:
            for leg in r["legs"].values():
                launches["flash_attention_tc_fwd"] += leg["k1_fwd"]["tc"]
                launches["flash_attention_tc_bwd"] += leg["k1_bwd"]["tc"]
    print("zero_phase " + json.dumps({
        "cards": cards, "seconds": time.perf_counter() - t18,
        "k1_launches": launches}), flush=True)
    return launches


# phase 19: the Fluid pipeline (``parallel/pipeline_program.py``'s 1F1B
# over the program, ``pipeline_schedule.py``'s tables, P2P on the pp line)
# through CompiledProgram.with_data_parallel on the (dp, pp, tp) mesh,
# training bench.py's headline program at full width. 19a (one card): the
# split, crossings and schedules against PP_TABLE (the JAX package's,
# pinned by tests/test_torch_pipeline_program.py) and K1 at each leg's
# microbatch shape; 19b and 19c (four cards, one child a card,
# ``--phase19-rank``): the legs of PP_LEGS
PP = dict(batch=160, warmup=3, steps=8, adam_steps=2, tokens=4, world=4)
# (name, (dp, pp, tp), microbatches, virtual stages, stash, optimizer)
PP_LEGS = [("pp4", (1, 4, 1), 8, 1, False, "sgd"),
           ("dp2_pp2", (2, 2, 1), 4, 1, False, "sgd"),
           ("dp2_pp2_v2_stash", (2, 2, 1), 4, 2, True, "sgd"),
           ("pp2_tp2_adam", (1, 2, 2), 4, 1, False, "adam")]
PP_TABLE = os.path.join("tests", "data", "pp_plan_headline.json")
PP_RANK_FLAG = "--phase19-rank"
PP_SPLITS = ((4, 1, 20), (2, 1, 20), (2, 2, 20), (2, 1, 40))
PP_SCHEDULES = ((4, 8, 1), (2, 4, 1), (2, 4, 2))
PP_COLS = ("fwd_mb", "fwd_chunk", "fwd_read", "fwd_save", "fwd_recv",
           "bwd_mb", "bwd_chunk", "bwd_read", "cot_read", "cot_recv")
# limits against Executor.run's step from the same init on the global
# batch (bf16 ulps at the value): the first loss within 1 ulp of the JAX
# fetch rule over Executor.run's microbatch losses (the pipelined fetch is
# the fp32 mean of the M·dp microbatch losses, each as its stage computed
# it in bf16, cast to bf16), and within 2 ulps of the whole batch's loss
# (the rule's two roundings); after step 1 each parameter within 2 ulps
# plus 1/128 of the largest update (phase 17c's limit: SGD's update is
# under an ulp of most weights, so a grad summed over microbatches in
# another order may round the other way); under Adam its step-1 update is
# lr·sign(grad) whatever the grad's size, so a near-zero grad whose sign
# differs moves the weight 2·lr the other way: 2 ulps plus 2·lr
PP_LOSS_ULPS, PP_WHOLE_ULPS, PP_PARAM_ULPS = 1, 2, 2
# the spans of a pipelined step (``pipeline_program.py``)
PP_SPANS = ("fwd", "bwd", "p2p", "update")


def pp_k1_shapes(legs, batch):
    """K1's [B, H] on each leg of `legs` at full width: a microbatch's
    rows of a dp line (batch / (dp·M)) and the H/tp heads of a rank."""
    out = []
    for _, (dp, _, tp), M, *_ in legs:
        shape = (batch // (dp * M), 8 // tp)
        if shape not in out:
            out.append(shape)
    return out


def pp_strategy(fluid, pp, M, v, stash, tp=1):
    bs = fluid.BuildStrategy()
    bs.pipeline_stages = pp
    bs.pipeline_microbatches = M
    bs.pipeline_virtual_stages = v
    bs.pipeline_activation_stash = stash
    bs.tensor_parallel_degree = tp
    return bs


def pp_table(table=None):
    """PP_TABLE (the JAX package's split of the headline program at full
    width at each of PP_SPLITS, its wires probed at a microbatch of that
    split's rows, and the schedules), or `table` as given."""
    if table is not None:
        return table
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, PP_TABLE)) as f:
        return json.load(f)


def pp_wires(step):
    """{cut: [[name, shape, dtype]]} of the wires the step's run learnt
    (the cuts this rank sent or received)."""
    return {str(c): [[n, list(e[0]), str(e[1]).replace("torch.", "")]
                     for n, e in zip(step.crossing[c], lay) if e is not None]
            for c, lay in sorted(step._layouts.items())}


def pp_layers(step, p):
    """The layers resident on pp rank p (its stages' attention ops)."""
    return sum(1 for op, s in zip(step.fwd_ops, step.stage_of)
               if s % step.pp == p and op.type == "fused_multihead_attention")


def pp_plan_check(fluid):
    """19a's plan: the headline program's stage split, crossing vars and
    their bytes a microbatch at PP_SPLITS, and the schedules at
    PP_SCHEDULES, against PP_TABLE. Returns one report a split; fails on
    a difference."""
    from paddle_tpu_torch.parallel.pipeline_program import \
        PipelineProgramStep
    from paddle_tpu_torch.parallel.pipeline_schedule import build_schedule

    table = pp_table()
    main, _, loss = build_tp_lm(fluid, TRAIN, "sgd")
    out = {}
    feeds = {"labels": (PP["batch"], TRAIN["seq_len"]),
             "tokens": (PP["batch"], TRAIN["seq_len"])}
    for pp, v, rows in PP_SPLITS:
        key = "pp%d_v%d_r%d" % (pp, v, rows)
        step = PipelineProgramStep(main, feeds, [loss.name],
                                   {"dp": 1, "pp": pp, "tp": 1},
                                   pp_strategy(fluid, pp, 4, v, False),
                                   loss.name)
        want = table["splits"][key]
        got = {"stage_of": list(step.stage_of), "crossing": step.crossing}
        for k in ("stage_of", "crossing"):
            if got[k] != want[k]:
                fail("19a: the %s split's %s differs from the JAX "
                     "package's table" % (key, k))
        out[key] = {"ops_per_stage": [step.stage_of.count(s)
                                      for s in range(step.S)],
                    "layers_per_rank": [pp_layers(step, p)
                                        for p in range(pp)],
                    "crossing": step.crossing,
                    "cut_bytes": want["cut_bytes"]}
    for pp, M, v in PP_SCHEDULES:
        key = "%d_%d_%d" % (pp, M, v)
        s = build_schedule(pp, M, v)
        got = {"tables": {k: getattr(s, k).tolist() for k in PP_COLS},
               "stats": s.stats(),
               "slots": [s.arrive_slots, s.input_slots, s.cot_slots]}
        if got != table["schedules"][key]:
            fail("19a: the schedule %s differs from the JAX package's" % key)
        out["schedule_" + key] = got["stats"]
    return out


def pp_fault(fault):
    """Plant a known fault in the pipelined step, for the CPU test of
    the gates: 'seed_once' (each microbatch's backward seeded as if it
    were the whole batch), 'no_cotangent' (the arrived cotangent
    dropped) or 'fp32_fetch' (a bf16 scalar fetched as the fp32 mean).
    Returns the undo."""
    from paddle_tpu_torch.parallel import pipeline_program as ppm

    cls = ppm.PipelineProgramStep
    if fault == "seed_once":
        saved = cls._ctx

        def ctx(self, *a):
            c = saved(self, *a)
            c.grad_seed_scale = self._grad_seed_scale
            return c
        cls._ctx = ctx
        return lambda: setattr(cls, "_ctx", saved)
    if fault == "no_cotangent":
        saved = cls._backward_unit

        def bwd(self, s, i, keep, cot, *a):
            if cot is not None:
                cot = [c.zero_() for c in cot]
            return saved(self, s, i, keep, cot, *a)
        cls._backward_unit = bwd
        return lambda: setattr(cls, "_backward_unit", saved)
    if fault == "fp32_fetch":
        import torch

        saved = ppm.torch_dtype

        def keep_fp32(dtype):
            return torch.float32 if dtype == "bfloat16" else saved(dtype)
        ppm.torch_dtype = keep_fp32
        return lambda: setattr(ppm, "torch_dtype", saved)
    raise ValueError(fault)


def pp_param_excess(got, ref, start, params, adam_lr=None):
    """The worst parameter's difference from the reference step's, over
    its limit (<= 1 passes): 2 bf16 ulps plus 1/128 of the largest
    update (SGD) or plus 2·lr (Adam)."""
    largest = max(float((ref[n].float() - start[n].float()).abs().max())
                  for n in params)
    worst, worst_name = -np.inf, None
    for n in params:
        a, b = got[n].float().cpu().numpy(), ref[n].float().cpu().numpy()
        s = start[n].float().cpu().numpy()
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(s))
        slack = 2 * adam_lr if adam_lr else largest / 128
        excess = float((np.abs(a - b) / (PP_PARAM_ULPS * ulp(mag, 7)
                                         + slack)).max())
        if excess > worst:
            worst, worst_name = excess, n
    return worst, worst_name, largest


def pp_reference(torch, fluid, main, loss, init, feed, dp, M, rows):
    """Executor.run on this rank's device from `init`: the whole global
    batch's first loss and its step-1 parameters, and the loss of each
    of the M·dp microbatches (rows of `rows`, in the pipeline's order)
    from `init` (the bf16 fetch rule's inputs)."""
    exe = fluid.Executor(feed["tokens"].device)
    scope = _restore(fluid, init)
    whole, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    params = {n: scope.get(n).clone() for n in main.param_grad_map}
    del scope
    mbs = []
    for j in range(dp * M):
        part = {k: t[j * rows:(j + 1) * rows] for k, t in feed.items()}
        out, = exe.run(main, feed=part, fetch_list=[loss],
                       scope=_restore(fluid, init))
        mbs.append(float(np.asarray(out).ravel()[0]))
    return float(np.asarray(whole).ravel()[0]), params, mbs


def bf16_rule(values):
    """The pipelined fetch of a bf16 scalar: the fp32 mean of the
    microbatch values cast to bf16."""
    import torch

    return float(torch.tensor(float(np.float32(sum(values))
                                    / np.float32(len(values))),
                              dtype=torch.float32).to(torch.bfloat16))


def pp_rank_legs(device=None, legs=None, cfg=None, batch=None, warmup=None,
                 steps=None, adam_steps=None, tokens=None, table=None):
    """19b/19c on this rank: each leg of PP_LEGS (or `legs`) at `cfg`
    (default TRAIN) on the global batch `batch`: the init drawn by the
    startup program (the same on every rank), Executor.run's reference
    step on this rank's device, then the pipelined steps (warm-up, timed
    with the last one's spans traced for the host's time a unit, then one
    more under the profiler, whose kernels by span give the card's time
    in the units, the exchanges and the update) through CompiledProgram, K1's and the collectives' counts zeroed just
    before them and read just after; the P2P prediction from `table`
    (default PP_TABLE: the JAX package's wires of the headline program at
    full width). Returns this rank's results."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.compiler import gather_persistables
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.mesh import init_data_group

    g = init_data_group(device)
    cfg = TRAIN if cfg is None else cfg
    legs = legs or PP_LEGS
    batch = batch or PP["batch"]
    warmup = PP["warmup"] if warmup is None else warmup
    steps = steps or PP["steps"]
    adam_steps = adam_steps or PP["adam_steps"]
    dev = g.device
    on_card = dev.type == "cuda"
    out = {"rank": g.rank, "world": g.world, "backend": g.backend,
           "device": str(dev), "legs": {}}
    feed = tp_feed(torch, cfg, batch, dev, tokens or PP["tokens"])
    table = pp_table(table)
    for name, mesh, M, v, stash, opt in legs:
        dp, pp, tp = mesh
        main, startup, loss = build_tp_lm(fluid, cfg, opt)
        exe = fluid.Executor(dev)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        init = _snapshot(scope)
        del scope
        rows = batch // (dp * M)
        whole, ref_params, mbs = pp_reference(torch, fluid, main, loss,
                                              init, feed, dp, M, rows)
        scope = _restore(fluid, init)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name,
            build_strategy=pp_strategy(fluid, pp, M, v, stash, tp))
        timed = adam_steps if opt == "adam" else steps
        first = 0 if opt == "adam" else warmup
        runs = first + timed + 1
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        fa.reset_counts()                      # main path starts
        C.reset_counts()
        losses, t0, wall, host_units = [], None, None, None
        step1 = None
        traced = tracing.enabled()
        for i in range(runs):
            if i == first:
                if on_card:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
            if i == runs - 2:
                tracing.enable()
                n0 = len(tracing.events())
            if i == runs - 1:
                if on_card:
                    torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                host_units = pp_span_ms(tracing.events()[n0:])
                profiler.start_profiler("All")
            o, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(o).ravel()[0]))
            if i == 0:
                step1 = {n: t.clone() for n, t in gather_persistables(
                    scope, sorted(ref_params)).items()}
        if on_card:
            torch.cuda.synchronize(dev)
        profiler.stop_profiler()
        if not traced:
            tracing.disable()
        k1 = flash_counts(fa)                  # main path ends
        counts = dict(C.counts)
        device_units = pp_device_ms(profiler.kernel_attribution(
            prefix="pp/"))
        step = next(iter(prog._compiled_steps.values()))
        p = step.mesh.axis_index("pp")
        split = table["splits"]["pp%d_v%d_r%d" % (pp, v, rows)]
        cuts = {c: tuple(b) for c, b in enumerate(split["cut_bytes"])}
        excess, worst, largest = pp_param_excess(
            step1, ref_params, init, sorted(ref_params),
            TP_ADAM_LR if opt == "adam" else None)
        sched = step.schedule.stats()
        rep = {"name": name, "mesh": list(mesh), "M": M, "v": v,
               "stash": stash, "optimizer": opt, "runs": runs,
               "losses": losses, "ref_loss": whole, "mb_losses": mbs,
               "rule_loss": bf16_rule(mbs),
               "ms_per_step": wall * 1e3 / timed,
               "tokens_per_s": feed["tokens"].numel() * timed / wall,
               "bubble_fraction": sched["bubble_fraction"],
               "ticks": sched["ticks"],
               "units": dict(step.units),
               "host_ms_last_timed": host_units,
               "host_ms_per_unit": {k: host_units[k] / n for k, n in
                                    step.units.items() if n},
               "device_ms": device_units,
               "k1_fwd": k1[0], "k1_bwd": k1[1], "k1_copies": k1[2],
               "layers": pp_layers(step, p),
               # a forward op runs twice a microbatch without the stash
               "k1_units": [1 if stash else 2, 1],
               "coords": [step.mesh.axis_index("dp"), p,
                          step.mesh.axis_index("tp")],
               "pp_fwd_bytes": counts["pp_fwd_bytes"],
               "pp_bwd_bytes": counts["pp_bwd_bytes"],
               "expected_p2p": list(step.expected_p2p(cuts)),
               "table_wires": {str(c): w for c, w in
                               enumerate(split["wire"])},
               "wires": pp_wires(step),
               "param_excess_over_limit": excess, "param_worst": worst,
               "largest_update": largest,
               "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if on_card else None)}
        rep["digests"] = {n: _digest(torch, scope.get(n))
                          for n in sorted(ref_params)}
        out["legs"][name] = rep
        del scope, prog, step, init, ref_params, step1
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def pp_span_ms(events):
    """{span: host ms} of a pipelined step's "pp/" spans in `events`
    (``observability.tracing``'s), each of PP_SPANS."""
    out = dict.fromkeys(PP_SPANS, 0.0)
    for e in events:
        name = e["name"]
        if name.startswith("pp/") and name[3:] in out:
            out[name[3:]] += e["dur"] / 1e3
    return out


def pp_device_ms(records):
    """{span: the card's kernel ms} of a profiled pipelined step: its
    kernels (``profiler.kernel_attribution(prefix="pp/")``'s records) by
    the span around their launch, "outside" those outside every span
    (empty: no kernel was traced, as on the CPU)."""
    if not records:
        return {}
    out = dict.fromkeys(PP_SPANS + ("outside",), 0.0)
    for r in records:
        out[r["op"] if r["op"] in out else "outside"] += r["us"] / 1e3
    return out


def _ulps_apart(a, b):
    return abs(a - b) / float(ulp(np.float32(max(abs(a), abs(b))), 7))


def check_pp_ranks(results, on_card):
    """19b/19c's gates over every rank's results: a list of failures
    (empty: the phase passed). Each leg: the backend the device's; the
    losses finite and every rank's the same; the first loss a bf16 value
    (the loss var's declared dtype), within PP_LOSS_ULPS bf16 ulps of the
    JAX fetch rule over Executor.run's microbatch losses and within
    PP_WHOLE_ULPS of the whole batch's; the
    parameters after step 1 within the limit of Executor.run's step;
    each parameter bitwise equal on every rank holding the same tp
    block; each rank's counted pp_fwd / pp_bwd bytes its stages' cuts ×
    M × the runs, the cuts' bytes the JAX step's wires' (each var's shape
    and dtype as the JAX step probes it: the table), the wires the run
    learnt equal to them; on the card K1 by the "tc" route, layers resident × M × 2 (1
    with the stash) forward and × M backward a run, no operand
    copied."""
    bad = []
    backend = "nccl" if on_card else "gloo"
    for r in results:
        if r["backend"] != backend:
            bad.append("rank %d: backend %s, not %s" % (
                r["rank"], r["backend"], backend))
    for name in results[0]["legs"]:
        ranks = [r["legs"][name] for r in results]
        if any(x["losses"] != ranks[0]["losses"] for x in ranks[1:]):
            bad.append("%s: the ranks' losses differ" % name)
        for n in ranks[0]["digests"]:
            groups = {}
            for x in ranks:
                groups.setdefault(x["coords"][2], set()).add(x["digests"][n])
            if any(len(d) > 1 for d in groups.values()):
                bad.append("%s: %r differs across the ranks holding its "
                           "block" % (name, n))
        for x, rank in zip(ranks, (r["rank"] for r in results)):
            tag = "%s rank %d" % (name, rank)
            losses = x["losses"]
            if not np.isfinite(losses).all():
                bad.append("%s: losses not finite: %r" % (tag, losses))
            if bf16_rule([losses[0]]) != losses[0]:
                bad.append("%s: the first loss %r is not a bf16 value: the "
                           "fetch is the loss var's declared dtype" % (
                               tag, losses[0]))
            ul = _ulps_apart(losses[0], x["rule_loss"])
            if not ul <= PP_LOSS_ULPS:
                bad.append("%s: the first loss %r is %.3g bf16 ulps off the "
                           "fetch rule's %r over Executor.run's microbatch "
                           "losses (limit %d)" % (tag, losses[0], ul,
                                                  x["rule_loss"],
                                                  PP_LOSS_ULPS))
            ul = _ulps_apart(losses[0], x["ref_loss"])
            if not ul <= PP_WHOLE_ULPS:
                bad.append("%s: the first loss %r is %.3g bf16 ulps off "
                           "Executor.run's %r (limit %d)" % (
                               tag, losses[0], ul, x["ref_loss"],
                               PP_WHOLE_ULPS))
            if not x["param_excess_over_limit"] <= 1:
                bad.append("%s: %r after step 1 is %.3g of its limit off "
                           "Executor.run's step" % (
                               tag, x["param_worst"],
                               x["param_excess_over_limit"]))
            runs = x["runs"]
            want = [runs * b for b in x["expected_p2p"]]
            if [x["pp_fwd_bytes"], x["pp_bwd_bytes"]] != want:
                bad.append("%s: P2P bytes %r, predicted %r" % (
                    tag, [x["pp_fwd_bytes"], x["pp_bwd_bytes"]], want))
            wires = x["wires"]
            if not wires or any(wires[c] != x["table_wires"].get(c)
                                for c in wires):
                bad.append("%s: the wires %r are not the JAX step's %r"
                           % (tag, wires, x["table_wires"]))
            M, v = x["M"], x["v"]
            if x["units"] != {"fwd": M * v, "bwd": M * v}:
                bad.append("%s: ran units %r, not %d each way" % (
                    tag, x["units"], M * v))
            if on_card:
                fwd_units, bwd_units = x["k1_units"]
                nf = x["layers"] * M * fwd_units * runs
                nb = x["layers"] * M * bwd_units * runs
                got = (x["k1_fwd"].get("tc", 0), x["k1_bwd"].get("tc", 0),
                       sum(x["k1_fwd"].values()) + sum(x["k1_bwd"].values()),
                       x["k1_copies"])
                if got != (nf, nb, nf + nb, 0):
                    bad.append("%s: K1 %r / %r, %d copies; expected %d "
                               "\"tc\" forward, %d backward, no copy" % (
                                   tag, x["k1_fwd"], x["k1_bwd"],
                                   x["k1_copies"], nf, nb))
    return bad


def pp_summary(name, ranks, card):
    """A leg's step as the slowest rank's: ms a step, tokens/s of the
    global batch, the schedule's bubble beside each rank's kernel time
    (one profiled step) in forward units, backward units, P2P and the
    update, its host ms a unit and its peak."""
    slow = max(ranks, key=lambda x: x["ms_per_step"])
    return {"leg": name, "card": card, "ms_per_step": slow["ms_per_step"],
            "tokens_per_s": slow["tokens_per_s"],
            "bubble_fraction": slow["bubble_fraction"],
            "ranks": [{"rank": x["rank"], "coords": x["coords"],
                       "layers": x["layers"], "device_ms": x["device_ms"],
                       # the kernel time's share out of the units: P2P
                       # waits, the grad sum and the update
                       "out_of_units": pp_out_of_units(x["device_ms"]),
                       "host_ms_per_unit": x["host_ms_per_unit"],
                       "peak_gib": x["peak_gib"]} for x in ranks]}


def pp_out_of_units(device_ms):
    """The share of a profiled step's kernel time in its "pp/p2p" and
    "pp/update" spans (None: no kernel was traced)."""
    total = sum(device_ms.values())
    if not total:
        return None
    return (device_ms["p2p"] + device_ms["update"]) / total


def pp_rank_main(args):
    """One rank of 19b/19c (a child of `pp_phase`; `args`
    `pp_rank_legs`'s keywords): one ``phase19_rank`` line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.get("device") == "cpu":
        torch.set_num_threads(1)
    out = pp_rank_legs(**args)
    from paddle_tpu_torch.parallel.mesh import destroy_data_group

    destroy_data_group()
    print("phase19_rank " + json.dumps(out), flush=True)


def pp_phase(torch, fa, fluid, timeout=900):
    """Phase 19: 19a on cuda:0 (the split, crossings and schedules
    against PP_TABLE; K1 checked and timed at each leg's microbatch
    shape, ``pp_k1_shapes``), then
    19b and 19c over four ranks when four cards are visible (with fewer,
    one ``pp_multi`` line saying they need four). Returns K1's launches
    on the phase's main paths by kernel row name."""
    import torch.nn.functional as F

    t19 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    plans = pp_plan_check(fluid)
    print("pp_plan " + json.dumps(dict(plans, card=card)), flush=True)
    flush = torch.empty(50 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for i, (B, H) in enumerate(pp_k1_shapes(PP_LEGS, PP["batch"])):
        rows = flash_timed_rows(torch, fa, F, flush, "bfloat16", B, 64,
                                seed=70 + i, H=H)
        print("pp_k1 " + json.dumps({"B": B, "H": H, "card": card,
                                     "rows": list(rows.values())}),
              flush=True)
    del flush
    launches = {"flash_attention_tc_fwd": 0, "flash_attention_tc_bwd": 0}
    cards = torch.cuda.device_count()
    if cards < PP["world"]:
        print("pp_multi " + json.dumps({
            "cards": cards, "ran": False,
            "why": "19b and 19c need four cards (--chips 4): no (dp, pp, "
                   "tp) mesh ran"}), flush=True)
    else:
        gc.collect()
        torch.cuda.empty_cache()
        results = run_ranks(PP_RANK_FLAG, "phase19_rank", PP["world"],
                            timeout)
        for name in results[0]["legs"]:
            ranks = [dict(r["legs"][name], rank=r["rank"]) for r in results]
            print("pp_multi " + json.dumps({
                "leg": name, "world": PP["world"], "card": card,
                "ranks": ranks}), flush=True)
            print("pp_summary " + json.dumps(pp_summary(name, ranks, card)),
                  flush=True)
        bad = check_pp_ranks(results, on_card=True)
        if bad:
            fail("19: " + "; ".join(bad))
        for r in results:
            for leg in r["legs"].values():
                launches["flash_attention_tc_fwd"] += leg["k1_fwd"]["tc"]
                launches["flash_attention_tc_bwd"] += leg["k1_bwd"]["tc"]
    print("pp_phase " + json.dumps({
        "cards": cards, "seconds": time.perf_counter() - t19,
        "k1_launches": launches}), flush=True)
    return launches


def main():
    try:
        import torch
    except ImportError as e:
        fail("PyTorch is not importable: %r" % (e,))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port runs on a "
             "CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        fail("no paddle_tpu_torch package beside chip_smoke.py")
    sys.path.insert(0, root)
    print(card_line(), flush=True)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa_mod
    from paddle_tpu_torch.ops import int8_matmul as im_mod
    from paddle_tpu_torch.ops import paged_attention as pa_mod
    from paddle_tpu_torch.ops import paged_attention_tree as pat_mod

    t0 = time.perf_counter()
    paths = _build.build()
    print("build: %s in %.2f s" % (", ".join(sorted(paths)),
                                   time.perf_counter() - t0), flush=True)
    for name, path in sorted(paths.items()):
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  %s: %s" % (name, line.strip()))

    rows = kernel_phase(torch, pa_mod)
    tree_rows = tree_kernel_phase(torch, pa_mod, pat_mod)
    flash_rows = flash_phase(torch, fa_mod)
    launches = serving_phase(torch, pa_mod)
    spec_model, legs = spec_serving_phase(torch, pa_mod, pat_mod)
    legs.update(spec_wide_phase(torch, pa_mod, pat_mod, spec_model))
    legs.update(spec_chunk_phase(torch, pa_mod, pat_mod, spec_model))
    spec_tree_profile(torch, spec_model)
    del spec_model
    legs.update({"fastpath_" + name: leg
                 for name, leg in fastpath_phase(torch, pa_mod).items()})
    bench_k2, bench_k3 = bench_serving_phase(torch, pa_mod, pat_mod)
    int8_step_profile(torch)
    fleet_c1 = fleet_phase(torch, pa_mod, pat_mod)
    # each row's launches are its own main paths': the serving phase and
    # phase 4e's replicas for the one-token decode (C=1), the linear legs
    # for C=7 and C=17, the chunk legs of phase 4b for C=8 (target chunks
    # and the drafter's catch-up), the fast path's chunked and fast legs
    # for C=64, phase 4d's bench functions for C=16 (the fast leg's
    # chunks, the drafters' catch-ups), the tree legs for C=13 (with the
    # model-drafted one and phase 4d's tree and int8 tree legs) and C=33
    k2_legs = {7: ("linear",), 17: ("linear16",),
               8: ("linear_c8", "tree_model"),
               64: ("fastpath_chunked", "fastpath_fast"), 16: ()}
    for row in rows:
        row["launches"] = launches + fleet_c1 if row["C"] == 1 else sum(
            legs[name]["paged_attention_launches_by_window"].get(row["C"], 0)
            for name in k2_legs[row["C"]])
        if row["C"] == 16:
            row["launches"] = sum(k2.get(16, 0) for k2 in bench_k2.values())
    k3_legs = {13: ("tree", "tree_model"), 33: ("tree4x8",)}
    for row in tree_rows:
        row["launches"] = sum(legs[name]["paged_attention_tree_launches"]
                              for name in k3_legs[row["C"]])
        if row["C"] == 13:
            row["launches"] += sum(bench_k3.values())
    program = build_lm(fluid)
    fwd, bwd = training_phase(torch, fa_mod, fluid, program)
    flash_rows["flash_attention_tc_fwd"]["launches"] = fwd
    flash_rows["flash_attention_tc_bwd"]["launches"] = bwd
    for suffix, kw in (("_dh128", dict(fp16=True)),
                       ("_dh256", dict(cfg=WIDE256, batch=WIDE256_BATCH))):
        for kernel, n in wide_head_phase(torch, fa_mod, fluid, **kw).items():
            flash_rows["flash_attention_%s%s" % (kernel, suffix)][
                "launches"] = n
    engine_launches = bench_phase(torch, fa_mod, fluid)
    flash_rows["flash_attention_fp16_fwd"]["launches"] = \
        engine_launches["fp16"]
    flash_rows["flash_attention_fp16_bwd"]["launches"] = \
        engine_launches["fp16"]
    fwd, bwd = user_training_phase(torch, fa_mod, fluid)
    flash_rows["flash_attention_tc_fwd"]["launches"] += fwd
    flash_rows["flash_attention_tc_bwd"]["launches"] += bwd
    fwd, bwd = stacked_phase(torch, fa_mod, fluid)
    flash_rows["flash_attention_tc_fwd"]["launches"] += fwd
    flash_rows["flash_attention_tc_bwd"]["launches"] += bwd
    card_vs_cpu_phase(torch, fluid, program, "bfloat16")
    del program
    program = build_lm(fluid, "float32")
    k1 = card_vs_cpu_phase(torch, fluid, program, "float32")
    n = 2 * TRAIN["n_layers"]                  # two steps on the card
    k1_want = ({"tc": 0, "fp16": 0, "f32tc": n},
               {"tc": 0, "fp16": 0, "f32tc": n}, 0)
    if k1 != k1_want:
        fail("card vs CPU fp32: flash attention launched %r (forward, "
             "backward by route; copies); expected %r" % (k1, k1_want))
    flash_rows["flash_attention_f32tc_bwd"]["launches"] = k1[1]["f32tc"]
    k1 = adam_card_vs_cpu_phase(torch, fluid, build_user_lm(
        fluid, "float32", cfg=dict(TRAIN, n_layers=2),
        clip_norm=USER_CVC_CLIP))
    n = 2 * 2                                  # two steps, two layers
    k1_want = ({"tc": 0, "fp16": 0, "f32tc": 2 * n},
               {"tc": 0, "fp16": 0, "f32tc": n}, 0)
    if k1 != k1_want:
        fail("card vs CPU Adam: flash attention launched %r (forward, "
             "backward by route; copies); expected %r (remat: each "
             "forward twice)" % (k1, k1_want))
    flash_rows["flash_attention_f32tc_bwd"]["launches"] += k1[1]["f32tc"]
    k1 = stacked_card_vs_cpu_phase(torch, fluid, build_stacked_cvc(fluid))
    n = STACKED_CVC["runs"] * 2                # the runs, two layers
    k1_want = ({"tc": 0, "fp16": 0, "f32tc": 2 * n},
               {"tc": 0, "fp16": 0, "f32tc": n}, 0)
    if k1 != k1_want:
        fail("card vs CPU stacked: flash attention launched %r (forward, "
             "backward by route; copies); expected %r (each layer's "
             "forward in the scan and in its replay)" % (k1, k1_want))
    flash_rows["flash_attention_f32tc_bwd"]["launches"] += k1[1]["f32tc"]
    stacked_f32_fwd = k1[0]["f32tc"]
    int8_rows = int8_kernel_phase(torch, im_mod)
    int8_launches, flash_rows["flash_attention_f32tc_fwd"]["launches"] = \
        int8_phase(torch, fluid, im_mod, fa_mod, program)
    flash_rows["flash_attention_f32tc_fwd"]["launches"] += stacked_f32_fwd
    for row in int8_rows:
        row["launches"] = int8_launches.get(tuple(row["mkn"]), 0)
    int8_card_vs_cpu_phase(torch, fluid, im_mod, program)
    del program
    t9 = time.perf_counter()
    before = kernel_launch_totals(fa_mod, pa_mod, pat_mod, im_mod)
    image_phase(torch, fluid)
    image_card_vs_cpu_phase(torch, fluid, build_image_cvc(fluid))
    after = kernel_launch_totals(fa_mod, pa_mod, pat_mod, im_mod)
    print("image_phase " + json.dumps({
        "seconds": time.perf_counter() - t9, "launches_before": before,
        "launches_after": after}), flush=True)
    if after != before:
        fail("phase 9 launched a hand-written kernel: %r -> %r"
             % (before, after))
    gc.collect()
    torch.cuda.empty_cache()
    k4_predictor = predictor_phase(torch, fluid, im_mod, pa_mod, pat_mod,
                                   fa_mod)
    int8_rows += predictor_kernel_rows(torch, im_mod, k4_predictor)
    gc.collect()
    torch.cuda.empty_cache()
    bench_phase_11(torch, fluid, fa_mod, pa_mod, pat_mod, im_mod)
    for name, n in native_phase(torch, fa_mod).items():
        flash_rows[name]["launches"] += n
    for name, n in data_phase(torch, fa_mod, fluid).items():
        flash_rows[name]["launches"] += n
    fwd, bwd = parallel_phase(torch, fa_mod)
    flash_rows["flash_attention_tc_fwd"]["launches"] += fwd
    flash_rows["flash_attention_tc_bwd"]["launches"] += bwd
    k1, k2_c1 = telemetry_phase(torch, fa_mod, pa_mod, fluid)
    for name, n in k1.items():
        flash_rows[name]["launches"] += n
    for row in rows:
        if row["C"] == 1:
            row["launches"] += k2_c1
    for name, n in spmd_phase(torch, fa_mod).items():
        flash_rows[name]["launches"] += n
    for name, n in tp_phase(torch, fa_mod, fluid).items():
        flash_rows[name]["launches"] += n
    for name, n in zero_phase(torch, fa_mod).items():
        flash_rows[name]["launches"] += n
    for name, n in pp_phase(torch, fa_mod, fluid).items():
        flash_rows[name]["launches"] += n
    kernels = rows + tree_rows + list(flash_rows.values()) + int8_rows
    idle = [(r["name"], r.get("C"), r.get("shape")) for r in kernels
            if not r.get("launches")]
    if idle:
        fail("kernels launched no time on their main path: %r" % idle)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == CHILD_FLAG:
        child_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == RANK_FLAG:
        parallel_rank_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == PROFILE_FLAG:
        profile_child_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == LOCK_FLAG:
        lockcheck_child_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == FIRST_FLAG:
        first_program_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == SPMD_RANK_FLAG:
        spmd_rank_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == TP_RANK_FLAG:
        tp_rank_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == ZERO_RANK_FLAG:
        zero_rank_main(json.loads(sys.argv[2]))
    elif len(sys.argv) == 3 and sys.argv[1] == PP_RANK_FLAG:
        pp_rank_main(json.loads(sys.argv[2]))
    else:
        main()
