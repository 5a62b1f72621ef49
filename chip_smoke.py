#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`mxnet_tpu_torch`) end to end on one
NVIDIA Hopper card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device of compute capability (9, 0), ``nvcc`` and
``nvidia-smi``, and builds the kernels from the sources in the checkout.

Phases; any failure ends the run with a non-zero exit and no result line:

1. device  -- the card's name and power limit (``nvidia-smi``), the
   capability check, TF32 off (parity is held in fp32).
2. build   -- every kernel of `mxnet_tpu_torch/csrc`, one ``nvcc`` per
   source, all started together; prints the seconds and the ptxas report
   (registers, spills, and any wgmma serialization warning).
3. kernels -- K1 against its plain PyTorch version on the same inputs on
   the card (fp32, K1's three-pass TF32 wgmma kernel, at 2e-4, within
   K1_SPLIT_TOL of O's largest magnitude and with a signed bias toward
   zero below K1_BIAS_TOL of O's mean magnitude; bf16, K1's wgmma kernel,
   compared in bf16 at 2e-2 with the logsumexp at the fp32 2e-4), at the
   main path's shape and others (both dtypes at every head dim, Lq != Lk,
   a ragged Lq of 100, a negative scale) and on inputs off 16-byte
   alignment in both dtypes.  Each case has two
   times for K1 and for one PyTorch library call: ``ms``, back-to-back
   calls through the wrapper (host time included), and ``device_ms``, a
   CUDA graph of DEVICE_CALLS calls replayed DEVICE_REPLAYS times; the
   bound's share is of the device time; the plain version's ms beside.
3b. backward kernels -- K2 (dq) and K3 (dk, dv) against their plain
   versions on K1's residuals with a nonzero dLSE: BERT-base's
   [8, 12, 512, 64] and [8, 12, 128, 64] calls, causal, bf16 (K2's and
   K3's wgmma kernels) at every head dim, Lq != Lk, a ragged Lq of 100
   and a ragged Lk of 100, a negative scale, and inputs off 16-byte
   alignment in both dtypes (bf16 with its lse, delta and dlse rows off
   it too); fp32 within 2e-3, with a signed bias toward zero of dq, dk
   and dv below K23_BIAS_TOL of their mean magnitudes, bf16 within 2e-2
   of the gradient's largest magnitude, each gradient's signed bias
   printed; call and device times as phase 3's beside the bound and its
   share and, at BERT-base's [8, 12, 512, 64] in both dtypes, causal and
   not, one library call (the backward of PyTorch's fused attention, for
   K2 + K3, printed beside K2 + K3).
3c. LSTM kernel -- K4 against its plain version: the LM's [32, 800] gates
   and [32, 200] cell, [20, 6000], [4096, 4096], an odd H = 13, and bf16
   gates with fp32 or bf16 cells; fp32 within 1e-5, bf16 within 2e-2
   (compared in fp32); times beside the bound and its share and PyTorch's
   fused CUDA LSTM cell (``aten._thnn_fused_lstm_cell``) as the library
   call.  At the LM's call, the host's µs a call (back-to-back wall time,
   no synchronize) and the device's µs a call (profiler), each beside the
   library call's.
4. slice   -- BERT-base (12 x 768, 12 heads, FFN 3072, vocab 30522, random
   weights from a seed, handed over as a `.params` blob) served by
   `mxnet_tpu_torch.Predictor` on cuda:0: 4 requests at (8, 512), a reshape
   to (8, 128), 2 more.  The graph optimizer must swap all 12 attention
   sites onto K1 and each forward must launch it 12 times; the outputs
   must match a second Predictor that runs the unfused graph on the card
   (``MXTPU_PALLAS=0``).  At each shape, after the checked requests and
   one warm-up, a few hundred more are timed for the latency percentiles.
   Each forward replays a CUDA graph: one replay must launch K1 12 times
   inside one ``cudaGraphLaunch`` by the profiler's trace, and a third
   Predictor runs the same path eagerly (``MXTPU_GRAPH_COMPILE=0``), whose
   outputs the captured ones must give within CAPTURE_TOL of the largest
   magnitude; the captured and eager p50 are printed side by side.
5. train   -- BERT-base masked-LM pretraining (`bert_mlm`, the encoder
   with `_fused_attention`, BERT's MLM head and a decoder tied to the word
   embedding) through `mxnet_tpu_torch.mod.Module` on cuda:0 at batch
   8 x 512 in fp32, weights from a seed through ``arg_params``.  One
   forward/backward with dropout 0 must match the unfused graph
   (``attention="batch_dot"``) on every parameter's gradient; then with
   dropout 0.1 and BERT's Adam, 20 steps on a fixed batch must lower the
   loss, and 20 more (after 2 warm-ups) are timed.  Every step must launch
   K1, K2 and K3 once per layer.  One warm step is profiled.
6. LSTM    -- MXNet's PTB LSTM language model (the reference's
   ``example/rnn/bucketing/lstm_bucketing.py`` at its defaults: 2 layers
   of 200, embed 200, vocab 10000, batch 32; random weights from a seed in
   one `.params` blob) served by one `mxnet_tpu_torch.Predictor` per
   bucket, T = 60 and T = 10.  The graph optimizer must swap all 2·T LSTM
   cells onto K4 (and no attention site); each forward must launch K4 2·T
   times and K1 never; 4 requests per bucket must match a Predictor of the
   unfused graph within 1e-4; then 100 (T = 60) and 400 (T = 10) warm
   requests are timed and one forward at T = 60 is profiled.  As in
   phase 4, one replay per bucket must launch K4 2·T times in the trace,
   and an eager Predictor per bucket must give the captured outputs.
7. fit     -- BERT-base MLM (phase 5's model) through ``Module.fit`` over
   an `NDArrayIter` of FIT_BATCHES fixed batches (token ids, one row of
   positions per sample, labels), FIT_EPOCHS epochs, BERT's Adam with a
   PolyScheduler warm-up, the accuracy accumulated inside the step; each
   step (forward, backward, the multi-tensor update, the metric) is one
   CUDA graph replay.  With dropout 0, FIT_K captured steps must leave
   every parameter within FIT_TOL of FIT_K eager ones under a changing
   lr, and two replays at lr 0 the same outputs; with dropout 0.1 the
   loss must fall, two replays at lr 0 must draw different masks, one
   replay must launch K1, K2 and K3 12 times each in the trace, and the
   in-step accuracy must equal a host ``update_metric``.  The step's p50
   is timed captured, eager and with the per-parameter update.
8. Gluon ResNet-50 -- `gluon.model_zoo.vision.resnet50_v1()` at its
   published widths (1000 classes, 224 x 224, random weights from a
   seed) on cuda:0 in fp32.  Serving at batch 8: the hybridized forward
   (a CUDA graph replay) must give the imperative one within
   RESNET_CAPTURE_TOL of the largest output; the net is exported and its
   JSON and `.params` served by `Predictor`, whose ``fold_bn`` must fold
   all 53 BatchNorms, within RESNET_EXPORT_TOL of Gluon's output; 200
   requests each way are timed with the output copy.  Training at batch
   32 with `SoftmaxCrossEntropyLoss` and `gluon.Trainer` (SGD, momentum
   0.9, wd 1e-4, lr 0.05): every convolution of one step, run by cuDNN in
   fp32 on the float64 step's own inputs, must give its output, input
   gradient and weight gradient within RESNET_GRAD_TOL of float64, and the
   step's gradients (BatchNorm on its moving statistics) must lie within
   RESNET_GRAD_TOL of the float64 step's by their norm; element-wise and
   train-mode figures are printed beside them; then 2 untimed and 10
   timed steps (the lr ramped linearly to 0.05 over the 12) on 2 fixed
   batches must lower the loss and move BatchNorm's moving statistics.
   One captured forward and one training step are profiled (device busy
   time, convolutions, BatchNorm, the update, the rest).  The training
   net is hybridized: its recorded forward and its backward replay as two
   CUDA graphs, and the step is timed captured and eager
   (``MXTPU_GRAPH_COMPILE=0``) in turns.  The phase's kernels are
   PyTorch's and cuDNN's: the JAX package runs this path on no Pallas
   kernel.
9. Gluon zoo and data -- AlexNet, VGG-16, VGG-16-BN, DenseNet-121,
   SqueezeNet 1.1 and MobileNet v2 1.0 at 224 x 224 and Inception-v3 at
   299 x 299, 1000 classes, Xavier weights from a seed, served at batch 8
   hybridized (a CUDA graph replay, within RESNET_CAPTURE_TOL of the
   imperative forward) with each one's p50.  Inception-v3 trained at
   batch 32 on the batches of one `gluon.data.DataLoader` iterator (2
   worker threads, reshuffled each pass) over an `ArrayDataset` of seeded
   uint8 images through ``ToTensor`` and ``Normalize``, each batch moved
   to the card: SGD with phase 8's settings and ramp over 16 steps, the
   loss must fall; on one batch the captured step must give the eager
   step's loss (ZOO_LOSS_TOL) and gradients (ZOO_GRAD_TOL of their norm)
   with the Dropout generator reseeded, and a replay without the reseed
   other masks; so must two calls whose backwards are pending together
   (the second on a program of its own).  The step p50 in the loop,
   captured and eager in turns, images/s on the step alone and with the
   loader's steady-state wait, the loader alone, and one profiled step's
   idle share are printed.  The trained net is exported
   and loaded back by `SymbolBlock.imports` on the card (within
   ZOO_IMPORT_TOL of the net) and served by `Predictor` with all 94
   BatchNorms folded, both timed.  `gluon.loss.CTCLoss` at T = 80, N = 32,
   38 classes, labels of 4-20 and varying input lengths, imperative and
   hybridized (its recorded call captured, a call two graph launches),
   must give its float64 loss and gradient on the CPU within CTC_TOL;
   each way's p50 is printed.  No TPU kernel
   lies on this path either.
10. RNN -- the rest of the RNN package, fp32 with TF32 off, weights from
   a seed.  10a: the ``RNN`` op (cuDNN's RNN on the card) against its
   step loop (`rnn_op.rnn_forward_plain`) on the card, every mode at 1
   and 2 layers, one and two directions, at the LM's [60, 32, 200] and
   [7, 3, 13]: outputs and states within LSTM_SLICE_TOL, the gradients of
   data, parameters and states within RNN_GRAD_TOL of their largest
   magnitudes (rnn_relu's within RNN_RELU_GRAD_TOL of their norm, since a
   ReLU input within fp32 rounding of 0 switches in one path and not the
   other; both paths' errors against the loop in float64 and the
   switches are printed); with dropout 0.5 between layers and the generator
   reseeded, the same masks as the loop; a training call (forward and
   backward) captured as a CUDA graph must give the eager call from the
   same seed within CAPTURE_TOL and redraw its masks at the next replay;
   then the op's and the loop's p50, forward and forward + backward, at
   the LM's shape, and the copies' share of one call's device time.
   10b: the PTB LSTM LM of phase 6 as the reference's
   ``lstm_bucketing.py`` trains it (`FusedRNNCell(200, 2 layers)`, embed
   200, vocab 10000, batch 32, buckets 10-60, Xavier in 2.34, SGD lr
   0.01) through ``BucketingModule.fit`` on synthetic Markov sentences
   encoded by ``encode_sentences`` and batched by `BucketSentenceIter`,
   RNN_EPOCHS epochs over every bucket, ``do_rnn_checkpoint`` writing
   each epoch to a temporary directory: the perplexity must fall.  10c:
   ``load_rnn_checkpoint`` repacks the last checkpoint into phase 6's
   unfused graph, served by `Predictor` with all 2·T cells on K4 (2·T
   launches a forward) at T = 60 and 10, within LSTM_SLICE_TOL of a
   `Predictor` of the fused graph and of the module's own inference
   forward.  Then each bucket's step p50 and tokens/s, the host metric's
   cost, and one profiled step at T = 60 (idle share).  10d: the
   reference's Gluon word LM (Embedding, Dropout, `gluon.rnn.LSTM` of 2
   x 200 with dropout, Dropout, Dense; bptt 35, batch 32, SGD lr 20, the
   gradients' norm clipped to 0.2) hybridized and trained on a synthetic
   token stream: the loss must fall, the captured step must give the
   eager step's loss and gradients (ZOO_LOSS_TOL, ZOO_GRAD_TOL) with the
   generator reseeded and a replay without the reseed other masks; the
   step is timed captured and eager in turns.  K4 is this phase's only
   TPU kernel, in 10c.
11. state and sparse storage.  11a: the reference's
   ``example/sparse/linear_classification.py`` local-store loop
   (``_train_local``) at the width of LIBSVM's avazu-app (AVAZU: 1,000,000
   features, the example's batch 8192 and lr 4), on 64 synthetic CSR
   batches built from their components (15 one-hot fields a row, Zipf
   categories): forward ``sparse.dot(X, w)``, gradient the transposed dot
   cast to row_sparse, ``kv.push``/``kv.pull`` through a local KVStore
   with SGD on push.  One batch's dot and transposed dot within
   SPARSE_TOL of float64 on the same rows, the transposed dot rerun
   bit-equal, the weight after 64 steps within SPARSE_TOL of the same
   steps in float64 on the host, ``row_sparse_pull`` of 4096 ids equal to
   the pulled rows, the loss falling; the p50 of the step, both dots,
   the cast, push and pull, examples/s and one profiled step's idle
   share.  11b: `tests/test_sparse_fm_train.py`'s factorization machine
   at the reference test's widths (FM) through ``Module.fit`` over a
   `LibSVMIter` on a file the phase writes, SGD, Adam and AdaGrad each
   under that test's MSE; the trained ``v`` (row_sparse) and a csr batch
   through one ``.params``.  11c: phase 7's fit (dropout 0.1, BERT's
   Adam; CKPT_LAYERS of BERT-base's 12 layers) with ``MXTPU_CKPT_DIR``: run A in this process; run B in a child
   SIGKILLed while epoch 2's checkpoint is written (the window widened by
   ``MXTPU_CKPT_COMMIT_DELAY``), after which ``latest_valid()`` must name
   epoch 1's; a second child resumes and must end bit-equal to run A,
   parameters and Adam states; a truncated newest ``params.params`` must
   make ``latest_valid()`` fall back a step; a save's and a restore's
   seconds and bytes, the children's start-up seconds (they reuse the
   kernel build).  11d: one epoch of fit at dropout 0 on a local KVStore
   (update-on-kvstore) with a `Monitor` over the outputs, within FIT_TOL
   of a store-less eager fit, the monitor's statistics equal to those of
   the outputs; one push of the gradients under 2-bit compression exact;
   the step's p50 beside phase 7's captured step.  11c and 11d run K1-K3.
12. the op surface, the samplers and DCGAN.  12a: every case of the CPU
   op sweep (`tests/torch_sweep_cases.py`: `tests/test_op_sweep.py`'s spec
   table and the port sweep's own cases) on the card in fp32, forward and
   the gradient of a fixed projection, against the port on the CPU in
   float64: within SWEEP_TOL of the float64 result's largest magnitude,
   SWEEP_FACTOR_TOL for the factorizations and solves (eigenvectors with
   their signs aligned); the count held and the worst error per ported
   file, and the factorizations' worst apart.  12b: each distribution at SAMPLER_N samples from the
   card's generator, held by its mean and a KS or chi-square test against
   `scipy.stats` (p > SAMPLER_P); reruns under `random.seed` bit-equal,
   `shuffle` a permutation, `multinomial`'s ``get_prob`` gradient finite
   and count / p.  12c: MXNet's DCGAN (`model_zoo.dcgan`, the reference's
   ``example/gan/dcgan.py``: Z 100, ngf = ndf = 64, 64 x 64 images, batch
   64, Adam lr 0.0002 beta1 0.5) through two `mod.Module`s with the
   reference's loop on synthetic images from the seed: one iteration in
   fp32 against the same iteration in float64 on the CPU, each ReLU and
   LeakyReLU element of the float64 iteration on the branch the card's
   took (an element that switched lies within DCGAN_SWITCH_TOL of zero),
   the gradients within DCGAN_GRAD_TOL by their norm, D's outputs within
   DCGAN_OUT_TOL,
   then DCGAN_WARM + DCGAN_TIMED iterations with the noise drawn on the
   card by ``nd.random.normal``: the iteration's p50 and images/s, one
   profiled iteration's idle share, and D's losses on real and on fake,
   which must move.  No TPU kernel lies on this path.
13. the optimizers, the initializers and the image data plane.  13a:
   every registered optimizer (and RMSProp centered) OPT_STEPS steps at
   ResNet-50 v1's parameter set (193 arrays, 25,575,912 numbers) in fp32
   on the card from seeded gradients, with wd, rescale_grad and
   clip_gradient set, through `Updater.update_multi` where it has a
   multi-tensor plan, against the same port code in float64 on the card:
   each array within OPT_TOL of its largest magnitude, except that for
   Signum and Ftrl (a sign or a threshold per element) at most
   OPT_SWITCH_SHARE of the elements may pass it; SGLD's noise within 5
   standard errors of N(0, lr) in mean and variance; multi_precision on
   fp16 weights for SGD, NAG and Adam within OPT_HALF_TOL of fp32, their
   masters within OPT_TOL; ``multi_sgd_mom_update`` and
   ``multi_mp_sgd_mom_update`` over every array within MULTI_TOL of the
   per-array ops; each optimizer's update ms a step beside its compulsory
   bytes over MEM_BPS.  The initializers at those shapes: Xavier
   (gaussian, in, 2) and MSRAPrelu by their std (pooled within
   INIT_STD_TOL, each array within 5 standard errors), Orthogonal within
   ORTHO_TOL of orthonormal, Bilinear and LSTMBias equal to numpy, Mixed
   routed by pattern.  13b: IMG_RECORDS synthetic 224 x 224 JPEGs (10
   classes of smooth prototypes plus noise, quality 95) packed by the
   port's `recordio`; `resnet50_v1()` hybridized, Xavier(gaussian, in,
   2), `Trainer('nag')` at IMG_NAG with a linear warm-up, trained for
   IMG_EPOCHS epochs of 20 batches of 32 from `io.ImageRecordIter`
   (shuffle, rand_mirror, mean, std, preprocess_threads = the host's
   cores); the line names the iterator class and decoder that served.
   Held: the loss falls; the first batch on the card within IMG_CHECK_TOL
   of the same records decoded on the host and mirrored and normalized
   in float64 with the flags its seeded stream draws, labels equal; two
   passes under the NaiveEngine with equal checksums; a batch unchanged
   after 3 more fetches.  Printed: the step p50 fed by the iterator and
   on one fixed batch, the loader's wait, the loader alone and decode
   alone in images/s, the H2D bytes and ms a batch, one profiled fed
   step's idle share, and the Python `ImageIter` (resize, random crop)
   images/s over 4 batches.  No TPU kernel lies on this path.
14. control flow, custom ops, partitioning and reshape, on phase 6's PTB
   LSTM LM (2 x 200, embed 200, vocab 10000, batch 32) with its time loop
   as one ``sym.contrib.foreach`` scan over the `rnn.LSTMCell`s
   (`model_zoo.foreach_lm`), fp32 with TF32 off, on synthetic Markov
   text.  14a: against the same LM unrolled by ``cell.unroll`` on the
   same weights over one batch (outputs within CF_FWD_TOL, gradients
   within CF_GRAD_TOL of the largest magnitude); two captured one-graph
   steps bit-equal to two eager ones; ``Module.fit`` CF_EPOCHS epochs of
   CF_BATCHES batches at T = CF_T with phase 10's SGD as one captured
   step, the perplexity falling; the step p50 captured and eager in turns
   and one profiled step's idle share, beside phase 10's
   `BucketingModule` step at T = 60.  14b: the trained parameters saved
   as `.params` and served on the unrolled LM by a `Predictor` whose
   forwards launch K4 2·T times each, its logits within CF_FWD_TOL of the
   foreach graph's captured forward.  14c: greedy decoding as a
   ``sym.contrib.while_loop`` (`model_zoo.greedy_decoder`; condition ``i
   < n_steps``, max_iterations CF_DECODE_ITERS, n_steps CF_DECODE_STEPS)
   run as one captured inference forward: tokens equal to the imperative
   ``nd.contrib.while_loop``'s, the rows past n_steps zero, replays
   bit-equal; ms a decode.  14d: the LM with
   `example/numpy-ops/custom_softmax.py`'s numpy head as a ``Custom`` op:
   the program's islands and one fallback node, the island-plan forward
   (each island a CUDA graph, the Custom eager between them) against the
   eager whole graph; CF_HEAD_STEPS classic-path steps against the same
   steps with ``SoftmaxOutput`` (first gradients and weights within
   CF_FWD_TOL); the step's ms, the host crossings' ms and bytes each way;
   `lower_step_fn` refusing the graph; ``Module.reshape`` from (32, 60)
   to (32, CF_RESHAPE_T) and back over the root buffer, equal to a fresh
   bind.  14e: `example/module/sequential_module.py`'s MLP (SEQ_MLP) as a
   `SequentialModule` of two `Module`s against one `Module` of the joined
   graph after 5 steps (SEQ_TOL); a hybridized ``F.contrib.foreach`` over
   ``gluon.rnn.LSTMCell(200)`` against its imperative run; ``_cond`` on
   the card (the island plan) against the CPU, both branches.  K4 is the
   phase's only TPU kernel, in 14b.

16. the rest of the serving plane, fp32 with TF32 off.  16a: phase 6's
   PTB LSTM LM as one decode step (`lm_cell_symbol`: heads ``[logits,
   h0', c0', h1', c1']``) rewritten by ``graph_opt.optimize``, which must
   put both LSTM sites on `_fused_lstm_gates` (K4); one step of it within
   LSTM_SLICE_TOL of the unfused cell's on the same seeded states; as
   `generation.DecodeEngine` (GEN_SLOTS slots, GEN_CHUNK steps a chunk,
   prompts up to GEN_PROMPT, outputs up to GEN_TOKENS) its chunk must be
   one graph launch holding 2 · GEN_CHUNK K4 launches in the profiler's
   trace (the session's first launch a warm-up, as in 15b), and both
   programs are built once (``traces`` 2 through every
   admission); GEN_PROMPTS prompts of GEN_PROMPT_LEN tokens of synthetic
   Markov text asking for GEN_NEW tokens, decoded through `DecodeService`
   continuously (the main path: K4 2 · GEN_CHUNK times a chunk) and with
   ``MXTPU_GEN_CONTINUOUS=0``, each bit-equal to ``decode_sequential``;
   a cell with an eos id stops every sequence at its first eos.  Printed:
   the chunk replay's ms, tokens/s each way, TTFT p50/p99, mean
   occupancy, one profiled chunk's idle share.  16b: the cell saved as a
   decode blob, registered in a `ModelRegistry`, loaded back and decoding
   bit-equal; then `ModelServer(phase 15's pool, decode=DecodeService)`
   with 4 client threads interleaving ``generate`` (each reply equal to
   the oracle's) and ``infer`` (each reply bit-equal to its rung's run).
   16c: FLEET_REPLICAS replica processes (``python -m
   mxnet_tpu_torch.serving_fleet --replica``, phase 15's blob at the
   FLEET_LADDER, the decode blob as ``--gen-blob``) on the one card under
   a `ReplicaSupervisor`, a `Router` in this process: its reply bit-equal
   to each replica's direct one at rung 4 and within RUNG_TOL of phase
   15's pool, as every reply of the traffic; FLEET_REQUESTS clean
   requests from FLEET_CLIENTS clients, then FLEET_CHAOS_REQUESTS with a
   `FaultPlan` SIGKILL of a replica at dispatch FLEET_KILL_AT (no request
   lost; the supervisor's respawn readmitted by a health probe); a
   rolling deploy to a same-weights v2 past its canary, a v3 of other
   weights refused by the canary and rolled back, a corrupt blob
   (``corrupt_blob_on_deploy``) rolled back, a rollback to v1, and
   ``Router.generate`` equal to the oracle.  16d: an `Autoscaler` (SCALE)
   over one replica: a burst of SCALE_BURST clients at poll
   SCALE_SPIKE_AT grows the fleet, the fresh replica is SIGKILLed before
   its warm-up (untouched by traffic while warming) and respawned, and
   after the burst the fleet returns to its floor; no request lost.
   Printed: rows/s and client p50/p99 through the router, each replica's
   start-up, deploy, refusal and rollback seconds, the scale-up's seconds
   from spawn to admitted, the card's peak memory (``nvidia-smi``).  K4
   runs in 16a-b, K1 in 16b's pool and in the replicas.

17. contexts -- several contexts in one process.  17a: phase 5's
   BERT-base (dropout 0.1, BERT's Adam) through
   ``Module(context=[gpu(0), gpu(0)])``, which folds onto gpu(0) with the
   JAX package's warning, CTX_FOLD_STEPS steps on a fixed batch beside
   ``Module(context=gpu(0))``, the device generator seeded alike: every
   parameter bit-equal after them, K1-K3 once per layer a step.  17b:
   `DataParallelExecutorManager` over [gpu(0), gpu(0)] with work_load_list
   [1, 3] (slices of 2 and 6 rows) on the same graph with the head's
   ``normalization='null'`` and dropout 0: one forward/backward whose two
   executors' summed gradients lie within TRAIN_GRAD_TOL of each
   gradient's largest magnitude of one executor's over the batch (the
   key biases, zero in exact arithmetic, within KEY_BIAS_TOL of the
   largest gradient of all, as in phase 5); K1-K3
   once per layer in each executor; each executor's step and the
   manager's timed (CUDA events).  17c: MXNet's Gluon MNIST MLP (Dense
   128 relu, 64 relu, 10) with replicas on [gpu(0), cpu(0)] fed by
   `split_and_load`, ``Trainer(kvstore='device')`` (SGD, lr 0.1, momentum
   0.9) for CTX_MLP_STEPS steps at batch 100 of seeded 784-wide data:
   within CTX_TOL of one context on the whole batch, the replicas within
   CTX_TOL of each other.  17d: the reference's model-parallel matrix
   factorization (embeddings in group "embed" on cpu(0), the dense head in
   "dense" on gpu(0), `Module(group2ctxs=...)`) at MovieLens-10M's id
   ranges (MF), CTX_MF_STEPS steps of Adam beside the same module on
   gpu(0): every gradient of every step within CTX_TOL, each group's
   arrays and gradients on its device.  The split of one module's batch
   across distinct cards needs two cards and is logged as skipped.

18. distributed -- the parameter-server plane across processes, each
   process a `tests/torch_bert_dist_worker.py` (the port's own worker
   script; every child checks that it imported neither JAX nor the JAX
   package and prints its K1-K3 launch counts, which the kernel report
   adds).  18a: phase 5's BERT-base MLM at its published widths and
   DIST_LAYERS of its layers, fp32, dropout 0, the head's gradient summed
   (``normalization='null'``):
   one process steps DIST_STEPS times on the whole 8 x 512 batch with
   BERT's Adam; then two worker processes of ``tools/launch.py
   --launcher local -n 2`` on the one card, joined over gloo, each on its
   4 rows through ``Module`` with ``kvstore='dist_sync'`` (Adam on the
   store): their parameters must be bit-equal to each other after every
   step and within TRAIN_GRAD_TOL of each parameter's largest magnitude
   of the one process after the last; the step ms and its share spent in
   the store's push and pull are printed.  18b: ``BYTEPS_ENABLE_ASYNC=1
   tools/launch.py -n 2 -s 1``: one server process (the same command,
   entered by importing the package under ``DMLC_ROLE=server``) and two
   workers with ``kvstore='dist_async'``.  Without a server optimizer
   (``stored += recved``) each worker pushes its gradients of DIST_STEPS
   steps and their float64 sums are exchanged; each worker's pull must
   equal the initial weights plus both sums within ``pushes · 2^-24 ·
   (max|w0| + Σ max|g|)``.  With BERT's Adam set on the server
   (``set_optimizer``), DIST_ASYNC_STEPS asynchronous steps a worker with
   dropout 0.1 must lower each worker's loss; the server's stats
   (pushes, pulls, the staleness histogram, dead workers, which must be
   none) and the comm counters (``push_batch`` frames, bytes) are
   printed.  K1-K3 launch once per layer a step in every process.  18c:
   11a's sparse linear classification at avazu-app's 1,000,000 features,
   batch 8192, with the weight a ``(1000000, 1)`` table of the embedding
   plane row-sharded over two in-process server shards in sync mode
   (sparse SGD on the shards), EMBED_STEPS steps on the card against
   11a's local-store path on the same batches: the weight within
   EMBED_TOL (bit-equal printed), the pull bytes of each step 4 x the
   batch's unique ids; `embed_counters` and both step times printed.
19. spmd -- the SPMD plane (`mxnet_tpu_torch.parallel`) and the training
   driver.  The script's own process joins a group of one (NCCL) for the
   one-rank halves; two processes of ``tools/launch.py --launcher local
   -n 2`` (SPMD_ENTRY), started once and sharing the card over gloo, run
   the two-rank halves of 19a-19d and write their records to files.
   First, K1 and K2/K3 at one ring hop's shape ([1, 12, 4096, 64] fp32,
   causal and not, K2/K3 with a random dLSE) against their plain
   versions, as in phases 3 and 3b.  19a: `resnet50_v1()` at its
   published widths, batch 32 at 224, SGD (momentum 0.9, wd 1e-4, lr
   0.01), SPMD_STEPS steps through `SPMDTrainer`, held in float64 (in
   train mode the random-init net turns fp32 rounding into gradients a
   few percent apart): on one rank within SPMD_RESNET_TOL of
   `gluon.Trainer` (phase 8's path) from the same weights; on two (dp 2,
   16 + 16 rows, BatchNorm's moments over the whole batch) within
   SPMD_RESNET_TOL of one rank, the arrays zero in exact arithmetic (the
   biases of convolutions that feed a BatchNorm, no larger than
   SPMD_ZERO_FLOOR) left out; the same steps
   in fp32 are timed, each step's ms and its share in the collectives
   printed.  19b: the ring LM of
   `model_zoo.ring_lm` (train_ring_lm.py's model at RING_LM_CARD: BERT-
   base's attention widths, causal, seq 8192, batch 1), SPMD_STEPS Adam
   steps at sp 1 and sp 2 (4096 positions a rank): the first step's
   logits within RING_OUT_TOL and every parameter's gradient within
   RING_GRAD_TOL of sp 1 (over their largest magnitudes); K1-K3's
   launches a step printed (at sp 2 rank r launches K1 r + 1 times).
   19c: phase 5's BERT-base MLM (4 of its 12 layers) at 8 x 512
   (dropout 0) through
   ``Module.fit``, SPMD_BERT["steps"] steps: on one rank ``MXTPU_SPMD=1`` (the
   sharded step, captured) within SPMD_FIT_TOL of the unified step; on
   two ranks ``MXTPU_SPMD_ZERO1=1`` within SPMD_FIT_TOL of one rank and
   bit-equal (weights and Adam states) to ``MXTPU_SPMD_ZERO1=0``; each
   rank's optimizer-state bytes must be half the total.  19d:
   train_pipeline_moe.py's pipeline (PIPE_CFG: 2 stages over pp 2, 8
   microbatches) and Switch MoE (MOE_CFG: 4 experts over ep 2) with SGD:
   the loss falls and its trajectory is within PIPE_TOL of one rank's
   (the stages in sequence; the experts on one rank).  19e: phase 5's
   BERT-base ``Module.fit`` (PREEMPT["layers"] of its 12 layers, PREEMPT
   batches, dropout 0.1, BERT's Adam)
   under ``MXTPU_ANOMALY_GUARD=1`` with a fault plan poisoning one step:
   run A here; run B in a child (PREEMPT_ENTRY) under a
   `train_driver.TrainingSupervisor` with a checkpoint directory, sent
   SIGTERM after a batch mid-epoch, must exit 75 with a committed
   mid-epoch ``preempted`` checkpoint; run C here resumes from it and
   must end bit-equal to A (weights and Adam states); A and B each skip
   the poisoned step once.
20. elastic mesh and contrib ops.  20a: phase 19c's BERT-base MLM (2 of
   its 12 layers at their published widths, 8 x 512, dropout 0, BERT's
   Adam)
   through ``Module.fit`` under ``MXTPU_SPMD=2`` with ZeRO-1,
   ``MXTPU_SPMD_SHARD_REDUNDANCY=1`` and a `TrainingSupervisor`, on two
   processes started with the launcher's ``DMLC_*`` env and sharing the
   card over gloo, 2 batches an epoch for 2 epochs; the fault plan's
   ``kill_device_at`` ends rank 1's process (exit 86) at step 3's probe.
   Rank 0 must detect it within the probe's bound
   (ELASTIC_STEP_TIMEOUT_S), census-attributed (``device_killed``, rank
   1 lost), recover the lost Adam shard from its buddy copy
   (``buddy_recoveries`` 1, ``disk_recoveries`` 0), shrink to one
   captured rank, retry batch 3 and end after step 4 bit-equal (weights
   and Adam states) to a fresh one-rank ``fit`` resumed from the
   checkpoint after step 2.  20b: the same with 2 layers, redundancy off
   and ``hang_device_at``: rank 1 stops itself (SIGSTOP), the census
   attributes the hang after the bound (``device_hang``), the disk
   checkpoint is restored, bit-equal the same way; the script kills the
   stopped rank.  Detection seconds, ``reshard_ms`` and each batch's ms
   are printed.  20c: `resnet50_v1()` at its published widths, exported
   (each convolution and dense layer named after its weights, as MXNet's
   export names them), calibrated (``naive``) on INT8["calib"] batches of
   32 x 224 and quantized with the first convolution and the dense head
   excluded, as MXNet's ``imagenet_gen_qsym.py`` does; served by
   `Predictor` on the card beside the fp32 export, p50 and images/s of
   each, in turns.  Three int8 convolutions (the first, and the first of
   the two widest reductions, K 2304 and 4608) at their real inputs give
   int32 sums bit-equal to the port's CPU path and to the op run
   eagerly on the card; the whole int8 model at INT8["cpu_batch"] within
   INT8_CPU_TOL of the CPU path.  20d: every case of
   `tests/torch_contrib_cases.py` (the 57 names of the contrib ops, int8
   included) on the card against the port's CPU path within CONTRIB_TOL
   (integer outputs exactly; the samplers by structure); SSD-300's head
   (SSD300: 8732 anchors, batch 32, 20 classes and background,
   ``nms_threshold`` 0.45, ``nms_topk`` 400) through MultiBoxPrior,
   MultiBoxTarget (hard-negative mining) and MultiBoxDetection, the card
   against the CPU path (anchors, box masks, positives and detections
   equal, box targets within CONTRIB_TOL, SSD_NEG_OVERLAP of the hard
   negatives shared); then `example/ssd/train_ssd.py`'s SSDNet and loss,
   SSD_TRAIN["steps"] SGD steps on its synthetic shapes, the loss must
   fall.  K1-K3 launch once per layer a step in 20a-b.
21. the front end (`gluon.contrib`, `contrib`, `rtc`, the rest).  21a:
   the LSTM-2048-512 language model of Jozefowicz et al., "Exploring the
   Limits of Language Modeling" (arXiv 1602.02410), on One Billion Word at
   its published widths (LM1B: vocabulary 793,471, embedding 512 through
   `gluon.contrib.nn.SparseEmbedding`, one `LSTMPCell` of 2048 projected
   to 512 inside a `VariationalDropoutCell`, bptt 20, batch 128, sampled
   softmax over 8192 ``rand_zipfian`` negatives with the log-expected-
   count correction as `example/rnn/sampled_softmax_lm.py` scores,
   Adagrad at lr 0.2 with eps 1; ~823 M parameters, random from the seed,
   on a Zipf Markov token stream from the seed): one step at dropout 0
   gives every parameter's gradient within LM1B_TOL of the same step in
   float64 on the card (the same sampled ids); the full-softmax
   evaluation at 16 x 20 has a finite perplexity, its log-probs within
   LM1B_TOL of float64, and hybridized (each cell step, the embedding and
   the softmax layer CUDA graph replays) within CAPTURE_TOL of eager; then
   LM1B["steps"] Adagrad steps with dropout 0.1 must lower the loss on a
   fixed batch and fixed samples; the step's ms and tokens/s, the eval's
   ms and the peak memory are printed.  21b: `resnet50_v1()` at its
   published widths exported by Gluon, written by
   `contrib.onnx.export_model` on the card and on the CPU (the same bytes),
   read back by `import_model` and served by `Predictor` at batch 32 x
   224 within ONNX_TOL of the Gluon net's own outputs; the p50.  21c:
   `SVRGModule` with `LinearRegressionOutput` on YearPredictionMSD's 90
   features, synthetic from the seed, at 46,372 rows (a tenth of its
   463,715 training rows, cut for the time limit), batch 100, a full pass
   every 2 epochs, 4 epochs of SGD, shuffle off: the weights within
   SVRG_TOL of the CPU path, the last epoch's training MSE within 2x of
   numpy's least squares, one TSV row a batch from
   `contrib.tensorboard.LogMetricsCallback`.  21d: MXNet's
   `rtc.CudaModule` example (``axpy``) compiled by NVRTC for sm_90a at
   RTC_N elements, ``y`` equal to ``y + alpha * x`` read by a torch op on
   the same stream without a synchronize; ``axpy<float>`` and
   ``axpy<double>`` through ``exports``; a compile error raises with
   NVRTC's log; the compile ms.  21e: every `gluon.contrib` block and
   cell at small shapes, eager and hybridized, a `CustomEmbedding` of a
   10,000 x 300 file written from the seed (``idx_to_vec`` on the card
   equal to the file's rows), `resource`'s temp spaces and streams,
   `runtime.Features()` with CUDA, and a `TorchBlock` around a torch
   ``nn.Sequential`` inside a Gluon net (the input's storage reaches the
   torch module) on the card against the CPU path within FRONT_TOL.  No
   TPU kernel lies on this phase's path: `LSTMPCell` splits its gates
   with ``split``, which the graph optimizer's LSTM matcher does not
   take, in either package.
22. mixed precision and the repaired ops.  22a: BERT-base MLM at its
   published widths in bfloat16 (`bert_mlm(dtype="bfloat16")`: both
   embedding tables bf16, so every weight after them; dropout 0), batch
   MP_FIT["batch"] x MP_FIT["seq"], weights from the seed, through
   ``Module.fit`` under MXNet's mixed-precision recipe, SGD with momentum
   0.9 and ``multi_precision`` (fp32 master copies and momenta), for
   MP_FIT["steps"] steps.  First K1, K2 and K3 in bf16 at this path's
   [8, 12, 512, 64] against their plain versions (phases 3 and 3b's
   checks), timed (call and device times) beside their bounds and
   PyTorch's fused attention.  Each fit step must be taken by
   `Module.fused_step` as one CUDA graph (the warm-up, then replays) and
   launch K1-K3 once per layer, in their bf16 instantiation by the
   profiler's trace of one replay (each as its wgmma kernel:
   ``flash_attn_fwd_wgmma_kernel``, ``flash_attn_bwd_dq_wgmma_kernel``,
   ``flash_attn_bwd_dkv_wgmma_kernel``, and no other); the captured
   steps must leave the weights, the fp32 master copies and the momenta
   bit-equal to as many eager per-parameter steps
   (``MXTPU_FUSED_STEP=0``: the ``mp_sgd_mom_update`` op per parameter),
   and each step's loss within MP_LOSS_TOL of the same steps in fp32.
   The captured and the eager step's ms are printed (MP_FIT["timed"]
   steps each).  22b: `linalg_potrf`'s gradient on a POTRF_N x POTRF_N SPD
   matrix (the symmetric part's Cholesky factor, as the JAX package's) on
   the card within POTRF_TOL of the CPU path, and in float64 within
   POTRF_FD_TOL of central differences of the forward; `Ftrl` through
   ``Module.fit`` on MXNet's MNIST MLP (FTRL_FIT), the captured step
   bit-equal to the eager one (weights, z and n).

The time limit: phase 20 came with cuts elsewhere (18a-b at 4 of
BERT-base's 12 layers and DIST_ASYNC_STEPS 2 of 4, the serving phases'
``TIMED`` and ``LSTM_TIMED`` counts halved, 19c at 2 of 3 steps).  Phase
21 came with these: the kernels build on a thread while phases 8, 9, 12
and 13, which launch none of them, run first (they share the host with
``nvcc`` for it); FLEET_REQUESTS and FLEET_CHAOS_REQUESTS at 100; 18a-b
at DIST_LAYERS 2, 11c at CKPT_LAYERS 4 and 20a at 4 of BERT-base's 12
layers.  Phase 22 came with these: 11c, 19e and 20a at 2 of BERT-base's
12 layers, FLEET_REPLICAS 2, and the autoscaler's ``max_replicas`` 2 (the
whole script had run 1334.7 s of command on a slow host before them).
Phase 3's bf16 cases and device times came with these: 19c at 4 of
BERT-base's 12 layers, and 19e at PREEMPT["layers"] as phase 22 meant
(`phase_spmd` had handed it the whole model; the whole script ran 1132 s
of command before the 19c cut).  Phase 3b's bf16 cases (every head dim,
ragged lengths, a negative scale, a misaligned view) came with K2's and K3's
wgmma backward, about 15 s.  If the run nears its limit again, cut
19c's all-reduce run before anything else of the training phases.

The line before the last is the JSON kernel report: K1-K3 (their fp32
kernels, launched on every path but 22a's; K1's named
``flash_attn_fwd_tf32``, its TF32 wgmma kernel) with phase 3's and 3b's
BERT-base records, K1-K3's bf16 wgmma kernels (``*_wgmma``, launched on
22a's path) with 22a's records, and K4; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.model_zoo import (BERT_BASE, DCGAN,  # noqa: E402
                                       PTB_LSTM, bert_encoder, bert_mlm,
                                       foreach_lm, greedy_decoder,
                                       lm_weight_names, lstm_lm, lstm_step,
                                       random_params)
from mxnet_tpu_torch.gluon.model_zoo import vision  # noqa: E402
from mxnet_tpu_torch.ndarray.ndarray import NDArray  # noqa: E402
from mxnet_tpu_torch.graph_compile import CapturedGraph, warm_up  # noqa: E402
from mxnet_tpu_torch.ops import cuda_build, hopper_kernels as hk  # noqa: E402
from mxnet_tpu_torch.ops import rnn_op  # noqa: E402
from mxnet_tpu_torch import io_native  # noqa: E402
from mxnet_tpu_torch.ops.registry import Attrs  # noqa: E402
from mxnet_tpu_torch.serialization import dumps_ndarrays  # noqa: E402

SEED = 0
# H100 SXM data-sheet peaks (dense): HBM bytes/s; fp32 FLOP/s outside the
# tensor cores (K4's elementwise work)
MEM_BPS = 3.35e12
FP32_FLOPS = 67e12
# the attention kernels' products: an fp32-accurate product on this card
# is three TF32 tensor-core passes (split operands), 495 / 3 TFLOP/s, which
# beats the 67 TFLOP/s outside the tensor cores; bf16 at the bf16 rate
ATTN_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# device times: back-to-back calls a captured CUDA graph holds, and its
# timed replays (`device_ms`)
DEVICE_CALLS, DEVICE_REPLAYS = 20, 10
# attention gradients: the reference's own tolerance (tests/test_pallas.py,
# rtol = atol = 2e-3) in fp32; bf16 relative to the gradient's largest
# magnitude
GRAD_TOL = 2e-3
BF16_GRAD_TOL = 2e-2
# fp32 K2/K3 are also held within SPLIT_TF32_TOL of the gradient's largest
# magnitude: emulated on phase 3b's fp32 shapes (tests/test_torch_kernels.py),
# the three TF32 passes stay below 1e-5 of it and one TF32 pass goes above
# 3e-4, so this limit fails a kernel that has lost its small parts
SPLIT_TF32_TOL = 1e-4
# fp32 K1 is also held within K1_SPLIT_TOL of O's largest magnitude:
# emulated on phase 3's fp32 shapes (tests/test_torch_kernels.py), the three
# TF32 passes stay below 2e-6 of it and one TF32 pass goes above 3e-4 (the
# 2e-4 absolute tolerance alone lets some one-pass cases through)
K1_SPLIT_TOL = 2e-5
# fp32 K1's O must carry no drift toward zero: mean((o - o_ref)·sign(o_ref))
# over mean |o_ref| above -K1_BIAS_TOL.  The tensor cores truncate as they
# accumulate.  At [96, 512, 64] on the H100, an O summed in one tensor-core
# accumulator over the sequence drifted by 3.4e-6 (within K1_SPLIT_TOL, yet
# it put the training gradients past their limit); the kept sums of 4
# chunks read 5.5e-7, sums of 8 read 7.4e-7 (PERF.md)
K1_BIAS_TOL = 1.5e-6
# fp32 K2/K3's dq, dk and dv must carry no more drift toward zero than
# their design does: their signed bias mean((g - g_ref)·sign(g_ref)) over
# mean |g_ref| above -K23_BIAS_TOL for sums of up to K23_BIAS_TERMS terms,
# and above -K23_BIAS_TOL times terms / K23_BIAS_TERMS for longer ones (dq
# sums over the keys, dk and dv over the queries).  Each is summed in one
# tensor-core accumulator, which truncates as it adds (see K1_BIAS_TOL),
# so the drift grows with the sum's length.  On the H100 the first reading
# of phase 3b's fp32 cases (sums of 64-512 terms) put every bias below
# zero, the worst -4.5e-6 (dk at BERT-base's causal [8, 12, 512, 64]); at
# a ring hop's 4096 terms dq, dk and dv read -1.0e-5 to -3.1e-5 (6.8x the
# drift for 8x the terms; PERF.md).  The limit leaves about twice the
# drift at each length: a kernel that lost its TF32 small parts, or that
# drifted faster per add, breaks it
K23_BIAS_TOL, K23_BIAS_TERMS = 1e-5, 512
# 12 LayerNorm'd layers of fp32 sums taken in another order
SLICE_TOL = 1e-3
# a captured forward (a CUDA graph replay) against the same program run
# eagerly: the same kernels on the same inputs, within CAPTURE_TOL of the
# output's largest magnitude
CAPTURE_TOL = 1e-6
# the spin kernels of the graph replayed first in `replay_launches`'s
# profiled region
SETTLE_KERNELS = 8
# requests timed per bound sequence length, after the checked ones and one
# warm-up
TIMED = {512: 50, 128: 200}
# training slice: each parameter's gradient against the unfused graph's,
# relative to its largest magnitude (the reference's attention-gradient
# tolerance); the key biases, zero in exact arithmetic, are held below
# KEY_BIAS_TOL of the largest gradient of all
TRAIN_GRAD_TOL = 2e-3
KEY_BIAS_TOL = 1e-5
TRAIN_STEPS, WARM_STEPS, TIMED_STEPS = 20, 2, 20
# BERT's published Adam settings, in MXNet's L2 form of weight decay
ADAM = dict(learning_rate=1e-4, wd=0.01, beta2=0.999, epsilon=1e-6)
ATTN_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
# their fp32 instantiations' names in a profiler trace (K1 on three-pass
# TF32 wgmma, K2 and K3 on mma.sync); the bf16 ones are
# ``<name>_wgmma_kernel``
FP32_KERNEL = {"flash_attn_fwd": "flash_attn_fwd_tf32_kernel",
               "flash_attn_bwd_dq": "flash_attn_bwd_dq_kernel",
               "flash_attn_bwd_dkv": "flash_attn_bwd_dkv_kernel"}
K1_FP32 = FP32_KERNEL["flash_attn_fwd"]
# phase 17: steps of the fold (17a), CUDA-event rounds per step time
# (17b), the MNIST MLP's steps and batch (17c, example/gluon/mnist's
# batch), the matrix factorization at MovieLens-10M's id ranges with the
# example's factor and hidden widths and Adam's lr (17d), and the
# tolerance of 17c-17d's parameters and gradients against one context,
# of their largest magnitudes
CTX_FOLD_STEPS, CTX_TIMED = 3, 5
CTX_MLP_STEPS, CTX_MLP_BATCH = 5, 100
MF = dict(users=71567, items=65133, factor=128, hidden=128, batch=256,
          lr=0.02)
CTX_MF_STEPS = 20
CTX_TOL = 1e-5
# fit phase: FIT_BATCHES fixed batches, FIT_EPOCHS epochs; FIT_K captured
# steps against as many eager ones, whose weights must agree within FIT_TOL
# of each parameter's largest magnitude; FIT_TIMED steps timed per path
FIT_BATCHES, FIT_EPOCHS, FIT_K, FIT_TIMED = 4, 3, 4, 10
FIT_TOL = 1e-5
FIT_WARMUP, FIT_MAX_UPDATE = 2, 100
# K4 against its plain version: the reference's LSTM-gate tolerance
# (tests/test_pallas.py:68) in fp32; bf16 in either input compared in fp32
# after the cast
LSTM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# operations per (b, j) of K4, counted from its source: 3 sigmoids (exp,
# add, divide) and 2 tanh at one each, 2 multiplies and an add for c', a
# multiply for h'
LSTM_OPS = 3 * 3 + 2 + 3 + 1
# the served LSTM LM against its unfused graph: 2·T recurrent applications
# of the cell, so the 1e-5 per-step tolerance is loosened to 1e-4
LSTM_SLICE_TOL = 1e-4
# LSTM LM: requests timed per bucket, after the checked ones and one warm-up
LSTM_BATCH = 32
LSTM_TIMED = {60: 50, 10: 200}
# Gluon ResNet-50: serving batch and requests timed per way; training batch,
# warm-up and timed steps; the train_cifar10.py optimizer settings, the lr
# reached by a linear ramp over the 12 updates: at a constant 0.05 (8x the
# linear-scaling rate of the ImageNet recipe at batch 32) the loss fell
# over 12 steps in 3 runs of 10, with the ramp in 7 of 7
# (tools/torch_resnet_diag.py lr; NVIDIA H100 80GB HBM3, 700 W)
RESNET_BATCH, RESNET_TIMED = 8, 200
RESNET_TRAIN_BATCH, RESNET_WARM, RESNET_STEPS = 32, 2, 10
RESNET_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4)
# a replay runs the same cuDNN calls as the imperative forward
RESNET_CAPTURE_TOL = 1e-6
# the exported graph with its 53 BatchNorms folded into the convolutions
RESNET_EXPORT_TOL = 1e-3
RESNET_BN = 53
# cuDNN's fp32 convolutions (TF32 off) against float64: every convolution
# of the training step, fed the float64 step's own inputs and output
# gradients, gives its output, input gradient and weight gradient within
# RESNET_GRAD_TOL of their largest magnitudes.  The whole step's fp32
# gradients are held against the float64 step by their norm, BatchNorm on
# its moving statistics.  Element by element they are not: a ReLU input
# or a max-pool pair within fp32 rounding of its switching point routes a
# gradient elsewhere (the stem's output gradient read 8.0e-2 off at one
# element, its weight gradient 4.8e-3, while cuDNN's weight gradient on
# the same inputs was within 9.0e-7), and in train mode random-init
# ResNet-50's batch statistics make it worse (1.3e-1; alike with cuDNN's
# deterministic algorithms and with cuDNN off) (tools/torch_resnet_diag.py
# stem and grads; NVIDIA H100 80GB HBM3, 700 W).
# Those element-wise errors are printed, not held.  A convolution bias
# that feeds a train-mode BatchNorm has a gradient that is zero in exact
# arithmetic and is measured relative to its weight's gradient instead
RESNET_GRAD_TOL = 2e-3
# phase 9, the other vision families: the served models at their
# published widths (name, image side), the serving batch, and the requests
# timed per way after one warm request
ZOO_SERVE = (("alexnet", 224), ("vgg16", 224), ("vgg16_bn", 224),
             ("densenet121", 224), ("squeezenet1.1", 224),
             ("mobilenetv2_1.0", 224), ("inceptionv3", 299))
ZOO_BATCH, ZOO_TIMED = 8, 50
# Inception-v3 training (docs/faq/perf.md:66,177,190 in the reference
# measure it at batch 32): ZOO_SAMPLES synthetic images, reshuffled at each
# pass, fed by one DataLoader iterator (2 worker threads) over every step:
# 2 warm-up and ZOO_STEPS timed steps with phase 8's SGD and lr ramp.  The
# loader's wait is read in steady state, after the timed steps' first
# ZOO_PREFETCH (the batches it fetched ahead during the warm-up); it is
# also timed alone over ZOO_LOADER_BATCHES batches
ZOO_TRAIN_BATCH, ZOO_SAMPLES = 32, 64
ZOO_WARM, ZOO_STEPS, ZOO_PREFETCH, ZOO_LOADER_BATCHES = 2, 14, 4, 10
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# the captured training step against the eager one on the same batch with
# the same Dropout masks (the generator reseeded before each): the loss
# within ZOO_LOSS_TOL relative, all gradients together within
# ZOO_GRAD_TOL of their norm.  cuDNN's backward picks nondeterministic
# algorithms (PERF.md), so two eager steps differ too; both figures print
ZOO_LOSS_TOL = 1e-6
ZOO_GRAD_TOL = 1e-4
# the trained net's export through `SymbolBlock.imports` against the
# hybridized net (the same ops in one graph); through `Predictor` with its
# BatchNorms folded into the convolutions, RESNET_EXPORT_TOL
ZOO_IMPORT_TOL = 1e-5
# CTC at an OCR-like shape: T steps, N sequences, 37 classes and the blank,
# labels of 4-20; the card's fp32 loss and gradient against the port's op
# on the CPU in float64; CTC_TIMED calls timed per way
CTC_T, CTC_N, CTC_C, CTC_LABELS = 80, 32, 38, (4, 20)
CTC_TIMED = 10
CTC_TOL = 1e-4
# phase 10, the RNN package.  10a: the RNN op (cuDNN's RNN) against its
# step loop on the card, every mode at 1 and 2 layers, one and two
# directions, at the LM's (T, N, C, H) and an odd small one.  Outputs and
# states within LSTM_SLICE_TOL of their largest magnitude (phase 6's
# recurrent limit); the gradients of data, parameters and states within
# RNN_GRAD_TOL of theirs: they run back through the same T steps of fp32
# sums taken in another order, so they get the outputs' loosened limit.
# rnn_relu's gradients are held within RNN_RELU_GRAD_TOL of their norm,
# their element-wise error printed beside each fp32 path's error against
# the loop in float64 and the ReLU outputs that switched against it: a
# ReLU input within fp32 rounding of 0 routes its gradient elsewhere.  At
# the LM's shape, 2 layers, both directions, cuDNN switched 1 of the
# 768,000 visible outputs, the loop none, and the op's gradients lay
# 3.0e-3 from the loop's (and from float64) at one element and 1.7e-4 by
# norm, while every other case agreed within 2.4e-5 (this phase on an
# NVIDIA H100 80GB HBM3, 700 W; PERF.md).  The other modes run the same
# cuDNN products, held element-wise, so a fault in the products' precision
# shows there.  RNN_TIMED calls timed per way for the op's p50.
RNN_OP_SHAPES = ((60, 32, 200, 200), (7, 3, 13, 13))
RNN_GRAD_TOL = 1e-4
RNN_RELU_GRAD_TOL = 1e-3
RNN_TIMED = 20
# 10b: the reference's example/rnn/bucketing/lstm_bucketing.py at its
# defaults (FusedRNNCell(200, 2 layers), embed 200, vocab 10000, batch 32,
# buckets 10-60, Xavier(factor_type='in', magnitude=2.34), Perplexity(0),
# SGD lr 0.01, momentum 0, wd 1e-5) on synthetic Markov sentences: a
# Zipfian successor table of RNN_SUCCESSORS next words per word, each
# sentence's length drawn within one bucket, RNN_SENTENCES of them per
# bucket, RNN_EPOCHS epochs; RNN_STEP_TIMED steps timed per bucket
RNN_BUCKETS = (10, 20, 30, 40, 50, 60)
RNN_BATCH, RNN_SENTENCES, RNN_EPOCHS = 32, 128, 3
RNN_SUCCESSORS, RNN_ZIPF = 4, 1.1
RNN_SGD = dict(learning_rate=0.01, momentum=0.0, wd=1e-5)
RNN_STEP_TIMED = 10
# 10d: the reference's example/gluon/word_language_model at its defaults:
# Embedding(10000, 200) -> Dropout(0.2) -> LSTM(200, 2 layers, dropout
# 0.2) -> Dropout(0.2) -> Dense(10000); bptt 35, batch 32, SGD lr 20 on
# the loss averaged over the bptt·batch tokens, the gradients' global norm
# clipped to 0.2 (the example's ``L / (bptt * batch_size)``,
# ``clip_global_norm(grads, clip)``, ``trainer.step(1)``), the states
# detached between batches
WORD_LM = dict(vocab=10000, embed=200, hidden=200, layers=2, dropout=0.2)
WORD_BPTT, WORD_BATCH, WORD_LR, WORD_CLIP, WORD_STEPS = 35, 32, 20.0, 0.2, 16
# phase 18: steps of 18a (and of 18b's first part), 18b's asynchronous
# steps with the server's Adam, 18c's steps, the tolerance of 18c's weight
# against the local store's, the worker script, the launcher, and each
# job's time limit
DIST_STEPS, DIST_ASYNC_STEPS, EMBED_STEPS = 3, 2, 20
# 18a-b's BERT: BERT-base's widths at 2 of its 12 layers (cut for the
# script's time limit: to 4 when phase 20 came, to 2 with phase 21; K1-K3
# once per layer a step)
DIST_LAYERS = 2
EMBED_TOL = 1e-6
DIST_WORKER = os.path.join(HERE, "tests", "torch_bert_dist_worker.py")
DIST_LAUNCH = os.path.join(HERE, "tools", "launch.py")
DIST_TIMEOUT = 420
# phase 19: steps of each trained path; ResNet-50 v1 at its published
# widths (19a); the ring LM at BERT-base's attention widths (19b, head dim
# 64, train_ring_lm.py's vocab; its lr of 1e-2, made for width 64, drove
# the loss up at width 768 on the card, so 1e-3); phase 5's BERT-base MLM
# (19c at 4 of its 12 layers, 19e at PREEMPT["layers"]);
# train_pipeline_moe.py's run_pipeline and run_moe (19d, fewer steps);
# 19e's batches, the step its fault plan poisons, the batch after which
# the child takes its SIGTERM
SPMD_STEPS = 3
SPMD_RESNET = dict(batch=32, side=224, classes=1000, steps=SPMD_STEPS,
                   lr=0.01, reference=False)
RING_LM_CARD = dict(vocab=32, dim=768, heads=12, seq_len=8192, batch=1,
                    lr=1e-3, steps=SPMD_STEPS)
SPMD_BERT = dict(batch=8, seq=512, steps=2, cfg=dict(num_layers=4))
PIPE_CFG = dict(stages=2, micro=8, batch=4, width=16, steps=20, lr=0.3)
MOE_CFG = dict(tokens=128, width=16, hidden=32, experts=4, steps=30, lr=0.3)
# 19e at 2 of BERT-base's 12 layers (cut for the time limit when phase 22
# came)
PREEMPT = dict(batches=6, poison_at=2, sigterm_after=3, layers=2)
# phase 19's limits: 19a's float64 weights after SPMD_STEPS steps
# (SPMDTrainer against gluon.Trainer on one rank, two ranks against one),
# max |diff| over each array's largest magnitude; 19b's outputs and first-step
# gradients at sp 2 against sp 1 (tests/test_pallas.py:25,51's tolerances);
# 19c's weights at two ranks against one (and the one-rank sharded step
# against the unified one); 19d's loss trajectories at two ranks against
# one rank
SPMD_RESNET_TOL = 1e-6
# ResNet-50's bottleneck convolutions feed BatchNorm, so their biases take
# a zero gradient in exact arithmetic: float64 arrays no larger than this
# hold rounding noise alone and are left out of 19a's comparison
SPMD_ZERO_FLOOR = 1e-9
RING_OUT_TOL, RING_GRAD_TOL = 2e-4, 2e-3
SPMD_FIT_TOL = 1e-4
PIPE_TOL = 1e-4
SPMD_TIMEOUT = 600
SPMD_ENTRY = "import sys, chip_smoke as cs; cs.spmd_worker(sys.argv[1])"
PREEMPT_ENTRY = "import sys, chip_smoke as cs; cs.preempt_child(sys.argv[1])"
# phase 20: 20a-b, the elastic mesh: phase 19c's BERT-base MLM fit (2
# batches an epoch, 2 epochs) on two ranks, the second lost at step 3's
# probe (ELASTIC_LOSS_STEP: epoch 1's first), 20a with 2 layers (all 12
# until phase 21 came and the time limit cut them to 4, phase 22 to 2), the
# buddy copy and a
# kill, 20b with 2 layers, no redundancy and a stopped rank; the probe's
# bound, and the launcher's time limit for each
ELASTIC = {"a": dict(layers=2, batch=8, seq=512, redundancy=1,
                     fault="kill_device_at"),
           "b": dict(layers=2, batch=8, seq=512, redundancy=0,
                     fault="hang_device_at")}
ELASTIC_LOSS_STEP = 3
ELASTIC_STEP_TIMEOUT_S = 10.0
ELASTIC_TIMEOUT = 900
ELASTIC_ENTRY = "import sys, chip_smoke as cs; cs.elastic_worker(sys.argv[1])"
# 20c: resnet50_v1 at its published widths, int8: the calibration
# batches, the timed requests a predictor (in turns with fp32), the batch
# of the whole-model check against the CPU path and its limit (max |diff|
# over the largest logit: the card's float layers round apart from the
# CPU's, and an int8 payload one level apart moves a logit by its scale)
INT8 = dict(batch=32, side=224, classes=1000, calib=2, timed=10,
            cpu_batch=2)
INT8_CPU_TOL = 0.05
# 20d: the contrib cases on the card against the CPU path (1e-5 of the
# largest magnitude, the op sweep's; integer outputs exactly); SSD-300's
# head from MXNet's example/ssd (VGG16-reduced at 300: feature maps
# 38/19/10/5/3/1, their sizes, ratios and steps; 8732 anchors; VOC's 20
# classes and background; batch 32); the share of hard negatives the card
# and the CPU must agree on (the mining ranks a softmax, whose sums round
# apart); train_ssd.py's SSDNet, its steps and batch
CONTRIB_TOL = 1e-5
SSD300 = [(38, (0.1, 0.141), (1, 2, 0.5), 8 / 300),
          (19, (0.2, 0.272), (1, 2, 0.5, 3, 1 / 3), 16 / 300),
          (10, (0.37, 0.447), (1, 2, 0.5, 3, 1 / 3), 32 / 300),
          (5, (0.54, 0.619), (1, 2, 0.5, 3, 1 / 3), 64 / 300),
          (3, (0.71, 0.79), (1, 2, 0.5), 100 / 300),
          (1, (0.88, 0.961), (1, 2, 0.5), 1.0)]
SSD300_BATCH = 32
SSD300_CLASSES = 20
SSD_NEG_OVERLAP = 0.999
SSD_TRAIN = dict(steps=20, batch=32, image=64)
# phase 21a: the LSTM-2048-512 language model of Jozefowicz et al.,
# "Exploring the Limits of Language Modeling" (arXiv 1602.02410), on One
# Billion Word at its published widths: vocabulary 793,471, embedding 512,
# one LSTMP layer of 2048 projected to 512, bptt 20, batch 128, sampled
# softmax over 8192 log-uniform negatives, Adagrad at lr 0.2 with eps 1
# and dropout 0.1 (MXNet's example/rnn/large_word_lm settings for this
# model); one layer (the paper's model), 5 steps
LM1B = dict(vocab=793471, embed=512, hidden=2048, proj=512, bptt=20,
            batch=128, sampled=8192, lr=0.2, eps=1.0, dropout=0.1, steps=5,
            eval_batch=16, init=0.05)
# a gradient or a log-prob against the same step run in float64, over its
# largest magnitude
LM1B_TOL = 1e-4
# 21b: the ONNX round trip of resnet50_v1 served at batch 32
ONNX_BATCH = 32
ONNX_TOL = 1e-5
ONNX_TIMED = 10
# 21c: YearPredictionMSD's 90 features, synthetic from the seed, at a
# tenth of its 463,715 training rows (cut for the time limit); batch 100,
# a full-gradient pass every 2 epochs, 4 epochs, SGD
SVRG_CFG = dict(rows=46372, features=90, batch=100, update_freq=2,
                epochs=4, lr=0.05)
SVRG_TOL = 1e-5
# 21d: MXNet's rtc example kernel over 2^24 elements
RTC_N = 1 << 24
# 21e: the contrib blocks, cells and the rest at small shapes, the card
# against the port's CPU path over the largest magnitude
FRONT_TOL = 1e-5
EMBED_FILE = dict(tokens=10000, dim=300)
# phase 22a: BERT-base MLM in bfloat16 through Module.fit under MXNet's
# mixed-precision recipe (SGD, momentum 0.9, multi_precision): MP_FIT's
# steps captured, eager and in fp32, then timed steps each way; the bf16
# losses against the fp32 run's, relative
MP_FIT = dict(batch=8, seq=512, steps=3, timed=10, lr=0.01)
MP_LOSS_TOL = 2e-2
# 22b: linalg_potrf's gradient on a POTRF_N x POTRF_N SPD matrix, the card
# against the CPU path over its largest magnitude; the card's float64
# gradient against central differences (step POTRF_EPS) in float64
POTRF_N, POTRF_EPS = 64, 1e-6
POTRF_TOL, POTRF_FD_TOL = 1e-5, 1e-6
# 22b: MXNet's MNIST MLP (example/image-classification/symbols/mlp.py, the
# batch of train_mnist.py) on MNIST-shaped data from the seed, under Ftrl
FTRL_FIT = dict(features=784, batch=64, batches=4, lr=0.1, lamda1=0.01)
# phase 11a: the reference's example/sparse/linear_classification.py
# local-store loop at the width of LIBSVM's avazu-app (1,000,000 features)
# and the example's batch 8192 and lr; rows one-hot in 15 fields with
# Zipf-skewed categories (a chosen density: the repo holds no Avazu data)
AVAZU = dict(dim=1_000_000, batch=8192, steps=64, nnz=15, lr=4.0,
             pull_ids=4096)
AVAZU_ZIPF = 1.1
# products and the trained weight against float64, relative to the largest
# magnitude of the float64 result
SPARSE_TOL = 1e-5
SPARSE_TIMED = 20
# phase 11b: tests/test_sparse_fm_train.py's factorization machine at the
# widths of the reference's tests/python/train/test_sparse_fm.py, with
# that test's optimizers, epochs and MSE thresholds
FM = dict(dim=10000, factor=4, batch=64, batches=5, density=0.1)
FM_RUNS = (("sgd", 18, 0.02), ("adam", 10, 0.05), ("adagrad", 20, 0.09))
# phase 11c: the seconds each checkpoint commit waits before its manifest
# in the child that is killed (the window it is killed in), and a child's
# time limit
CKPT_COMMIT_DELAY = 5.0
CKPT_CHILD_TIMEOUT = 600
# 11c's BERT: BERT-base's widths at 2 of its 12 layers (cut for the
# script's time limit: to 4 when phase 21 came, to 2 when phase 22 came)
CKPT_LAYERS = 2
# how 11c starts a child (a CPU rehearsal puts its own entry here)
CHILD_ENTRY = "import sys, chip_smoke as cs; cs.ckpt_child(sys.argv[1])"
# phase 7's record, which 11d prints its step beside
FIT_RECORD = {}
# phase 12a: the CPU sweep's cases (tests/torch_sweep_cases.py) on the card
# in fp32, forward and gradient, against the port on the CPU in float64,
# each output and gradient within its tolerance of the float64 result's
# largest magnitude: SWEEP_TOL, and SWEEP_FACTOR_TOL for the
# factorizations and solves (cuSOLVER against LAPACK; their worst read
# 6.2e-7, syevd's, on an NVIDIA H100 80GB HBM3 at 700 W); an eigenvector
# is compared with its sign aligned
SWEEP_TOL = 1e-5
SWEEP_FACTOR_TOL = 2e-5
SWEEP_FACTOR_OPS = frozenset({
    "linalg_potrf", "linalg_potri", "linalg_trsm", "linalg_inverse",
    "linalg_det", "linalg_slogdet", "linalg_syevd", "linalg_gelqf",
    "linalg_sumlogdiag"})
# phase 12b: samples per distribution, and the least p-value of its KS or
# chi-square test against scipy.stats
SAMPLER_N = 10_000_000
SAMPLER_P = 1e-3
# phase 12c: MXNet's DCGAN (model_zoo.DCGAN: Z 100, ngf = ndf = 64, nc 3,
# 64 x 64, batch 64, Adam lr 0.0002 beta1 0.5, Normal(0.02)); one fp32
# iteration's gradients within DCGAN_GRAD_TOL of the float64 iteration's
# by their norm, D's outputs within DCGAN_OUT_TOL; then DCGAN_WARM +
# DCGAN_TIMED iterations, D's BCE losses on real and on fake each moving
# by more than DCGAN_LOSS_MOVE from the first iteration's.  The float64
# iteration takes each ReLU and LeakyReLU element's branch from the card's
# fp32 iteration: an element within fp32 rounding of zero may switch
# between the two, and one switch routes a gradient elsewhere.  Unpinned,
# the gradients read 2.4e-6, 2.2e-3 or 8.4e-3 from float64 by norm in
# processes alike, with cuDNN's default, deterministic or benchmarked
# algorithms and with TF32 forced off, while each of the ten
# convolutions alone at its shape read within 1.6e-6 in every such
# process (tools/torch_dcgan_diag.py; NVIDIA H100 80GB HBM3, 700 W).  A
# switched element must lie within DCGAN_SWITCH_TOL of its layer's
# largest magnitude from zero.
DCGAN_GRAD_TOL = 1e-5
DCGAN_SWITCH_TOL = 1e-5
DCGAN_OUT_TOL = 1e-4
DCGAN_WARM, DCGAN_TIMED = 2, 20
DCGAN_LOSS_MOVE = 0.01
# phase 13a: the optimizers at ResNet-50 v1's parameter set, OPT_STEPS
# steps in fp32 against float64, each array within OPT_TOL of its
# largest float64 magnitude; where an element's update turns on a sign or
# a threshold (OPT_DECISIONS), an element whose decision lies within
# rounding may switch: at most OPT_SWITCH_SHARE of the elements may pass
# OPT_TOL.  fp16 weights under multi_precision within OPT_HALF_TOL of
# fp32, their masters within OPT_TOL; the multi_ ops within MULTI_TOL of
# their per-array ops; initializers' stds within INIT_STD_TOL (pooled),
# Orthogonal within ORTHO_TOL of orthonormal
OPT_STEPS = 10
OPT_TOL = 1e-5
OPT_SWITCH_SHARE = 1e-6
OPT_HALF_TOL = 1e-3
OPT_DECISIONS = {"signum", "ftrl"}
OPT_COMMON = dict(learning_rate=0.01, wd=1e-4, rescale_grad=1 / 32,
                  clip_gradient=5.0)
OPT_CASES = {
    "sgd": dict(momentum=0.9), "ccsgd": dict(momentum=0.9),
    "nag": dict(momentum=0.9), "signum": dict(momentum=0.9),
    "adam": dict(learning_rate=1e-3), "adagrad": {}, "rmsprop": {},
    "rmsprop_centered": dict(centered=True), "adadelta": {}, "ftrl": {},
    "adamax": {}, "nadam": {}, "ftml": {}, "dcasgd": dict(momentum=0.9),
    "sgld": {}, "lbsgd": dict(momentum=0.9, warmup_strategy="lars"),
    "test": {}, "groupadagrad": {},
}
MULTI_TOL = 1e-6
INIT_STD_TOL = 0.01
ORTHO_TOL = 1e-4
# phase 13b: the image data plane, trained (example/gluon/
# image_classification.py's feed, fit.py's NAG and Xavier)
IMG_RECORDS, IMG_SIDE, IMG_CLASSES, IMG_QUALITY = 640, 224, 10, 95
IMG_BATCH, IMG_EPOCHS, IMG_TIMED = 32, 2, 12
IMG_NAG = dict(learning_rate=0.025, momentum=0.9, wd=1e-4)
IMG_CHECK_TOL = 1e-6
# phase 14: the PTB LSTM LM of phase 6 (PTB_LSTM, batch 32) with its time
# loop as one sym.contrib.foreach scan at T = CF_T, trained through
# Module.fit for CF_EPOCHS epochs of CF_BATCHES batches of synthetic Markov
# text with phase 10's SGD; outputs held within CF_FWD_TOL and gradients
# within CF_GRAD_TOL of the largest magnitude (the unrolled LM, the served
# logits, the island plan, the Custom head against SoftmaxOutput)
CF_T, CF_BATCH, CF_BATCHES, CF_EPOCHS = 60, 32, 12, 2
CF_FWD_TOL, CF_GRAD_TOL = 1e-5, 1e-4
CF_DECODE_ITERS, CF_DECODE_STEPS = 60, 45
CF_HEAD_STEPS, CF_RESHAPE_T, CF_TIMED = 3, 35, 10
# 14e: calls of a hybridized host-reading block, each with new inputs
CF_HOST_CALLS = 6
# phase 15: BERT-base behind the micro-batcher; 15c's traffic (cut the
# request counts first if the run nears its limit)
SERVE_SEQ = 128
SERVE_LADDER = (1, 2, 4, 8, 16)
SERVE_REQUESTS = 400
SERVE_SWAP_REQUESTS = 200
SERVE_CLIENTS = 4
SERVE_DELAY_MS = 2.0
# a row served alone (rung 1) against itself inside a fuller rung, over its
# largest magnitude: the rungs' GEMMs run at other M, which cuBLAS tiles
# and orders otherwise (1.4e-6 to 2.3e-6 on an H100 at 700 W, over
# CAPTURE_TOL); at one rung the rows are bit-equal
RUNG_TOL = 1e-5
SERVE_RUNG_TIMED = 20
# phase 16: the PTB LSTM LM decoded by the slot arena (the LM's published
# batch of 32 as the arena width), GEN_PROMPTS prompts of GEN_PROMPT_LEN
# tokens of synthetic Markov text asking for GEN_NEW tokens; the fused
# decode cell's step against the unfused one within LSTM_SLICE_TOL
GEN_SLOTS, GEN_CHUNK, GEN_PROMPT, GEN_TOKENS = 32, 16, 64, 128
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW = 128, (4, 64), (8, 128)
GEN_WIRE_REQUESTS = 64
# 16c: replica processes on the one card, phase 15's blob at this ladder;
# FLEET_REQUESTS clean requests, then FLEET_CHAOS_REQUESTS with a SIGKILL
# at router dispatch FLEET_KILL_AT (cut these first if the run nears its
# limit)
FLEET_REPLICAS, FLEET_LADDER = 2, (1, 2, 4, 8)
FLEET_REQUESTS, FLEET_CHAOS_REQUESTS, FLEET_KILL_AT = 100, 100, 40
FLEET_CLIENTS, FLEET_READY_S, FLEET_WAIT_S = 4, 180.0, 120.0
# 16d: the autoscaler from a floor of 1 to at most 2 replicas, a burst of
# SCALE_BURST clients at poll SCALE_SPIKE_AT, the idle window set short
# (the cooldown outlasts the scale-up's spawn, kill and respawn, so the
# burst grows the fleet once and the floor follows soon after it ends)
SCALE = dict(min_replicas=1, max_replicas=2, up_queue_rows=4,
             down_queue_rows=1, idle_window_s=2.0, cooldown_s=30.0,
             interval_s=0.2, warmup_timeout_s=180.0, drain_wait_s=5.0)
SCALE_BURST, SCALE_SPIKE_AT = 16, 3
# 14e: example/module/sequential_module.py's MLP on MNIST-shaped data
SEQ_MLP = dict(features=784, batch=100, steps=5, lr=0.1)
SEQ_TOL = 1e-6
# phase 10's BucketingModule step at the largest bucket, for phase 14
RNN_RECORD = {}


def log(*parts):
    print(*parts, flush=True)


def best_ms(fns, rounds=5, iters=100):
    """Per-call ms of each of ``fns``: the best of ``rounds`` rounds of
    `time_ms` over ``iters`` calls, the functions taking turns in each
    round, so that a slow spell of the host falls on all of them alike
    (host-bound calls, such as K4's at the LM's size, vary by a third from
    one process to the next)."""
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], time_ms(fn, iters=iters))
    return best


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; inputs stay warm in L2 where they fit)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(make, calls=DEVICE_CALLS, replays=DEVICE_REPLAYS):
    """Device time of one call: a CUDA graph captures ``calls``
    back-to-back calls, its ``replays`` replays are timed with CUDA events,
    and the time is divided by the calls, so none of the calls' host time
    (the wrapper, its checks, the launch) is in it.  ``make()`` runs on the
    capture's stream and returns the function to time, so a backward whose
    forward ``make`` runs is captured on the forward's stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn = make()
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    got = os.path.dirname(os.path.abspath(mt.__file__))
    if got != os.path.join(HERE, "mxnet_tpu_torch"):
        raise SystemExit(f"chip_smoke: mxnet_tpu_torch came from {got}, "
                         "not from this checkout")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels are built for sm_90a; "
                         f"this card has capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def _instantiation(entry):
    """``kernel<template args>`` from a mangled entry name, e.g.
    ``flash_attn_fwd_tf32_kernel<Li64ELb0>`` (K1 fp32, D 64, not causal) or
    ``flash_attn_fwd_wgmma_kernel<Li128ELb1>`` (K1 bf16, D 128, causal)."""
    m = re.search(r"\d((?:flash_attn|lstm_gates)\w*?_kernel)I(.*?)EEv", entry)
    return f"{m.group(1)}<{m.group(2).rstrip('E')}>" if m else entry


def phase_build():
    t0 = time.perf_counter()
    logs = cuda_build.build()
    secs = time.perf_counter() - t0
    log(f"build: {len(logs)} kernel source(s) in {secs:.2f} s")
    for name, text in logs.items():
        entry = name
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = _instantiation(m.group(1))
            elif "Used" in line or "spill" in line or \
                    "Performance" in line:
                log(f"  {entry}: {line.strip()}")
    return secs


def _attention_bound(q, k, causal):
    """Least time for K1's work on these inputs: each input read once and
    each output written once over HBM, or the operations this mask needs
    over the attention product rate for the input type, whichever is
    larger."""
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    bh = q.numel() // (lq * d)
    elem = q.element_size()
    nbytes = (2 * bh * lq * d + 2 * bh * lk * d) * elem + bh * lq * 4
    pairs = sum(min(i + 1, lk) for i in range(lq)) if causal else lq * lk
    flops = 4.0 * bh * d * pairs
    t_mem = nbytes / MEM_BPS
    t_ops = flops / ATTN_PEAK_FLOPS[q.dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem > t_ops
                                     else "operations")


def check_attention(name, q_shape, lk, dtype, causal, gen, scale=None):
    """K1 against its plain version on one input; returns the record: the
    errors, the call times (``ms``: back-to-back calls through the
    wrapper) and the device times (``device_ms``, `device_ms`) of K1 and
    of PyTorch's fused attention, the bound and its share of the device
    time.  ``scale`` defaults to D^-0.5."""
    d = q_shape[-1]
    kv_shape = tuple(q_shape[:-2]) + (lk, d)
    dev = torch.device("cuda", 0)
    q = torch.randn(q_shape, generator=gen, device=dev).to(dtype)
    k = torch.randn(kv_shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(kv_shape, generator=gen, device=dev).to(dtype)
    scale = d ** -0.5 if scale is None else scale
    o, lse = hk.flash_attention_with_lse(q, k, v, causal=causal,
                                         scale=scale)
    o_ref, lse_ref = hk._flash_attention_with_lse_plain(
        q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    # the library call gets the same tensors as [B, H, L, D] views, the
    # layout it is fastest on
    lib_qkv = (q, k, v) if q.dim() == 4 else (q[None], k[None], v[None])
    err, rel, bias = _forward_err(o, lse, o_ref, lse_ref)

    def kernel():
        return hk.flash_attention_with_lse(q, k, v, causal=causal,
                                           scale=scale)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            *lib_qkv, is_causal=causal, scale=scale)

    rec = {
        "check": name, "q": list(q_shape), "lk": lk,
        "dtype": str(dtype).replace("torch.", ""), "causal": causal,
        "scale": scale,
        "max_abs_err": err, "max_rel_err": rel, "signed_bias": bias,
        "lse_max_abs_err": (lse - lse_ref).abs().max().item(),
        "ms": time_ms(kernel),
        "device_ms": device_ms(lambda: kernel),
        "plain_ms": time_ms(lambda: hk._flash_attention_with_lse_plain(
            q, k, v, causal=causal, scale=scale)),
        "library_ms": time_ms(library),
        "library_device_ms": device_ms(lambda: library),
    }
    rec["bound_ms"], rec["bound_by"] = _attention_bound(q, k, causal)
    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
    log(json.dumps(rec))
    return rec


def _forward_err(o, lse, o_ref, lse_ref):
    """(max |o - o_ref|, the same over max |o_ref|, the signed bias
    mean((o - o_ref)·sign(o_ref)) over mean |o_ref|); O within TOL of its
    dtype (and, in fp32, within K1_SPLIT_TOL of its largest magnitude with
    a bias above -K1_BIAS_TOL), the logsumexp within the fp32 TOL."""
    tol = TOL[o.dtype]
    torch.testing.assert_close(o, o_ref, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    diff, ref = o.float() - o_ref.float(), o_ref.float()
    err = diff.abs().max().item()
    rel = err / ref.abs().max().item()
    bias = ((diff * ref.sign()).mean() / ref.abs().mean()).item()
    if o.dtype == torch.float32:
        if rel > K1_SPLIT_TOL:
            raise AssertionError(f"fp32 K1 output off by {rel} of its "
                                 f"largest magnitude, above {K1_SPLIT_TOL}")
        if bias < -K1_BIAS_TOL:
            raise AssertionError(f"fp32 K1 output drifts toward zero by "
                                 f"{-bias} of its mean magnitude, above "
                                 f"{K1_BIAS_TOL}")
    return err, rel, bias


def _odd_view(t):
    """A contiguous copy of ``t`` whose storage starts one element past a
    16-byte boundary (a view at an odd offset)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    view = flat[1:].view(t.shape)
    if view.data_ptr() % 16 == 0:
        raise AssertionError("the misaligned view is aligned")
    return view


def check_misaligned_forward(gen, dtype=torch.float32):
    """K1 on inputs off 16-byte alignment: the wrapper copies them to
    aligned memory for TMA (both dtypes); O and lse must match
    the plain version."""
    dev = torch.device("cuda", 0)
    shape = (1, 2, 128, 32)
    q, k, v = (_odd_view(torch.randn(shape, generator=gen, device=dev)
                         .to(dtype)) for _ in range(3))
    o, lse = hk.flash_attention_with_lse(q, k, v, causal=True)
    o_ref, lse_ref = hk._flash_attention_with_lse_plain(
        q, k, v, causal=True, scale=shape[-1] ** -0.5)
    torch.cuda.synchronize()
    err, rel, bias = _forward_err(o, lse, o_ref, lse_ref)
    log(json.dumps({"check": "misaligned", "kernel": "flash_attn_fwd",
                    "dtype": str(dtype).replace("torch.", ""),
                    "q": list(shape), "max_abs_err": err,
                    "max_rel_err": rel, "signed_bias": bias}))


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # BERT-base attention as the main path calls it: the graph's
    # (batch * heads, seq, 64) batch_dot entries, at seq 512 and 128
    cases = [("bert_base", (96, 512, 64), 512, torch.float32, False),
             ("bert_base_128", (96, 128, 64), 128, torch.float32, False),
             ("bert_base", (96, 512, 64), 512, torch.float32, True)]
    for causal in (False, True):
        cases.append(("bert_base", (8, 12, 512, 64), 512, torch.bfloat16,
                      causal))
    for causal in (False, True):
        cases += [("small", (2, 3, 256, 16), 256, torch.float32, causal),
                  ("lq_ne_lk", (2, 4, 128, 64), 256, torch.float32, causal),
                  ("d32", (1, 2, 128, 32), 128, torch.float32, causal),
                  # fp32 at D = 128 (one consumer warpgroup, 32-key
                  # tiles) and a ragged Lq (a block's second warpgroup
                  # past the rows)
                  ("d128", (2, 2, 256, 128), 256, torch.float32, causal),
                  ("ragged", (2, 4, 100, 64), 128, torch.float32, causal),
                  ("d128", (2, 2, 256, 128), 256, torch.bfloat16, causal),
                  # bf16 at every head dim the wgmma kernel is built for
                  # (32- and 64-byte swizzles), Lq != Lk, and a ragged Lq
                  # (a query tile past the rows: TMA's zeros, not stored)
                  ("small", (2, 3, 256, 16), 256, torch.bfloat16, causal),
                  ("d32", (1, 2, 128, 32), 128, torch.bfloat16, causal),
                  ("lq_ne_lk", (2, 4, 128, 64), 256, torch.bfloat16, causal),
                  ("ragged", (2, 4, 100, 64), 128, torch.bfloat16, causal)]
    with torch.no_grad():
        recs = [check_attention(*c, gen) for c in cases]
        # a scale below zero: bf16's path without the scale folded into
        # the exponent; fp32 scales q before the split
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                check_attention("negative_scale", (2, 4, 128, 64), 128,
                                dtype, causal, gen, scale=-0.125)
        check_misaligned_forward(gen)
        check_misaligned_forward(gen, torch.bfloat16)
    # the main path's call: BERT-base attention at seq 512, fp32, no mask
    return recs[0]


def _backward_bound(q, k, causal, dkv):
    """Least time for K2's (``dkv`` False) or K3's work on these inputs:
    q, k, v, dO and the three fp32 rows read once, dq (or dk and dv)
    written once, or 6 (K2: s, dp, dq) or 8 (K3: s, dv, dp, dk) operations
    per visible (query, key, d) over the attention product rate for the
    input type."""
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    bh = q.numel() // (lq * d)
    elem = q.element_size()
    reads = (2 * bh * lq * d + 2 * bh * lk * d) * elem + 3 * bh * lq * 4
    writes = (2 * bh * lk * d if dkv else bh * lq * d) * elem
    pairs = sum(min(i + 1, lk) for i in range(lq)) if causal else lq * lk
    flops = (8.0 if dkv else 6.0) * bh * d * pairs
    t_mem = (reads + writes) / MEM_BPS
    t_ops = flops / ATTN_PEAK_FLOPS[q.dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem > t_ops
                                     else "operations")


def _grad_err(got, want, dtype, terms):
    """(max |got - want|, the same over max |want|, the signed bias
    mean((got - want)·sign(want)) over mean |want|) in fp32 for a gradient
    summed over ``terms`` keys or queries; fp32 must be within GRAD_TOL
    (rtol and atol, the reference's attention-gradient tolerance), within
    SPLIT_TF32_TOL of the gradient's largest magnitude and with a bias
    above the K23_BIAS_TOL limit for its length, bf16 within BF16_GRAD_TOL
    of its largest magnitude."""
    got, want = got.float(), want.float()
    diff = got - want
    err = diff.abs().max().item()
    rel = err / want.abs().max().item()
    bias = ((diff * want.sign()).mean() / want.abs().mean()).item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)
        if rel > SPLIT_TF32_TOL:
            raise AssertionError(f"fp32 gradient off by {rel} of its largest "
                                 f"magnitude, above {SPLIT_TF32_TOL}")
        limit = K23_BIAS_TOL * max(1.0, terms / K23_BIAS_TERMS)
        if bias < -limit:
            raise AssertionError(f"fp32 gradient summed over {terms} terms "
                                 f"drifts toward zero by {-bias} of its mean "
                                 f"magnitude, above {limit}")
    elif rel > BF16_GRAD_TOL:
        raise AssertionError(f"bf16 gradient off by {err}")
    return err, rel, bias


def check_attention_backward(name, q_shape, lk, dtype, causal, gen,
                             scale=None):
    """K2 and K3 against their plain versions on one input, the forward
    residuals from K1 and a nonzero dLSE; returns the two records.
    ``scale`` defaults to D^-0.5."""
    d = q_shape[-1]
    kv_shape = tuple(q_shape[:-2]) + (lk, d)
    dev = torch.device("cuda", 0)
    q, do = (torch.randn(q_shape, generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(kv_shape, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    dlse = torch.randn(q_shape[:-1], generator=gen, device=dev)
    scale = d ** -0.5 if scale is None else scale
    o, lse = hk.flash_attention_with_lse(q, k, v, causal=causal, scale=scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse)
    kw = dict(causal=causal, scale=scale)
    dq = hk._attn_dq_cuda(*args, **kw)
    dk, dv = hk._attn_dkv_cuda(*args, **kw)
    dq_ref = hk._attn_dq_plain(*args, **kw)
    dk_ref, dv_ref = hk._attn_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    lq = q_shape[-2]
    errs = {"dq": _grad_err(dq, dq_ref, dtype, lk),
            "dk": _grad_err(dk, dk_ref, dtype, lq),
            "dv": _grad_err(dv, dv_ref, dtype, lq)}
    lib_ms = lib_device_ms = None
    if name in ("mixed_precision_fit", "bert_base"):
        # one library call for the three gradients (dLSE = 0 there): the
        # backward of PyTorch's fused attention on the same tensors
        def library():
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            with torch.enable_grad():
                out = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, is_causal=causal, scale=scale)
            return lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True)
        lib_ms = time_ms(library())
        lib_device_ms = device_ms(library)
    recs = []
    for kernel, fn, plain, dkv, parts in (
            ("flash_attn_bwd_dq", lambda: hk._attn_dq_cuda(*args, **kw),
             lambda: hk._attn_dq_plain(*args, **kw), False, ("dq",)),
            ("flash_attn_bwd_dkv", lambda: hk._attn_dkv_cuda(*args, **kw),
             lambda: hk._attn_dkv_plain(*args, **kw), True, ("dk", "dv"))):
        rec = {"check": name, "kernel": kernel, "q": list(q_shape), "lk": lk,
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "scale": scale, "max_abs_err": max(errs[g][0] for g in parts),
               "max_rel_err": max(errs[g][1] for g in parts),
               **{f"{g}_signed_bias": errs[g][2] for g in parts},
               "ms": time_ms(fn), "device_ms": device_ms(lambda: fn),
               "plain_ms": time_ms(plain),
               "library_ms": lib_ms, "library_device_ms": lib_device_ms}
        rec["bound_ms"], rec["bound_by"] = _backward_bound(q, k, causal, dkv)
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        log(json.dumps(rec))
        recs.append(rec)
    if lib_ms is not None:
        both = recs[0]["device_ms"] + recs[1]["device_ms"]
        log(json.dumps({"check": name, "dtype": recs[0]["dtype"],
                        "causal": causal, "k2_plus_k3_device_ms": both,
                        "library_device_ms": lib_device_ms,
                        "k2_plus_k3_over_library": both / lib_device_ms}))
    return recs


def check_misaligned_backward(gen, dtype=torch.float32):
    """K2 and K3 on inputs whose storage starts one element past a 16-byte
    boundary (a contiguous view at an odd offset): the wrappers copy them
    to aligned memory for cp.async (fp32) and TMA (bf16, whose K3 also
    reads the lse, delta and dlse rows by TMA: they are off alignment
    too, and dLSE nonzero); the gradients must match the plain
    versions."""
    dev = torch.device("cuda", 0)
    shape = (1, 2, 128, 32)
    q, k, v, do = (_odd_view(torch.randn(shape, generator=gen, device=dev)
                             .to(dtype)) for _ in range(4))
    o, lse = hk.flash_attention_with_lse(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    dlse = torch.zeros_like(lse)
    if dtype == torch.bfloat16:
        dlse = torch.randn(lse.shape, generator=gen, device=dev)
        lse, delta, dlse = (_odd_view(t) for t in (lse, delta, dlse))
    args = (q, k, v, do, lse, delta, dlse)
    kw = dict(causal=False, scale=shape[-1] ** -0.5)
    got = (hk._attn_dq_cuda(*args, **kw), *hk._attn_dkv_cuda(*args, **kw))
    want = (hk._attn_dq_plain(*args, **kw), *hk._attn_dkv_plain(*args, **kw))
    torch.cuda.synchronize()
    err, rel, _ = map(max, *(_grad_err(g, w, dtype, shape[2])
                             for g, w in zip(got, want)))
    log(json.dumps({"check": "misaligned", "dtype": str(dtype).replace(
        "torch.", ""), "q": list(shape), "max_abs_err": err,
        "max_rel_err": rel}))


def phase_backward_kernels():
    """K2 and K3 against their plain versions; returns the records of the
    main path's call (BERT-base's [8, 12, 512, 64] fp32 attention)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [("bert_base", (8, 12, 512, 64), 512, torch.float32, False),
             ("bert_base_128", (8, 12, 128, 64), 128, torch.float32, False),
             ("bert_base", (8, 12, 512, 64), 512, torch.float32, True)]
    for causal in (False, True):
        cases.append(("bert_base", (8, 12, 512, 64), 512, torch.bfloat16,
                      causal))
    for causal in (False, True):
        cases += [("d16", (2, 3, 256, 16), 256, torch.float32, causal),
                  ("d32", (1, 2, 128, 32), 128, torch.float32, causal),
                  ("d128", (2, 2, 256, 128), 256, torch.float32, causal),
                  ("d128", (2, 2, 256, 128), 256, torch.bfloat16, causal),
                  ("lq_ne_lk", (1, 2, 64, 16), 256, torch.float32, causal),
                  ("lq_ne_lk", (2, 4, 64, 64), 256, torch.float32, causal),
                  # bf16 at every head dim the wgmma kernels are built for
                  # (32- and 64-byte swizzles), Lq != Lk both ways, a
                  # ragged Lq (a query tile past the rows: TMA's zeros, K3's
                  # rows of the next (b, h), masked) and a ragged Lk
                  ("d16", (2, 3, 256, 16), 256, torch.bfloat16, causal),
                  ("d32", (1, 2, 128, 32), 128, torch.bfloat16, causal),
                  ("lq_ne_lk", (1, 2, 64, 16), 256, torch.bfloat16, causal),
                  ("lq_ne_lk", (2, 4, 64, 64), 256, torch.bfloat16, causal),
                  ("lq_gt_lk", (2, 2, 256, 128), 128, torch.bfloat16,
                   causal),
                  ("ragged_lq", (2, 4, 100, 64), 128, torch.bfloat16,
                   causal),
                  ("ragged_lq", (1, 2, 100, 128), 128, torch.bfloat16,
                   causal),
                  ("ragged_lk", (2, 4, 128, 64), 100, torch.bfloat16,
                   causal)]
    with torch.no_grad():
        recs = [check_attention_backward(*c, gen) for c in cases]
        # bf16 at a scale below zero: p = exp2(fma(s, c, -lse log2e)) with
        # c < 0 (no row max is taken, so the fold holds)
        for causal in (False, True):
            check_attention_backward("negative_scale", (2, 4, 128, 64), 128,
                                     torch.bfloat16, causal, gen,
                                     scale=-0.125)
        check_misaligned_backward(gen)
        check_misaligned_backward(gen, torch.bfloat16)
    return {r["kernel"]: r for r in recs[0]}


def _lstm_bound(gates, c):
    """Least time for K4's work on these inputs: the gates and c read once,
    c' and h' written once, over HBM, or LSTM_OPS fp32 operations per
    (b, j) over the fp32 rate, whichever is larger."""
    nbytes = gates.numel() * gates.element_size() + \
        3 * c.numel() * c.element_size()
    t_mem = nbytes / MEM_BPS
    t_ops = LSTM_OPS * c.numel() / FP32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem > t_ops
                                     else "operations")


def check_lstm(name, b, h, gates_dtype, c_dtype, gen):
    """K4 against its plain version on one input; returns the record."""
    dev = torch.device("cuda", 0)
    gates = torch.randn((b, 4 * h), generator=gen, device=dev) \
        .to(gates_dtype)
    c = torch.randn((b, h), generator=gen, device=dev).to(c_dtype)
    c_new, h_new = hk.lstm_gates(gates, c)
    c_ref, h_ref = hk._lstm_gates_plain(gates, c)
    torch.cuda.synchronize()
    if c_new.dtype != c_dtype or tuple(h_new.shape) != (b, h):
        raise AssertionError(f"K4 gave {c_new.dtype} {tuple(h_new.shape)}")
    err = max((c_new.float() - c_ref.float()).abs().max().item(),
              (h_new.float() - h_ref.float()).abs().max().item())
    tol = LSTM_TOL[torch.bfloat16 if torch.bfloat16 in (gates_dtype, c_dtype)
                   else torch.float32]
    if not err <= tol:
        raise AssertionError(f"K4 {name} off by {err} (tolerance {tol})")
    kernel = (lambda: hk.lstm_gates(gates, c))
    # PyTorch's fused CUDA LSTM cell (gate order i|f|g|o) on the same gates
    # with zero hidden-side gates: for the table only, never on the path;
    # it and the kernel take turns (best_ms)
    lib = torch.ops.aten._thnn_fused_lstm_cell
    lib_err = lib_ms = None
    if gates_dtype == c_dtype == torch.float32:
        zeros = torch.zeros_like(gates)
        hy, cy, _ = lib(gates, zeros, c)
        lib_err = max((cy - c_ref).abs().max().item(),
                      (hy - h_ref).abs().max().item())
        ms, lib_ms = best_ms([kernel, lambda: lib(gates, zeros, c)])
    else:
        ms, = best_ms([kernel])
    rec = {"check": name, "kernel": "lstm_gates", "gates": [b, 4 * h],
           "c": [b, h], "gates_dtype": str(gates_dtype)[6:],
           "c_dtype": str(c_dtype)[6:], "max_abs_err": err, "ms": ms,
           "plain_ms": time_ms(lambda: hk._lstm_gates_plain(gates, c),
                               iters=100),
           "library_ms": lib_ms, "library_max_abs_err": lib_err}
    rec["bound_ms"], rec["bound_by"] = _lstm_bound(gates, c)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(json.dumps(rec))
    return rec


def _host_us(fn, n=1000):
    """Host µs a call of ``fn`` over ``n`` back-to-back calls: wall time to
    issue them, with no synchronize inside the timed loop."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def _device_us(fn, n=200):
    """Device µs a call of ``fn``: the profiler's kernel time over ``n``
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / n if total else "not measured"


def lstm_call_split(name, b, h, gen):
    """K4's host µs and device µs a call at one fp32 width, beside the
    library cell's.  Host times are the best of three rounds in turns, all
    taken before the profiler runs (profiling slows the host's later
    calls)."""
    dev = torch.device("cuda", 0)
    gates = torch.randn((b, 4 * h), generator=gen, device=dev)
    c = torch.randn((b, h), generator=gen, device=dev)
    zeros = torch.zeros_like(gates)
    lib = torch.ops.aten._thnn_fused_lstm_cell
    kernel, library = (lambda: hk.lstm_gates(gates, c)), \
        (lambda: lib(gates, zeros, c))
    host_k = host_l = float("inf")
    for _ in range(3):
        host_k = min(host_k, _host_us(kernel))
        host_l = min(host_l, _host_us(library))
    rec = {"check": name, "kernel": "lstm_gates", "gates": [b, 4 * h],
           "host_us_per_call": host_k,
           "device_us_per_call": _device_us(kernel),
           "library_host_us_per_call": host_l,
           "library_device_us_per_call": _device_us(library)}
    log(json.dumps(rec))
    return rec


def phase_lstm_kernels():
    """K4 against its plain version; returns the records of the main
    path's call ([32, 800] gates and [32, 200] c in fp32) and of the
    [4096, 4096] call, where the share of the bound means something."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("ptb_lstm", LSTM_BATCH, PTB_LSTM["num_hidden"], f32, f32),
             ("wide", 20, 1500, f32, f32),
             ("large", 4096, 1024, f32, f32),
             ("odd_h13", 7, 13, f32, f32),
             ("ptb_lstm", LSTM_BATCH, PTB_LSTM["num_hidden"], bf16, f32),
             ("ptb_lstm", LSTM_BATCH, PTB_LSTM["num_hidden"], bf16, bf16),
             ("large", 4096, 1024, bf16, f32),
             ("large", 4096, 1024, bf16, bf16)]
    with torch.no_grad():
        recs = [check_lstm(*c, gen) for c in cases]
        lstm_call_split("ptb_lstm", LSTM_BATCH, PTB_LSTM["num_hidden"], gen)
    return recs[0], recs[2]


def _serve(pred, feeds, expect=None, keep=True):
    """Answer each request (a dict of inputs): forward plus the output copy
    to the host; returns the outputs (when ``keep``) and the latencies in
    ms.  ``expect`` {kernel: n} holds each forward to n launches of each
    named kernel."""
    expect = expect or {}
    outs, lat = [], []
    for feed in feeds:
        before = dict(hk.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.forward(**feed)
        out = pred.get_output(0).asnumpy()
        lat.append((time.perf_counter() - t0) * 1e3)
        if keep:
            outs.append(out)
        for kernel, want in expect.items():
            launched = hk.LAUNCHES[kernel] - before[kernel]
            if launched != want:
                raise AssertionError(f"a forward launched {kernel} "
                                     f"{launched} times, want {want}")
    return outs, lat


def _latency(pred, feeds, n, expect=None):
    """Latency summary of ``n`` requests cycled from ``feeds``, after one
    untimed warm-up request at the bound shape."""
    _serve(pred, feeds[:1], expect, keep=False)
    _, lat = _serve(pred, [feeds[i % len(feeds)] for i in range(n)], expect,
                    keep=False)
    q = np.percentile(lat, [50, 90, 99])
    return {"n": n, "p50_ms": float(q[0]), "p90_ms": float(q[1]),
            "p99_ms": float(q[2]), "min_ms": float(min(lat)),
            "max_ms": float(max(lat))}


def profile_forward(tag, pred, feed):
    """Device time by kernel over one warm forward (with the output copy
    to the host), and the device's idle share of that wall time; K1's,
    K4's and the GEMMs' totals are summed out of the kernel rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pred.forward(**feed)
    pred.get_output(0).asnumpy()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.forward(**feed)
        pred.get_output(0).asnumpy()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    rec = {"profile": tag, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else
           "not measured",
           "k1_ms": sum(ms for key, ms, _ in rows
                        if K1_FP32 in key),
           "k4_ms": sum(ms for key, ms, _ in rows
                        if "lstm_gates_kernel" in key),
           "k4_launches": sum(n for key, _, n in rows
                              if "lstm_gates_kernel" in key),
           "gemm_ms": sum(ms for key, ms, _ in rows
                          if "gemm" in key.lower() or "gemv" in key.lower()),
           "top": [[name[:90], ms, n] for name, ms, n in rows[:12]]}
    log(json.dumps(rec))
    return rec


def _site_counts(pred):
    """``(rewrites, attention sites, LSTM sites)`` of the Predictor's
    ``pallas_select`` report."""
    rep = [r for r in pred._program.opt_reports
           if r.name == "pallas_select"][0]
    return (rep.rewrites, len(rep.details.get("attention_sites", [])),
            len(rep.details.get("lstm_sites", [])))


def _rewrites(pred):
    return _site_counts(pred)[0]


@contextlib.contextmanager
def env(**values):
    """Environment switches for the Predictors and modules built and run
    inside."""
    # mxtpu-lint: disable=raw-env-read -- save and restore of the
    # switches the caller sets, not a knob read
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pallas_mode(value):
    """``MXTPU_PALLAS`` for the Predictors built and reshaped inside."""
    return env(MXTPU_PALLAS=value)


def eager():
    """``MXTPU_GRAPH_COMPILE=0``: every program and step runs eagerly."""
    return env(MXTPU_GRAPH_COMPILE="0")


_SETTLE_GRAPH = []


def _settle_graph():
    """A CUDA graph of SETTLE_KERNELS short spin kernels, captured once,
    which `replay_launches` replays first in its profiled region."""
    if not _SETTLE_GRAPH:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(SETTLE_KERNELS):
                torch.cuda._sleep(1000)
        _SETTLE_GRAPH.append(graph)
    return _SETTLE_GRAPH[0]


def _trace_settle():
    """A ~1 ms spin kernel and a synchronize at the start of a profiled
    region: on some machines the trace misses the kernels of the first
    milliseconds after the profiler starts (a whole run of this script on
    an H100 once lost all 20 K4 kernels of a 4 ms replay); the spin
    kernel is not counted by name."""
    torch.cuda._sleep(2_000_000)
    torch.cuda.synchronize()


def replay_launches(run):
    """Kernel launches of one call of ``run`` (after a warm one), from a
    profiler trace: ``({kernel name: launches}, {runtime launch call:
    calls})``; a captured call shows its kernels inside one
    ``cudaGraphLaunch``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    settle = _settle_graph()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _trace_settle()
        # in a whole run a session's first graph launch loses some of its
        # kernel records (1 of 120 K4 in phase 6, 1 of 12 K1 in 15b, 2 of
        # 32 K4 in 16a): the settling graph, not counted by name, is that
        # launch here
        settle.replay()
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the spins (`_trace_settle`'s and the settling graph's) left out
    kernels = {e.key: e.count for e in events
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.key}
    host = {e.key: e.count for e in events
            if e.device_type == DeviceType.CPU and ("LaunchKernel" in e.key
                                                   or "GraphLaunch" in e.key)}
    graph_key = next((k for k in host if "GraphLaunch" in k), None)
    if graph_key is None:
        raise AssertionError("the settling graph's launch is not in the "
                             "profiler's trace")
    host[graph_key] -= 1
    if not host[graph_key]:
        del host[graph_key]
    return kernels, host


def _named(kernels, part):
    return sum(n for key, n in kernels.items() if part in key)


def check_replay(what, run, want):
    """One captured call of ``run`` launches each kernel of ``want``
    {kernel name: launches} that many times in the profiler's trace, and
    the host launched a CUDA graph."""
    kernels, host = replay_launches(run)
    got = {name: _named(kernels, name) for name in want}
    graphs = sum(n for key, n in host.items() if "GraphLaunch" in key)
    log(json.dumps({"replay": what, "kernel_launches": got,
                    "all_kernels": sum(kernels.values()),
                    "host_launch_calls": host}))
    if got != want or graphs < 1:
        raise AssertionError(f"{what}: one replay launched {got} in "
                             f"{graphs} graph launch(es), want {want}")
    return {"kernels": sum(kernels.values()), "host": host,
            "multi_tensor": _named(kernels, "multi_tensor_apply_kernel")}


def _capture_err(got, want):
    """max |got - want| over the largest |want| of a list of outputs."""
    scale = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / \
        max(scale, 1e-30)


def phase_slice(card):
    cfg = dict(BERT_BASE)
    n_layers = cfg["num_layers"]
    batch, seq, short = 8, 512, 128
    sym = bert_encoder(mt.sym, **cfg)
    shapes = {"data": (batch, seq), "positions": (1, seq)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    t0 = time.perf_counter()
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    n_params = sum(a.size for a in params.values())
    blob = dumps_ndarrays({"arg:" + n: NDArray(torch.from_numpy(a))
                           for n, a in params.items()})
    del params
    log(f"slice: BERT-base {n_params} parameters, blob {len(blob)} bytes, "
        f"made in {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED + 1)
    reqs = [rng.randint(0, cfg["vocab"], (batch, seq)).astype(np.float32)
            for _ in range(4)]
    reqs_short = [rng.randint(0, cfg["vocab"], (batch, short))
                  .astype(np.float32) for _ in range(2)]
    pos = np.arange(seq, dtype=np.float32)[None]
    pos_short = np.arange(short, dtype=np.float32)[None]
    feeds = [dict(data=d, positions=pos) for d in reqs]
    feeds_short = [dict(data=d, positions=pos_short) for d in reqs_short]
    short_shapes = {"data": (batch, short), "positions": (1, short)}
    expect = {"flash_attn_fwd": n_layers, "lstm_gates": 0}

    # the reference: the unfused graph on the same card
    with pallas_mode("0"):
        ref = mt.Predictor(sym.tojson(), blob, shapes)
        if _rewrites(ref) != 0:
            raise AssertionError("MXTPU_PALLAS=0 still swapped kernels in")
        ref_out, _ = _serve(ref, feeds)
        ref_lat = _latency(ref, feeds, TIMED[seq])
        ref.reshape(short_shapes)
        ref_out_s, _ = _serve(ref, feeds_short)
        ref_lat_s = _latency(ref, feeds_short, TIMED[short])
        ref.reshape(shapes)
        profile_forward("unfused seq 512", ref, feeds[0])
    del ref
    torch.cuda.empty_cache()

    # the main path: Predictor with the default kernel selection
    with pallas_mode("auto"):
        pred = mt.Predictor(sym.tojson(), blob, shapes)
        if _rewrites(pred) != n_layers:
            raise AssertionError(f"pallas_select rewrote {_rewrites(pred)} "
                                 f"attention sites, want {n_layers}")
        hk.reset_launch_counts()
        outs, _ = _serve(pred, feeds, expect)
        lat = _latency(pred, feeds, TIMED[seq], expect)
        pred.reshape(short_shapes)
        if _rewrites(pred) != n_layers:
            raise AssertionError("pallas_select after reshape rewrote "
                                 f"{_rewrites(pred)} sites")
        outs_s, _ = _serve(pred, feeds_short, expect)
        lat_s = _latency(pred, feeds_short, TIMED[short], expect)
        launches = dict(hk.LAUNCHES)
        forwards = len(reqs) + len(reqs_short) + TIMED[seq] + TIMED[short] + 2
        if launches["flash_attn_fwd"] != n_layers * forwards:
            raise AssertionError(f"K1 launched {launches} times over "
                                 f"{forwards} forwards")
        # each forward replays its CUDA graph: K1 inside it, by the trace
        check_replay("BERT serving seq 128",
                     lambda: pred.forward(**feeds_short[0]),
                     {K1_FP32: n_layers})
        # diagnostics after the counted run: where a forward's time goes
        profile_forward("K1 seq 128", pred, feeds_short[0])
        pred.reshape(shapes)
        check_replay("BERT serving seq 512", lambda: pred.forward(**feeds[0]),
                     {K1_FP32: n_layers})
        profile_forward("K1 seq 512", pred, feeds[0])

    # the same path run eagerly (MXTPU_GRAPH_COMPILE=0), whose outputs the
    # captured forwards must give
    with pallas_mode("auto"), eager():
        eag = mt.Predictor(sym.tojson(), blob, shapes)
        eag_out, _ = _serve(eag, feeds, expect)
        eag_lat = _latency(eag, feeds, TIMED[seq], expect)
        eag.reshape(short_shapes)
        eag_out_s, _ = _serve(eag, feeds_short, expect)
        eag_lat_s = _latency(eag, feeds_short, TIMED[short], expect)
        del eag
    cap_err = max(_capture_err(outs, eag_out), _capture_err(outs_s, eag_out_s))
    log(f"slice: p50 ms captured / eager: seq {seq} {lat['p50_ms']:.3f} / "
        f"{eag_lat['p50_ms']:.3f}, seq {short} {lat_s['p50_ms']:.3f} / "
        f"{eag_lat_s['p50_ms']:.3f}; captured against eager {cap_err:.3e} "
        "of the largest output")
    if cap_err > CAPTURE_TOL:
        raise AssertionError(f"captured BERT forward off the eager one by "
                             f"{cap_err} of the output's largest magnitude")

    worst = 0.0
    for got, want, shape in ([(g, w, (batch, seq, cfg["hidden"]))
                              for g, w in zip(outs, ref_out)]
                             + [(g, w, (batch, short, cfg["hidden"]))
                                for g, w in zip(outs_s, ref_out_s)]):
        if got.shape != shape or not np.isfinite(got).all():
            raise AssertionError(f"output {got.shape} not finite {shape}")
        np.testing.assert_allclose(got, want, rtol=SLICE_TOL, atol=SLICE_TOL)
        worst = max(worst, float(np.abs(got - want).max()))
    rec = {
        "slice": "bert_base_predictor", "card": card,
        "batch": batch, "seq": seq, "short_seq": short,
        "latency": lat, "latency_short": lat_s,
        "tokens_per_s": batch * seq / (lat["p50_ms"] / 1e3),
        "tokens_per_s_short": batch * short / (lat_s["p50_ms"] / 1e3),
        "unfused_latency": ref_lat, "unfused_latency_short": ref_lat_s,
        "eager_latency": eag_lat, "eager_latency_short": eag_lat_s,
        "captured_vs_eager_rel_err": cap_err,
        "max_abs_diff_vs_unfused": worst, "launches": launches,
    }
    log(json.dumps(rec))
    return launches


# ---------------------------------------------------------------------------
# phase 5: BERT-base masked-LM training through Module
# ---------------------------------------------------------------------------

def _mlm_batch(vocab, batch, seq):
    """One fixed batch on the card: token ids, positions, and labels that
    hold the token at 15 % of the positions and -1 elsewhere."""
    rng = np.random.RandomState(SEED + 3)
    data = rng.randint(0, vocab, (batch, seq)).astype(np.float32)
    label = np.where(rng.rand(batch, seq) < 0.15, data, -1.0) \
        .astype(np.float32)
    pos = np.arange(seq, dtype=np.float32)[None]
    dev = mt.gpu(0)
    return mt.io.DataBatch([mt.nd.array(data, ctx=dev),
                            mt.nd.array(pos, ctx=dev)],
                           [mt.nd.array(label, ctx=dev)])


def _mlm_module(sym, params, batch, seq):
    """`Module` on the default context (the card), bound for training and
    initialized from ``params`` through ``arg_params``."""
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",))
    mod.bind([("data", (batch, seq)), ("positions", (1, seq))],
             [("mlm_label", (batch, seq))])
    mod.init_params(arg_params=params)
    return mod


def _mlm_loss(mod, label):
    """Mean -log p(label) over the masked positions."""
    prob = mod.get_outputs()[0].data
    flat = label.reshape(-1)
    rows = torch.nonzero(flat >= 0).squeeze(1)
    return -torch.log(prob[rows, flat[rows].long()]).mean().item()


def _check_launches(what, launches, want):
    """K1, K2 and K3 launched ``want`` times each, K4 never."""
    expect = dict.fromkeys(ATTN_KERNELS, want)
    expect["lstm_gates"] = 0
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times, want {n} ({launches})")


def _grad_parity(fused, unfused):
    """Every parameter's gradient in the fused graph against the unfused
    one: max |diff| over the gradient's largest magnitude."""
    gf, gu = fused._exec.grad_dict, unfused._exec.grad_dict
    if set(gf) != set(gu):
        raise AssertionError(f"gradient sets differ: {set(gf) ^ set(gu)}")
    scale = max(g.data.abs().max().item() for g in gu.values())
    worst, key_bias = {}, {}
    for name in gf:
        got, want = gf[name].data, gu[name].data
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {name} is not finite")
        if name.endswith("_key_bias"):
            # zero in exact arithmetic: a shift shared by a row's scores
            # leaves its softmax unchanged; both graphs give roundoff
            key_bias[name] = max(got.abs().max().item(),
                                 want.abs().max().item()) / scale
            continue
        worst[name] = ((got - want).abs().max() /
                       want.abs().max().clamp_min(1e-30)).item()
    ranked = sorted(worst.items(), key=lambda kv: -kv[1])
    name, err = ranked[0]
    log(f"train: worst gradients {[(n, f'{e:.3e}') for n, e in ranked[:4]]} "
        f"(relative to each one's largest magnitude); key biases at most "
        f"{max(key_bias.values()):.3e} of the largest gradient")
    if err > TRAIN_GRAD_TOL:
        raise AssertionError(f"gradient of {name} off by {err} relative")
    if max(key_bias.values()) > KEY_BIAS_TOL:
        raise AssertionError(f"key-bias gradients {key_bias}")
    return name, err


def _kernel_ms(rows, part):
    return sum(ms for key, ms in rows if part in key)


def profile_step(mod, batch_data):
    """Device time by kind over one warm training step: the fp32 GEMMs,
    K1, K2, K3, SoftmaxOutput (forward and its defined backward) and the
    optimizer update, beside the device-busy total and the wall time.
    The forward and the update are spans of this thread; autograd runs the
    backward's kernels from a thread of its own, so the backward is the
    rest of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    spans = ("forward", "optimizer_update")
    mod.forward_backward(batch_data)
    mod.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(spans[0]):
            mod.forward(batch_data, is_train=True)
        mod.backward()
        with record_function(spans[1]):
            mod.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3) for e in events
               if e.device_type == DeviceType.CUDA and e.key not in spans
               and not getattr(e, "is_user_annotation", False)]
    host = {e.key: e.device_time_total / 1e3 for e in events
            if e.device_type == DeviceType.CPU}
    busy = sum(ms for _, ms in kernels)
    gemm = sum(ms for key, ms in kernels
               if "gemm" in key.lower() or "gemv" in key.lower())
    smo_keys = [k for k in host if k == "_SoftmaxOutput" or
                k.endswith(": _SoftmaxOutputBackward")]
    kernels.sort(key=lambda r: -r[1])
    fwd, upd = (host.get(s, 0.0) for s in spans)
    rec = {"profile": "train step", "wall_ms": wall_ms,
           "device_busy_ms": busy,
           "idle_share": (1.0 - busy / wall_ms) if busy else "not measured",
           "forward_ms": fwd, "backward_ms": busy - fwd - upd,
           "optimizer_update_ms": upd, "fp32_gemm_ms": gemm,
           "k1_ms": _kernel_ms(kernels, K1_FP32),
           "k2_ms": _kernel_ms(kernels, FP32_KERNEL["flash_attn_bwd_dq"]),
           "k3_ms": _kernel_ms(kernels, FP32_KERNEL["flash_attn_bwd_dkv"]),
           "softmax_output_ms": (sum(host[k] for k in smo_keys)
                                 if smo_keys else "not measured"),
           "softmax_output_events": smo_keys,
           "top": [[name[:90], ms] for name, ms in kernels[:12]]}
    log(json.dumps(rec))
    return rec


def phase_train(card, cfg=None, batch=8, seq=512):
    """BERT-base masked-LM pretraining steps through `Module` on cuda:0.
    ``cfg`` cuts the model for a rehearsal; the smoke runs BERT_BASE."""
    cfg = dict(BERT_BASE if cfg is None else cfg)
    n_layers = cfg["num_layers"]
    shapes = {"data": (batch, seq), "positions": (1, seq),
              "mlm_label": (batch, seq)}
    fused_sym = bert_mlm(mt.sym, **dict(cfg, dropout=0.0))
    arg_shapes, _, _ = fused_sym.infer_shape(**shapes)
    t0 = time.perf_counter()
    params = random_params({n: s for n, s in zip(fused_sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    log(f"train: BERT-base MLM {sum(a.size for a in params.values())} "
        f"parameters made in {time.perf_counter() - t0:.2f} s")
    data = _mlm_batch(cfg["vocab"], batch, seq)
    label = data.label[0].data

    # 1. gradient parity: dropout 0, one forward/backward, against the
    # unfused graph (batch_dot attention) on the same weights and batch
    fused = _mlm_module(fused_sym, params, batch, seq)
    hk.reset_launch_counts()
    fused.forward(data, is_train=True)
    fused.backward()
    torch.cuda.synchronize()
    _check_launches("parity step", dict(hk.LAUNCHES), n_layers)
    unfused = _mlm_module(bert_mlm(mt.sym, **dict(cfg, dropout=0.0),
                                   attention="batch_dot"),
                          params, batch, seq)
    unfused.forward(data, is_train=True)
    unfused.backward()
    out, out_ref = fused.get_outputs()[0].data, unfused.get_outputs()[0].data
    if tuple(out.shape) != (batch * seq, cfg["vocab"]) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"MLM output {tuple(out.shape)} not finite")
    out_err = (out - out_ref).abs().max().item()
    if out_err > SLICE_TOL:
        raise AssertionError(f"MLM probabilities off by {out_err}")
    worst = _grad_parity(fused, unfused)
    del fused, unfused, out, out_ref
    torch.cuda.empty_cache()

    # 2. training: dropout 0.1, BERT's Adam, the same fixed batch
    mod = _mlm_module(bert_mlm(mt.sym, **cfg), params, batch, seq)
    del params
    mod.init_optimizer(optimizer="adam", optimizer_params=ADAM)
    mt.random.seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    losses = []
    for _ in range(TRAIN_STEPS):
        mod.forward(data, is_train=True)
        losses.append(_mlm_loss(mod, label))
        mod.backward()
        mod.update()
    lat = []
    for _ in range(WARM_STEPS + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(data)
        mod.update()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = dict(hk.LAUNCHES)
    steps = TRAIN_STEPS + WARM_STEPS + TIMED_STEPS
    _check_launches(f"{steps} training steps", launches, n_layers * steps)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train: losses {losses}")
    if not np.isfinite(losses).all() or \
            not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    prof = profile_step(mod, data)
    q = np.percentile(lat[WARM_STEPS:], [50, 90])
    rec = {"slice": "bert_base_mlm_module", "card": card, "batch": batch,
           "seq": seq, "layers": n_layers, "dtype": "float32",
           "first_loss": losses[0], "last5_mean_loss":
           float(np.mean(losses[-5:])),
           "step_p50_ms": float(q[0]), "step_p90_ms": float(q[1]),
           "tokens_per_s": batch * seq / (q[0] / 1e3),
           "step_ms": lat[WARM_STEPS:],
           "peak_memory_gib": peak_gb, "output_max_abs_diff_vs_unfused":
           out_err, "worst_grad": worst, "launches": launches,
           "device_busy_ms": prof["device_busy_ms"]}
    log(json.dumps(rec))
    return launches


# ---------------------------------------------------------------------------
# phase 6: the PTB LSTM language model served through Predictor
# ---------------------------------------------------------------------------

def _check_lm_outputs(outs, refs, batch, seq, vocab):
    """Each output finite, (batch·seq, vocab), rows summing to 1, and
    within LSTM_SLICE_TOL of the unfused graph's; returns the worst
    difference."""
    worst = 0.0
    for got, want in zip(outs, refs):
        if got.shape != (batch * seq, vocab) or not np.isfinite(got).all():
            raise AssertionError(f"LM output {got.shape} not finite "
                                 f"({batch * seq}, {vocab})")
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0,
                                   atol=LSTM_SLICE_TOL)
        np.testing.assert_allclose(got, want, rtol=LSTM_SLICE_TOL,
                                   atol=LSTM_SLICE_TOL)
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


def _forward_and_copy(pred, feed, n=20):
    """Median ms of the forward alone (ending in a device synchronize) and
    of the output's copy to the host after it, over ``n`` requests."""
    fwd, copy = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.forward(**feed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred.get_output(0).asnumpy()
        copy.append((time.perf_counter() - t1) * 1e3)
        fwd.append((t1 - t0) * 1e3)
    return {"n": n, "forward_p50_ms": float(np.median(fwd)),
            "copy_p50_ms": float(np.median(copy))}


def phase_lstm_serving(card):
    """MXNet's PTB LSTM LM (2 x 200, vocab 10000, batch 32) served one
    `Predictor` per bucket from one `.params` blob, at T = 60 and T = 10:
    the fused graph (every cell on K4) against the unfused one on the
    card.  Returns the K4 launches of the fused Predictors' run."""
    cfg = dict(PTB_LSTM)
    batch, vocab, buckets = LSTM_BATCH, cfg["vocab"], tuple(LSTM_TIMED)
    syms = {t: lstm_lm(mt, t, **cfg) for t in buckets}
    shapes = {t: {"data": (batch, t)} for t in buckets}
    sym = syms[buckets[0]]
    arg_shapes, _, _ = sym.infer_shape(**shapes[buckets[0]])
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n != "data"}, SEED)
    blob = dumps_ndarrays({"arg:" + n: NDArray(torch.from_numpy(a))
                           for n, a in params.items()})
    log(f"lstm: PTB LSTM LM {sum(a.size for a in params.values())} "
        f"parameters, blob {len(blob)} bytes")
    del params
    rng = np.random.RandomState(SEED + 4)
    feeds = {t: [dict(data=rng.randint(0, vocab, (batch, t))
                      .astype(np.float32)) for _ in range(4)]
             for t in buckets}

    # the reference: the unfused graph of each bucket on the same card
    ref_out, ref_lat, ref_split = {}, {}, {}
    with pallas_mode("0"):
        for t in buckets:
            ref = mt.Predictor(syms[t].tojson(), blob, shapes[t])
            if _rewrites(ref) != 0:
                raise AssertionError("MXTPU_PALLAS=0 still swapped kernels")
            ref_out[t], _ = _serve(ref, feeds[t])
            ref_lat[t] = _latency(ref, feeds[t], LSTM_TIMED[t])
            ref_split[t] = _forward_and_copy(ref, feeds[t][0])
            if t == buckets[0]:
                profile_forward(f"unfused LSTM T {t}", ref, feeds[t][0])
            del ref

    # the main path: one Predictor per bucket with the default selection
    with pallas_mode("auto"):
        preds, opt_ms = {}, {}
        for t in buckets:
            preds[t] = mt.Predictor(syms[t].tojson(), blob, shapes[t])
            rewrites, attn, lstm = _site_counts(preds[t])
            if (rewrites, attn, lstm) != (2 * t, 0, 2 * t):
                raise AssertionError(
                    f"pallas_select at T {t}: {rewrites} rewrites, {attn} "
                    f"attention and {lstm} LSTM sites; want {2 * t} LSTM")
            opt_ms[t] = [r.wall_ms for r in preds[t]._program.opt_reports
                         if r.name == "pallas_select"][0]
        hk.reset_launch_counts()
        outs, lat = {}, {}
        for t in buckets:
            expect = {"lstm_gates": 2 * t, "flash_attn_fwd": 0}
            outs[t], _ = _serve(preds[t], feeds[t], expect)
            lat[t] = _latency(preds[t], feeds[t], LSTM_TIMED[t], expect)
        launches = dict(hk.LAUNCHES)
        want = sum(2 * t * (len(feeds[t]) + 1 + LSTM_TIMED[t])
                   for t in buckets)
        if launches["lstm_gates"] != want or \
                any(launches[k] for k in ATTN_KERNELS):
            raise AssertionError(f"LSTM serving launched {launches}; want "
                                 f"{want} of lstm_gates only")
        for t in buckets:
            check_replay(f"LSTM LM T {t}",
                         lambda t=t: preds[t].forward(**feeds[t][0]),
                         {"lstm_gates_kernel": 2 * t,
                          K1_FP32: 0})
        # diagnostics after the counted run
        split = {t: _forward_and_copy(preds[t], feeds[t][0])
                 for t in buckets}
        prof = profile_forward(f"K4 LSTM T {buckets[0]}", preds[buckets[0]],
                               feeds[buckets[0]][0])
    del preds
    # the same path run eagerly (MXTPU_GRAPH_COMPILE=0)
    eag_out, eag_lat, eag_split = {}, {}, {}
    with pallas_mode("auto"), eager():
        for t in buckets:
            eag = mt.Predictor(syms[t].tojson(), blob, shapes[t])
            expect = {"lstm_gates": 2 * t, "flash_attn_fwd": 0}
            eag_out[t], _ = _serve(eag, feeds[t], expect)
            eag_lat[t] = _latency(eag, feeds[t], LSTM_TIMED[t], expect)
            eag_split[t] = _forward_and_copy(eag, feeds[t][0])
            del eag
    cap_err = {t: _capture_err(outs[t], eag_out[t]) for t in buckets}
    for t in buckets:
        log(f"lstm: T {t} p50 ms captured / eager {lat[t]['p50_ms']:.3f} / "
            f"{eag_lat[t]['p50_ms']:.3f}; forward alone "
            f"{split[t]['forward_p50_ms']:.3f} / "
            f"{eag_split[t]['forward_p50_ms']:.3f}; captured against eager "
            f"{cap_err[t]:.3e} of the largest output")
    if max(cap_err.values()) > CAPTURE_TOL:
        raise AssertionError(f"captured LM forward off the eager one: "
                             f"{cap_err}")
    worst = {t: _check_lm_outputs(outs[t], ref_out[t], batch, t, vocab)
             for t in buckets}
    log(f"lstm: max |fused - unfused| {worst} (tolerance {LSTM_SLICE_TOL})")
    rec = {"slice": "ptb_lstm_lm_predictor", "card": card, "batch": batch,
           "config": cfg, "buckets": list(buckets),
           "pallas_select_wall_ms": opt_ms,
           "latency": {str(t): lat[t] for t in buckets},
           "tokens_per_s": {str(t): batch * t / (lat[t]["p50_ms"] / 1e3)
                            for t in buckets},
           "unfused_latency": {str(t): ref_lat[t] for t in buckets},
           "forward_and_copy": {str(t): split[t] for t in buckets},
           "unfused_forward_and_copy": {str(t): ref_split[t]
                                        for t in buckets},
           "eager_latency": {str(t): eag_lat[t] for t in buckets},
           "eager_forward_and_copy": {str(t): eag_split[t]
                                      for t in buckets},
           "captured_vs_eager_rel_err": {str(t): cap_err[t]
                                         for t in buckets},
           "max_abs_diff_vs_unfused": {str(t): worst[t] for t in buckets},
           "launches": launches,
           "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                            "idle_share", "k4_ms",
                                            "gemm_ms")}}
    log(json.dumps(rec))
    return launches

# ---------------------------------------------------------------------------
# phase 7: BERT-base masked-LM training through Module.fit, one CUDA graph
# a step
# ---------------------------------------------------------------------------

def _fit_iter(vocab, batch, seq):
    """An `NDArrayIter` over FIT_BATCHES fixed batches made from the seed:
    token ids, positions (one row per sample) and labels that hold the
    token at 15 % of the positions and -1 elsewhere."""
    rng = np.random.RandomState(SEED + 5)
    n = FIT_BATCHES * batch
    data = rng.randint(0, vocab, (n, seq)).astype(np.float32)
    label = np.where(rng.rand(n, seq) < 0.15, data, -1.0).astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.float32), (n, 1))
    return mt.io.NDArrayIter({"data": data, "positions": pos},
                             {"mlm_label": label}, batch_size=batch)


def _fit_adam():
    """BERT's Adam with a linear warm-up and linear decay (PolyScheduler,
    pwr 1), in MXNet's optimizer_params form: a fresh schedule each call."""
    sched = mt.lr_scheduler.PolyScheduler(
        max_update=FIT_MAX_UPDATE, base_lr=ADAM["learning_rate"], pwr=1,
        warmup_steps=FIT_WARMUP)
    return dict(ADAM, lr_scheduler=sched)


def _fit_module(sym, it, params):
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params)
    mod.init_optimizer(optimizer="adam", optimizer_params=_fit_adam())
    return mod


def _batch_loss(mod, data_batch):
    """Mean -log p(label) of a step's outputs over the masked positions."""
    prob = mod.get_outputs()[0].data
    flat = data_batch.label[0].data.to(prob.device).reshape(-1)
    rows = torch.nonzero(flat >= 0).squeeze(1)
    return -torch.log(prob[rows, flat[rows].long()].float()).mean().item()


def _params_err(a, b):
    """Worst parameter of module ``a`` against module ``b``: max |diff|
    over the parameter's largest magnitude in ``b``."""
    pa, pb = a._exec.arg_dict, b._exec.arg_dict
    worst = {}
    for name in a._exec._grad_arg_names:
        x, y = pa[name].data, pb[name].data
        worst[name] = ((x - y).abs().max() /
                       y.abs().max().clamp_min(1e-30)).item()
    name = max(worst, key=worst.get)
    return name, worst[name]


def _step_ms(step, n):
    """Median ms of ``n`` calls of ``step``, each ending in a device
    synchronize."""
    lat = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat))


def phase_fit(card, cfg=None, batch=8, seq=512):
    """BERT-base masked-LM pretraining through `Module.fit` on cuda:0, the
    whole step (forward, backward, the multi-tensor Adam update, the
    accuracy) captured as one CUDA graph.  ``cfg`` cuts the model for a
    rehearsal; the smoke runs BERT_BASE.  Returns the fit's launches."""
    cfg = dict(BERT_BASE if cfg is None else cfg)
    n_layers = cfg["num_layers"]
    it = _fit_iter(cfg["vocab"], batch, seq)
    shapes = {d.name: d.shape for d in it.provide_data + it.provide_label}
    sym0 = bert_mlm(mt.sym, **dict(cfg, dropout=0.0))
    arg_shapes, _, _ = sym0.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym0.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    batches = list(it)
    want = {FP32_KERNEL[n]: n_layers for n in ATTN_KERNELS}

    # 1. the captured step against the eager one: dropout 0, the same
    # weights and batches, the scheduler's lr new at every step
    cap = _fit_module(sym0, it, params)
    ref = _fit_module(sym0, it, params)
    lrs = []
    for k in range(FIT_K):
        b = batches[k % len(batches)]
        if not cap.fused_step(b):
            raise AssertionError("Module.fused_step declined the step")
        lrs.append(cap._optimizer.learning_rate)
        with env(MXTPU_FUSED_STEP="0"):
            ref.forward_backward(b)
            ref.update()
    if not cap._fused_train_step.captured or len(set(lrs)) != len(lrs):
        raise AssertionError(f"steps not captured, or lr not new each step "
                             f"({lrs})")
    name, step_err = _params_err(cap, ref)
    log(f"fit: after {FIT_K} steps at lr {lrs}, captured against eager: "
        f"worst parameter {name} off by {step_err:.3e} of its largest "
        "magnitude")
    if step_err > FIT_TOL:
        raise AssertionError(f"captured step's {name} off by {step_err}")
    # with no dropout and lr 0, two replays give the same outputs: the
    # control for the dropout check below
    opt = cap._optimizer
    opt.lr_scheduler, opt.lr = None, 0.0
    cap.fused_step(batches[0])
    o1 = cap.get_outputs()[0].data.clone()
    cap.fused_step(batches[0])
    if not torch.equal(o1, cap.get_outputs()[0].data):
        raise AssertionError("two replays without dropout differ")
    del cap, ref, o1
    torch.cuda.empty_cache()

    # 2. fit: dropout 0.1, the accuracy inside the step
    mod = mt.mod.Module(bert_mlm(mt.sym, **cfg),
                        data_names=("data", "positions"),
                        label_names=("mlm_label",))
    losses, metric = [], mt.metric.create("acc")

    def on_batch(param):
        losses.append(_batch_loss(mod, param.locals["data_batch"]))

    torch.cuda.reset_peak_memory_stats()
    hk.reset_launch_counts()
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=FIT_EPOCHS, optimizer="adam",
            optimizer_params=_fit_adam(), eval_metric=metric,
            arg_params=params, batch_end_callback=on_batch)
    fit_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    steps = FIT_EPOCHS * FIT_BATCHES
    _check_launches(f"fit over {steps} steps", launches, n_layers * steps)
    step = mod._fused_train_step
    if not (step.captured and mod.last_step_metric_done):
        raise AssertionError("fit's steps were not captured with the "
                             "metric inside")
    first = float(np.mean(losses[:FIT_BATCHES]))
    last = float(np.mean(losses[-FIT_BATCHES:]))
    log(f"fit: {steps} steps in {fit_s:.2f} s; losses {losses}")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"the loss did not fall: {losses}")
    del params

    # 3. the in-step accuracy against a host update_metric on the same
    # outputs and labels
    b = batches[0]
    acc = mt.metric.Accuracy()
    if not (mod.fused_step(b, eval_metric=acc) and
            mod.last_step_metric_done):
        raise AssertionError("the metric did not ride the step")
    host = mt.metric.Accuracy()
    mod.update_metric(host, b.label)
    if acc.get() != host.get() or acc.num_inst != host.num_inst:
        raise AssertionError(f"in-step accuracy {acc.get()} "
                             f"({acc.num_inst}) against host {host.get()} "
                             f"({host.num_inst})")

    # 4. dropout: at lr 0 the weights stand still, so two replays on one
    # batch differ by their masks alone
    opt = mod._optimizer
    lr_sched = opt.lr_scheduler
    opt.lr_scheduler, opt.lr = None, 0.0
    w0 = mod._exec.arg_dict["word_embed_weight"].data.clone()
    mod.fused_step(b, eval_metric=acc)
    o1 = mod.get_outputs()[0].data.clone()
    mod.fused_step(b, eval_metric=acc)
    masks_differ = not torch.equal(o1, mod.get_outputs()[0].data)
    if not masks_differ or not torch.equal(
            w0, mod._exec.arg_dict["word_embed_weight"].data):
        raise AssertionError("two replays drew the same dropout masks (or "
                             "lr 0 moved the weights)")
    opt.lr_scheduler = lr_sched
    del o1, w0

    # 5. launches and time of one step, captured and eager
    replay = check_replay("fit step", lambda: mod.fused_step(b, acc), want)
    eager_kernels, eager_host = replay_launches(
        lambda: (mod.forward_backward(b), mod.update()))
    captured_ms = _step_ms(lambda: mod.fused_step(b, acc), FIT_TIMED)
    with eager():
        unified_eager_ms = _step_ms(lambda: mod.fused_step(b, acc),
                                    FIT_TIMED)
    with env(MXTPU_FUSED_STEP="0"):
        classic_ms = _step_ms(lambda: (mod.forward_backward(b),
                                       mod.update()), FIT_TIMED)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = {"slice": "bert_base_mlm_fit", "card": card, "batch": batch,
           "seq": seq, "layers": n_layers, "dtype": "float32",
           "epochs": FIT_EPOCHS, "batches": FIT_BATCHES,
           "captured_vs_eager_param_rel_err": step_err, "lrs": lrs,
           "first_epoch_loss": first, "last_epoch_loss": last,
           "train_accuracy": metric.get()[1],
           "step_p50_ms": {"captured": captured_ms,
                           "eager_one_update": unified_eager_ms,
                           "eager_per_parameter_update": classic_ms},
           "tokens_per_s": batch * seq / (captured_ms / 1e3),
           "kernels_per_step": {"captured": replay["kernels"],
                                "eager": sum(eager_kernels.values())},
           "update_launches_per_step": {
               "captured": replay["multi_tensor"],
               "eager": _named(eager_kernels, "multi_tensor_apply_kernel")},
           "host_launch_calls_per_step": {"captured": replay["host"],
                                          "eager": eager_host},
           "peak_memory_gib": peak_gb, "launches": launches}
    log(json.dumps(rec))
    FIT_RECORD.update(rec)
    return launches


# ---------------------------------------------------------------------------
# phase 8: Gluon ResNet-50
# ---------------------------------------------------------------------------

def _resnet(model, classes, ctx, x):
    """A seeded net on ``ctx`` (weights drawn on the host, so every call
    gives the same ones), its deferred shapes settled by one forward."""
    mt.random.seed(SEED)
    net = model(classes=classes, prefix="resnet50_v1_")
    net.initialize(mt.init.Xavier(magnitude=2), ctx=ctx)
    net(x)
    return net


def _blocks(net, kind):
    found = []
    net.apply(lambda b: found.append(b) if isinstance(b, kind) else None)
    return found


def _bias_feeds_bn(net):
    """{bias name: weight name} of each convolution whose output goes
    straight into a BatchNorm: in train mode that bias's gradient is zero
    in exact arithmetic."""
    nn = mt.gluon.nn
    out = {}
    for seq in _blocks(net, nn.HybridSequential):
        kids = list(seq._children.values())
        for a, b in zip(kids, kids[1:]):
            if isinstance(a, nn.Conv2D) and isinstance(b, nn.BatchNorm) \
                    and a.bias is not None:
                out[a.bias.name] = a.weight.name
    return out


def _gluon_grads(net, x, y, train=True):
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record(train_mode=train):
        loss = loss_fn(net(x), y)
    loss.backward()
    return {n: p.grad().data.double() for n, p in
            net.collect_params().items() if p.grad_req != "null"}


def _rel(got, want):
    return float((got.double() - want).abs().max()) / \
        max(float(want.abs().max()), 1e-30)


def _conv_checks(convs):
    """Each recorded convolution's output, input gradient and weight
    gradient computed by cuDNN in fp32 and in float64 from the float64
    step's own input, weight and output gradient: the worst error of each
    kind (relative to its largest magnitude) and where."""
    from torch.nn.grad import conv2d_input, conv2d_weight
    worst = {"fprop": (0.0, None), "dgrad": (0.0, None),
             "wgrad": (0.0, None)}
    for name, blk, x, dz in convs:
        w = blk.weight.data().data.detach()
        kw = blk._kwargs
        args = (kw["stride"], kw["pad"], kw["dilate"], kw["num_group"])
        with torch.no_grad():
            pairs = {
                "fprop": (torch.nn.functional.conv2d(x.float(), w.float(),
                                                     None, *args),
                          torch.nn.functional.conv2d(x, w, None, *args)),
                "dgrad": (conv2d_input(x.shape, w.float(), dz.float(),
                                       *args),
                          conv2d_input(x.shape, w, dz, *args)),
                "wgrad": (conv2d_weight(x.float(), w.shape, dz.float(),
                                        *args),
                          conv2d_weight(x, w.shape, dz, *args))}
        for kind, (got, want) in pairs.items():
            e = _rel(got, want)
            if e > worst[kind][0]:
                worst[kind] = (e, name)
    return worst


def _resnet_grad_check(model, classes, x, y, train):
    """One training step in fp32 against the same step in float64 on the
    card, with BatchNorm on batch statistics (``train``) or on its moving
    ones: all gradients together (relative to their norm), the worst
    single parameter (relative to its largest magnitude; in train mode a
    bias feeding a BatchNorm relative to its weight's) and, from the
    float64 step's recorded convolutions, cuDNN's fp32 against float64
    (`_conv_checks`)."""
    gpu = mt.gpu(0)
    net = _resnet(model, classes, gpu, x)
    exact = _resnet(model, classes, gpu, x)
    exact.cast("float64")
    got = _gluon_grads(net, x, y, train)
    convs, hooks = [], []

    def keep(name):
        def hook(blk, args, out):
            out.data.retain_grad()
            convs.append((name, blk, args[0].data.detach(), out.data))
        return hook
    for blk in _blocks(exact, mt.gluon.nn.Conv2D):
        hooks.append(blk.register_forward_hook(keep(blk.name)))
    want = _gluon_grads(exact, x.astype("float64"), y.astype("float64"),
                        train)
    for h in hooks:
        h.detach()
    conv = _conv_checks([(n, b, x_, out.grad) for n, b, x_, out in convs])
    n_convs = len(convs)
    zero = _bias_feeds_bn(net) if train else {}
    worst, err, num, den = None, 0.0, 0.0, 0.0
    for name, w in want.items():
        scale = float(want[zero.get(name, name)].abs().max())
        e = float((got[name] - w).abs().max()) / max(scale, 1e-30)
        if e > err:
            worst, err = name, e
        num += float(((got[name] - w) ** 2).sum())
        den += float((w ** 2).sum())
    del net, exact, got, want, convs
    torch.cuda.empty_cache()
    return {"norm_rel_err": (num / den) ** 0.5, "worst": worst,
            "rel_err": err, "convs": n_convs,
            **{f"{k}_rel_err": v[0] for k, v in conv.items()},
            **{f"{k}_worst": v[1] for k, v in conv.items()}}


def _gluon_latency(fn, xs, n):
    """p50/p90/p99 ms of ``n`` requests cycled from ``xs`` (forward plus
    the output copy to the host), after one warm request."""
    fn(xs[0]).asnumpy()
    lat = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(xs[i % len(xs)]).asnumpy()
        lat.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(lat, [50, 90, 99])
    return {"n": n, "p50_ms": float(q[0]), "p90_ms": float(q[1]),
            "p99_ms": float(q[2])}


def _kind(kernel):
    """The kind of a kernel of the ResNet path, from its name."""
    low = kernel.lower()
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad",
                              "implicit")):
        return "conv"
    if "batch_norm" in low or "bn_fw" in low or "bn_bw" in low:
        return "batchnorm"
    if "multi_tensor_apply" in low:
        return "update"
    return "rest"


def profile_gluon(tag, run):
    """Device time by kind over one warm call of ``run``: convolutions,
    BatchNorm, the optimizer update and the rest, beside the device-busy
    total and the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kinds = {k: 0.0 for k in ("conv", "batchnorm", "update", "rest")}
    for key, ms, _ in rows:
        kinds[_kind(key)] += ms
    busy = sum(kinds.values())
    rows.sort(key=lambda r: -r[1])
    rec = {"profile": tag, "wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": (1.0 - busy / wall_ms) if busy else "not measured",
           **{f"{k}_ms": v for k, v in kinds.items()},
           "kernels": sum(n for _, _, n in rows),
           "top": [[name[:90], ms, n] for name, ms, n in rows[:12]]}
    log(json.dumps(rec))
    return rec


def _check_hybridized(name, net, reqs):
    """The hybridized (captured) forward against the imperative one on the
    same requests; one replay is one graph launch."""
    imp = [net(r).asnumpy() for r in reqs]
    net.hybridize()
    cap = [net(r).asnumpy() for r in reqs]
    if net._cached_op.num_programs != 1:
        raise AssertionError(f"{name}: the hybridized forward was not "
                             "captured once")
    err = _capture_err(cap, imp)
    _, host = replay_launches(lambda: net(reqs[0]).asnumpy())
    graphs = sum(n for key, n in host.items() if "GraphLaunch" in key)
    if err > RESNET_CAPTURE_TOL or graphs < 1:
        raise AssertionError(f"{name}: captured forward off by {err} or not "
                             f"replayed ({host})")
    return err, imp


def captured_and_eager(step, what, rounds=2, n=5):
    """A recorded Gluon step (``step(k)`` returns its loss) timed captured
    and eager (``MXTPU_GRAPH_COMPILE=0``) in turns, captured-eager-eager-
    captured per round, ``n`` steps a turn: each way's p50 ms.  One
    captured step must replay its forward and backward graphs (two graph
    launches in the profiler's trace)."""
    _, host = replay_launches(lambda: step(0).asnumpy())
    graphs = sum(c for key, c in host.items() if "GraphLaunch" in key)
    if graphs < 2:
        raise AssertionError(f"{what}: a captured training step launched "
                             f"{graphs} graph(s), want the forward's and "
                             f"the backward's ({host})")
    times = {"captured": [], "eager": []}
    turns = {"captured": [], "eager": []}
    k = 0
    for _ in range(rounds):
        for way in ("captured", "eager", "eager", "captured"):
            with (eager() if way == "eager" else contextlib.nullcontext()):
                turn = []
                for _ in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(k)
                    torch.cuda.synchronize()
                    turn.append((time.perf_counter() - t0) * 1e3)
                    k += 1
            times[way] += turn
            turns[way].append(float(np.median(turn)))
    rec = {f"{way}_p50_ms": float(np.median(ts[1:]))
           for way, ts in times.items()}
    for way, ps in turns.items():
        rec[f"{way}_turn_p50s_ms"] = ps
    # the gap is told from noise only where it exceeds the spread of each
    # way's turn p50s
    gap = rec["eager_p50_ms"] - rec["captured_p50_ms"]
    spread = max(max(ps) - min(ps) for ps in turns.values())
    rec["gap_ms"], rec["turn_spread_ms"] = gap, spread
    rec["gap_resolved"] = abs(gap) > spread
    rec["graph_launches_a_step"] = graphs
    log(f"{what}: step captured {rec['captured_p50_ms']:.2f} ms, eager "
        f"{rec['eager_p50_ms']:.2f} ms (p50, in turns; gap {gap:.2f} ms, "
        f"turn spread {spread:.2f} ms)")
    return rec


def phase_gluon(card, model=None, classes=1000, image=224,
                batch=RESNET_BATCH, train_batch=RESNET_TRAIN_BATCH,
                timed=RESNET_TIMED):
    """ResNet-50 v1 through Gluon on cuda:0: serving (imperative,
    hybridized, exported to `Predictor`) and training through
    `autograd.record`, ``backward`` and `Trainer.step`.  ``model`` and the
    sizes cut the net for a rehearsal; the smoke runs resnet50_v1 at its
    published widths."""
    t_phase = time.perf_counter()
    model = model or vision.resnet50_v1
    gpu = mt.gpu(0)
    rng = np.random.RandomState(SEED)
    reqs = [mt.nd.array(rng.uniform(-1, 1, (batch, 3, image, image)),
                        ctx=gpu) for _ in range(4)]

    # 1. serving: imperative, then hybridized (captured), then exported
    net = _resnet(model, classes, gpu, reqs[0])
    n_bn = len(_blocks(net, mt.gluon.nn.BatchNorm))
    lat = {"imperative": _gluon_latency(net, reqs, timed)}
    cap_err, imp = _check_hybridized("ResNet-50", net, reqs)
    log(f"gluon: captured against imperative {cap_err:.3e} of the largest "
        "output, one graph launch a forward")
    lat["hybridized"] = _gluon_latency(net, reqs, timed)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "resnet50_v1")
    net.export(prefix)
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read()
    with open(prefix + "-0000.params", "rb") as f:
        blob = f.read()
    pred = mt.Predictor(sym_json, blob, {"data": (batch, 3, image, image)})
    folded = {r.name: r.rewrites for r in pred._program.opt_reports}
    served = []
    for r in reqs:
        pred.forward(data=r)
        served.append(pred.get_output(0).asnumpy())
    export_err = _capture_err(served, imp)
    log(f"gluon: exported graph through Predictor against Gluon "
        f"{export_err:.3e}; fold_bn folded {folded.get('fold_bn')} of "
        f"{n_bn} BatchNorms")
    if export_err > RESNET_EXPORT_TOL or folded.get("fold_bn") != n_bn:
        raise AssertionError(f"Predictor off by {export_err}, or fold_bn "
                             f"folded {folded.get('fold_bn')} of {n_bn}")

    def predict(r):
        pred.forward(data=r)
        return pred.get_output(0)

    lat["predictor"] = _gluon_latency(predict, reqs, timed)
    for rec in lat.values():
        rec["images_per_s"] = batch / (rec["p50_ms"] / 1e3)
    log(json.dumps({"gluon_serving": lat}))
    serve_profile = profile_gluon("gluon serving forward (captured)",
                                  lambda: net(reqs[0]).asnumpy())
    del net, pred, reqs, imp, served
    torch.cuda.empty_cache()

    # 2. training: the float64 check of one step, then the loop
    data = [(mt.nd.array(rng.uniform(-1, 1, (train_batch, 3, image, image)),
                         ctx=gpu),
             mt.nd.array(rng.randint(0, classes, (train_batch,)), ctx=gpu))
            for _ in range(2)]
    checks = {}
    for mode, train in (("moving_stats", False), ("batch_stats", True)):
        c = checks[mode] = _resnet_grad_check(model, classes, *data[0],
                                              train)
        log(f"gluon: one step against float64, BatchNorm on "
            f"{mode.replace('_', ' ')}: gradients {c['norm_rel_err']:.3e} "
            f"of their norm (worst element {c['worst']} {c['rel_err']:.3e}"
            f"); cuDNN over its convolutions: fprop "
            f"{c['fprop_rel_err']:.3e}, dgrad {c['dgrad_rel_err']:.3e}, "
            f"wgrad {c['wgrad_rel_err']:.3e}")
        held = [c[f"{k}_rel_err"] for k in ("fprop", "dgrad", "wgrad")]
        if mode == "moving_stats":
            held.append(c["norm_rel_err"])
        if max(held) > RESNET_GRAD_TOL:
            raise AssertionError(f"the step against float64 ({mode}): {c}")
    net = _resnet(model, classes, gpu, data[0][0])
    net.hybridize()
    ramp = mt.lr_scheduler.FactorScheduler(
        step=10 ** 6, base_lr=RESNET_SGD["learning_rate"],
        warmup_steps=RESNET_WARM + RESNET_STEPS, warmup_begin_lr=0.0)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(RESNET_SGD, lr_scheduler=ramp))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    stats0 = {n: p.data().data.clone() for n, p in
              net.collect_params().items() if "running_" in n}

    def step(k):
        x, y = data[k % 2]
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(train_batch)
        return loss

    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for k in range(RESNET_WARM + RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(k).mean().asscalar()))
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(p.data().data, stats0[n])
                for n, p in net.collect_params().items() if n in stats0)
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    log(f"gluon: losses {losses}; {moved} of {len(stats0)} moving "
        "statistics moved")
    if not np.isfinite(losses).all() or not last < first \
            or moved != len(stats0):
        raise AssertionError(f"the loss did not fall ({losses}) or the "
                             f"moving statistics stood still ({moved})")
    step_ms = float(np.median(times[RESNET_WARM:]))
    turns = captured_and_eager(step, "ResNet-50")
    train_profile = profile_gluon("gluon training step (captured)",
                                  lambda: step(0).asnumpy())
    rec = {"slice": "gluon_resnet50_v1", "card": card, "dtype": "float32",
           "image": image, "classes": classes, "serve_batch": batch,
           "capture_rel_err": cap_err, "export_rel_err": export_err,
           "fold_bn": folded.get("fold_bn"), "serving": lat,
           "train_batch": train_batch, "grads_vs_float64": checks,
           "losses": losses,
           "step_p50_ms": step_ms, "step_turns": turns,
           "images_per_s": train_batch / (step_ms / 1e3),
           "peak_memory_gib": peak_gb,
           "serve_profile": serve_profile, "train_profile": train_profile,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    del net, trainer, data
    torch.cuda.empty_cache()
    log(f"gluon: phase 8 in {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 9: the Gluon zoo and data
# ---------------------------------------------------------------------------

def _zoo_net(name, ctx, x, classes=1000):
    """A zoo net by name, Xavier weights drawn on the host from seed 0, its
    deferred shapes settled by one forward of ``x``."""
    mt.random.seed(SEED)
    net = vision.get_model(name, classes=classes)
    net.initialize(mt.init.Xavier(magnitude=2), ctx=ctx)
    net(x)
    return net


def zoo_serving(serve=ZOO_SERVE, batch=ZOO_BATCH, timed=ZOO_TIMED,
                classes=1000):
    """9a: each family served at batch ``batch``, imperative and
    hybridized, the captured outputs within RESNET_CAPTURE_TOL of the
    imperative ones."""
    gpu = mt.gpu(0)
    rng = np.random.RandomState(SEED)
    out = {}
    for name, side in serve:
        t0 = time.perf_counter()
        reqs = [mt.nd.array(rng.uniform(-1, 1, (batch, 3, side, side)),
                            ctx=gpu) for _ in range(2)]
        net = _zoo_net(name, gpu, reqs[0], classes)
        n_params = sum(p.data().size for p in net.collect_params().values())
        lat = {"imperative": _gluon_latency(net, reqs, max(timed // 5, 5))}
        err, imp = _check_hybridized(name, net, reqs)
        if not all(np.isfinite(o).all() and o.shape == (batch, classes)
                   for o in imp):
            raise AssertionError(f"{name}: outputs not finite or of shape "
                                 f"{(batch, classes)}")
        lat["hybridized"] = _gluon_latency(net, reqs, timed)
        rec = {"image": side, "parameters": n_params, "capture_rel_err": err,
               "images_per_s": batch / (lat["hybridized"]["p50_ms"] / 1e3),
               **{f"{k}_p50_ms": v["p50_ms"] for k, v in lat.items()},
               "hybridized_p99_ms": lat["hybridized"]["p99_ms"],
               "s": time.perf_counter() - t0}
        log(f"zoo: {name} at batch {batch}, {side} x {side}: hybridized p50 "
            f"{rec['hybridized_p50_ms']:.3f} ms, imperative "
            f"{rec['imperative_p50_ms']:.3f} ms, captured against "
            f"imperative {err:.3e}")
        out[name] = rec
        del net, reqs, imp
        torch.cuda.empty_cache()
    return out


def _synthetic_images(n, side, classes, seed):
    """``n`` uint8 HWC images and int32 labels, each class's images shifted
    by its own offset (the datasets' synthetic recipe), so that a few
    steps can fit them."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n).astype(np.int32)
    images = rng.randint(0, 200, (n, side, side, 3)).astype(np.int32)
    images += (labels % 56)[:, None, None, None]
    return images.astype(np.uint8), labels


class _Passes(mt.gluon.data.Sampler):
    """``passes`` shuffled passes over 0..length - 1, one after another (a
    `RandomSampler` per pass), so that one `DataLoader` iterator runs
    through many epochs."""

    def __init__(self, length, passes):
        self._length, self._passes = length, passes

    def __iter__(self):
        for _ in range(self._passes):
            yield from mt.gluon.data.RandomSampler(self._length)

    def __len__(self):
        return self._length * self._passes


def _zoo_loader(samples, side, classes, batch, n_batches):
    """A `DataLoader` (2 worker threads) of ``n_batches`` shuffled batches
    over an `ArrayDataset` of uint8 images through ``ToTensor`` and
    ``Normalize``."""
    tr = mt.gluon.data.vision.transforms
    images, labels = _synthetic_images(samples, side, classes, SEED + 9)
    data = mt.gluon.data.ArrayDataset(images, labels).transform_first(
        tr.Compose([tr.ToTensor(), tr.Normalize(IMAGENET_MEAN,
                                                IMAGENET_STD)]))
    passes = -(-n_batches * batch // samples)
    sampler = mt.gluon.data.BatchSampler(_Passes(samples, passes), batch,
                                         "discard")
    return mt.gluon.data.DataLoader(data, batch_sampler=sampler,
                                    num_workers=2, prefetch=ZOO_PREFETCH)


def _loader_alone(samples, side, classes, batch, n):
    """ms a batch of the loader on its own: the time from its first batch
    to its ``n``-th over n - 1 (the first pays the start)."""
    it = iter(_zoo_loader(samples, side, classes, batch, n))
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(n - 1):
            next(it)
        return (time.perf_counter() - t0) * 1e3 / (n - 1)
    finally:
        it.close()


def zoo_training(name="inceptionv3", side=299, batch=ZOO_TRAIN_BATCH,
                 samples=ZOO_SAMPLES, classes=1000, warm=ZOO_WARM,
                 steps=ZOO_STEPS):
    """9b: the net hybridized and trained through `autograd.record`,
    ``backward`` and `Trainer.step` on the batches of one `DataLoader`
    iterator (`_zoo_loader`); each batch moved to the card.  The loss must
    fall; the captured step must give the eager one's loss and gradients
    on one batch with the same Dropout masks, and so must two calls whose
    backwards are pending together; the captured and eager steps are
    timed in turns.  Returns the record and the trained net."""
    gpu = mt.gpu(0)
    np.random.seed(SEED)
    loader_alone_ms = _loader_alone(samples, side, classes, batch,
                                    ZOO_LOADER_BATCHES)
    x0 = mt.nd.array(np.zeros((batch, 3, side, side), np.float32), ctx=gpu)
    net = _zoo_net(name, gpu, x0, classes)
    net.hybridize()
    n_total = warm + steps
    ramp = mt.lr_scheduler.FactorScheduler(
        step=10 ** 6, base_lr=RESNET_SGD["learning_rate"],
        warmup_steps=n_total, warmup_begin_lr=0.0)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(RESNET_SGD, lr_scheduler=ramp))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(xy):
        x, y = xy
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch)
        return loss

    feed = iter(_zoo_loader(samples, side, classes, batch, n_total + 1))
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, load_ms = [], [], []
    for _ in range(n_total):
        t0 = time.perf_counter()
        hx, hy = next(feed)
        xy = (hx.as_in_context(gpu), hy.as_in_context(gpu))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(step(xy).mean().asscalar()))
        step_ms.append((time.perf_counter() - t1) * 1e3)
        load_ms.append((t1 - t0) * 1e3)
    hx, hy = next(feed)
    xy2 = (hx.as_in_context(gpu), hy.as_in_context(gpu))
    feed.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    log(f"zoo: {name} training losses {losses}")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"{name}: the loss did not fall ({losses})")
    if net._cached_op.num_train_programs < 1:
        raise AssertionError(f"{name}: no training step was captured")
    check = _captured_against_eager(net, loss_fn, xy)
    pending = _pending_pair_against_eager(net, loss_fn, [xy, xy2])
    turns = captured_and_eager(lambda k: step(xy), name)
    cap_p50 = float(np.median(step_ms[warm:]))
    steady = slice(warm + min(ZOO_PREFETCH, steps - 1), n_total)
    loop_s = (sum(step_ms[steady]) + sum(load_ms[steady])) / 1e3
    rec = {"model": name, "image": side, "batch": batch, "samples": samples,
           "losses": losses, "step_p50_ms": cap_p50, "step_turns": turns,
           "images_per_s": batch / (cap_p50 / 1e3),
           "loader_wait_ms": load_ms[warm:],
           "loader_wait_steady_p50_ms": float(np.median(load_ms[steady])),
           "loader_alone_ms_a_batch": loader_alone_ms,
           "loop_images_per_s": batch * len(load_ms[steady]) / loop_s,
           "peak_memory_gib": peak_gb, "captured_vs_eager": check,
           "pending_pair_vs_eager": pending,
           "train_programs": net._cached_op.num_train_programs}
    rec["profile"] = profile_gluon(f"{name} training step (captured)",
                                   lambda: step(xy).asnumpy())
    log(f"zoo: {name} step p50 captured {cap_p50:.2f} ms in the loop, "
        f"{rec['images_per_s']:.1f} images/s on the step alone, "
        f"{rec['loop_images_per_s']:.1f} with the loader's wait "
        f"({rec['loader_wait_steady_p50_ms']:.2f} ms a batch in steady "
        f"state; the loader alone {loader_alone_ms:.2f} ms a batch); idle "
        f"{rec['profile']['idle_share']}")
    return rec, net


def _step_grads(net, loss_fn, xy):
    """One recorded step's loss and every gradient (no update), Dropout's
    generator reseeded first."""
    mt.random.seed(SEED)
    x, y = xy
    with mt.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    return (loss.data.detach().double(),
            [p.grad().data.detach().double() for p in
             net.collect_params().values() if p.grad_req != "null"])


def _captured_against_eager(net, loss_fn, xy):
    """The captured step's loss and gradients against the eager step's on
    one batch, the Dropout generator reseeded before each (so both draw
    the same masks), and two eager steps against each other; a replay
    without the reseed draws other masks."""
    def norm_err(a, b):
        num = sum(float(((g - w) ** 2).sum()) for g, w in zip(a, b))
        den = sum(float((w ** 2).sum()) for w in b)
        return (num / den) ** 0.5

    cap_loss, cap_g = _step_grads(net, loss_fn, xy)
    x, y = xy
    with mt.autograd.record():
        again = loss_fn(net(x), y).data.detach().double()
    if torch.equal(again, cap_loss):
        raise AssertionError("two captured steps drew the same Dropout "
                             "masks")
    with eager():
        eag_loss, eag_g = _step_grads(net, loss_fn, xy)
        eag2_loss, eag2_g = _step_grads(net, loss_fn, xy)
    rec = {"loss_rel_err": float((cap_loss - eag_loss).abs().max()
                                 / eag_loss.abs().max()),
           "grad_norm_rel_err": norm_err(cap_g, eag_g),
           "eager_vs_eager_loss_rel_err": float(
               (eag2_loss - eag_loss).abs().max() / eag_loss.abs().max()),
           "eager_vs_eager_grad_norm_rel_err": norm_err(eag2_g, eag_g)}
    log(f"zoo: captured step against eager: loss {rec['loss_rel_err']:.3e}"
        f", gradients {rec['grad_norm_rel_err']:.3e} of their norm (eager "
        f"against eager: {rec['eager_vs_eager_loss_rel_err']:.3e}, "
        f"{rec['eager_vs_eager_grad_norm_rel_err']:.3e})")
    if rec["loss_rel_err"] > ZOO_LOSS_TOL or \
            rec["grad_norm_rel_err"] > ZOO_GRAD_TOL:
        raise AssertionError(f"captured step against eager: {rec}")
    return rec


def _pending_pair(net, loss_fn, batches):
    """Two recorded calls whose backwards run together (the second made
    while the first's is pending), Dropout's generator reseeded before
    each: both losses and every gradient."""
    with mt.autograd.record():
        losses = []
        for i, (x, y) in enumerate(batches):
            mt.random.seed(SEED + i)
            losses.append(loss_fn(net(x), y))
    mt.autograd.backward(losses)
    return (torch.cat([l.data.detach().double() for l in losses]),
            [p.grad().data.detach().double() for p in
             net.collect_params().values() if p.grad_req != "null"])


def _pending_pair_against_eager(net, loss_fn, batches):
    """`_pending_pair` captured (its second call on a program of its own,
    both replayed) against eager, within ZOO_LOSS_TOL and ZOO_GRAD_TOL."""
    before = net._cached_op.num_train_programs
    _pending_pair(net, loss_fn, batches)
    if net._cached_op.num_train_programs != before + 1:
        raise AssertionError("a call while another's backward was pending "
                             "did not capture a program of its own")
    cap_loss, cap_g = _pending_pair(net, loss_fn, batches)
    with eager():
        eag_loss, eag_g = _pending_pair(net, loss_fn, batches)
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(cap_g, eag_g))
    den = sum(float((w ** 2).sum()) for w in eag_g)
    rec = {"loss_rel_err": float((cap_loss - eag_loss).abs().max()
                                 / eag_loss.abs().max()),
           "grad_norm_rel_err": (num / den) ** 0.5,
           "train_programs": net._cached_op.num_train_programs}
    log(f"zoo: two pending calls captured against eager: loss "
        f"{rec['loss_rel_err']:.3e}, gradients {rec['grad_norm_rel_err']:.3e}"
        " of their norm")
    if rec["loss_rel_err"] > ZOO_LOSS_TOL or \
            rec["grad_norm_rel_err"] > ZOO_GRAD_TOL:
        raise AssertionError(f"two pending calls against eager: {rec}")
    return rec


def zoo_serve_back(net, name="inceptionv3", side=299, batch=ZOO_BATCH,
                   timed=ZOO_TIMED):
    """9c: the trained net exported, loaded back by `SymbolBlock.imports`
    on the card (hybridized) within ZOO_IMPORT_TOL of the hybridized net,
    and served by `Predictor` with every BatchNorm folded."""
    gpu = mt.gpu(0)
    rng = np.random.RandomState(SEED + 3)
    reqs = [mt.nd.array(rng.uniform(-1, 1, (batch, 3, side, side)),
                        ctx=gpu) for _ in range(2)]
    want = [net(r).asnumpy() for r in reqs]
    n_bn = len(_blocks(net, mt.gluon.nn.BatchNorm))
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, name)
    net.export(prefix)
    blk = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0000.params", ctx=gpu)
    blk.hybridize()
    got = [blk(r).asnumpy() for r in reqs]
    import_err = _capture_err(got, want)
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read()
    with open(prefix + "-0000.params", "rb") as f:
        blob = f.read()
    pred = mt.Predictor(sym_json, blob, {"data": (batch, 3, side, side)})
    folded = {r.name: r.rewrites for r in pred._program.opt_reports}
    served = []
    for r in reqs:
        pred.forward(data=r)
        served.append(pred.get_output(0).asnumpy())
    export_err = _capture_err(served, want)
    log(f"zoo: {name} exported: SymbolBlock.imports against the net "
        f"{import_err:.3e}, Predictor {export_err:.3e}, fold_bn folded "
        f"{folded.get('fold_bn')} of {n_bn} BatchNorms")
    if import_err > ZOO_IMPORT_TOL or export_err > RESNET_EXPORT_TOL \
            or folded.get("fold_bn") != n_bn:
        raise AssertionError(f"{name} export: imports {import_err}, "
                             f"Predictor {export_err}, fold_bn "
                             f"{folded.get('fold_bn')} of {n_bn}")

    def predict(r):
        pred.forward(data=r)
        return pred.get_output(0)

    return {"import_rel_err": import_err, "export_rel_err": export_err,
            "fold_bn": folded.get("fold_bn"), "batchnorms": n_bn,
            "symbol_block_p50_ms": _gluon_latency(blk, reqs, timed)["p50_ms"],
            "predictor_p50_ms": _gluon_latency(predict, reqs,
                                               timed)["p50_ms"]}


def zoo_ctc(T=CTC_T, N=CTC_N, C=CTC_C, lengths=CTC_LABELS,
            timed=CTC_TIMED):
    """9d: `gluon.loss.CTCLoss` (TNC, blank last) on the card at an OCR
    shape, imperative and hybridized (the recorded call captured and
    replayed as its forward and backward graphs), its loss and gradient
    against the same block on the CPU in float64 within CTC_TOL relative;
    each way's p50 of ``timed`` calls (forward and backward)."""
    rng = np.random.RandomState(SEED + 4)
    pred = rng.randn(T, N, C).astype(np.float32)
    lab_len = rng.randint(lengths[0], lengths[1] + 1, N)
    label = np.full((N, lengths[1]), -1, np.float32)
    for n, k in enumerate(lab_len):
        label[n, :k] = rng.randint(0, C - 1, k)
    pred_len = rng.randint(max(2 * lengths[1] + 1, T // 2), T + 1, N)
    feeds = (pred, label, pred_len.astype(np.float32),
             lab_len.astype(np.float32))

    def make(ctx, dtype, hybrid):
        arrs = [mt.nd.array(a, ctx=ctx, dtype=dtype) for a in feeds]
        arrs[0].attach_grad()
        loss_fn = mt.gluon.loss.CTCLoss(layout="TNC")
        if hybrid:
            loss_fn.hybridize()

        def run():
            with mt.autograd.record():
                loss = loss_fn(*arrs)
            loss.backward()
            return loss.data.detach().double().cpu(), \
                arrs[0].grad.data.double().cpu()
        return run, loss_fn

    want_loss, want_grad = make(mt.cpu(), "float64", False)[0]()
    rec = {"mean_loss": float(want_loss.mean())}
    for way, hybrid in (("imperative", False), ("hybridized", True)):
        run, loss_fn = make(mt.gpu(0), "float32", hybrid)
        for _ in range(3):
            loss, grad = run()
        if hybrid:
            _, host = replay_launches(run)
            graphs = sum(n for key, n in host.items() if "GraphLaunch" in key)
            if loss_fn._cached_op.num_train_programs != 1 or graphs < 2:
                raise AssertionError(
                    "CTCLoss hybridized: the recorded call was not captured "
                    f"once ({loss_fn._cached_op.num_train_programs}) or a "
                    f"call launched {graphs} graph(s), want 2")
            rec["graph_launches_a_call"] = graphs
        times = []
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        rec[f"{way}_p50_ms"] = float(np.median(times))
        rec[f"{way}_loss_rel_err"] = float(((loss - want_loss).abs()
                                           / want_loss.abs()).max())
        rec[f"{way}_grad_rel_err"] = float((grad - want_grad).abs().max()
                                           / want_grad.abs().max())
        if not torch.isfinite(loss).all() or \
                rec[f"{way}_loss_rel_err"] > CTC_TOL or \
                rec[f"{way}_grad_rel_err"] > CTC_TOL:
            raise AssertionError(f"CTCLoss on the card, {way}: {rec}")
    log(f"zoo: CTCLoss at T {T}, N {N}, {C} classes against float64 on the "
        f"CPU: loss {rec['imperative_loss_rel_err']:.3e} / "
        f"{rec['hybridized_loss_rel_err']:.3e}, gradient "
        f"{rec['imperative_grad_rel_err']:.3e} / "
        f"{rec['hybridized_grad_rel_err']:.3e} (imperative / hybridized); "
        f"forward and backward p50 {rec['imperative_p50_ms']:.2f} / "
        f"{rec['hybridized_p50_ms']:.2f} ms")
    return rec


def phase_zoo(card):
    """Phase 9: the Gluon zoo and data on cuda:0."""
    t_phase = time.perf_counter()
    serving = zoo_serving()
    train, net = zoo_training()
    served_back = zoo_serve_back(net)
    del net
    torch.cuda.empty_cache()
    ctc = zoo_ctc()
    rec = {"phase": "gluon_zoo", "card": card, "dtype": "float32",
           "serving": serving, "training": train,
           "served_back": served_back, "ctc": ctc,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    log(f"zoo: phase 9 in {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 10: the RNN package -- the RNN op, BucketingModule training of the
# PTB LSTM LM, its weights served back onto K4, and the Gluon word LM
# ---------------------------------------------------------------------------

def _rel_err(got, want):
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _event_p50_ms(fn, n=RNN_TIMED, warm=3):
    """p50 of ``n`` calls of ``fn``, each timed alone by CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _rnn_case(mode, layers, bidir, shape, gen, device):
    """Seeded inputs of one RNN op call: data, packed vector and states,
    all requiring gradients."""
    t, n, c, h = shape
    d = 2 if bidir else 1
    size = rnn_op.param_size(mode, layers, c, h, d)
    ins = [torch.randn(t, n, c, generator=gen),
           torch.rand(size, generator=gen) * 0.2 - 0.1,
           0.5 * torch.randn(layers * d, n, h, generator=gen)]
    if mode == "lstm":
        ins.append(0.5 * torch.randn(layers * d, n, h, generator=gen))
    return [x.to(device).requires_grad_() for x in ins]


def _rnn_attrs(mode, layers, bidir, h, p=0.0, train=True):
    return Attrs(mode=mode, state_size=h, num_layers=layers,
                 bidirectional=bidir, state_outputs=True, p=p,
                 __train=train)


def _rnn_plain(mode, layers, bidir, h, ins, p=0.0, gen=None):
    """The step loop on the op's inputs (its outputs in the op's order)."""
    d = 2 if bidir else 1
    params = rnn_op.unpack_params(ins[1], mode, layers, ins[0].shape[-1],
                                  h, d)
    out = rnn_op.rnn_forward_plain(
        mode, ins[0], (ins[2], ins[3] if mode == "lstm" else None), params,
        bidir, p, gen)
    return [o for o in out if o is not None]


def _norm_err(got, want):
    """|got - want| over |want| of a list of tensors, as one vector."""
    num = sum(float((g.double() - w.double()).square().sum())
              for g, w in zip(got, want))
    return (num / max(sum(float(w.double().square().sum()) for w in want),
                      1e-300)) ** 0.5


def _rnn_check(mode, layers, bidir, shape, gen, device):
    """10a, one case: the registered op against the step loop on the same
    inputs and head gradients, and both against the loop in float64.
    Returns the outputs' and the gradients' largest element error, the
    gradients' norm error, each fp32 path's gradient error against
    float64 and the outputs that are zero on one side of float64 (ReLU
    switches: rnn_relu only)."""
    ins = _rnn_case(mode, layers, bidir, shape, gen, device)
    attrs = _rnn_attrs(mode, layers, bidir, shape[3])
    got = list(rnn_op._rnn(attrs, None, *ins))
    want = _rnn_plain(mode, layers, bidir, shape[3], ins)
    heads = [torch.randn(o.shape, generator=gen).to(device) for o in want]
    g_got = torch.autograd.grad(got, ins, heads)
    g_want = torch.autograd.grad(want, ins, heads)
    ins64 = [x.detach().double().requires_grad_() for x in ins]
    exact = _rnn_plain(mode, layers, bidir, shape[3], ins64)
    g_exact = torch.autograd.grad(exact, ins64, [h.double() for h in heads])

    def flips(out):
        return int(((out[0] > 0) != (exact[0] > 0)).sum()) \
            if mode == "rnn_relu" else 0

    return {"out": max(_rel_err(a.detach(), b.detach())
                       for a, b in zip(got, want)),
            "grad": max(_rel_err(a, b) for a, b in zip(g_got, g_want)),
            "grad_norm": _norm_err(g_got, g_want),
            "op_grad_vs_f64": max(_rel_err(a.double(), b)
                                  for a, b in zip(g_got, g_exact)),
            "loop_grad_vs_f64": max(_rel_err(a.double(), b)
                                    for a, b in zip(g_want, g_exact)),
            "op_relu_flips": flips(got), "loop_relu_flips": flips(want)}


def _rnn_case_ok(name, err):
    """The outputs element-wise; the gradients element-wise, but for
    rnn_relu by their norm (a ReLU input within fp32 rounding of 0 routes
    a gradient elsewhere in one of the two)."""
    if name.startswith("rnn_relu"):
        grad_ok = err["grad_norm"] <= RNN_RELU_GRAD_TOL
    else:
        grad_ok = err["grad"] <= RNN_GRAD_TOL
    return err["out"] <= LSTM_SLICE_TOL and grad_ok


def _rnn_masks_and_capture(device):
    """10a: dropout between layers.  With the generator reseeded, the op
    and the step loop draw the same masks; captured as one CUDA graph
    (forward and backward in training mode), a replay from the reseeded
    generator gives the eager call and a replay without the reseed other
    masks."""
    gen = torch.Generator().manual_seed(SEED + 10)
    t, n, c, h = RNN_OP_SHAPES[0]
    ins = _rnn_case("lstm", 2, False, (t, n, c, h), gen, device)
    attrs = _rnn_attrs("lstm", 2, False, h, p=0.5)
    dgen = mt.random.generator(device)
    # no tape here: a live one would hold the inputs' gradient
    # accumulators on this stream, which the capture below may not reach
    with torch.no_grad():
        dgen.manual_seed(SEED)
        got = rnn_op._rnn(attrs, dgen, *ins)
        dgen.manual_seed(SEED)
        want = _rnn_plain("lstm", 2, False, h, ins, 0.5, dgen)
    mask_err = max(_rel_err(a, b) for a, b in zip(got, want))

    def step():
        out = rnn_op._rnn(attrs, dgen, *ins)
        return [out[0].detach()] + list(torch.autograd.grad(
            out[0].square().sum(), ins[:2]))

    warm_up(step, device)
    graph = CapturedGraph(step, device, dgen)
    dgen.manual_seed(SEED + 1)
    eager_out = step()
    dgen.manual_seed(SEED + 1)
    replay = [o.clone() for o in graph.replay()]
    other = graph.replay()
    cap_err = max(_rel_err(a, b) for a, b in zip(replay, eager_out))
    redrawn = not torch.equal(other[0], replay[0])
    return {"mask_err": mask_err, "capture_err": cap_err,
            "replay_redraws": redrawn}


def _rnn_op_profile(ins, attrs):
    """Device time of one forward + backward of the op at the LM's shape,
    with the copies' share (cuDNN's repack of the weight views among
    them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        out = rnn_op._rnn(attrs, None, *ins)
        torch.autograd.grad(out[0].sum(), ins)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(ms for _, ms, _ in rows)
    copies = sum(ms for key, ms, _ in rows
                 if "copy" in key.lower() or "memcpy" in key.lower())
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": busy, "copy_ms": copies,
            "copy_share": copies / busy if busy else "not measured",
            "top": [[k[:80], ms, c] for k, ms, c in rows[:8]]}


def rnn_op_phase(shapes=RNN_OP_SHAPES, timed=RNN_TIMED):
    """10a: the RNN op on the card against its step loop, all modes, 1 and
    2 layers, one and two directions, at ``shapes``; dropout masks and
    the captured training call; then the op's and the loop's p50 at the
    first shape (the LM's), forward and forward + backward."""
    device = mt.gpu(0).device
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must stay off for the RNN op's parity")
    gen = torch.Generator().manual_seed(SEED + 9)
    cases = {}
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for layers, bidir in ((1, False), (1, True), (2, False),
                              (2, True)):
            for shape in shapes:
                cases[f"{mode} L{layers} D{2 if bidir else 1} "
                      f"{list(shape)}"] = _rnn_check(mode, layers, bidir,
                                                     shape, gen, device)
    worst = {k: max(c[k] for c in cases.values())
             for k in next(iter(cases.values()))}
    relu = {k: c for k, c in cases.items() if k.startswith("rnn_relu")}
    worst_relu = {k: max(c[k] for c in relu.values())
                  for k in next(iter(relu.values()))}
    log(f"rnn: op against its step loop, {len(cases)} cases: outputs "
        f"{worst['out']:.3e}, gradients {worst['grad']:.3e} element-wise "
        f"and {worst['grad_norm']:.3e} by norm (limits {LSTM_SLICE_TOL}, "
        f"{RNN_GRAD_TOL}; rnn_relu's {RNN_RELU_GRAD_TOL} by norm); "
        f"against float64 the op's gradients "
        f"{worst['op_grad_vs_f64']:.3e}, the loop's "
        f"{worst['loop_grad_vs_f64']:.3e}")
    rest = [c for k, c in cases.items() if not k.startswith("rnn_relu")]
    log(f"rnn: lstm, gru and rnn_tanh: gradients "
        f"{max(c['grad'] for c in rest):.3e} element-wise")
    log(f"rnn: rnn_relu: gradients {worst_relu['grad']:.3e} element-wise, "
        f"{worst_relu['grad_norm']:.3e} by norm; ReLU outputs switched "
        f"against float64 {sum(c['op_relu_flips'] for c in relu.values())}"
        f" in the op, {sum(c['loop_relu_flips'] for c in relu.values())} "
        f"in the loop")
    bad = {k: v for k, v in cases.items() if not _rnn_case_ok(k, v)}
    if bad:
        raise AssertionError(f"RNN op off its step loop: {bad}")
    masks = _rnn_masks_and_capture(device)
    log(f"rnn: dropout p 0.5 against the loop with the same masks "
        f"{masks['mask_err']:.3e}; captured training call against eager "
        f"{masks['capture_err']:.3e}, a replay redraws: "
        f"{masks['replay_redraws']}")
    if masks["mask_err"] > LSTM_SLICE_TOL or \
            masks["capture_err"] > CAPTURE_TOL or \
            not masks["replay_redraws"]:
        raise AssertionError(f"RNN op dropout or capture: {masks}")
    t, n, c, h = shapes[0]
    ins = _rnn_case("lstm", 2, False, shapes[0], gen, device)
    attrs = _rnn_attrs("lstm", 2, False, h)

    def fwd(fn):
        with torch.no_grad():
            fn()

    def fwd_bwd(fn):
        torch.autograd.grad(fn()[0].sum(), ins)

    op = lambda: rnn_op._rnn(attrs, None, *ins)  # noqa: E731
    plain = lambda: _rnn_plain("lstm", 2, False, h, ins)  # noqa: E731
    times = {"forward_ms": _event_p50_ms(lambda: fwd(op), timed),
             "plain_forward_ms": _event_p50_ms(lambda: fwd(plain), timed),
             "forward_backward_ms": _event_p50_ms(lambda: fwd_bwd(op),
                                                  timed),
             "plain_forward_backward_ms": _event_p50_ms(
                 lambda: fwd_bwd(plain), timed)}
    prof = _rnn_op_profile(ins, attrs)
    log(f"rnn: op p50 at [{t}, {n}, {c}] H {h}, 2 layers: forward "
        f"{times['forward_ms']:.3f} ms (loop {times['plain_forward_ms']:.3f}"
        f"), forward + backward {times['forward_backward_ms']:.3f} ms (loop "
        f"{times['plain_forward_backward_ms']:.3f}); copies "
        f"{prof['copy_ms']:.4f} of {prof['device_ms']:.4f} device ms")
    return {"cases": len(cases), "worst": worst, "worst_relu": worst_relu,
            **masks, **times, "profile": prof}


def _zipf_chain(vocab, seed):
    """A Markov chain over ids 1..vocab-1: each id's RNN_SUCCESSORS next
    ids drawn from a Zipf law over a shuffled vocabulary (as words are
    drawn in text), and the law itself for first words."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(np.arange(1, vocab))
    law = 1.0 / np.arange(1, vocab) ** RNN_ZIPF
    law /= law.sum()
    succ = rng.choice(ids, size=(vocab, RNN_SUCCESSORS), p=law)
    return rng, ids, law, succ


def _markov_sentences(vocab, buckets, per_bucket, seed):
    """``per_bucket`` sentences whose lengths fall in each bucket, as
    lists of word strings."""
    rng, ids, law, succ = _zipf_chain(vocab, seed)
    sents = []
    lo = 1
    for hi in buckets:
        for _ in range(per_bucket):
            length = int(rng.randint(lo + 1, hi + 1))
            s = [int(rng.choice(ids, p=law))]
            for _ in range(length - 1):
                s.append(int(succ[s[-1], rng.randint(RNN_SUCCESSORS)]))
            sents.append([f"w{i}" for i in s])
        lo = hi
    return sents


def _markov_stream(vocab, n, seed):
    """One stream of ``n`` token ids from the same kind of chain."""
    rng, ids, law, succ = _zipf_chain(vocab, seed)
    toks = [int(rng.choice(ids, p=law))]
    picks = rng.randint(RNN_SUCCESSORS, size=n)
    for i in range(n - 1):
        toks.append(int(succ[toks[-1], picks[i]]))
    return np.asarray(toks, np.float32)


def _fused_lm(seq_len, cfg, cell, head):
    """The LM's bucket graph over one `FusedRNNCell` (the reference
    example's ``sym_gen``) with ``head``: 'train' ends in SoftmaxOutput
    over the shifted labels, 'serve' in softmax."""
    sym = mt.sym
    embed = sym.Embedding(sym.var("data"), input_dim=cfg["vocab"],
                          output_dim=cfg["num_embed"], name="embed")
    cell.reset()
    out, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
    pred = sym.Reshape(out, shape=(-1, cfg["num_hidden"]))
    pred = sym.FullyConnected(pred, num_hidden=cfg["vocab"], name="pred")
    if head == "serve":
        return sym.softmax(pred, axis=-1, name="softmax")
    label = sym.Reshape(sym.var("softmax_label"), shape=(-1,))
    return sym.SoftmaxOutput(pred, label, name="softmax")


def _unfused_stack(cfg):
    """Phase 6's unfused layers: the cells that `lstm_lm` unrolls."""
    stack = mt.rnn.SequentialRNNCell()
    for i in range(cfg["num_layers"]):
        stack.add(mt.rnn.LSTMCell(cfg["num_hidden"], prefix=f"lstm_l{i}_"))
    return stack


def _bucket_batches(it):
    """One batch of each bucket from the iterator."""
    it.reset()
    out = {}
    for b in it:
        out.setdefault(b.bucket_key, b)
    return out


def _step_timing(mod, batches, n):
    """Per bucket: the training step's p50 (forward, backward and the
    update, ending in a device synchronize), tokens/s, and the host
    metric's p50 (the probabilities' copy to the host and the sum)."""
    rec = {}
    metric = mt.metric.Perplexity(0)
    for key in sorted(batches):
        b = batches[key]
        times, mtimes = [], []
        for i in range(n + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(b)
            mod.update()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mod.update_metric(metric, b.label)
            if i >= 2:
                times.append((t1 - t0) * 1e3)
                mtimes.append((time.perf_counter() - t1) * 1e3)
        p50 = float(np.median(times))
        tokens = b.data[0].shape[0] * key
        rec[str(key)] = {"step_p50_ms": p50, "tokens_per_s":
                         tokens / (p50 / 1e3),
                         "metric_p50_ms": float(np.median(mtimes))}
        log(f"rnn: bucket {key} step p50 {p50:.2f} ms, "
            f"{tokens / (p50 / 1e3):.0f} tokens/s; host metric "
            f"{rec[str(key)]['metric_p50_ms']:.2f} ms")
    return rec


def rnn_lm_training(card, cfg=None, buckets=RNN_BUCKETS, batch=RNN_BATCH,
                    per_bucket=RNN_SENTENCES, epochs=RNN_EPOCHS,
                    timed=RNN_STEP_TIMED):
    """10b and 10c: the PTB LSTM LM trained through ``BucketingModule.fit``
    over `BucketSentenceIter` batches of every bucket, checkpointed each
    epoch by ``do_rnn_checkpoint``; then the last checkpoint served back
    through phase 6's unfused graph onto K4 against the fused graph and
    the module's own inference forward; then each bucket's step timed and
    one step at the largest bucket profiled."""
    cfg = dict(cfg or PTB_LSTM)
    gpu = mt.gpu(0)
    t0 = time.perf_counter()
    sents = _markov_sentences(cfg["vocab"], buckets, per_bucket, SEED + 11)
    coded, vocab = mt.rnn.encode_sentences(sents, invalid_label=0,
                                           start_label=1)
    if len(vocab) > cfg["vocab"]:
        raise AssertionError(f"{len(vocab)} words for a vocabulary of "
                             f"{cfg['vocab']}")
    it = mt.rnn.BucketSentenceIter(coded, batch, buckets=list(buckets),
                                   invalid_label=0)
    data_s = time.perf_counter() - t0
    cell = mt.rnn.FusedRNNCell(cfg["num_hidden"],
                               num_layers=cfg["num_layers"], mode="lstm",
                               prefix="lstm_")

    def sym_gen(seq_len):
        return (_fused_lm(seq_len, cfg, cell, "train"), ("data",),
                ("softmax_label",))

    mt.random.seed(SEED)
    mod = mt.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=gpu)
    ppl = []
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as ckpt_dir:
        prefix = os.path.join(ckpt_dir, "ptb_lstm")
        save = mt.rnn.do_rnn_checkpoint(cell, prefix)
        metric = mt.metric.Perplexity(0)

        def epoch_end(epoch, sym, arg, aux):
            ppl.append(metric.get()[1])
            save(epoch, sym, arg, aux)

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mod.fit(it, eval_metric=metric, num_epoch=epochs,
                optimizer="sgd", optimizer_params=dict(RNN_SGD),
                initializer=mt.init.Xavier(factor_type="in",
                                           magnitude=2.34),
                epoch_end_callback=epoch_end)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        log(f"rnn: BucketingModule.fit {epochs} epochs of "
            f"{len(it.idx)} batches in {fit_s:.1f} s; perplexity by epoch "
            f"{ppl}; buckets {sorted(mod._buckets)}")
        if sorted(mod._buckets) != sorted(buckets):
            raise AssertionError(f"trained buckets {sorted(mod._buckets)},"
                                 f" want {list(buckets)}")
        if not (np.isfinite(ppl).all() and ppl[-1] < ppl[0]):
            raise AssertionError(f"perplexity did not fall: {ppl}")
        files = sorted(os.listdir(ckpt_dir))
        if len([f for f in files if f.endswith(".params")]) != epochs:
            raise AssertionError(f"checkpoints written: {files}")
        batches = _bucket_batches(it)
        served = rnn_serve_back(mod, cell, cfg, prefix, epochs, batches,
                                (max(buckets), min(buckets)))
    timing = _step_timing(mod, batches, timed)
    RNN_RECORD["step_p50_ms"] = timing[str(max(buckets))]["step_p50_ms"]
    big = batches[max(buckets)]

    def train_step():
        mod.forward_backward(big)
        mod.update()

    prof = profile_gluon(f"PTB LSTM LM training step T {max(buckets)}",
                         train_step)
    return {"config": cfg, "batch": batch, "buckets": list(buckets),
            "sentences": len(coded), "batches_an_epoch": len(it.idx),
            "data_s": data_s, "fit_s": fit_s, "perplexity": ppl,
            "steps": timing, "profile": prof, "served_back": served}


def _module_probs(mod, batch):
    mod.forward(batch, is_train=False)
    return mod.get_outputs()[0].asnumpy()


def rnn_serve_back(mod, cell, cfg, prefix, epoch, batches, keys):
    """10c: the last checkpoint through ``load_rnn_checkpoint`` into phase
    6's unfused graph (`lstm_lm`), served by `Predictor` with every cell
    on K4, against a `Predictor` of the fused graph on the packed weights
    and the module's own inference forward, per bucket of ``keys`` (the
    largest first); the K4 launches of the unfused Predictors' forwards
    counted."""
    _, unfused_args, _ = mt.rnn.load_rnn_checkpoint(_unfused_stack(cfg),
                                                     prefix, epoch)
    _, fused_args, _ = mt.rnn.load_rnn_checkpoint(cell, prefix, epoch)
    blobs = {way: dumps_ndarrays({"arg:" + n: a for n, a in args.items()})
             for way, args in (("unfused", unfused_args),
                               ("fused", fused_args))}
    rec = {}
    launches = 0
    for t in keys:
        b = batches[t]
        feed = {"data": b.data[0].asnumpy()}
        shapes = {"data": feed["data"].shape}
        with pallas_mode("auto"):
            pred = mt.Predictor(lstm_lm(mt, t, **cfg).tojson(),
                                blobs["unfused"], shapes)
            rewrites, attn, lstm = _site_counts(pred)
            if (rewrites, attn, lstm) != (2 * t, 0, 2 * t):
                raise AssertionError(f"serve-back T {t}: {rewrites} "
                                     f"rewrites, {lstm} LSTM sites")
            before = hk.LAUNCHES["lstm_gates"]
            outs, _ = _serve(pred, [feed, feed], {"lstm_gates": 2 * t})
            launches += hk.LAUNCHES["lstm_gates"] - before
        fused = mt.Predictor(_fused_lm(t, cfg, cell, "serve").tojson(),
                             blobs["fused"], shapes)
        ref, _ = _serve(fused, [feed], {"lstm_gates": 0})
        own = _module_probs(mod, b)
        vocab = cfg["vocab"]
        err_fused = _check_lm_outputs(outs[:1], ref, b.data[0].shape[0], t,
                                      vocab)
        err_mod = _check_lm_outputs(outs[1:], [own], b.data[0].shape[0], t,
                                    vocab)
        rec[str(t)] = {"max_abs_diff_vs_fused": err_fused,
                       "max_abs_diff_vs_module": err_mod}
        log(f"rnn: served back at T {t} on K4 ({2 * t} launches a "
            f"forward): against the fused graph {err_fused:.3e}, against "
            f"the module's forward {err_mod:.3e} (limit {LSTM_SLICE_TOL})")
    rec["k4_launches"] = launches
    return rec


class _WordLM(mt.gluon.HybridBlock):
    """The reference's example/gluon/word_language_model model."""

    def __init__(self, vocab, embed, hidden, layers, dropout, **kwargs):
        super().__init__(**kwargs)
        self._hidden = hidden
        with self.name_scope():
            self.drop = mt.gluon.nn.Dropout(dropout)
            self.encoder = mt.gluon.nn.Embedding(
                vocab, embed, weight_initializer=mt.init.Uniform(0.1))
            self.rnn = mt.gluon.rnn.LSTM(hidden, layers, dropout=dropout,
                                         input_size=embed)
            self.decoder = mt.gluon.nn.Dense(vocab, in_units=hidden)

    def hybrid_forward(self, F, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        return self.decoder(F.reshape(output, shape=(-1, self._hidden))), \
            hidden


def gluon_word_lm(cfg=None, bptt=WORD_BPTT, batch=WORD_BATCH,
                  steps=WORD_STEPS):
    """10d: the word LM hybridized and trained on a synthetic token stream
    (SGD lr 20 on the mean loss, the gradients' norm clipped to WORD_CLIP,
    the states detached between batches): the loss must fall; with the Dropout
    generator reseeded the captured step must give the eager step's loss
    and gradients, and a replay without the reseed other masks; the step
    timed captured and eager in turns."""
    cfg = dict(cfg or WORD_LM)
    gpu = mt.gpu(0)
    stream = _markov_stream(cfg["vocab"], bptt * batch * (steps + 1) + 1,
                            SEED + 12)
    n = (len(stream) - 1) // batch
    src = stream[:n * batch].reshape(batch, n).T        # (n, batch)
    tgt = stream[1:n * batch + 1].reshape(batch, n).T
    pairs = [(mt.nd.array(src[i * bptt:(i + 1) * bptt], ctx=gpu),
              mt.nd.array(tgt[i * bptt:(i + 1) * bptt].reshape(-1),
                          ctx=gpu)) for i in range(n // bptt)]
    mt.random.seed(SEED)
    net = _WordLM(**cfg, prefix="wordlm_")
    net.initialize(mt.init.Xavier(), ctx=gpu)
    net.hybridize()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": WORD_LR, "momentum": 0,
                                "wd": 0})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    zeros = net.rnn.begin_state(batch_size=batch, ctx=gpu)
    state = {"hidden": zeros}

    def forward_backward(x, y, hidden):
        with mt.autograd.record():
            out, new = net(x, hidden)
            loss = loss_fn(out, y) / (bptt * batch)
        loss.backward()
        return loss, new

    def step(k):
        x, y = pairs[k % len(pairs)]
        hidden = [h.detach() for h in state["hidden"]]
        loss, state["hidden"] = forward_backward(x, y, hidden)
        mt.gluon.utils.clip_global_norm([p.grad() for p in params],
                                        WORD_CLIP)
        trainer.step(1)
        return loss

    losses = [float(step(k).sum().asscalar()) for k in range(steps)]
    log(f"rnn: word LM losses {[round(v, 4) for v in losses]}")
    if not (np.isfinite(losses).all() and
            np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"word LM: the loss did not fall ({losses})")
    if net._cached_op.num_train_programs < 1:
        raise AssertionError("word LM: no training step was captured")

    def grads_once(x, y):
        mt.random.seed(SEED)
        loss, _ = forward_backward(x, y, zeros)
        return (loss.data.detach().double(),
                [p.grad().data.detach().double() for p in params])

    x, y = pairs[0]
    cap_loss, cap_g = grads_once(x, y)
    with mt.autograd.record():
        again = loss_fn(net(x, zeros)[0], y).data.detach().double()
    with eager():
        eag_loss, eag_g = grads_once(x, y)
        eag2_loss, eag2_g = grads_once(x, y)

    check = {"loss_rel_err": _rel_err(cap_loss, eag_loss),
             "grad_norm_rel_err": _norm_err(cap_g, eag_g),
             "eager_vs_eager_loss_rel_err": _rel_err(eag2_loss, eag_loss),
             "eager_vs_eager_grad_norm_rel_err": _norm_err(eag2_g, eag_g),
             "replay_redraws": not torch.equal(again, cap_loss)}
    log(f"rnn: word LM captured step against eager: loss "
        f"{check['loss_rel_err']:.3e}, gradients "
        f"{check['grad_norm_rel_err']:.3e} of their norm (eager against "
        f"eager {check['eager_vs_eager_loss_rel_err']:.3e}, "
        f"{check['eager_vs_eager_grad_norm_rel_err']:.3e}); a replay "
        f"redraws: {check['replay_redraws']}")
    if check["loss_rel_err"] > ZOO_LOSS_TOL or \
            check["grad_norm_rel_err"] > ZOO_GRAD_TOL or \
            not check["replay_redraws"]:
        raise AssertionError(f"word LM captured step against eager: {check}")
    turns = captured_and_eager(step, "word LM")
    return {"config": cfg, "bptt": bptt, "batch": batch, "losses": losses,
            "captured_vs_eager": check, "step_turns": turns,
            "tokens_per_s_captured": bptt * batch /
            (turns["captured_p50_ms"] / 1e3)}


def phase_rnn(card):
    """Phase 10: the RNN package on cuda:0.  Returns the K4 launches of
    its main path (10c's unfused Predictors)."""
    t_phase = time.perf_counter()
    op = rnn_op_phase()
    hk.reset_launch_counts()
    lm = rnn_lm_training(card)
    launches = dict(hk.LAUNCHES)
    if launches["lstm_gates"] != lm["served_back"]["k4_launches"] or \
            any(launches[k] for k in ATTN_KERNELS):
        raise AssertionError(f"phase 10 launched {launches}; want only the "
                             "served-back forwards' K4")
    torch.cuda.empty_cache()
    word = gluon_word_lm()
    rec = {"phase": "rnn", "card": card, "dtype": "float32", "op": op,
           "bucketing_lm": lm, "word_lm": word, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    log(f"rnn: phase 10 in {rec['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: training state and sparse storage
# ---------------------------------------------------------------------------

def _zipf_ranks(rng, shape, n, s):
    """Ranks in [0, n) with P(r) ∝ 1 / (r + 1)^s (a truncated Zipf law,
    drawn by the inverse of its cumulative weights)."""
    cdf = np.cumsum(1.0 / np.arange(1, n + 1) ** s)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.rand(*shape)), n - 1)


def _avazu_batches(dim, batch, steps, nnz, seed):
    """``steps`` CSR batches of ``batch`` rows at ``dim`` features, made
    from the seed: each row one-hot in ``nnz`` fields of dim / nnz
    columns (ascending, value 1), each field's category drawn
    Zipf-skewed; labels from a hidden logistic model.  Returned as numpy
    (indptr, indices, values, labels)."""
    rng = np.random.RandomState(seed)
    field = dim // nnz
    w_true = rng.randn(dim) * 0.5
    out = []
    for _ in range(steps):
        cols = _zipf_ranks(rng, (batch, nnz), field, AVAZU_ZIPF) + \
            np.arange(nnz) * field
        z = w_true[cols].sum(1) + 0.5 * rng.randn(batch)
        out.append((np.arange(batch + 1, dtype=np.int64) * nnz,
                    cols.reshape(-1).astype(np.int64),
                    np.ones(batch * nnz, np.float32),
                    (z > 0).astype(np.float32).reshape(-1, 1)))
    return out


def _rel_max(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() /
                 max(np.abs(want).max(), 1e-30))


def _wall_p50(fn, n):
    """Median ms of ``n`` calls of ``fn``, each ending in a device
    synchronize (host-bound calls: the wall time is what a step pays)."""
    fn()
    return _step_ms(fn, n)


def sparse_linear(card, dim=AVAZU["dim"], batch=AVAZU["batch"],
                  steps=AVAZU["steps"], nnz=AVAZU["nnz"], lr=AVAZU["lr"],
                  n_ids=AVAZU["pull_ids"], timed=SPARSE_TIMED):
    """11a: the reference's ``example/sparse/linear_classification.py``
    local-store loop (`_train_local`) on ``mt.gpu(0)``: the weight lives
    in a local KVStore with SGD on push, the forward is ``sparse.dot(X,
    w)``, the gradient the transposed dot cast to row_sparse and pushed,
    the weight pulled back; the same steps in float64 on the host are the
    reference."""
    import scipy.sparse as spsp
    from mxnet_tpu_torch.ndarray import sparse as msp
    ctx = mt.gpu(0)
    t0 = time.perf_counter()
    data = _avazu_batches(dim, batch, steps, nnz, SEED + 11)
    host = [spsp.csr_matrix((v.astype(np.float64), i, p), shape=(batch, dim))
            for p, i, v, _ in data]
    xs = [msp.csr_matrix((v, i, p), shape=(batch, dim), ctx=ctx)
          for p, i, v, _ in data]
    setup_s = time.perf_counter() - t0
    for x in xs[:2]:
        x.check_format()

    kv = mt.kv.create("local")
    kv.init("w", mt.nd.zeros((dim, 1), ctx=ctx))
    kv.set_optimizer(mt.optimizer.SGD(learning_rate=lr))
    weight = mt.nd.zeros((dim, 1), ctx=ctx)
    bias = np.zeros((1,), np.float32)
    w64, b64 = np.zeros(dim), 0.0
    losses, eps = [], 1e-7

    def step(k, train_host=False):
        nonlocal bias, w64, b64
        xb, yb = xs[k], data[k][3]
        z = msp.dot(xb, weight).asnumpy() + bias
        with np.errstate(over="ignore"):       # exp(-z) = inf gives p = 0
            p = 1.0 / (1.0 + np.exp(-z))
        loss = float(-(yb * np.log(p + eps) +
                       (1 - yb) * np.log(1 - p + eps)).mean())
        gz = mt.nd.array((p - yb) / batch, ctx=ctx)
        grad = msp.dot(xb, gz, transpose_a=True).tostype("row_sparse")
        kv.push("w", grad)
        kv.pull("w", out=weight)
        bias -= lr * float((p - yb).mean())
        if train_host:
            z64 = host[k] @ w64 + b64
            p64 = 1.0 / (1.0 + np.exp(-z64))
            g64 = (p64 - yb[:, 0]) / batch
            w64 -= lr * (host[k].T @ g64)
            b64 -= lr * g64.sum()
        return loss

    t0 = time.perf_counter()
    for k in range(steps):
        losses.append(step(k, train_host=True))
    train_s = time.perf_counter() - t0
    w_err = _rel_max(weight.asnumpy()[:, 0], w64)
    first, last = np.mean(losses[:8]), np.mean(losses[-8:])
    log(f"11a: {steps} steps at {dim} features, batch {batch}: loss "
        f"{first:.5f} -> {last:.5f}; weight against float64 "
        f"{w_err:.3e} of its largest magnitude")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"11a: the loss did not fall: {losses}")
    if w_err > SPARSE_TOL:
        raise AssertionError(f"11a: weight off float64 by {w_err}")

    # one batch's products against float64 on the same rows, and the
    # transposed product's determinism
    w_now = weight.asnumpy()[:, 0].astype(np.float64)
    g = np.random.RandomState(SEED + 12).randn(batch, 1).astype(np.float32)
    gnd = mt.nd.array(g, ctx=ctx)
    dot_err = _rel_max(msp.dot(xs[0], weight).asnumpy()[:, 0],
                       host[0] @ w_now)
    t1 = msp.dot(xs[0], gnd, transpose_a=True).data
    t2 = msp.dot(xs[0], gnd, transpose_a=True).data
    dot_t_err = _rel_max(t1.cpu().numpy()[:, 0],
                         host[0].T @ g[:, 0].astype(np.float64))
    rerun_equal = bool(torch.equal(t1, t2))
    log(f"11a: dot {dot_err:.3e}, transposed dot {dot_t_err:.3e} of the "
        f"float64 result's largest magnitude; transposed rerun bit-equal "
        f"{rerun_equal}")
    if max(dot_err, dot_t_err) > SPARSE_TOL or not rerun_equal:
        raise AssertionError("11a: a sparse dot is off float64 or not "
                             "deterministic")

    # row_sparse_pull of n_ids ids (repeats included) against the rows of
    # the pulled dense weight
    rng = np.random.RandomState(SEED + 13)
    touched = np.unique(np.concatenate([d[1] for d in data[:4]]))
    ids = np.concatenate([rng.choice(touched, n_ids // 2),
                          rng.randint(0, dim, n_ids - n_ids // 2)])
    out = msp.zeros("row_sparse", (dim, 1), ctx=ctx)
    kv.row_sparse_pull("w", out=out, row_ids=mt.nd.array(ids, ctx=ctx))
    out.check_format()
    uids = np.unique(ids)
    pulled_ok = bool(np.array_equal(out.indices.asnumpy(), uids) and
                     np.array_equal(out.sp_data.asnumpy()[:, 0],
                                    weight.asnumpy()[uids, 0]))
    if not pulled_ok:
        raise AssertionError("11a: row_sparse_pull rows differ from the "
                             "pulled weight")

    # times (after the checks: the timed steps train on)
    k = [0]

    def next_step():
        k[0] = (k[0] + 1) % steps
        step(k[0])
    xb = xs[1]
    gz = mt.nd.array(np.full((batch, 1), 1e-3, np.float32), ctx=ctx)
    grad = msp.dot(xb, gz, transpose_a=True).tostype("row_sparse")
    ms = {"step": _wall_p50(next_step, timed),
          "dot": _wall_p50(lambda: msp.dot(xb, weight), timed),
          "dot_transposed": _wall_p50(
              lambda: msp.dot(xb, gz, transpose_a=True), timed),
          "cast_row_sparse": _wall_p50(
              lambda: msp.dot(xb, gz, transpose_a=True).tostype(
                  "row_sparse"), timed),
          "push": _wall_p50(lambda: kv.push("w", grad), timed),
          "pull": _wall_p50(lambda: kv.pull("w", out=weight), timed)}
    prof = profile_gluon("11a sparse linear step", next_step)
    rec = {"sub": "11a_sparse_linear", "card": card, "dim": dim,
           "batch": batch, "steps": steps, "nnz_per_row": nnz,
           "zipf_s": AVAZU_ZIPF, "lr": lr, "setup_s": setup_s,
           "train_s_with_host_float64": train_s,
           "loss_first8": first, "loss_last8": last,
           "weight_rel_err_vs_float64": w_err, "dot_rel_err": dot_err,
           "dot_transposed_rel_err": dot_t_err,
           "dot_transposed_rerun_bit_equal": rerun_equal,
           "row_sparse_pull_ids": int(n_ids),
           "row_sparse_pull_unique": int(uids.size),
           "p50_ms": ms, "examples_per_s": batch / (ms["step"] / 1e3),
           "idle_share": prof["idle_share"]}
    log(json.dumps(rec))
    return rec


def _write_libsvm(path, rows, dim, density, seed):
    """A LIBSVM file of ``rows`` rows at ``dim`` features, each feature
    present with probability ``density`` (a uniform value in (0, 1)),
    label 1: `tests/test_sparse_fm_train.py`'s data."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            cols = np.nonzero(rng.rand(dim) < density)[0]
            vals = rng.rand(cols.size)
            f.write("1 " + " ".join(f"{c}:{v:.6f}" for c, v in
                                    zip(cols, vals)) + "\n")


def _fm_symbol(factor, dim, init):
    """`tests/test_sparse_fm_train.py`'s factorization machine."""
    sym = mt.sym
    x = sym.Variable("data", stype="csr")
    v = sym.var("v", shape=(dim, factor), init=init, stype="row_sparse")
    w1_weight = sym.var("w1_weight", shape=(dim, 1), init=init,
                        stype="row_sparse")
    w1_bias = sym.var("w1_bias", shape=(1,))
    w1 = sym.broadcast_add(sym.dot(x, w1_weight), w1_bias)
    v_s = sym._internal._square_sum(data=v, axis=1, keepdims=True)
    bd_sum = sym.dot(sym.square(data=x), v_s)
    w2_squared = 0.5 * sym.square(data=sym.dot(x, v))
    sum1 = sym.sum(data=sym.Concat(w1, w2_squared, dim=1), axis=1,
                   keepdims=True)
    model = sym.elemwise_add(sum1, 0.5 * sym.negative(bd_sum))
    return sym.LinearRegressionOutput(data=model, label=sym.Variable("label"))


def fm_libsvm(card, dim=FM["dim"], factor=FM["factor"], batch=FM["batch"],
              batches=FM["batches"], runs=FM_RUNS):
    """11b: the factorization machine through ``Module.fit`` over a
    `LibSVMIter` on a file this phase writes, each optimizer of
    `tests/test_sparse_fm_train.py` with its settings, epochs and MSE
    threshold; then ``v`` (row_sparse) and a batch (csr) through one
    ``.params`` file."""
    from mxnet_tpu_torch import serialization as ser
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fm_")
    path = os.path.join(tmp, "fm.libsvm")
    _write_libsvm(path, batch * batches, dim, FM["density"], SEED + 14)
    opts = {"sgd": lambda: mt.optimizer.SGD(
                momentum=0.1, clip_gradient=5.0, learning_rate=0.01,
                rescale_grad=1.0 / batch),
            "adam": lambda: mt.optimizer.Adam(
                clip_gradient=5.0, learning_rate=0.0005,
                rescale_grad=1.0 / batch),
            "adagrad": lambda: mt.optimizer.AdaGrad(
                clip_gradient=5.0, learning_rate=0.01,
                rescale_grad=1.0 / batch)}
    results = {}
    mod = None
    for name, epochs, limit in runs:
        mt.random.seed(SEED)
        init = mt.initializer.Normal(sigma=0.01)
        it = mt.io.LibSVMIter(path, data_shape=(dim,), batch_size=batch)
        mod = mt.mod.Module(_fm_symbol(factor, dim, init),
                            data_names=["data"], label_names=["label"])
        metric = mt.metric.create("MSE")
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=epochs, optimizer=opts[name](),
                initializer=init, eval_metric=metric)
        secs = time.perf_counter() - t0
        mse = metric.get()[1]
        results[name] = {"epochs": epochs, "final_mse": mse,
                         "threshold": limit, "fit_s": secs,
                         "step_ms": secs * 1e3 / (epochs * batches)}
        log(f"11b: FM with {name}: MSE {mse:.5f} after {epochs} epochs "
            f"(limit {limit}), {secs:.2f} s")
        if not mse < limit:
            raise AssertionError(f"11b: {name} MSE {mse} not under {limit}")
    first = next(iter(mt.io.LibSVMIter(path, data_shape=(dim,),
                                       batch_size=batch))).data[0]
    v = mod._exec.arg_dict["v"].tostype("row_sparse")
    f = os.path.join(tmp, "fm.params")
    ser.save_ndarrays(f, {"arg:v": v, "data": first})
    back = ser.load_ndarrays(f)
    same = (back["arg:v"].stype == "row_sparse" and
            back["data"].stype == "csr" and
            np.array_equal(back["arg:v"].asnumpy(), v.asnumpy()) and
            np.array_equal(back["data"].asnumpy(), first.asnumpy()))
    nbytes = os.path.getsize(f)
    if not same:
        raise AssertionError("11b: sparse .params did not load back equal")
    rec = {"sub": "11b_fm_libsvm", "card": card, "feature_dim": dim,
           "factor": factor, "batch": batch, "batches": batches,
           "runs": results, "sparse_params_bytes": nbytes,
           "v_rows_stored": int(v._sp_indices.numel()),
           "batch_nnz": int(first.nnz)}
    log(json.dumps(rec))
    shutil.rmtree(tmp, ignore_errors=True)
    return rec


def _ckpt_job(cfg, batch, seq, init_file):
    """The fit of 11c, run alike by this process and its children:
    phase 7's model with dropout 0.1 and BERT's Adam, FIT_EPOCHS epochs of
    FIT_BATCHES batches, weights from ``init_file``."""
    from mxnet_tpu_torch.serialization import load_ndarrays
    it = _fit_iter(cfg["vocab"], batch, seq)
    mod = mt.mod.Module(bert_mlm(mt.sym, **cfg),
                        data_names=("data", "positions"),
                        label_names=("mlm_label",))
    mt.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=FIT_EPOCHS, optimizer="adam",
            optimizer_params=_fit_adam(), arg_params=load_ndarrays(init_file))
    return mod, time.perf_counter() - t0


def _module_state(mod):
    """The parameters and the Adam states of ``mod``, as numpy."""
    arg, _ = mod.get_params()
    out = {f"arg:{k}": v.asnumpy() for k, v in arg.items()}
    for k, st in mod._active_updater().states.items():
        for i, s in enumerate(st):
            out[f"state:{k}:{i}"] = s.asnumpy()
    return out


def ckpt_child(job_file):
    """A child process of 11c: run `_ckpt_job` under the environment it
    was given (``MXTPU_CKPT_DIR``, ``MXTPU_CKPT_COMMIT_DELAY``), writing
    its start-up time, whether the kernels were built already, and at the
    end the module's state."""
    t_start = time.time()
    with open(job_file) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = all(os.path.exists(cuda_build._library_path(n))
                for n in ("flash_attn_fwd", "flash_attn_bwd"))
    with open(job["ready"], "w") as f:
        json.dump({"ready_wall": time.time(), "own_s": time.time() - t_start,
                   "kernels_built_already": built}, f)
    hk.reset_launch_counts()
    mod, fit_s = _ckpt_job(job["cfg"], job["batch"], job["seq"], job["init"])
    state = _module_state(mod)
    np.savez(job["out"], **state)
    with open(job["done"], "w") as f:
        json.dump({"fit_s": fit_s, "launches": dict(hk.LAUNCHES)}, f)


def _spawn_child(job, env_extra):
    path = job["job"]
    with open(path, "w") as f:
        json.dump(job, f)
    env_ = dict(os.environ, **env_extra)
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", CHILD_ENTRY, path],
        cwd=HERE, env=env_, stdout=open(job["log"], "w"),
        stderr=subprocess.STDOUT)
    return proc, t0


def _child_log(job):
    with open(job["log"]) as f:
        return f.read()[-4000:]


def _files_bytes(directory):
    return sum(os.path.getsize(os.path.join(directory, n))
               for n in os.listdir(directory))


def ckpt_resume(card, cfg=None, batch=8, seq=512):
    """11c: ``Module.fit`` with ``MXTPU_CKPT_DIR``: run A in this
    process; run B in a child killed (SIGKILL) while its second epoch's
    checkpoint is being written, the window widened by
    ``MXTPU_CKPT_COMMIT_DELAY``; a second child resumes from
    ``latest_valid()`` and must end bit-equal to A, parameters and Adam
    states; a truncated newest ``params.params`` must make
    ``latest_valid()`` fall back one step.  Returns the launches of run A
    (this process's)."""
    import signal
    from mxnet_tpu_torch.checkpoint import CheckpointManager, MANIFEST_NAME
    from mxnet_tpu_torch.serialization import save_ndarrays
    cfg = dict(dict(BERT_BASE, num_layers=CKPT_LAYERS) if cfg is None
               else cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    it = _fit_iter(cfg["vocab"], batch, seq)
    shapes = {d.name: d.shape for d in it.provide_data + it.provide_label}
    sym = bert_mlm(mt.sym, **cfg)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    init = os.path.join(tmp, "init.params")
    save_ndarrays(init, {n: NDArray(torch.from_numpy(v)) for n, v in
                         random_params({n: s for n, s in
                                        zip(sym.list_arguments(), arg_shapes)
                                        if n not in shapes}, SEED).items()})

    # run A: uninterrupted, in this process, its saves timed
    dir_a = os.path.join(tmp, "a")
    saves = []
    real_save = CheckpointManager.save_module

    def timed_save(self, module, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck = real_save(self, module, *a, **k)
        saves.append((time.perf_counter() - t0, _files_bytes(ck.directory)))
        return ck
    hk.reset_launch_counts()
    CheckpointManager.save_module = timed_save
    try:
        with env(MXTPU_CKPT_DIR=dir_a, MXTPU_CKPT_KEEP="2"):
            mod, fit_a_s = _ckpt_job(cfg, batch, seq, init)
    finally:
        CheckpointManager.save_module = real_save
    launches = dict(hk.LAUNCHES)
    _check_launches(f"11c run A over {FIT_EPOCHS * FIT_BATCHES} steps",
                    launches, cfg["num_layers"] * FIT_EPOCHS * FIT_BATCHES)
    want = _module_state(mod)
    mgr_a = CheckpointManager(dir_a, keep_n=2)
    t0 = time.perf_counter()
    mgr_a.restore(module=mod)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del mod
    shutil.rmtree(dir_a, ignore_errors=True)
    torch.cuda.empty_cache()

    # run B: killed inside epoch 2's save
    dir_b = os.path.join(tmp, "b")
    job = {"cfg": cfg, "batch": batch, "seq": seq, "init": init,
           "job": os.path.join(tmp, "b.json"),
           "log": os.path.join(tmp, "b.log"),
           "ready": os.path.join(tmp, "b.ready"),
           "out": os.path.join(tmp, "b.npz"),
           "done": os.path.join(tmp, "b.done")}
    proc, t_spawn = _spawn_child(job, {
        "MXTPU_CKPT_DIR": dir_b, "MXTPU_CKPT_KEEP": "2",
        "MXTPU_CKPT_COMMIT_DELAY": str(CKPT_COMMIT_DELAY)})
    target = os.path.join(dir_b, "step-00000001")
    deadline = time.time() + CKPT_CHILD_TIMEOUT
    try:
        while not os.path.exists(os.path.join(target, "optimizer.states")):
            if proc.poll() is not None:
                raise AssertionError("11c: child B ended before its "
                                     f"second save:\n{_child_log(job)}")
            if time.time() > deadline:
                raise AssertionError("11c: child B never reached its "
                                     f"second save:\n{_child_log(job)}")
            time.sleep(0.02)
        killed_uncommitted = not os.path.exists(
            os.path.join(target, MANIFEST_NAME))
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(job["ready"]) as f:
        ready_b = json.load(f)
    mgr_b = CheckpointManager(dir_b, keep_n=2)
    ck_b = mgr_b.latest_valid()
    aborted_left = os.path.isdir(target) and not os.path.exists(
        os.path.join(target, MANIFEST_NAME))
    log(f"11c: child B killed with step 1 uncommitted "
        f"({killed_uncommitted}); latest_valid {ck_b}; the aborted step "
        f"left on disk {aborted_left}")
    if not (killed_uncommitted and aborted_left and ck_b is not None
            and ck_b.step == 0 and ck_b.epoch == 0):
        raise AssertionError("11c: the kill did not leave epoch 1's "
                             "checkpoint as the newest valid one")

    # run C: a fresh child resumes from it and finishes
    job_c = dict(job, job=os.path.join(tmp, "c.json"),
                 log=os.path.join(tmp, "c.log"),
                 ready=os.path.join(tmp, "c.ready"),
                 out=os.path.join(tmp, "c.npz"),
                 done=os.path.join(tmp, "c.done"))
    proc, t_spawn_c = _spawn_child(job_c, {
        "MXTPU_CKPT_DIR": dir_b, "MXTPU_CKPT_KEEP": "2",
        "MXTPU_CKPT_COMMIT_DELAY": "0"})
    try:
        rc = proc.wait(timeout=CKPT_CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"11c: child C failed (rc {rc}):\n"
                             f"{_child_log(job_c)}")
    with open(job_c["ready"]) as f:
        ready_c = json.load(f)
    with open(job_c["done"]) as f:
        done_c = json.load(f)
    got = dict(np.load(job_c["out"]))
    diff = sorted(k for k in want if k not in got or
                  not np.array_equal(got[k], want[k]))
    log(f"11c: resumed run C against run A: {len(want) - len(diff)} of "
        f"{len(want)} parameters and Adam states bit-equal")
    if diff or set(got) != set(want):
        raise AssertionError(f"11c: resumed run differs from run A in "
                             f"{diff[:8]} ({len(diff)} arrays)")
    c_launches = done_c["launches"]
    if c_launches["flash_attn_fwd"] != cfg["num_layers"] * \
            (FIT_EPOCHS - 1) * FIT_BATCHES:
        raise AssertionError(f"11c: child C launched {c_launches}; it "
                             "should have trained the last two epochs")

    # a torn newest params.params: latest_valid falls back one step
    newest = mgr_b.latest_valid()
    p = os.path.join(newest.directory, "params.params")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    fallback = mgr_b.latest_valid()
    if fallback is None or fallback.step != newest.step - 1:
        raise AssertionError(f"11c: after truncating step {newest.step}'s "
                             f"params, latest_valid gave {fallback}")
    rec = {"sub": "11c_checkpoint_resume", "card": card, "batch": batch,
           "seq": seq, "layers": cfg["num_layers"], "epochs": FIT_EPOCHS,
           "batches": FIT_BATCHES, "fit_a_s": fit_a_s,
           "save_s": [t for t, _ in saves],
           "save_bytes": saves[-1][1], "restore_s": restore_s,
           "child_startup_s": {"b": ready_b["ready_wall"] - t_spawn,
                               "c": ready_c["ready_wall"] - t_spawn_c},
           "child_kernels_built_already": [ready_b["kernels_built_already"],
                                           ready_c["kernels_built_already"]],
           "child_c_fit_s": done_c["fit_s"],
           "resumed_bit_equal_arrays": len(want),
           "truncated_step_fallback": [newest.step, fallback.step],
           "commit_delay_s": CKPT_COMMIT_DELAY,
           "launches_run_a": launches, "launches_child_c": c_launches}
    log(json.dumps(rec))
    if not all(rec["child_kernels_built_already"]):
        raise AssertionError("11c: a child found no kernel build to reuse")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _compression_check(mod, threshold, scales=(1.0, 1000.0)):
    """Pushes of the module's gradients through a local store with 2-bit
    compression, once as they are and then scaled by 1000 (BERT's raw
    gradients rarely reach 0.5, the scaled ones do): each pushed value in
    {-t, 0, +t}, and the pushed value and the residual equal to the plain
    formula, r = residual + g, q = ±t where |r| >= t, residual' = r - q,
    bit for bit."""
    kv = mt.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": threshold})
    names = mod._exec._grad_arg_names
    grads = [mod._exec.grad_dict[n] for n in names]
    kv.init(names, [mt.nd.zeros(g.shape, ctx=g.context) for g in grads])
    pushed = {}
    kv.set_updater(lambda k, r, s: pushed.__setitem__(k, r.data.clone()))
    residual = {n: torch.zeros_like(g.data, dtype=torch.float32)
                for n, g in zip(names, grads)}
    exact, nonzero = True, []
    for scale in scales:
        kv.push(names, [g * scale if scale != 1.0 else g for g in grads])
        count = 0
        for n, g in zip(names, grads):
            r = residual[n] + (g.data * scale if scale != 1.0
                               else g.data).float()
            t = torch.full((), threshold, device=r.device)
            q = torch.where(r >= t, t, torch.where(r <= -t, -t,
                                                   torch.zeros_like(t)))
            got = pushed[n]
            exact &= set(torch.unique(got).cpu().tolist()) <= \
                {-threshold, 0.0, threshold}
            exact &= bool(torch.equal(got, q.to(got.dtype)))
            residual[n] = r - q
            exact &= bool(torch.equal(kv._gc._residuals[n], residual[n]))
            count += int((got != 0).sum())
        nonzero.append(count)
    return {"keys": len(names), "scales": list(scales),
            "nonzero_codes": nonzero, "exact": exact}


def kv_monitor_fit(card, cfg=None, batch=8, seq=512):
    """11d: ``Module.fit`` on a local KVStore (update-on-kvstore) with a
    `Monitor` over the outputs, one epoch at dropout 0, against a
    store-less eager fit of the same batches; then one push of the
    gradients under 2-bit compression.  Returns the launches."""
    cfg = dict(BERT_BASE if cfg is None else cfg, dropout=0.0)
    it = _fit_iter(cfg["vocab"], batch, seq)
    shapes = {d.name: d.shape for d in it.provide_data + it.provide_label}
    sym = bert_mlm(mt.sym, **cfg)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    hk.reset_launch_counts()
    stats, outs_stat = [], []

    def stat(x):
        return float(x.data.abs().mean())

    mon = mt.Monitor(1, stat_func=stat, pattern=".*")
    real = mon.toc_print
    mon.toc_print = lambda: stats.extend(real()) or []
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",))
    mod.fit(it, num_epoch=1, optimizer="adam", optimizer_params=_fit_adam(),
            arg_params=params, kvstore=mt.kv.create("local"), monitor=mon,
            batch_end_callback=lambda p: outs_stat.append(
                [stat(o) for o in mod.get_outputs()]))
    launches = dict(hk.LAUNCHES)
    _check_launches(f"11d fit over {FIT_BATCHES} steps", launches,
                    cfg["num_layers"] * FIT_BATCHES)
    with env(MXTPU_FUSED_STEP="0"):
        ref = mt.mod.Module(sym, data_names=("data", "positions"),
                            label_names=("mlm_label",))
        ref.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params=_fit_adam(), arg_params=params)
    name, err = _params_err(mod, ref)
    names = [n for _s, n, _v in stats]
    mon_equal = [v for _s, _n, v in stats] == \
        [v for row in outs_stat for v in row] and \
        names == list(mod.output_names) * FIT_BATCHES
    log(f"11d: fit on a local store with a Monitor against store-less "
        f"eager fit: worst parameter {name} off by {err:.3e}; the monitor's "
        f"{len(stats)} statistics equal the outputs' {mon_equal}")
    if err > FIT_TOL or not mon_equal:
        raise AssertionError("11d: the store's fit or the monitor differ")
    if not isinstance(mod._active_updater().optimizer, mt.optimizer.Adam) \
            or mod._kvstore is None:
        raise AssertionError("11d: the fit did not update on the store")
    it.reset()
    b = next(it)
    mod.forward_backward(b)
    gc = _compression_check(mod, 0.5)
    log(f"11d: 2-bit compression of {gc['keys']} gradients, pushed at "
        f"scales {gc['scales']}: values in {{-t, 0, t}} and residual r - q "
        f"exact {gc['exact']}, nonzero codes {gc['nonzero_codes']}")
    if not gc["exact"]:
        raise AssertionError("11d: 2-bit compression is not exact")

    def store_step():
        mon.tic()
        mod.forward_backward(b)
        mod.update()
        mon.toc()
    ms = _step_ms(store_step, FIT_TIMED)
    with env(MXTPU_FUSED_STEP="0"):
        eager_ms = _step_ms(lambda: (ref.forward_backward(b), ref.update()),
                            FIT_TIMED)
    rec = {"sub": "11d_kvstore_monitor_fit", "card": card, "batch": batch,
           "seq": seq, "layers": cfg["num_layers"],
           "param_rel_err_vs_storeless": err, "worst_param": name,
           "monitor_stats": len(stats), "monitor_equal": mon_equal,
           "compression": gc,
           "step_p50_ms": {"store_and_monitor": ms,
                           "storeless_eager_per_parameter": eager_ms,
                           "phase7_captured": FIT_RECORD.get(
                               "step_p50_ms", {}).get("captured",
                                                      "not measured")},
           "launches": launches}
    log(json.dumps(rec))
    return launches


def phase_state(card):
    """Phase 11: sparse storage, the local KVStore, Monitor and
    crash-consistent checkpoints.  Returns the K1-K3 launches of its main
    path in this process (11c's run A and 11d)."""
    t_phase = time.perf_counter()
    subs = {"11a": sparse_linear(card)}
    torch.cuda.empty_cache()
    subs["11b"] = fm_libsvm(card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = ckpt_resume(card)
    subs["11c_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    more = kv_monitor_fit(card)
    subs["11d_s"] = time.perf_counter() - t0
    launches = {k: launches[k] + more[k] for k in launches}
    torch.cuda.empty_cache()
    rec = {"phase": "state_and_sparse", "card": card, "launches": launches,
           "11c_s": subs["11c_s"], "11d_s": subs["11d_s"],
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    log(f"state: phase 11 in {rec['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the op surface, the samplers, DCGAN
# ---------------------------------------------------------------------------

def _sweep_cases():
    """The CPU sweep's cases that the port registers: the spec table of
    `tests/test_op_sweep.py` and `tests/torch_sweep_cases.py`'s own, by
    name, as ``(op name, inputs, attrs, wrt, unprojected outputs)``."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_sweep_cases as cases
    ported = set(mt.ops.registry.list_ops())
    out = {n: cases.spec_case(n) for n in sorted(cases.SPECS)
           if n in ported}
    out.update({c: cases.extra_case(c) for c in sorted(cases.CASES)})
    return cases, out


def _sweep_err(got, ref):
    """max |got - ref| over the largest |ref| on the finite entries; inf
    where the finite entries differ, exact for integers."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        return float("inf")
    if not np.issubdtype(ref.dtype, np.floating):
        return 0.0 if np.array_equal(got, ref) else float("inf")
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    fin = np.isfinite(ref)
    if not np.array_equal(fin, np.isfinite(got)):
        return float("inf")
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - ref[fin]).max()
                 / max(np.abs(ref[fin]).max(), 1e-30))


def _sweep_tol(name):
    return SWEEP_FACTOR_TOL if name in SWEEP_FACTOR_OPS else SWEEP_TOL


def ops_sweep(device="cuda"):
    """12a: every case of the CPU sweep on ``device`` in fp32, forward and
    gradient, against the port on the CPU in float64; the count held and
    the worst error per ported file."""
    cases, todo = _sweep_cases()
    dev = mt.gpu(0) if device == "cuda" else mt.cpu()
    per_file, failed, factor_worst = {}, [], (0.0, None)
    t0 = time.perf_counter()
    for case, (name, inputs, attrs, wrt, free) in todo.items():
        with dev:
            out, grads = cases.run_case(
                mt, name, inputs, attrs, wrt, free,
                make=lambda x: mt.nd.array(x, ctx=dev, dtype=x.dtype))
        with mt.cpu():
            rout, rgrads = cases.run_case(
                mt, name, inputs, attrs, wrt, free,
                make=lambda x: mt.nd.array(x, ctx=mt.cpu(),
                                           dtype="float64"))
        errs = []
        for k, (o, r) in enumerate(zip(out, rout)):
            if k in free:
                o = cases.align_rows(o, r)
            errs.append(_sweep_err(o, r))
        errs += [_sweep_err(g, r) for g, r in zip(grads, rgrads)]
        if len(out) != len(rout) or len(grads) != len(rgrads):
            errs.append(float("inf"))
        err = max(errs) if errs else 0.0
        fname = mt.ops.registry.get_op(name).fn.__module__.rsplit(".", 1)[1]
        rec = per_file.setdefault(fname, {"held": 0, "worst": 0.0,
                                          "worst_case": None})
        if err <= _sweep_tol(name):
            rec["held"] += 1
        else:
            failed.append((case, err, _sweep_tol(name)))
        if err >= rec["worst"]:
            rec["worst"], rec["worst_case"] = err, case
        if name in SWEEP_FACTOR_OPS and err >= factor_worst[0]:
            factor_worst = (err, case)
    for fname, rec in sorted(per_file.items()):
        log(f"ops 12a: {fname}: {rec['held']} held, worst "
            f"{rec['worst']:.3e} ({rec['worst_case']})")
    log(f"ops 12a: factorizations and solves worst {factor_worst[0]:.3e} "
        f"({factor_worst[1]})")
    log(json.dumps({"phase": "12a", "cases": len(todo),
                    "factor_worst": factor_worst,
                    "held": sum(r["held"] for r in per_file.values()),
                    "tol": SWEEP_TOL, "factor_tol": SWEEP_FACTOR_TOL,
                    "per_file": per_file,
                    "seconds": time.perf_counter() - t0}))
    if failed:
        raise SystemExit(f"chip_smoke: ops past their tolerance on "
                         f"{device}: {failed}")
    return per_file


def _ks(samples, dist):
    import scipy.stats as ss
    return float(ss.kstest(samples.astype(np.float64), dist.cdf).pvalue)


def _chi2(samples, dist, top):
    """Chi-square over 0..top-1 with the tail folded into the last bin."""
    import scipy.stats as ss
    s = samples.astype(np.int64)
    counts = np.bincount(np.minimum(s, top - 1), minlength=top)[:top]
    probs = dist.pmf(np.arange(top - 1))
    probs = np.append(probs, 1.0 - probs.sum())
    return float(ss.chisquare(counts.astype(np.float64),
                              probs * len(s)).pvalue)


def _sampler_cases(n, ctx):
    """name -> (draw, scipy distribution, chi-square bins or None for the
    KS test): each distribution of 12b at ``n`` samples on ``ctx``."""
    import scipy.stats as ss
    nd = mt.nd
    row = dict(shape=(n,))

    def second_row(fn, *params):
        return lambda: fn(*[nd.array(p, ctx=ctx) for p in params],
                          **row)[1]

    return {
        "normal": (lambda: nd.random.normal(1.5, 2.0, ctx=ctx, **row),
                   ss.norm(1.5, 2.0), None),
        "uniform": (lambda: nd.random.uniform(-2.0, 3.0, ctx=ctx, **row),
                    ss.uniform(-2.0, 5.0), None),
        "gamma": (lambda: nd.random.gamma(3.0, 2.0, ctx=ctx, **row),
                  ss.gamma(a=3.0, scale=2.0), None),
        "gamma_a0.5": (lambda: nd.random.gamma(0.5, 1.0, ctx=ctx, **row),
                       ss.gamma(a=0.5), None),
        "exponential": (lambda: nd.random.exponential(2.5, ctx=ctx, **row),
                        ss.expon(scale=2.5), None),
        "poisson": (lambda: nd.random.poisson(4.0, ctx=ctx, **row),
                    ss.poisson(4.0), 14),
        "negative_binomial": (
            lambda: nd.random.negative_binomial(5, 0.4, ctx=ctx, **row),
            ss.nbinom(5, 0.4), 24),
        "generalized_negative_binomial": (
            lambda: nd.random.generalized_negative_binomial(
                3.0, 0.4, ctx=ctx, **row),
            ss.nbinom(1 / 0.4, 1 / (1 + 0.4 * 3.0)), 16),
        "randint": (lambda: nd.random.randint(0, 10, ctx=ctx, **row),
                    ss.randint(0, 10), 10),
        "multinomial": (lambda: nd.random.multinomial(
            nd.array([0.1, 0.2, 0.3, 0.4], ctx=ctx), shape=(n,)),
            ss.rv_discrete(values=([0, 1, 2, 3], [0.1, 0.2, 0.3, 0.4])),
            4),
        "sample_normal": (second_row(nd.sample_normal, [0.0, 5.0],
                                    [1.0, 0.1]), ss.norm(5.0, 0.1), None),
        "sample_gamma": (second_row(nd.sample_gamma, [2.0, 9.0],
                                    [1.0, 0.5]),
                         ss.gamma(a=9.0, scale=0.5), None),
        "sample_poisson": (second_row(nd.sample_poisson, [1.0, 6.0]),
                           ss.poisson(6.0), 16),
    }


def samplers_check(n=SAMPLER_N, device="cuda"):
    """12b: each distribution at ``n`` samples from ``device``'s generator,
    by its moments and a KS or chi-square test against `scipy.stats`;
    bit-equal reruns under `random.seed`; `shuffle` a permutation;
    `multinomial`'s ``get_prob`` gradient finite (count / p)."""
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    recs, bad = {}, []
    t0 = time.perf_counter()
    for name, (draw, dist, bins) in _sampler_cases(n, ctx).items():
        mt.random.seed(SEED + 12)
        arr = draw()
        if arr.context != ctx:
            raise SystemExit(f"chip_smoke: {name} drew on {arr.context}")
        s = arr.asnumpy().ravel()
        p = _chi2(s, dist, bins) if bins else _ks(s, dist)
        z = abs(s.mean() - dist.mean()) / (dist.std() / np.sqrt(len(s)))
        recs[name] = {"p": p, "mean": float(s.mean()),
                      "want_mean": float(dist.mean()), "mean_z": float(z),
                      "var": float(s.var()), "want_var": float(dist.var())}
        if not (p > SAMPLER_P and z < 5.0):
            bad.append(name)
    # the same seed, the same draws, on the card's generator
    def draws():
        mt.random.seed(SEED + 3)
        return [mt.nd.random.normal(0, 1, shape=(1000,), ctx=ctx).asnumpy(),
                mt.nd.random.gamma(2.0, 1.0, shape=(1000,),
                                   ctx=ctx).asnumpy(),
                mt.nd.random.poisson(3.0, shape=(1000,), ctx=ctx).asnumpy(),
                mt.nd.random.shuffle(mt.nd.arange(1000, ctx=ctx)).asnumpy()]
    reruns_equal = all(np.array_equal(a, b)
                       for a, b in zip(draws(), draws()))
    perm = mt.nd.random.shuffle(mt.nd.arange(100_000, ctx=ctx)).asnumpy()
    is_perm = np.array_equal(np.sort(perm), np.arange(100_000))
    probs_np = np.array([[0.1, 0.2, 0.3, 0.4], [0.4, 0.3, 0.2, 0.1]],
                        np.float32)
    probs = mt.nd.array(probs_np, ctx=ctx)
    probs.attach_grad()
    with mt.autograd.record():
        s, lp = mt.nd.random.multinomial(probs, shape=1000, get_prob=True)
        lp.sum().backward()
    g = probs.grad.asnumpy()
    counts = np.stack([np.bincount(r, minlength=4)
                       for r in s.asnumpy().astype(int)])
    grad_ok = bool(np.isfinite(g).all()) and np.allclose(
        g, counts / probs_np, rtol=1e-5)
    rec = {"phase": "12b", "n": n, "p_min": SAMPLER_P,
           "distributions": recs, "reruns_bit_equal": reruns_equal,
           "shuffle_is_permutation": bool(is_perm),
           "multinomial_get_prob_grad_ok": grad_ok,
           "seconds": time.perf_counter() - t0}
    log(json.dumps(rec))
    log("samplers 12b: " + ", ".join(
        f"{k} p={v['p']:.3g}" for k, v in recs.items()))
    if bad or not (reruns_equal and is_perm and grad_ok):
        raise SystemExit(f"chip_smoke: samplers failed: {bad}, reruns "
                         f"{reruns_equal}, permutation {is_perm}, get_prob "
                         f"gradient {grad_ok}")
    return rec


def _dcgan_weights(sym, shapes, seed):
    """The reference's ``mx.init.Normal(0.02)`` from a numpy seed; the
    BatchNorms' gamma 1 and beta 0."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    out = {}
    for name, shp in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("_gamma"):
            out[name] = np.ones(shp, np.float32)
        elif name.endswith("_beta"):
            out[name] = np.zeros(shp, np.float32)
        else:
            out[name] = (rs.randn(*shp) * DCGAN["sigma"]).astype(np.float32)
    return out


def _dcgan_modules(cfg, ctx, dtype="float32"):
    """The reference's two Modules over `model_zoo.dcgan`: G bound on the
    noise, D on images and labels with ``inputs_need_grad``, both with
    Adam (lr 0.0002, beta1 0.5), weights from the seed."""
    from mxnet_tpu_torch.model_zoo import dcgan
    symG, symD = dcgan(mt.sym, cfg["ngf"], cfg["ndf"], cfg["nc"])
    b, z, side = cfg["batch"], cfg["Z"], cfg["image"]
    shapesG = {"rand": (b, z, 1, 1)}
    shapesD = {"data": (b, cfg["nc"], side, side), "label": (b,)}
    wG = _dcgan_weights(symG, shapesG, SEED + 1)
    wD = _dcgan_weights(symD, shapesD, SEED + 2)
    opt = {"learning_rate": cfg["lr"], "wd": 0.0, "beta1": cfg["beta1"]}
    modG = mt.mod.Module(symG, data_names=("rand",), label_names=None,
                         context=ctx)
    modG.bind(data_shapes=[mt.io.DataDesc("rand", shapesG["rand"], dtype)])
    modG.init_params(arg_params={k: mt.nd.array(v, ctx=ctx, dtype=dtype)
                                 for k, v in wG.items()})
    modG.init_optimizer(optimizer="adam", optimizer_params=opt)
    modD = mt.mod.Module(symD, data_names=("data",), label_names=("label",),
                         context=ctx)
    modD.bind(data_shapes=[mt.io.DataDesc("data", shapesD["data"], dtype)],
              label_shapes=[mt.io.DataDesc("label", (b,), dtype)],
              inputs_need_grad=True)
    modD.init_params(arg_params={k: mt.nd.array(v, ctx=ctx, dtype=dtype)
                                 for k, v in wD.items()})
    modD.init_optimizer(optimizer="adam", optimizer_params=opt)
    return modG, modD


def _dcgan_iteration(modG, modD, noise, real, label, grads=None):
    """One iteration of the reference's loop (``example/gan/dcgan.py``):
    D on G's batch with label 0, its gradients kept; D on the real batch
    with label 1 and the kept gradients added, one D update; D on G's
    batch with label 1 and G's backward from D's input gradient, one G
    update.  ``grads``, when given, receives copies of D's summed and G's
    gradients before their updates.  Returns D's outputs on fake and on
    real."""
    modG.forward(mt.io.DataBatch([noise], None), is_train=True)
    outG = modG.get_outputs()
    label[:] = 0
    modD.forward(mt.io.DataBatch(outG, [label]), is_train=True)
    modD.backward()
    out_fake = modD.get_outputs()[0].copy()
    gradD = [g.copy() for g in modD._exec.grad_arrays if g is not None]
    label[:] = 1
    modD.forward(mt.io.DataBatch([real], [label]), is_train=True)
    modD.backward()
    out_real = modD.get_outputs()[0].copy()
    for gr, gf in zip([g for g in modD._exec.grad_arrays if g is not None],
                      gradD):
        gr += gf
    if grads is not None:
        grads.update({f"D:{n}": g.asnumpy().astype(np.float64)
                      for n, g in modD._exec.grad_dict.items()
                      if n != "data"})
    modD.update()
    modD.forward(mt.io.DataBatch(outG, [label]), is_train=True)
    modD.backward()
    modG.backward(modD.get_input_grads())
    if grads is not None:
        grads.update({f"G:{n}": g.asnumpy().astype(np.float64)
                      for n, g in modG._exec.grad_dict.items()})
    modG.update()
    return out_fake, out_real


def _dcgan_images(cfg, seed):
    """Synthetic "real" images in [-1, 1]: smooth random colour fields
    (a few low-frequency waves per channel) from the seed."""
    rs = np.random.RandomState(seed)
    b, c, side = cfg["batch"], cfg["nc"], cfg["image"]
    yy, xx = np.meshgrid(np.linspace(0, 1, side), np.linspace(0, 1, side),
                         indexing="ij")
    img = np.zeros((b, c, side, side))
    for _ in range(3):
        fy, fx, ph = (rs.uniform(0.5, 3.0, (b, c, 1, 1)),
                      rs.uniform(0.5, 3.0, (b, c, 1, 1)),
                      rs.uniform(0, 2 * np.pi, (b, c, 1, 1)))
        img += np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
    return np.tanh(img).astype(np.float32)


def _bce(p, label):
    p = np.clip(np.asarray(p, np.float64).ravel(), 1e-12, 1 - 1e-12)
    return float(-np.mean(np.log(p) if label else np.log(1 - p)))


@contextlib.contextmanager
def _pinned_branches(masks, replay, flips):
    """Within the block every relu ``Activation`` and leaky ``LeakyReLU``
    of the port records in ``masks``, call by call, the branch each
    element takes (``x > 0``, on the host); with ``replay`` it takes each
    element's branch from ``masks`` instead and appends to ``flips`` the
    farthest distance from zero of an element whose branch that changed,
    relative to the call's largest magnitude (0.0 where none did)."""
    from mxnet_tpu_torch.ops.registry import get_op
    act, leaky = get_op("Activation"), get_op("LeakyReLU")
    act_fn, leaky_fn = act.fn, leaky.fn
    calls = iter(masks)

    def branch(x):
        pos = x > 0
        if not replay:
            masks.append(pos.cpu())
            return pos
        want = next(calls).to(x.device)
        moved = want != pos
        top = float(x.detach().abs().max())
        flips.append(float(x.detach()[moved].abs().max()) / top
                     if bool(moved.any()) else 0.0)
        return want

    def act_pinned(attrs, x):
        if attrs.get_str("act_type", "relu") != "relu":
            return act_fn(attrs, x)
        pos = branch(x)
        return act_fn(attrs, x) if not replay else \
            torch.where(pos, x, torch.zeros_like(x))

    def leaky_pinned(attrs, generator, x, gamma=None):
        if attrs.get_str("act_type", "leaky") != "leaky":
            return leaky_fn(attrs, generator, x, gamma)
        pos = branch(x)
        return leaky_fn(attrs, generator, x, gamma) if not replay else \
            torch.where(pos, x, attrs.get_float("slope", 0.25) * x)

    act.fn, leaky.fn = act_pinned, leaky_pinned
    try:
        yield
    finally:
        act.fn, leaky.fn = act_fn, leaky_fn


def _grad_errors(g32, g64):
    """The error of all gradients together and of D's and G's apart,
    relative to their norm, and the worst element relative to its
    gradient's largest magnitude."""
    def norm_err(names):
        return float(np.sqrt(
            sum(((g32[n] - g64[n]) ** 2).sum() for n in names)
            / sum((g64[n] ** 2).sum() for n in names)))
    names = sorted(g64)
    per_net = {net: norm_err([n for n in names if n.startswith(net)])
               for net in ("D", "G")}
    elem = max(float(np.abs(g32[n] - g64[n]).max()
                     / max(np.abs(g64[n]).max(), 1e-30)) for n in names)
    return norm_err(names), per_net, elem


def dcgan_check(cfg=None, device="cuda"):
    """12c first part: one full iteration on ``device`` in fp32 against
    the same iteration on the CPU in float64, the same weights, noise and
    images, each ReLU and LeakyReLU element of the float64 iteration on
    the branch the fp32 iteration took (`_pinned_branches`; an element
    that switched must lie within DCGAN_SWITCH_TOL of zero): D's outputs
    and both networks' gradients, the gradients held by their norm.  The
    element-wise error, and the error against the float64 iteration left
    to its own branches, are printed, not held."""
    cfg = cfg or DCGAN
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    rs = np.random.RandomState(SEED + 5)
    noise = rs.randn(cfg["batch"], cfg["Z"], 1, 1).astype(np.float32)
    real = _dcgan_images(cfg, SEED + 6)
    masks, flips, res = [], [], {}
    t0 = time.perf_counter()
    for where, c, dt, pin in (("card", ctx, "float32", False),
                              ("float64", mt.cpu(), "float64", True),
                              ("free", mt.cpu(), "float64", None)):
        modG, modD = _dcgan_modules(cfg, c, dt)
        grads = {}
        label = mt.nd.zeros((cfg["batch"],), ctx=c, dtype=dt)
        with contextlib.ExitStack() as stack:
            if pin is not None:
                stack.enter_context(_pinned_branches(masks, pin, flips))
            out_fake, out_real = _dcgan_iteration(
                modG, modD, mt.nd.array(noise, ctx=c, dtype=dt),
                mt.nd.array(real, ctx=c, dtype=dt), label, grads)
        res[where] = (grads, out_fake.asnumpy(), out_real.asnumpy())
        res[where + "_s"] = time.perf_counter() - t0
    g32, f32, r32 = res["card"]
    g64, f64, r64 = res["float64"]
    norm_err, per_net, elem = _grad_errors(g32, g64)
    free_err, free_per_net, _ = _grad_errors(g32, res["free"][0])
    out_err = max(float(np.abs(f32 - f64).max()),
                  float(np.abs(r32 - r64).max()))
    rec = {"phase": "12c_check", "grad_norm_err": norm_err,
           "grad_norm_err_by_net": per_net,
           "grad_elementwise_err": elem, "d_out_err": out_err,
           "branch_calls": len(flips),
           "switched_calls": sum(f > 0 for f in flips),
           "switch_worst": max(flips, default=0.0),
           "unpinned_grad_norm_err": free_err,
           "unpinned_by_net": free_per_net,
           "grad_tol": DCGAN_GRAD_TOL, "out_tol": DCGAN_OUT_TOL,
           "switch_tol": DCGAN_SWITCH_TOL,
           "float64_s": res["float64_s"] - res["card_s"]}
    log(json.dumps(rec))
    if not (len(flips) == len(masks) and norm_err <= DCGAN_GRAD_TOL
            and out_err <= DCGAN_OUT_TOL
            and rec["switch_worst"] <= DCGAN_SWITCH_TOL):
        raise SystemExit(f"chip_smoke: DCGAN's fp32 iteration on {device} "
                         f"left float64's: {rec}")
    return rec


def dcgan_training(card, cfg=None, warm=DCGAN_WARM, timed=DCGAN_TIMED,
                   device="cuda"):
    """12c second part: ``warm`` + ``timed`` iterations at ``cfg``'s widths
    with the noise drawn on the card each iteration by
    ``nd.random.normal(0, 1, shape=(batch, Z, 1, 1), ctx=gpu(0))``: the
    iteration's p50 and images/s, the idle share of one profiled
    iteration, and D's losses on real and on fake, which must move from
    their first values."""
    cfg = cfg or DCGAN
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    modG, modD = _dcgan_modules(cfg, ctx)
    real = mt.nd.array(_dcgan_images(cfg, SEED + 7), ctx=ctx)
    label = mt.nd.zeros((cfg["batch"],), ctx=ctx)
    shape = (cfg["batch"], cfg["Z"], 1, 1)
    losses = []

    def step():
        noise = mt.nd.random.normal(0, 1, shape=shape, ctx=ctx)
        f, r = _dcgan_iteration(modG, modD, noise, real, label)
        losses.append((_bce(r.asnumpy(), 1), _bce(f.asnumpy(), 0)))

    mt.random.seed(SEED + 8)
    times = []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize() if device == "cuda" else None
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    prof = profile_gluon("dcgan_iteration", step) if device == "cuda" \
        else {"idle_share": "not measured"}
    (real0, fake0), (real1, fake1) = losses[0], losses[-1]
    rec = {"phase": "12c_train", "card": card, "batch": cfg["batch"],
           "iterations": warm + timed, "timed": timed, "p50_ms": p50,
           "images_per_s": cfg["batch"] / p50 * 1e3,
           "idle_share": prof["idle_share"],
           "d_loss_real": [real0, real1], "d_loss_fake": [fake0, fake1]}
    log(json.dumps(rec))
    log(f"dcgan 12c: iteration p50 {p50:.2f} ms, "
        f"{rec['images_per_s']:.0f} images/s, idle share "
        f"{prof['idle_share']}; D loss real {real0:.4f} -> {real1:.4f}, "
        f"fake {fake0:.4f} -> {fake1:.4f} ({card})")
    moved = (abs(real1 - real0) > DCGAN_LOSS_MOVE
             and abs(fake1 - fake0) > DCGAN_LOSS_MOVE)
    if not (moved and np.isfinite([real1, fake1]).all()):
        raise SystemExit(f"chip_smoke: DCGAN's D losses did not move: "
                         f"{rec}")
    return rec


def phase_ops(card):
    """Phase 12: the ported op surface on the card (12a), the samplers
    (12b) and MXNet's DCGAN at its published widths (12c).  No TPU kernel
    lies on this path; returns its K1-K4 launches (none)."""
    t_phase = time.perf_counter()
    before = dict(hk.LAUNCHES)
    ops_sweep()
    torch.cuda.empty_cache()
    samplers_check()
    torch.cuda.empty_cache()
    dcgan_check()
    torch.cuda.empty_cache()
    dcgan_training(card)
    torch.cuda.empty_cache()
    launches = {k: hk.LAUNCHES[k] - before.get(k, 0) for k in hk.LAUNCHES}
    rec = {"phase": "ops_samplers_dcgan", "card": card,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    log(f"ops: phase 12 in {rec['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the optimizers, the initializers and the image data plane
# ---------------------------------------------------------------------------

def _resnet_params(model, classes, device):
    """The trainable parameters of a seeded ``model`` as (names, float32
    tensors): ResNet-50 v1's are 193 arrays of 25,575,912 numbers (the
    reference's 161 and the biases of 32 convolutions that feed a
    BatchNorm)."""
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    mt.random.seed(SEED)
    net = model(classes=classes, prefix="resnet50_v1_")
    net.initialize(mt.init.Xavier(magnitude=2), ctx=ctx)
    net(mt.nd.zeros((1, 3, 224, 224), ctx=ctx))
    params = [(n, p.data().data.detach().clone())
              for n, p in net.collect_params().items()
              if p.grad_req != "null"]
    del net
    return [n for n, _ in params], [t for _, t in params]


def _opt_grads(ws, steps, seed):
    gen = torch.Generator(device=ws[0].device).manual_seed(seed)
    return [[torch.randn(w.shape, generator=gen, device=w.device) * 64
             for w in ws] for _ in range(steps)]


def _opt_create(key, names):
    name = key.split("_")[0]
    kw = dict(OPT_COMMON, **OPT_CASES[key],
              param_idx2name=dict(enumerate(names)))
    if name == "groupadagrad":
        kw.pop("wd")
    return mt.optimizer.create(name, **kw)


def _opt_steps(key, names, ws, grads, dtype, multi=True, mp=False):
    """``len(grads)`` steps of optimizer ``key`` from weights ``ws`` in
    ``dtype``, through `Updater.update_multi` where the optimizer has a
    multi-tensor plan (``multi``), else parameter by parameter; returns
    the weights, the updater and each step's ms (ending in a
    synchronize)."""
    opt = _opt_create(key, names)
    opt.multi_precision = mp
    upd = mt.optimizer.get_updater(opt)
    w_nd = [NDArray(w.to(dtype).clone()) for w in ws]
    times = []
    for step in grads:
        g_nd = [NDArray(g.to(dtype)) for g in step]
        _sync(ws[0])
        t0 = time.perf_counter()
        items = [(i, g, w) for i, (g, w) in enumerate(zip(g_nd, w_nd))]
        if not (multi and upd.update_multi(items)):
            for i, g, w in items:
                upd(i, g, w)
        _sync(ws[0])
        times.append((time.perf_counter() - t0) * 1e3)
    return w_nd, upd, times


def _sync(t):
    if t.device.type == "cuda":
        torch.cuda.synchronize()


def _array_errs(got, want):
    """Per array: max |got - want| over want's largest magnitude, and the
    elements past OPT_TOL of it."""
    errs, switched = [], 0
    for g, w in zip(got, want):
        w = w.double()
        d = (g.double() - w).abs()
        scale = max(float(w.abs().max()), 1e-30)
        errs.append(float(d.max()) / scale)
        switched += int((d > OPT_TOL * scale).sum())
    return errs, switched


def _state_numel(state):
    if state is None:
        return 0
    if isinstance(state, (tuple, list)):
        return sum(_state_numel(s) for s in state)
    return state.data.numel()


def _sgld_check(names, ws, grads):
    """SGLD's noise: the step minus its deterministic half step, in
    float64 from the same inputs, is N(0, lr)."""
    w32, _, _ = _opt_steps("sgld", names, ws, grads[:1], torch.float32,
                           multi=False)
    lr = OPT_COMMON["learning_rate"]
    noise = []
    for k, (w, g, new) in enumerate(zip(ws, grads[0], w32)):
        wd = OPT_COMMON["wd"] * (1.0 if names[k].endswith(
            ("_weight", "_gamma")) else 0.0)
        gd = (g.double() * OPT_COMMON["rescale_grad"]).clamp(
            -OPT_COMMON["clip_gradient"], OPT_COMMON["clip_gradient"])
        det = w.double() - lr / 2 * (gd + wd * w.double())
        noise.append((new.data.double() - det).reshape(-1))
    noise = torch.cat(noise)
    n = noise.numel()
    mean_z = float(noise.mean()) / math.sqrt(lr / n)
    var_z = (float(noise.var()) / lr - 1) / math.sqrt(2.0 / n)
    return {"n": n, "mean_z": mean_z, "var_z": var_z}


def optimizer_checks(card, model=None, classes=1000, steps=OPT_STEPS,
                     device="cuda"):
    """13a, the optimizers at ResNet-50 v1's parameter set: every
    registered optimizer ``steps`` steps in fp32 against the same port
    code in float64 from the same seeded gradients (wd, rescale_grad and
    clip_gradient set, no weight decay on biases and betas by their
    names); SGLD by its noise; ``multi_precision`` fp16 for SGD, NAG and
    Adam against fp32; the ``multi_`` ops over every array against their
    per-array ops.  Each optimizer's update ms a step beside its
    compulsory bytes over MEM_BPS."""
    names, ws = _resnet_params(model or vision.resnet50_v1, classes, device)
    numel = sum(w.numel() for w in ws)
    log(f"optimizers 13a: {len(ws)} arrays, {numel} parameters ({card})")
    grads = _opt_grads(ws, steps, SEED + 13)
    rows, failed = {}, []
    for key in sorted(OPT_CASES):
        if key == "sgld":
            continue
        w32, upd, times = _opt_steps(key, names, ws, grads, torch.float32)
        w64, _, _ = _opt_steps(key, names, ws, grads, torch.float64,
                               multi=False)
        errs, switched = _array_errs([w.data for w in w32],
                                     [w.data for w in w64])
        states = sum(_state_numel(s) for s in upd.states.values())
        nbytes = 4 * (3 * numel + 2 * states)
        rec = {"worst_rel_err": max(errs), "switched": switched,
               "step_ms": float(np.median(times[1:] or times)),
               "bytes": nbytes, "bound_ms": nbytes / MEM_BPS * 1e3}
        rows[key] = rec
        decides = key.split("_")[0] in OPT_DECISIONS
        ok = (switched <= OPT_SWITCH_SHARE * numel) if decides \
            else rec["worst_rel_err"] <= OPT_TOL
        if not ok:
            failed.append(key)
        log(f"optimizers 13a: {key:18s} fp32 against float64 "
            f"{rec['worst_rel_err']:.3e} ({switched} elements past "
            f"{OPT_TOL:g}), update {rec['step_ms']:.2f} ms a step, "
            f"{nbytes / 1e6:.1f} MB, bound {rec['bound_ms']:.3f} ms")
        del w32, w64, upd
    sgld = rows["sgld"] = _sgld_check(names, ws, grads)
    log(f"optimizers 13a: sgld noise over {sgld['n']} elements: mean "
        f"{sgld['mean_z']:.2f} and variance {sgld['var_z']:.2f} standard "
        "errors from N(0, lr)")
    if abs(sgld["mean_z"]) > 5 or abs(sgld["var_z"]) > 5:
        failed.append("sgld")
    for key in ("sgd", "nag", "adam"):
        half = [w.half().float() for w in ws]
        g16 = [[g.half() for g in step] for step in grads]
        w16, upd, _ = _opt_steps(key, names, half, g16, torch.float16,
                                 mp=True)
        ref, _, _ = _opt_steps(key, names, half,
                               [[g.float() for g in s] for s in g16],
                               torch.float32, multi=False)
        werr, _ = _array_errs([w.data for w in w16], [w.data for w in ref])
        merr, _ = _array_errs([upd.states[i][1].data
                               for i in range(len(ws))],
                              [w.data for w in ref])
        rows[f"{key}_mp"] = {"fp16_rel_err": max(werr),
                             "master_rel_err": max(merr)}
        log(f"optimizers 13a: {key} multi_precision: fp16 weights "
            f"{max(werr):.3e}, fp32 masters {max(merr):.3e} from fp32")
        if max(werr) > OPT_HALF_TOL or max(merr) > OPT_TOL:
            failed.append(f"{key}_mp")
    rows["multi_ops"] = _multi_op_checks(ws, grads[0])
    if max(rows["multi_ops"].values()) > MULTI_TOL:
        failed.append("multi_ops")
    rows["initializers"] = init_checks(names, ws)
    rec = {"phase": "13a", "card": card, "arrays": len(ws),
           "parameters": numel, "steps": steps, "rows": rows}
    log(json.dumps(rec))
    if failed or not rows["initializers"]["ok"]:
        raise SystemExit(f"chip_smoke: 13a failed {failed}: {rec}")
    return rec


def _multi_op_checks(ws, grads):
    """``multi_sgd_mom_update`` and ``multi_mp_sgd_mom_update`` over every
    array against ``sgd_mom_update`` and ``mp_sgd_mom_update`` on each."""
    from mxnet_tpu_torch.ndarray.register import invoke
    n = len(ws)
    lrs = tuple(0.01 * (1 + k % 3) for k in range(n))
    wds = tuple(1e-4 * (k % 2) for k in range(n))
    kw = dict(momentum=0.9, rescale_grad=OPT_COMMON["rescale_grad"],
              clip_gradient=OPT_COMMON["clip_gradient"])
    out = {}
    for mp in (False, True):
        dt = torch.float16 if mp else torch.float32
        groups = [[NDArray(w.to(dt).clone()), NDArray(g.to(dt)),
                   NDArray(torch.zeros_like(w))] +
                  ([NDArray(w.to(dt).float())] if mp else [])
                  for w, g in zip(ws, grads)]
        singles = [[NDArray(a.data.clone()) for a in grp] for grp in groups]
        name = "mp_sgd_mom_update" if mp else "sgd_mom_update"
        invoke("multi_" + name, *[a for grp in groups for a in grp],
               out=[grp[0] for grp in groups], num_weights=n, lrs=lrs,
               wds=wds, **kw)
        for k, grp in enumerate(singles):
            invoke(name, *grp, out=grp[0], lr=lrs[k], wd=wds[k], **kw)
        errs, _ = _array_errs([a.data for grp in groups for a in grp],
                              [a.data for grp in singles for a in grp])
        out[f"multi_{name}"] = max(errs)
        log(f"optimizers 13a: multi_{name} over {n} arrays against "
            f"{name} on each: {max(errs):.3e}")
    return out


def init_checks(names, ws):
    """The initializers at the parameter set's shapes: Xavier (gaussian,
    in, magnitude 2) and MSRAPrelu by their std (pooled over every weight
    within INIT_STD_TOL of the formula, each array within 5 standard
    errors), Orthogonal's rows or columns orthonormal within ORTHO_TOL,
    Bilinear and LSTMBias equal to numpy, Mixed routed by pattern."""
    dev = ws[0].device
    ctx = mt.gpu(0) if dev.type == "cuda" else mt.cpu()
    weights = [(n, w.shape) for n, w in zip(names, ws) if w.dim() >= 2]
    res, ok = {}, True
    mt.random.seed(SEED + 14)
    for label, init, mag in (
            ("xavier", mt.init.Xavier("gaussian", "in", 2), 2.0),
            ("msraprelu", mt.init.MSRAPrelu("in", 0.25), 2.0 / 1.0625)):
        zs, worst_se = [], 0.0
        for n, shape in weights:
            arr = mt.nd.zeros(shape, ctx=ctx)
            init(n, arr)
            fan_in = shape[1] * math.prod(shape[2:])
            z = arr.data.double() / math.sqrt(mag / fan_in)
            zs.append(z.reshape(-1))
            se = math.sqrt(1.0 / (2 * z.numel()))
            worst_se = max(worst_se, abs(float(z.std()) - 1) / se)
        pooled = float(torch.cat(zs).std())
        res[label] = {"pooled_std_ratio": pooled, "worst_array_se": worst_se}
        ok &= abs(pooled - 1) <= INIT_STD_TOL and worst_se <= 5
    worst = 0.0
    for shape in sorted({s for _, s in weights}):
        arr = mt.nd.zeros(shape, ctx=ctx)
        mt.init.Orthogonal(scale=1.5)("o_weight", arr)
        m = arr.data.double().reshape(shape[0], -1) / 1.5
        q = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        worst = max(worst, float((q - torch.eye(q.shape[0], device=dev,
                                                dtype=q.dtype)).abs().max()))
    res["orthogonal_max_err"] = worst
    ok &= worst <= ORTHO_TOL
    exact = True
    for n, shape in weights:
        if len(shape) == 4:
            arr = mt.nd.zeros(shape, ctx=ctx)
            mt.init.Bilinear()("b_weight", arr)
            f = np.ceil(shape[3] / 2.0)
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            kern = np.outer(1 - np.abs(np.arange(shape[2]) / f - c),
                            1 - np.abs(np.arange(shape[3]) / f - c))
            exact &= bool(np.array_equal(
                arr.asnumpy(), np.broadcast_to(kern.astype(np.float32),
                                               shape)))
    for n, w in zip(names, ws):
        if w.dim() == 1 and w.shape[0] % 4 == 0:
            arr = mt.nd.zeros(tuple(w.shape), ctx=ctx)
            mt.init.LSTMBias(1.0)._init_weight(n, arr)
            want = np.zeros(w.shape, np.float32)
            want[w.shape[0] // 4:w.shape[0] // 2] = 1.0
            exact &= bool(np.array_equal(arr.asnumpy(), want))
    mixed = mt.init.Mixed([".*conv.*weight", ".*dense.*weight", ".*"],
                          [mt.init.Constant(0.5), mt.init.One(),
                           mt.init.Zero()])
    routed = True
    for n, w in zip(names, ws):
        arr = mt.nd.zeros(tuple(w.shape), ctx=ctx)
        mixed(n, arr)
        want = (0.5 if ("conv" in n and n.endswith("weight")) else
                1.0 if (("dense" in n and n.endswith("weight"))
                        or n.endswith("gamma")) else 0.0)
        routed &= bool((arr.data == want).all())
    res.update(exact=exact, mixed_routed=routed)
    res["ok"] = bool(ok and exact and routed)
    log(f"initializers 13a: {json.dumps(res)}")
    return res


def _pack_records(prefix, n, side, classes, seed):
    """``n`` JPEGs (quality IMG_QUALITY) of ``classes`` smooth prototypes
    plus noise, with their labels, into ``prefix``.rec/.idx by the port's
    `recordio`; returns the labels."""
    rng = np.random.RandomState(seed)
    protos = torch.nn.functional.interpolate(
        torch.from_numpy(rng.uniform(40, 215, (classes, 3, 4, 4))),
        size=(side, side), mode="bilinear", align_corners=False)
    protos = protos.permute(0, 2, 3, 1).numpy()
    labels = rng.randint(0, classes, n)
    rec = mt.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    for i, lab in enumerate(labels):
        img = np.clip(protos[lab] + rng.normal(0, 12, (side, side, 3)),
                      0, 255).astype(np.uint8)
        rec.write_idx(i, mt.recordio.pack_img((0, float(lab), i, 0), img,
                                              quality=IMG_QUALITY))
    rec.close()
    return labels


def _iter_kind(it):
    inner = it.iters[0]
    native = isinstance(inner, mt.io.NativeImageRecordIter)
    decoder = ("the native library (libjpeg)" if native else
               "PIL in image.imdecode (the native library built without "
               "libjpeg: RecordIO only)")
    return inner, native, decoder


def _host_batch(inner, native, rec_path, batch, seed_aug):
    """The first batch of a fresh epoch decoded on the host and mirrored
    and normalized in float64 with the flags the iterator's seeded
    stream draws, and its labels."""
    import random as pyrandom
    keys = (inner._keys if native else inner._records)[:batch]
    if native:
        flags = np.random.RandomState(seed_aug).rand(batch) < 0.5
    else:
        rng = pyrandom.Random(seed_aug)
        flags = np.array([rng.random() < 0.5 for _ in keys])
    rec = mt.recordio.MXIndexedRecordIO(rec_path[:-4] + ".idx", rec_path,
                                        "r")
    heads, bufs = zip(*(mt.recordio.unpack(rec.read_idx(k)) for k in keys))
    rec.close()
    if native:
        c, h, w = inner.data_shape
        imgs, _ = io_native.decode_jpeg_batch(
            bufs, h, w, c, fast=inner._fast_decode)
    else:
        imgs = np.stack([mt.image.imdecode(b).asnumpy() for b in bufs])
    x = imgs.astype(np.float64)
    x[flags] = x[flags][:, :, ::-1]
    mean = np.array([123.68, 116.28, 103.53], np.float32).astype(np.float64)
    std = np.array([58.395, 57.12, 57.375], np.float32).astype(np.float64)
    x = ((x - mean) / std).transpose(0, 3, 1, 2)
    return x, np.array([hd.label for hd in heads], np.float64)


def _checksums(it, n):
    out = []
    for _ in range(n):
        b = it.next()
        d = b.data[0].data.double()
        out.append((float(d.sum()), float((d * d).sum()),
                    float(b.label[0].data.double().sum())))
    return out


def data_plane_training(card, model=None, classes=1000, side=IMG_SIDE,
                        records=IMG_RECORDS, batch=IMG_BATCH,
                        epochs=IMG_EPOCHS, timed=IMG_TIMED, device="cuda",
                        workdir=None):
    """13b: ``model`` (ResNet-50 v1) hybridized and trained by `Trainer`
    ('nag') from `io.ImageRecordIter` over a RecordIO file of ``records``
    synthetic JPEGs packed by the port's `recordio`, with the iterator's
    checks, the step fed by it and by one fixed batch, the loader's wait,
    decode and copy numbers and one profiled step's idle share; then the
    Python `ImageIter` (resize, random crop) for 4 batches."""
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_", dir=workdir)
    try:
        prefix = os.path.join(tmp, "synthetic")
        t0 = time.perf_counter()
        _pack_records(prefix, records, side, IMG_CLASSES, SEED + 15)
        pack_s = time.perf_counter() - t0
        rec_path = prefix + ".rec"
        args = dict(path_imgrec=rec_path, data_shape=(3, side, side),
                    batch_size=batch, shuffle=True, rand_mirror=True,
                    mean=True, std=True, preprocess_threads=os.cpu_count(),
                    seed=SEED, seed_aug=SEED + 16)
        with ctx:
            it = mt.io.ImageRecordIter(**args)
        inner, native, decoder = _iter_kind(it)
        log(f"data 13b: {type(inner).__name__} serves every batch of "
            f"ImageRecordIter, decoded by {decoder}; {records} records "
            f"packed in {pack_s:.1f} s ({card})")
        if device == "cuda" and native != io_native.decode_available():
            raise SystemExit("chip_smoke: ImageRecordIter served "
                             f"{type(inner).__name__} against the decoder")
        checks = _data_checks(args, ctx, rec_path, batch, epochs)
        mt.random.seed(SEED)
        net = (model or vision.resnet50_v1)(classes=classes,
                                            prefix="resnet50_v1_")
        net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2), ctx=ctx)
        net.hybridize()
        steps_total = epochs * (records // batch)
        ramp = mt.lr_scheduler.FactorScheduler(
            step=10 ** 6, base_lr=IMG_NAG["learning_rate"],
            warmup_steps=steps_total // 2, warmup_begin_lr=0.0)
        trainer = mt.gluon.Trainer(net.collect_params(), "nag",
                                   dict(IMG_NAG, lr_scheduler=ramp))
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()

        def step(x, y):
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(batch)
            return float(loss.mean().asscalar())

        losses, waits, times = [], [], []
        for _ in range(epochs):
            it.reset()
            for _ in range(records // batch):
                t0 = time.perf_counter()
                b = it.next()
                t1 = time.perf_counter()
                losses.append(step(b.data[0], b.label[0]))
                times.append((time.perf_counter() - t0) * 1e3)
                waits.append((t1 - t0) * 1e3)
        first, last = np.mean(losses[:4]), np.mean(losses[-4:])
        log(f"data 13b: losses {[round(v, 4) for v in losses]}")
        if not (np.isfinite(losses).all() and last < first):
            raise SystemExit(f"chip_smoke: 13b's loss did not fall: {losses}")
        fed_p50 = float(np.median(times[4:]))
        h2d = inner._stager.h2d_ms()
        copy = {"bytes": inner._stager.bytes_per_batch,
                "ms_p50": float(np.median(h2d)) if h2d else "not measured"}
        # the step on one fixed batch: debug_skip_load where the iterator
        # is native, else the first batch kept by hand
        it.reset()
        if native:
            inner.debug_skip_load()
        fixed = it.next()
        fixed_times = []
        for _ in range(timed):
            b = it.next() if native else fixed
            t0 = time.perf_counter()
            step(b.data[0], b.label[0])
            fixed_times.append((time.perf_counter() - t0) * 1e3)
        fixed_p50 = float(np.median(fixed_times[2:]))
        with ctx:
            it = mt.io.ImageRecordIter(**args)
        inner = it.iters[0]
        alone = _loader_alone_ips(inner, batch, device)
        decode = _decode_ips(rec_path, batch, native, inner)

        def profiled():
            b = it.next()
            step(b.data[0], b.label[0])

        it.reset()
        prof = profile_gluon("13b step fed by ImageRecordIter", profiled) \
            if device == "cuda" else {"idle_share": "not measured"}
        del net, trainer, it
        python_path = _python_imageiter(rec_path, side, batch, ctx, device)
        rec = {"phase": "13b", "card": card, "iterator": type(inner).__name__,
               "decoder": decoder, "records": records, "batch": batch,
               "steps": len(losses), "losses": losses,
               "step_p50_ms_fed": fed_p50, "step_p50_ms_fixed": fixed_p50,
               "fixed_by": "debug_skip_load" if native else "one batch kept",
               "loader_wait_ms_p50": float(np.median(waits[4:])),
               "loader_wait_ms_mean": float(np.mean(waits[4:])),
               "loader_alone_images_per_s": alone,
               "decode_images_per_s": decode, "h2d": copy,
               "images_per_s_fed": batch / fed_p50 * 1e3,
               "idle_share": prof["idle_share"], "checks": checks,
               "python_imageiter": python_path, "pack_s": pack_s}
        log(json.dumps(rec))
        log(f"data 13b: step p50 {fed_p50:.2f} ms fed by the iterator, "
            f"{fixed_p50:.2f} ms on one fixed batch; loader wait "
            f"{rec['loader_wait_ms_p50']:.2f} ms a batch; loader alone "
            f"{alone:.0f} images/s, decode alone {decode:.0f} images/s; "
            f"H2D {copy['bytes']} bytes, {copy['ms_p50']} ms a batch; idle "
            f"share {prof['idle_share']}; ImageIter (resize, crop) "
            f"{python_path['images_per_s']:.0f} images/s ({card})")
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _data_checks(args, ctx, rec_path, batch, epochs):
    """The iterator's holds: a batch on the device against the host's
    float64 decode, mirror and normalize with the same flags; two passes
    under the NaiveEngine with equal checksums; a batch unchanged after 3
    more fetches."""
    with ctx:
        it = mt.io.ImageRecordIter(**args)
    inner, native, _ = _iter_kind(it)
    b = it.next()
    want_x, want_y = _host_batch(inner, native, rec_path, batch,
                                 args["seed_aug"])
    got_x = b.data[0].data.double().cpu().numpy()
    x_err = float(np.abs(got_x - want_x).max())
    y_ok = bool(np.array_equal(b.label[0].asnumpy(), want_y))
    snap = b.data[0].data.clone()
    for _ in range(3):
        it.next()
    _sync(snap)
    unchanged = bool(torch.equal(b.data[0].data, snap))
    passes = []
    for _ in range(2):
        with ctx:
            fresh = mt.io.ImageRecordIter(**args).iters[0]
        naive = mt.io.PrefetchingIter(fresh,
                                      engine=mt.engine.Engine("NaiveEngine"))
        passes.append(_checksums(naive, 4))
    out = {"batch_vs_host_float64": x_err, "labels_equal": y_ok,
           "unchanged_after_3_fetches": unchanged,
           "naive_passes_equal": passes[0] == passes[1]}
    log(f"data 13b: {json.dumps(out)}")
    if not (x_err <= IMG_CHECK_TOL and y_ok and unchanged
            and out["naive_passes_equal"]):
        raise SystemExit(f"chip_smoke: 13b's iterator checks failed: {out}")
    return out


def _loader_alone_ips(inner, batch, device, n=8):
    """Images/s of the iterator alone (decode, augment, stage, device
    step), ``n`` batches after a first one."""
    inner.reset()
    inner._staged_next()
    t0 = time.perf_counter()
    for _ in range(n):
        b = inner._staged_next()
    _sync(b.data[0].data)
    return n * batch / (time.perf_counter() - t0)


def _decode_ips(rec_path, batch, native, inner, n=4):
    """Images/s of the host's decode alone over ``n`` batches' records."""
    rec = mt.recordio.MXRecordIO(rec_path, "r")
    bufs = [mt.recordio.unpack(rec.read())[1] for _ in range(n * batch)]
    rec.close()
    t0 = time.perf_counter()
    if native:
        c, h, w = inner.data_shape
        for k in range(n):
            io_native.decode_jpeg_batch(bufs[k * batch:(k + 1) * batch], h,
                                        w, c, inner._threads)
    else:
        for buf in bufs:
            mt.image.imdecode(buf)
    return len(bufs) / (time.perf_counter() - t0)


def _python_imageiter(rec_path, side, batch, ctx, device, n=4):
    """`image.ImageIter` with CreateAugmenter's resize and random crop
    (the per-image path), ``n`` batches: images/s."""
    with ctx:
        it = mt.image.ImageIter(batch_size=batch, data_shape=(3, side, side),
                                path_imgrec=rec_path, resize=side + 32,
                                rand_crop=True, rand_mirror=True, mean=True,
                                std=True, seed_aug=SEED)
    it.next()
    t0 = time.perf_counter()
    for _ in range(n):
        b = it.next()
    _sync(b.data[0].data)
    ips = n * batch / (time.perf_counter() - t0)
    if b.data[0].shape != (batch, 3, side, side) or \
            not torch.isfinite(b.data[0].data).all():
        raise SystemExit("chip_smoke: ImageIter's batch is malformed")
    return {"images_per_s": ips, "device_tail": it._tail is not None}


def phase_data(card):
    """Phase 13: the optimizers and initializers (13a) and the image data
    plane trained on ResNet-50 v1 (13b).  No TPU kernel lies on this
    path; returns its K1-K4 launches (none)."""
    t_phase = time.perf_counter()
    before = dict(hk.LAUNCHES)
    optimizer_checks(card)
    torch.cuda.empty_cache()
    data_plane_training(card)
    torch.cuda.empty_cache()
    launches = {k: hk.LAUNCHES[k] - before.get(k, 0) for k in hk.LAUNCHES}
    rec = {"phase": "optimizers_data_plane", "card": card,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    log(f"data: phase 13 in {rec['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: control flow, custom ops, partitioning and reshape
# ---------------------------------------------------------------------------

@mt.operator.register("numpy_softmax_loss")
class _NumpySoftmaxLossProp(mt.operator.CustomOpProp):
    """`example/numpy-ops/custom_softmax.py`'s softmax + cross-entropy
    head written in numpy, on the port's `nd`."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        class NumpySoftmaxLoss(mt.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                x = in_data[0].asnumpy()
                e = np.exp(x - x.max(axis=1, keepdims=True))
                self.assign(out_data[0], req[0],
                            mt.nd.array(e / e.sum(axis=1, keepdims=True)))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                p = np.array(out_data[0].asnumpy())
                label = in_data[1].asnumpy().astype(int)
                p[np.arange(len(label)), label] -= 1.0
                self.assign(in_grad[0], req[0], mt.nd.array(p))
                self.assign(in_grad[1], req[1],
                            mt.nd.zeros(in_data[1].shape))
        return NumpySoftmaxLoss()


class _HostCalls:
    """Times every host crossing of a custom op (`operator.CustomCall`'s
    forward and backward, the copies included) and counts its bytes each
    way, while installed."""

    def __init__(self):
        self.calls = {"forward": [], "backward": []}

    def __enter__(self):
        self._saved = (mt.operator.CustomCall.forward,
                       mt.operator.CustomCall.backward)
        fwd, bwd = self._saved
        calls = self.calls

        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts
                       if t is not None)

        def timed(kind, fn, host_args):
            def run(call, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(call, *args)
                torch.cuda.synchronize()
                calls[kind].append({
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "to_host_bytes": sum(nbytes(a) for a in host_args(args)),
                    "to_device_bytes": nbytes(out)})
                return out
            return run

        mt.operator.CustomCall.forward = timed(
            "forward", fwd, lambda a: [a[0]])
        mt.operator.CustomCall.backward = timed(
            "backward", bwd, lambda a: [a[0], a[1], a[2]])
        return self

    def __exit__(self, *exc):
        mt.operator.CustomCall.forward, mt.operator.CustomCall.backward = \
            self._saved

    def summary(self):
        out = {}
        for kind, rows in self.calls.items():
            if rows:
                out[kind] = {"calls": len(rows),
                             "p50_ms": float(np.median([r["ms"]
                                                        for r in rows])),
                             "to_host_bytes": rows[-1]["to_host_bytes"],
                             "to_device_bytes": rows[-1]["to_device_bytes"]}
        return out


def _cf_data(cfg, n_batches, batch, seq, seed):
    """Token ids (n·batch, seq) from one Markov stream and the next-token
    labels."""
    n = n_batches * batch
    stream = _markov_stream(cfg["vocab"], n * (seq + 1), seed)
    rows = stream.reshape(n, seq + 1)
    return rows[:, :-1].copy(), rows[:, 1:].copy()


def _lm_head(pred, head):
    label = mt.sym.Reshape(mt.sym.var("softmax_label"), shape=(-1,))
    if head == "custom":
        return mt.sym.Custom(pred, label, op_type="numpy_softmax_loss",
                             name="softmax")
    return mt.sym.SoftmaxOutput(pred, label, name="softmax")


def _unrolled_pred(cfg, seq):
    """The LM's logits with its loop unrolled by `cell.unroll` (phase
    6's graph, no head)."""
    return lstm_lm(mt, seq, **cfg).get_internals()["pred_output"]


def _lm_grads(sym, params, ids, label, ctx):
    """One recorded forward and backward of ``sym`` on the card: the
    outputs and every parameter's gradient."""
    args = {k: mt.nd.array(v, ctx=ctx) for k, v in params.items()}
    args["data"] = mt.nd.array(ids, ctx=ctx)
    args["softmax_label"] = mt.nd.array(label, ctx=ctx)
    ex = sym.bind(ctx, args=args,
                  args_grad={k: mt.nd.zeros(v.shape, ctx=ctx)
                             for k, v in params.items()},
                  grad_req={k: "write" for k in params})
    out = ex.forward(is_train=True)[0].data.clone()
    ex.backward()
    return out, {k: ex.grad_dict[k].data.clone() for k in params}


def _cf_module(sym, ctx, params, batch, seq):
    mod = mt.mod.Module(sym, context=ctx)
    mod.bind([("data", (batch, seq))], [("softmax_label", (batch, seq))])
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=ctx)
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(RNN_SGD))
    return mod


def _cf_batch(ids, label, i, batch, ctx):
    sl = slice(i * batch, (i + 1) * batch)
    return mt.io.DataBatch([mt.nd.array(ids[sl], ctx=ctx)],
                           [mt.nd.array(label[sl], ctx=ctx)])


def _step_turns(step, n=CF_TIMED, rounds=2):
    """``step()`` timed captured and eager (``MXTPU_GRAPH_COMPILE=0``) in
    turns, captured-eager-eager-captured per round: each way's p50 ms."""
    times = {"captured": [], "eager": []}
    for _ in range(rounds):
        for way in ("captured", "eager", "eager", "captured"):
            with (eager() if way == "eager" else contextlib.nullcontext()):
                step()
                for _ in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times[way].append((time.perf_counter() - t0) * 1e3)
    return {f"{w}_p50_ms": float(np.median(t)) for w, t in times.items()}


def foreach_lm_training(card, cfg=None, seq=CF_T, batch=CF_BATCH,
                        n_batches=CF_BATCHES, epochs=CF_EPOCHS):
    """14a: the foreach LM trained through ``Module.fit`` as one captured
    step; returns the module, its parameters, the data and the record."""
    cfg = dict(cfg or PTB_LSTM)
    gpu = mt.gpu(0)
    ids, label = _cf_data(cfg, n_batches, batch, seq, SEED + 14)
    sym = _lm_head(foreach_lm(mt, seq, batch, **cfg), "softmax_output")
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
        data=(batch, seq), softmax_label=(batch, seq))[0]))
    params = random_params({k: v for k, v in shapes.items()
                            if k not in ("data", "softmax_label")},
                           SEED + 15)
    # against the unrolled LM on the same weights, over one batch
    out_f, g_f = _lm_grads(sym, params, ids[:batch], label[:batch], gpu)
    out_u, g_u = _lm_grads(_lm_head(_unrolled_pred(cfg, seq),
                                    "softmax_output"),
                           params, ids[:batch], label[:batch], gpu)
    err_out = _rel_err(out_f, out_u)
    err_grad = max(_rel_err(g_f[k], g_u[k]) for k in params)
    log(f"cf: foreach LM against the unrolled LM: outputs {err_out:.3e} "
        f"(limit {CF_FWD_TOL}), gradients {err_grad:.3e} (limit "
        f"{CF_GRAD_TOL}) of the largest magnitude")
    if not (err_out <= CF_FWD_TOL and err_grad <= CF_GRAD_TOL):
        raise AssertionError(f"foreach LM off the unrolled LM: outputs "
                             f"{err_out}, gradients {err_grad}")
    # captured against eager, bit-equal over two steps from one state
    finals = {}
    for way in ("captured", "eager"):
        with (eager() if way == "eager" else contextlib.nullcontext()):
            m = _cf_module(sym, gpu, params, batch, seq)
            for i in range(2):
                if not m.fused_step(_cf_batch(ids, label, i, batch, gpu)):
                    raise AssertionError("the foreach LM took no one-graph "
                                         "step")
            finals[way] = {k: v.data.clone() for k, v in
                           m._exec.arg_dict.items() if k in params}
            if way == "captured" and not m._fused_train_step._graphs:
                raise AssertionError("the foreach LM step was not captured")
    bit_equal = all(torch.equal(finals["captured"][k], finals["eager"][k])
                    for k in params)
    worst = max(_rel_err(finals["captured"][k], finals["eager"][k])
                for k in params)
    log(f"cf: two captured steps against two eager ones: bit-equal "
        f"{bit_equal} (worst {worst:.3e})")
    if not bit_equal:
        raise AssertionError(f"captured steps off eager by {worst}")
    del finals
    # Module.fit, Perplexity per epoch
    it = mt.io.NDArrayIter(ids, label, batch_size=batch)
    mod = mt.mod.Module(sym, context=gpu)
    metric = mt.metric.Perplexity(None)
    ppl = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(it, eval_metric=metric, num_epoch=epochs, optimizer="sgd",
            optimizer_params=dict(RNN_SGD),
            arg_params={k: mt.nd.array(v, ctx=gpu)
                        for k, v in params.items()},
            epoch_end_callback=lambda *a: ppl.append(metric.get()[1]))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    step = mod._fused_train_step
    if step is None or not step._graphs:
        raise AssertionError("fit did not run the captured step")
    log(f"cf: Module.fit {epochs} epochs of {n_batches} batches in "
        f"{fit_s:.1f} s; perplexity by epoch {ppl}")
    if not (np.isfinite(ppl).all() and ppl[-1] < ppl[0]):
        raise AssertionError(f"perplexity did not fall: {ppl}")
    b0 = _cf_batch(ids, label, 0, batch, gpu)
    check_replay("foreach LM fit step", lambda: mod.fused_step(b0), {})
    turns = _step_turns(lambda: mod.fused_step(b0))
    prof = profile_gluon(f"foreach LM training step T {seq}",
                         lambda: mod.fused_step(b0))
    rec = {"config": cfg, "seq": seq, "batch": batch,
           "batches_an_epoch": n_batches, "epochs": epochs,
           "vs_unrolled": {"outputs": err_out, "gradients": err_grad},
           "captured_vs_eager_bit_equal": bit_equal, "fit_s": fit_s,
           "perplexity": ppl, **turns,
           "idle_share": prof["idle_share"],
           "phase10_bucketing_step_p50_ms": RNN_RECORD.get(
               "step_p50_ms", "not measured")}
    log(f"cf: foreach LM step at T {seq}: captured "
        f"{turns['captured_p50_ms']:.2f} ms, eager "
        f"{turns['eager_p50_ms']:.2f} ms (p50, in turns), idle share "
        f"{prof['idle_share']}; phase 10's BucketingModule step at T 60 "
        f"{rec['phase10_bucketing_step_p50_ms']} ms ({card})")
    return mod, params, (ids, label), rec


def foreach_served_on_k4(mod, cfg, seq, batch, ids):
    """14b: the trained parameters saved as `.params` and served on the
    unrolled LM by a `Predictor` whose forward runs K4; its logits against
    the foreach graph's captured inference forward."""
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    feed = {"data": ids[:batch]}
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        prefix = os.path.join(d, "foreach_lm")
        mod.save_checkpoint(prefix, 1)
        with open(f"{prefix}-0001.params", "rb") as f:
            blob = f.read()
    shapes = {"data": (batch, seq)}
    with pallas_mode("auto"):
        pred = mt.Predictor(_unrolled_pred(cfg, seq).tojson(), blob, shapes)
        rewrites, attn, lstm = _site_counts(pred)
        if (lstm, attn) != (2 * seq, 0):
            raise AssertionError(f"served LM: {lstm} LSTM sites on K4, want "
                                 f"{2 * seq}")
        before = hk.LAUNCHES["lstm_gates"]
        outs, _ = _serve(pred, [feed, feed], {"lstm_gates": 2 * seq})
        k4 = hk.LAUNCHES["lstm_gates"] - before
    scan = mt.Predictor(foreach_lm(mt, seq, batch, **cfg).tojson(), blob,
                        shapes)
    ref, _ = _serve(scan, [feed, feed], {"lstm_gates": 0})
    err = max(float(np.abs(o - ref[-1]).max()) for o in outs) / \
        float(np.abs(ref[-1]).max())
    log(f"cf: foreach-trained weights served on K4 ({k4} launches, "
        f"{2 * seq} a forward): logits against the foreach graph's "
        f"{err:.3e} (limit {CF_FWD_TOL})")
    if not err <= CF_FWD_TOL:
        raise AssertionError(f"served logits off the foreach graph by {err}")
    return {"k4_launches": k4, "logits_vs_foreach": err}


def while_decode(params, cfg, batch, ids, max_iter=CF_DECODE_ITERS,
                 n_steps=CF_DECODE_STEPS):
    """14c: greedy decoding as a `sym.contrib.while_loop` run as one
    captured inference forward, against the imperative host loop."""
    gpu = mt.gpu(0)
    H = cfg["num_hidden"]
    dec = greedy_decoder(mt, max_iter, **cfg)
    feed = dict(params, tok=ids[:batch, 0], i=np.zeros(1, np.float32),
                n_steps=np.array([n_steps], np.float32),
                **{f"s{k}": np.zeros((batch, H), np.float32)
                   for k in range(2 * cfg["num_layers"])})
    ex = dec.bind(gpu, args={k: mt.nd.array(v, ctx=gpu)
                             for k, v in feed.items()}, grad_req="null")
    runs = [ex.compiled_forward(is_train=False)[0].data.clone()
            for _ in range(4)]
    prog = ex.graph_program(False)
    if len(prog._graphs) != 1 or not prog.one_graph:
        raise AssertionError("the decode was not one captured forward")
    replays_equal = all(torch.equal(runs[1], r) for r in runs[2:])
    toks = runs[-1]
    w = {k: mt.nd.array(feed[k], ctx=gpu) for k in lm_weight_names(
        cfg["num_layers"])}
    n_nd = mt.nd.array(feed["n_steps"], ctx=gpu)

    def func(tok, i, *st):
        nxt, new = lstm_step(mt.nd, tok, list(st), w, cfg["num_layers"], H,
                             cfg["num_embed"], cfg["vocab"])
        return nxt, [nxt, i + 1.0] + new

    imp, _ = mt.nd.contrib.while_loop(
        lambda tok, i, *s: i < n_nd, func,
        [mt.nd.array(feed["tok"], ctx=gpu), mt.nd.zeros((1,), ctx=gpu)] +
        [mt.nd.zeros((batch, H), ctx=gpu)
         for _ in range(2 * cfg["num_layers"])], max_iterations=max_iter)
    equal_imp = torch.equal(toks, imp.data)
    pad_zero = not bool(toks[n_steps:].any())
    check_replay("while_loop decode", lambda: ex.compiled_forward(), {})
    ms = _event_p50_ms(lambda: ex.compiled_forward(), n=CF_TIMED)
    log(f"cf: while_loop greedy decode ({max_iter} iterations, n_steps "
        f"{n_steps}, batch {batch}): tokens equal the host loop's "
        f"{equal_imp}, rows {n_steps}-{max_iter - 1} zero {pad_zero}, "
        f"replays bit-equal {replays_equal}; {ms:.2f} ms a decode")
    if not (equal_imp and pad_zero and replays_equal):
        raise AssertionError("while_loop decode failed its holds")
    return {"ms_per_decode": ms, "tokens_equal_host_loop": equal_imp,
            "padding_zero": pad_zero, "replays_bit_equal": replays_equal,
            "max_iterations": max_iter, "n_steps": n_steps}


def custom_head_islands(params, cfg, seq, batch, data):
    """14d: the LM with the numpy softmax head as a ``Custom`` op: its
    island plan, 3 classic-path fit steps against the built-in head, the
    host crossings' cost, `lower_step_fn`'s refusal."""
    from mxnet_tpu_torch import graph_compile as gc
    gpu = mt.gpu(0)
    ids, label = data
    pred = foreach_lm(mt, seq, batch, **cfg)
    sym = _lm_head(pred, "custom")
    args = {k: mt.nd.array(v, ctx=gpu) for k, v in params.items()}
    args["data"] = mt.nd.array(ids[:batch], ctx=gpu)
    args["softmax_label"] = mt.nd.array(label[:batch], ctx=gpu)
    ex = sym.bind(gpu, args=args, grad_req="null")
    prog = ex.graph_program(False)
    islands = (prog.islands, prog.fallback_nodes)
    plan = [ex.compiled_forward(is_train=False)[0].data.clone()
            for _ in range(3)][-1]
    whole = ex.forward(is_train=False)[0].data.clone()
    err_plan = _rel_err(plan, whole)
    log(f"cf: Custom head: {islands[0]} islands, {islands[1]} fallback "
        f"node(s); the island plan against the eager whole graph "
        f"{err_plan:.3e} (limit {CF_FWD_TOL})")
    if islands[1] != 1 or islands[0] < 1 or not err_plan <= CF_FWD_TOL:
        raise AssertionError(f"island plan: {islands}, off by {err_plan}")
    try:
        gc.lower_step_fn(sym)
    except mt.MXNetError as e:
        refused = str(e)
    else:
        raise AssertionError("lower_step_fn took a graph with a Custom op")
    mods = {h: _cf_module(_lm_head(pred, h), gpu, params, batch, seq)
            for h in ("custom", "softmax_output")}
    b0 = _cf_batch(ids, label, 0, batch, gpu)
    grads = {}
    for h, m in mods.items():
        m.forward_backward(b0)
        grads[h] = {k: m._exec.grad_dict[k].data.clone() for k in params}
    grads_err = max(_rel_err(grads["custom"][k], grads["softmax_output"][k])
                    for k in params)
    del grads
    steps_ms = []
    with _HostCalls() as host:
        for i in range(CF_HEAD_STEPS):
            b = _cf_batch(ids, label, i, batch, gpu)
            for h, m in mods.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if not m.fused_step(b):
                    m.forward_backward(b)
                    m.update()
                torch.cuda.synchronize()
                if h == "custom":
                    steps_ms.append((time.perf_counter() - t0) * 1e3)
    if mods["custom"]._fused_train_step is not None:
        raise AssertionError("the Custom-head module built a one-graph step")
    w_err = max(_rel_err(mods["custom"]._exec.arg_dict[k].data,
                         mods["softmax_output"]._exec.arg_dict[k].data)
                for k in params)
    crossing = host.summary()
    log(f"cf: {CF_HEAD_STEPS} fit steps with the Custom head on the classic"
        f" path against SoftmaxOutput's one-graph steps: first gradients "
        f"{grads_err:.3e}, weights after {CF_HEAD_STEPS} {w_err:.3e} (limit"
        f" {CF_FWD_TOL}); step {float(np.median(steps_ms)):.2f} ms; host "
        f"crossings {json.dumps(crossing)}")
    if not (grads_err <= CF_FWD_TOL and w_err <= CF_FWD_TOL):
        raise AssertionError(f"Custom head off SoftmaxOutput: gradients "
                             f"{grads_err}, weights {w_err}")
    return {"islands": islands[0], "fallback_nodes": islands[1],
            "island_plan_vs_eager": err_plan, "grads_vs_builtin": grads_err,
            "weights_vs_builtin": w_err,
            "step_ms": float(np.median(steps_ms)), "host": crossing,
            "lower_step_fn": refused}


def module_reshape(mod, cfg, params, data, seq, batch, short=CF_RESHAPE_T):
    """14d: `Module.reshape` of the trained module from (batch, seq) to
    (batch, short) and back: the shrunk inputs view the root buffer; the
    outputs equal a fresh bind at ``short``."""
    gpu = mt.gpu(0)
    ids, label = data
    exec0 = mod._exec
    root = exec0.arg_dict["data"].data.data_ptr()
    mod.reshape([("data", (batch, short))], [("softmax_label",
                                               (batch, short))])
    shrunk = mod._exec.arg_dict["data"].data.data_ptr() == root
    b = mt.io.DataBatch([mt.nd.array(ids[:batch, :short], ctx=gpu)],
                        [mt.nd.array(label[:batch, :short], ctx=gpu)])
    mod.forward(b, is_train=False)
    got = mod.get_outputs()[0].data.clone()
    arg, aux = mod.get_params()
    fresh = mt.mod.Module(mod.symbol, context=gpu)
    fresh.bind([("data", (batch, short))], [("softmax_label",
                                             (batch, short))],
               for_training=False)
    fresh.init_params(arg_params=arg, aux_params=aux)
    fresh.forward(b, is_train=False)
    err = _rel_err(got, fresh.get_outputs()[0].data)
    mod.reshape([("data", (batch, seq))], [("softmax_label", (batch, seq))])
    back = mod._exec.arg_dict["data"].data.data_ptr() == root and \
        mod._exec is exec0
    log(f"cf: Module.reshape ({batch}, {seq}) -> ({batch}, {short}) -> "
        f"back: root buffer shared {shrunk} / {back}; outputs against a "
        f"fresh bind {err:.3e} (limit {CF_FWD_TOL})")
    if not (shrunk and back and err <= CF_FWD_TOL):
        raise AssertionError(f"Module.reshape: shared {shrunk}/{back}, "
                             f"off by {err}")
    return {"root_shared": [shrunk, back], "vs_fresh_bind": err}


def _seq_mlp(joined, ctx):
    """`example/module/sequential_module.py`: fc1 (128) | fc2 (64), fc3
    (10), SoftmaxOutput, as two modules or one."""
    S = mt.sym
    net1 = S.Activation(S.FullyConnected(S.var("data"), name="fc1",
                                         num_hidden=128),
                        name="relu1", act_type="relu")
    net2 = S.Activation(S.FullyConnected(net1 if joined else S.var("data"),
                                         name="fc2", num_hidden=64),
                        name="relu2", act_type="relu")
    net2 = S.SoftmaxOutput(S.FullyConnected(net2, name="fc3",
                                            num_hidden=10), name="softmax")
    if joined:
        return mt.mod.Module(net2, context=ctx)
    seq = mt.mod.SequentialModule()
    seq.add(mt.mod.Module(net1, label_names=[], context=ctx))
    seq.add(mt.mod.Module(net2, context=ctx), take_labels=True,
            auto_wiring=True)
    return seq


def other_surfaces(card, cfg=SEQ_MLP):
    """14e: a SequentialModule against one Module of the joined graph; a
    hybridized foreach over `gluon.rnn.LSTMCell(200)` against its
    imperative run; a hybridized block with a ``_cond`` called with new
    inputs; `_cond` on the card against the CPU, and inside a scan."""
    from mxnet_tpu_torch import graph_compile as gc
    gpu = mt.gpu(0)
    rng = np.random.RandomState(SEED + 16)
    n = cfg["batch"] * cfg["steps"]
    X = rng.rand(n, cfg["features"]).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    w0 = {"fc1_weight": rng.randn(128, cfg["features"]) * 0.05,
          "fc1_bias": np.zeros(128), "fc2_weight": rng.randn(64, 128) * 0.1,
          "fc2_bias": np.zeros(64), "fc3_weight": rng.randn(10, 64) * 0.1,
          "fc3_bias": np.zeros(10)}
    weights = {}
    for joined in (False, True):
        m = _seq_mlp(joined, gpu)
        m.fit(mt.io.NDArrayIter(X, y, batch_size=cfg["batch"]), num_epoch=1,
              optimizer="sgd", optimizer_params={"learning_rate": cfg["lr"]},
              arg_params={k: mt.nd.array(v.astype(np.float32), ctx=gpu)
                          for k, v in w0.items()})
        weights[joined] = {k: v.data for k, v in m.get_params()[0].items()}
    seq_err = max(_rel_err(weights[False][k], weights[True][k]) for k in w0)
    # F.contrib.foreach over a Gluon LSTMCell, hybridized
    cell_h, steps = 200, CF_RESHAPE_T

    class Scan(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.cell = mt.gluon.rnn.LSTMCell(cell_h, input_size=cell_h)

        def hybrid_forward(self, F, x, h, c):
            outs, _ = F.contrib.foreach(lambda item, st: self.cell(item, st),
                                        x, [h, c])
            return outs

    net = Scan(prefix="scan_")
    net.initialize(mt.init.Xavier(), ctx=gpu)
    x = mt.nd.array(rng.randn(steps, CF_BATCH, cell_h).astype(np.float32),
                    ctx=gpu)
    h0 = mt.nd.zeros((CF_BATCH, cell_h), ctx=gpu)
    c0 = mt.nd.zeros((CF_BATCH, cell_h), ctx=gpu)
    imp = net(x, h0, c0).data.clone()
    net.hybridize()
    hyb = [net(x, h0, c0).data.clone() for _ in range(3)][-1]
    if net._cached_op.num_programs != 1:
        raise AssertionError("the hybridized foreach was not captured once")
    scan_err = _rel_err(hyb, imp)
    gate_err, gate_programs = _host_block_calls(gpu, rng, cell_h)
    # _cond on the card, both branches, against the CPU
    S = mt.sym
    xs, a, b = S.var("x"), S.var("a"), S.var("b")
    cond = S.contrib.cond(S.sum(xs) > 0.0,
                          lambda: S.exp(S.FullyConnected(a, num_hidden=8,
                                                         name="fc")),
                          lambda: b * 3.0)
    av = rng.randn(4, 8).astype(np.float32)
    cond_err = 0.0
    for scale in (1.0, -1.0):
        feed = {"x": np.full((2,), scale, np.float32), "a": av,
                "b": rng.randn(4, 8).astype(np.float32),
                "fc_weight": rng.randn(8, 8).astype(np.float32) * 0.3,
                "fc_bias": np.zeros(8, np.float32)}
        outs = []
        for ctx in (gpu, mt.cpu()):
            e = cond.bind(ctx, args={k: mt.nd.array(v, ctx=ctx)
                                     for k, v in feed.items()},
                          grad_req="null")
            outs.append([e.compiled_forward(is_train=False)[0].data.cpu()
                         for _ in range(3)][-1])
        cond_err = max(cond_err, _rel_err(outs[0], outs[1]))
    # a _cond inside a foreach body: the scan runs eagerly between islands
    nested, _ = S.contrib.foreach(
        lambda item, st: [S.contrib.cond(S.sum(item) > 0.0,
                                         lambda: st + item,
                                         lambda: st * 0.5)] * 2,
        xs, b)
    if gc.one_graph(nested):
        raise AssertionError("a _cond inside a foreach body counted as "
                             "capturable")
    feed = {"x": rng.randn(6, 4, 8).astype(np.float32),
            "b": rng.randn(4, 8).astype(np.float32)}
    outs = []
    for ctx in (gpu, mt.cpu()):
        e = nested.bind(ctx, args={k: mt.nd.array(v, ctx=ctx)
                                   for k, v in feed.items()},
                        grad_req="null")
        outs.append([e.compiled_forward(is_train=False)[0].data.cpu()
                     for _ in range(3)][-1])
    nested_err = _rel_err(outs[0], outs[1])
    log(f"cf: SequentialModule of 2 Modules against the joined Module after "
        f"{cfg['steps']} steps {seq_err:.3e} (limit {SEQ_TOL}); hybridized "
        f"foreach over LSTMCell({cell_h}) against imperative "
        f"{scan_err:.3e}; a hybridized block with a _cond over "
        f"{CF_HOST_CALLS} calls of new inputs against imperative "
        f"{gate_err:.3e}, {gate_programs} program(s) kept; _cond on the "
        f"card against the CPU, both branches, {cond_err:.3e}, inside a "
        f"foreach body {nested_err:.3e} (limit {CF_FWD_TOL}) ({card})")
    if not (seq_err <= SEQ_TOL and scan_err <= CF_FWD_TOL
            and gate_err <= CF_FWD_TOL and cond_err <= CF_FWD_TOL
            and nested_err <= CF_FWD_TOL):
        raise AssertionError(f"14e: sequential {seq_err}, scan {scan_err}, "
                             f"host block {gate_err}, cond {cond_err}, "
                             f"nested cond {nested_err}")
    return {"sequential_vs_joined": seq_err, "hybrid_foreach": scan_err,
            "host_block": gate_err, "host_block_programs": gate_programs,
            "cond_vs_cpu": cond_err, "cond_in_foreach_vs_cpu": nested_err}


def _host_block_calls(gpu, rng, width, calls=CF_HOST_CALLS):
    """A hybridized block whose forward reads the host (a ``_cond``),
    called with a new input array each time, as a server calls it: every
    output equals the block's imperative run, and the block keeps one
    program whose islands each hold one capture."""

    class Gate(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc = mt.gluon.nn.Dense(width, in_units=width)

        def hybrid_forward(self, F, x):
            y = self.fc(x)
            return F.contrib.cond(F.sum(y) > 0.0, lambda: F.tanh(y),
                                  lambda: y * 0.5)

    net = Gate(prefix="gate_")
    net.initialize(mt.init.Xavier(), ctx=gpu)
    xs = [rng.randn(CF_BATCH, width).astype(np.float32) * s
          for s in (1.0, -1.0) * (calls // 2)]
    imp = [net(mt.nd.array(x, ctx=gpu)).data.clone() for x in xs]
    net.hybridize()
    errs, counts = [], set()
    for x, want in zip(xs, imp):
        errs.append(_rel_err(net(mt.nd.array(x, ctx=gpu)).data, want))
        progs = net._cached_op._graph_programs
        prog = next(iter(progs.values()))[0]
        counts.add((len(progs), len(prog._graphs),
                    tuple(len(i._graphs) for i in
                          prog._islands_of.values())))
    (n_progs, whole, per_island), = counts
    if n_progs != 1 or whole or not per_island or \
            any(n != 1 for n in per_island):
        raise AssertionError(f"host block captures grew over {calls} "
                             f"calls: {sorted(counts)}")
    return max(errs), n_progs


def phase_control_flow(card):
    """Phase 14: control flow, custom ops, partitioning and reshape on the
    foreach LM.  Returns its main path's K1-K4 launches (14b's K4)."""
    t_phase = time.perf_counter()
    cfg = dict(PTB_LSTM)
    hk.reset_launch_counts()
    mod, params, data, train = foreach_lm_training(card, cfg)
    served = foreach_served_on_k4(mod, cfg, CF_T, CF_BATCH, data[0])
    launches = dict(hk.LAUNCHES)
    if launches["lstm_gates"] != served["k4_launches"] or \
            any(launches[k] for k in ATTN_KERNELS):
        raise AssertionError(f"phase 14 launched {launches}; want only the "
                             "served forwards' K4")
    trained = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    decode = while_decode(trained, cfg, CF_BATCH, data[0])
    custom = custom_head_islands(params, cfg, CF_T, CF_BATCH, data)
    reshape = module_reshape(mod, cfg, params, data, CF_T, CF_BATCH)
    del mod
    torch.cuda.empty_cache()
    other = other_surfaces(card)
    rec = {"phase": "control_flow", "card": card, "dtype": "float32",
           "foreach_lm": train, "served_on_k4": served, "decode": decode,
           "custom_head": custom, "reshape": reshape, "other": other,
           "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    log(f"cf: phase 14 in {rec['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the one-server serving plane, observed by the port's profiler
# ---------------------------------------------------------------------------

def _serve_feed(rows, seq, vocab, rng):
    """``rows`` BERT requests: token ids and one row of positions each."""
    return {"data": rng.randint(0, vocab, (rows, seq)).astype(np.float32),
            "positions": np.tile(np.arange(seq, dtype=np.float32),
                                 (rows, 1))}


def _row_rel_err(got, want):
    """max |got - want| over the largest |want| of two numpy arrays."""
    return float(np.abs(got - want).max()) / \
        max(float(np.abs(want).max()), 1e-30)


def serving_export(cfg, blob, seq, ladder, tmpdir, ref_pallas="0",
                   tol=SLICE_TOL):
    """15a: export, load and capture.  The live Predictor's pool and the
    blob's must agree bitwise at every rung, both within ``tol`` of an
    unfused-graph Predictor; a row alone (rung 1) within CAPTURE_TOL of the
    same row in a full rung; a truncated blob refused."""
    from mxnet_tpu_torch.predictor import CompiledBlobError
    from mxnet_tpu_torch.serving import CompiledModelPool
    n_layers = cfg["num_layers"]
    sym = bert_encoder(mt.sym, **cfg)
    bound = max(ladder) // 2
    shapes = {"data": (bound, seq), "positions": (bound, seq)}
    path = os.path.join(tmpdir, "bert_v1.blob")
    with pallas_mode("auto"):
        pred = mt.Predictor(sym.tojson(), blob, shapes)
    if _rewrites(pred) != n_layers:
        raise AssertionError(f"pallas_select rewrote {_rewrites(pred)} "
                             f"attention sites, want {n_layers}")
    t0 = time.perf_counter()
    pred.export_compiled(path, dynamic_batch=True)
    export_s = time.perf_counter() - t0
    blob_bytes = os.path.getsize(path)
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    live = CompiledModelPool(pred, batch_ladder=ladder)
    live_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = CompiledModelPool(path, batch_ladder=ladder)
    blob_s = time.perf_counter() - t0
    # each rung's eager warm-up launches K1 for real; its capture none
    warm = n_layers * len(ladder) * 2 if pool.devices[0].type == "cuda" \
        else hk.LAUNCHES["flash_attn_fwd"]
    if hk.LAUNCHES["flash_attn_fwd"] != warm:
        raise AssertionError(f"building the pools counted launches "
                             f"{dict(hk.LAUNCHES)}, want {warm} (the "
                             "warm-ups'): a capture's launches count at its "
                             "replays")
    if pool.devices[0].type == "cuda" and \
            not all(p.captured for p in pool._exec[0].values()):
        raise AssertionError("a rung of the blob pool is not captured")
    rng = np.random.RandomState(SEED + 15)
    feeds = {r: _serve_feed(r, seq, cfg["vocab"], rng) for r in ladder}
    outs, worst_ref = {}, 0.0
    with pallas_mode(ref_pallas):
        ref = mt.Predictor(sym.tojson(), blob, shapes)
    if _rewrites(ref) != 0:
        raise AssertionError("the unfused reference swapped kernels in")
    for r in ladder:
        before = hk.LAUNCHES["flash_attn_fwd"]
        got = pool.run(feeds[r])[0]
        if hk.LAUNCHES["flash_attn_fwd"] - before != n_layers:
            raise AssertionError(f"rung {r}: a replay launched K1 "
                                 f"{hk.LAUNCHES['flash_attn_fwd'] - before}"
                                 f" times, want {n_layers}")
        want = live.run(feeds[r])[0]
        if got.shape != (r, seq, cfg["hidden"]) or \
                not np.isfinite(got).all():
            raise AssertionError(f"rung {r}: output {got.shape} not finite")
        if not np.array_equal(got, want):
            raise AssertionError(f"rung {r}: blob pool off the live pool by "
                                 f"{float(np.abs(got - want).max())}")
        with pallas_mode(ref_pallas):
            ref.reshape({"data": (r, seq), "positions": (r, seq)})
            ref.forward(**feeds[r])
            unfused = ref.get_output(0).asnumpy()
        np.testing.assert_allclose(got, unfused, rtol=tol, atol=tol)
        worst_ref = max(worst_ref, float(np.abs(got - unfused).max()))
        outs[r] = got
    del ref
    # a row alone (rung 1) against the same row inside each fuller rung:
    # the rungs run their GEMMs at other M, which cuBLAS tiles otherwise
    rung_errs = {}
    for r in ladder[1:]:
        lone = pool.run({k: v[:1] for k, v in feeds[r].items()})[0]
        rung_errs[r] = _row_rel_err(lone[0], outs[r][0])
    rung_err = max(rung_errs.values()) if rung_errs else 0.0
    if rung_err > RUNG_TOL:
        raise AssertionError(f"row 0 alone (rung {ladder[0]}) off the same "
                             f"row at the other rungs by {rung_errs} of its "
                             f"largest magnitude > {RUNG_TOL}")
    # one pool.run a rung (replay and the rows' host copy), host-timed
    rung_ms = {}
    for r in ladder:
        lat = []
        for _ in range(SERVE_RUNG_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.run(feeds[r])
            lat.append((time.perf_counter() - t0) * 1e3)
        rung_ms[r] = float(np.percentile(lat, 50))
    cut = os.path.join(tmpdir, "bert_cut.blob")
    with open(path, "rb") as f, open(cut, "wb") as g:
        g.write(f.read(blob_bytes // 2))
    try:
        CompiledModelPool(cut, batch_ladder=[1])
    except CompiledBlobError as e:
        refused = str(e)[:160]
    else:
        raise AssertionError("a truncated blob was served")
    os.remove(cut)
    rec = {"serving": "export", "blob_bytes": blob_bytes,
           "export_s": export_s, "live_pool_capture_s": live_s,
           "blob_load_and_capture_s": blob_s, "ladder": list(ladder),
           "max_abs_diff_vs_unfused": worst_ref,
           "rung1_vs_rung_rel_err": rung_errs, "pool_run_p50_ms": rung_ms,
           "truncated_refused": refused,
           "launches": dict(hk.LAUNCHES)}
    log(json.dumps(rec))
    return pred, live, pool, path, feeds, rec


def _graph_k1_counts(events, kernel=K1_FP32):
    """K1 launches per ``cudaGraphLaunch`` of a Chrome trace, by the
    correlation id a graph's kernels share with its launch call; and the
    K1 launches outside any graph launch."""
    launches = {e["args"]["correlation"] for e in events
                if e.get("name") == "cudaGraphLaunch"
                and "correlation" in e.get("args", {})}
    per = {c: 0 for c in launches}
    stray = 0
    for e in events:
        if e.get("cat") != "kernel" or kernel not in e.get("name", ""):
            continue
        c = e.get("args", {}).get("correlation")
        if c in per:
            per[c] += 1
        else:
            stray += 1
    return per, stray


def serving_profile(pool, feeds, n_layers, tmpdir):
    """15b: the port's own profiler around one ``pool.run`` per rung: its
    Chrome trace must show each replay as one graph launch holding
    ``n_layers`` K1 launches, and `dumps()` the serve family.  The
    session's first graph launch is a warm-up left out of the count: in
    a whole run of this script the trace holds 11 of its 12 K1 launches,
    even after `_trace_settle` (12 when phase 15 runs alone)."""
    trace = os.path.join(tmpdir, "serve_trace.json")
    top = max(feeds)
    torch.cuda.synchronize()
    mt.profiler.set_config(filename=trace)
    mt.profiler.start()
    _trace_settle()
    pool.run(feeds[top])
    for r in sorted(feeds):
        with mt.profiler.Task(name=f"serve.rung_{r}"):
            pool.run(feeds[r])
    mt.profiler.stop()
    if mt.profiler.dump() != trace:
        raise AssertionError("profiler.dump wrote no trace")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    per, stray = _graph_k1_counts(events)
    launches = [per[c] for c in sorted(per)]
    counts = launches[1:]
    if counts != [n_layers] * len(feeds) or stray:
        raise AssertionError(f"the trace's graph launches held K1 "
                             f"{launches} (the first a warm-up) and {stray} "
                             f"K1 launches outside them; want {len(feeds)} "
                             f"launches of {n_layers} after the warm-up")
    table = mt.profiler.dumps()
    if "-- serve --" not in table or "serve.rung_1" not in table:
        raise AssertionError("profiler.dumps() lacks the serve family or "
                             "the rung spans")
    rec = {"serving": "profile", "trace_bytes": os.path.getsize(trace),
           "trace_events": len(events), "graph_launches": len(launches),
           "k1_per_graph_launch": launches}
    log(json.dumps(rec))
    return rec


@contextlib.contextmanager
def _recording():
    """Every ``CompiledModelPool.run`` inside, whichever pool serves
    (a deploy builds its own), kept as (pool, input tokens, rung)."""
    from mxnet_tpu_torch.serving import CompiledModelPool
    seen = []
    run = CompiledModelPool.run

    def recorded(self, feed, replica=0):
        seen.append((self, np.array(feed["data"]),
                     self.rung_for(len(feed["data"]))))
        return run(self, feed, replica=replica)
    CompiledModelPool.run = recorded
    try:
        yield seen
    finally:
        CompiledModelPool.run = run


def _dispatch_of(seen, data):
    """The pool and rung whose dispatch carried the request rows
    ``data``."""
    n = len(data)
    for pool, batch, rung in seen:
        for i in range(len(batch) - n + 1):
            if np.array_equal(batch[i:i + n], data):
                return pool, rung
    raise AssertionError("a request's rows were never dispatched")


def _client_traffic(host, port, n_requests, clients, seq, vocab, seed,
                    retry_draining=False, during=None):
    """``clients`` threads sending 1-3-row requests (``n_requests`` in
    all, and with ``during`` until it has returned too); returns
    [(request, reply, ms)] and the failures.  With ``retry_draining`` a
    refusal during a hot swap's drain is sent again and counted;
    ``during()`` runs on this thread while they send."""
    import threading
    from mxnet_tpu_torch.serving import ServeClient, ServerDrainingError
    results, failures, refusals = [], [], []
    lock = threading.Lock()
    done = threading.Event()
    if during is None:
        done.set()

    def client(k):
        rng = np.random.RandomState(seed + k)
        sent = 0
        with ServeClient(host, port, retry_deadline=30.0) as cli:
            while sent < n_requests // clients or not done.is_set():
                sent += 1
                feed = _serve_feed(int(rng.randint(1, 4)), seq, vocab, rng)
                while True:
                    t0 = time.perf_counter()
                    try:
                        out = cli.infer(feed)[0]
                    except ServerDrainingError as e:
                        if retry_draining:
                            with lock:
                                refusals.append(1)
                            time.sleep(0.001)
                            continue
                        with lock:
                            failures.append(repr(e))
                        out = None
                    except Exception as e:
                        with lock:
                            failures.append(repr(e))
                        out = None
                    break
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    results.append((feed, out, ms))

    ts = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    if during is not None:
        try:
            during()
        finally:
            done.set()
    for t in ts:
        t.join()
    return results, failures, len(refusals), time.perf_counter() - t0


def _check_replies(seen, results):
    """Each reply equals bitwise the same rows run at the rung (of the
    pool) they were dispatched at; returns the count per rung."""
    per_rung = {}
    for feed, out, _ms in results:
        pool, rung = _dispatch_of(seen, feed["data"])
        n = len(feed["data"])
        prog = pool._exec[0][rung]
        want = prog([feed[k] for k in pool.input_names], rows=n)[0]
        if out is None or not np.array_equal(out, want):
            raise AssertionError(f"a {n}-row reply is not the rung-{rung} "
                                 "run of its rows")
        per_rung[rung] = per_rung.get(rung, 0) + 1
    return per_rung


def serving_wire(pool, seq, vocab, n_requests=SERVE_REQUESTS,
                 clients=SERVE_CLIENTS):
    """15c: `ModelServer` behind the micro-batcher, `ServeClient`s over
    the wire; every reply checked bitwise at its dispatch rung."""
    from mxnet_tpu_torch.serving import ModelServer
    mt.profiler.reset_serve_counters()
    with _recording() as seen:
        with env(MXTPU_SERVE_MAX_DELAY_MS=str(SERVE_DELAY_MS)):
            srv = ModelServer(pool, model_version="v1")
        with srv:
            host, port = srv.serve()
            results, failures, _r, wall = _client_traffic(
                host, port, n_requests, clients, seq, vocab, SEED + 150)
            counters = mt.profiler.serve_counters(window_s=600.0)
    if failures or len(results) != n_requests:
        raise AssertionError(f"{len(failures)} requests failed: "
                             f"{failures[:3]}")
    checked = _check_replies(seen, results)
    lat = np.array([ms for _f, _o, ms in results])
    rows = sum(len(f["data"]) for f, _o, _m in results)
    q = np.percentile(lat, [50, 90, 99])
    rec = {"serving": "wire", "requests": n_requests, "clients": clients,
           "max_delay_ms": SERVE_DELAY_MS, "rows": rows,
           "p50_ms": float(q[0]), "p90_ms": float(q[1]),
           "p99_ms": float(q[2]), "wall_s": wall, "rows_per_s": rows / wall,
           "replies_checked_per_rung": checked,
           "dispatches_per_rung": {k: v for k, v in counters.items()
                                   if k.startswith("rung_")},
           "serve_counters": counters}
    log(json.dumps(rec, default=float))
    return rec


def serving_swap(pool, pred, path, seq, vocab, tmpdir,
                 n_requests=SERVE_SWAP_REQUESTS, clients=SERVE_CLIENTS):
    """15d: a deploy of a second blob during traffic and a rollback: no
    request fails (a refusal during a drain is sent again and counted),
    every reply is bitwise its rung's run, `stats()` names the version
    served; then one traced request's id in the server's ``serve.infer``
    span, read from the flight recorder."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import ModelServer, ServeClient
    path2 = os.path.join(tmpdir, "bert_v2.blob")
    pred.export_compiled(path2, dynamic_batch=True)
    versions = {}
    with _recording() as seen:
        with env(MXTPU_SERVE_MAX_DELAY_MS=str(SERVE_DELAY_MS)):
            srv = ModelServer(pool, model_version="v1")
        with srv:
            host, port = srv.serve()

            def swap():
                time.sleep(0.2)
                t0 = time.perf_counter()
                srv.deploy(path2, version="v2")
                versions["deploy_s"] = time.perf_counter() - t0
                versions["v2"] = srv._pool
                with ServeClient(host, port) as cli:
                    versions["after_deploy"] = cli.stats()["model_version"]
                time.sleep(0.2)
                t0 = time.perf_counter()
                srv.deploy(path, version="v1")
                versions["rollback_s"] = time.perf_counter() - t0
                with ServeClient(host, port) as cli:
                    versions["after_rollback"] = \
                        cli.stats()["model_version"]

            results, failures, refusals, wall = _client_traffic(
                host, port, n_requests, clients, seq, vocab, SEED + 160,
                retry_draining=True, during=swap)
            telemetry.reset()
            with ServeClient(host, port) as cli, telemetry.trace() as tid:
                cli.infer(_serve_feed(1, seq, vocab,
                                      np.random.RandomState(SEED + 170)))
            spans = [r for r in telemetry.flight_records()
                     if r["name"] == "serve.infer" and r.get("trace") == tid]
    if failures or len(results) < n_requests:
        raise AssertionError(f"{len(failures)} requests failed during the "
                             f"swap: {failures[:3]}")
    if not any(p is versions["v2"] for p, _b, _r in seen):
        raise AssertionError("no request was served by the deployed v2")
    if versions.get("after_deploy") != "v2" or \
            versions.get("after_rollback") != "v1":
        raise AssertionError(f"stats named {versions}")
    if not spans:
        raise AssertionError("the server's serve.infer span lost the "
                             "request's trace id")
    checked = _check_replies(seen, results)
    rec = {"serving": "hot_swap", "requests": len(results),
           "drain_refusals_resent": refusals, "wall_s": wall,
           "deploy_s": versions["deploy_s"],
           "rollback_s": versions["rollback_s"],
           "v2_dispatches": sum(1 for p, _b, _r in seen
                                if p is versions["v2"]),
           "versions": [versions["after_deploy"],
                        versions["after_rollback"]],
           "replies_checked_per_rung": checked, "trace_id": tid,
           "serve_infer_spans": len(spans)}
    log(json.dumps(rec))
    return rec


def phase_serving(card, cfg=None, seq=SERVE_SEQ, ladder=SERVE_LADDER,
                  profile=True, keep=False):
    """Phase 15: BERT-base served through the whole plane.  Returns its
    K1 launches; with ``keep`` also what phase 16 serves on (the pool,
    the blobs, their directory, which the caller then removes)."""
    t_phase = time.perf_counter()
    cfg = dict(cfg or BERT_BASE)
    n_layers = cfg["num_layers"]
    sym = bert_encoder(mt.sym, **cfg)
    shapes = {"data": (1, seq), "positions": (1, seq)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    blob = dumps_ndarrays({"arg:" + n: NDArray(torch.from_numpy(a))
                           for n, a in params.items()})
    del params
    tmpdir = tempfile.mkdtemp(prefix="mxtt_serve_")
    try:
        hk.reset_launch_counts()
        pred, live, pool, path, feeds, export = serving_export(
            cfg, blob, seq, ladder, tmpdir)
        del live
        prof = serving_profile(pool, feeds, n_layers, tmpdir) \
            if profile else None
        wire = serving_wire(pool, seq, cfg["vocab"])
        swap = serving_swap(pool, pred, path, seq, cfg["vocab"], tmpdir)
        launches = dict(hk.LAUNCHES)
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    if not keep:
        shutil.rmtree(tmpdir, ignore_errors=True)
    if any(launches[k] for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                                 "lstm_gates")):
        raise AssertionError(f"phase 15 launched {launches}; want K1 only")
    rec = {"phase": "serving", "card": card, "dtype": "float32",
           "seq": seq, "export": export, "profile": prof, "wire": wire,
           "hot_swap": swap, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec, default=float))
    log(f"serving: phase 15 in {rec['phase_s']:.1f} s")
    if keep:
        return launches, dict(
            pool=pool, cfg=cfg, seq=seq, tmpdir=tmpdir, v1=path,
            v2=os.path.join(tmpdir, "bert_v2.blob"), sym=sym,
            shapes={"data": (max(ladder) // 2, seq),
                    "positions": (max(ladder) // 2, seq)})
    return launches


# ---------------------------------------------------------------------------
# phase 16: the rest of the serving plane -- the decode arena on K4, the
# decode lane on the wire, a fleet of replica processes, the autoscaler
# ---------------------------------------------------------------------------

def lm_cell_symbol(mx, num_layers=2, num_hidden=200, num_embed=200,
                   vocab=10000):
    """One step of MXNet's PTB LSTM LM built with package ``mx``: the
    token embedded, each `rnn.LSTMCell` of the stack stepped on the state
    variables ``h<i>``, ``c<i>``, the decoder; heads ``[logits, h0', c0',
    h1', c1', ...]`` (the shape `generation.DecodeCell.from_symbol`
    takes)."""
    sym = mx.sym
    x = sym.Embedding(sym.var("token"), input_dim=vocab,
                      output_dim=num_embed, name="embed")
    states = []
    for i in range(num_layers):
        cell = mx.rnn.LSTMCell(num_hidden=num_hidden, prefix=f"lstm_l{i}_")
        x, (h, c) = cell(x, [sym.var(f"h{i}"), sym.var(f"c{i}")])
        states += [h, c]
    return sym.Group([sym.FullyConnected(x, num_hidden=vocab, name="pred")]
                     + states)


def lm_decode_cells(cfg, slots, device):
    """The LM's decode cell rewritten by `graph_opt` (every LSTM site on
    `_fused_lstm_gates`, K4) and the unfused one, on the same seeded
    weights on ``device``."""
    from mxnet_tpu_torch import graph_opt
    from mxnet_tpu_torch.generation import DecodeCell
    sym = lm_cell_symbol(mt, **cfg)
    order = [f"{k}{i}" for i in range(cfg["num_layers"]) for k in "hc"]
    shapes = {"token": (slots,)}
    shapes.update({n: (slots, cfg["num_hidden"]) for n in order})
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED + 16)
    specs = {n: ((cfg["num_hidden"],), np.float32) for n in order}
    with pallas_mode("auto"):
        res = graph_opt.optimize(sym, shapes=shapes,
                                 device=torch.device(device))
    fused_sites = json.loads(res.symbol.tojson())["nodes"]
    n_fused = sum(1 for n in fused_sites if n["op"] == "_fused_lstm_gates")
    if n_fused != cfg["num_layers"]:
        raise AssertionError(f"graph_opt put {n_fused} LSTM sites on K4, "
                             f"want {cfg['num_layers']}")
    feed = dict(params)
    feed.update({k: v.numpy() for k, v in res.const_feed.items()})
    ctx = mt.gpu(0)
    fused = DecodeCell.from_symbol(res.symbol, feed, specs, cfg["vocab"],
                                   state_order=order, ctx=ctx)
    unfused = DecodeCell.from_symbol(sym, params, specs, cfg["vocab"],
                                     state_order=order, ctx=ctx)
    return fused, unfused, order


def _cell_step_err(fused, unfused, order, cfg, slots):
    """One step of both cells on the same seeded arena states and
    tokens: the worst of logits' and states' max |a - b| over the largest
    |b|."""
    rng = np.random.RandomState(SEED + 161)
    dev = fused.device
    state = {n: torch.from_numpy((0.5 * rng.randn(
        slots, cfg["num_hidden"])).astype(np.float32)).to(dev)
        for n in order}
    tok = torch.from_numpy(rng.randint(0, cfg["vocab"], slots)
                           .astype(np.int32)).to(dev)
    with torch.inference_mode():
        s1, l1 = fused.step_fn(fused.params, state, tok)
        s2, l2 = unfused.step_fn(unfused.params, state, tok)
    errs = {"logits": _row_rel_err(l1.cpu().numpy(), l2.cpu().numpy())}
    for n in order:
        errs[n] = _row_rel_err(s1[n].cpu().numpy(), s2[n].cpu().numpy())
    return errs


def _gen_prompts(vocab, n, seed):
    """``n`` prompts of GEN_PROMPT_LEN tokens cut from one synthetic
    Markov stream, and budgets in GEN_NEW, from ``seed``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(GEN_PROMPT_LEN[0], GEN_PROMPT_LEN[1] + 1, n)
    budgets = [int(b) for b in rng.randint(GEN_NEW[0], GEN_NEW[1] + 1, n)]
    stream = _markov_stream(vocab, int(lens.sum()), seed).astype(np.int32)
    cuts = np.cumsum(lens)[:-1]
    return [p.copy() for p in np.split(stream, cuts)], budgets


def _serve_decode(svc, prompts, budgets):
    """Every prompt submitted to ``svc`` at once; the outputs, the wall
    seconds to the last one and each request's TTFT ms."""
    t0 = time.perf_counter()
    futs = [svc.submit(p, b) for p, b in zip(prompts, budgets)]
    outs = [f.result(timeout=600.0) for f in futs]
    return outs, time.perf_counter() - t0, [f.ttft_ms for f in futs]


def _same_tokens(what, got, want):
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not np.array_equal(np.asarray(g), w)]
    if bad or len(got) != len(want):
        raise AssertionError(f"{what}: sequences {bad[:8]} differ from "
                             f"decode_sequential")


def chunk_replay_check(eng, want):
    """Two chunks of ``eng`` under the profiler, each one graph launch:
    the second must hold ``want`` K4 launches by the Chrome trace's
    correlation ids, and no K4 may run outside a graph launch.  The
    session's first graph launch is a warm-up left out of the count (as
    in 15b: in a whole run of this script on an H100 at 700 W it read 30
    of 32)."""
    from torch.profiler import ProfilerActivity, profile
    eng.step_chunk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _trace_settle()
        eng.step_chunk()
        eng.step_chunk()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    per, stray = _graph_k1_counts(events, kernel="lstm_gates_kernel")
    launches = [per[c] for c in sorted(per)]
    rec = {"replay": "decode chunk", "k4_per_graph_launch": launches,
           "k4_outside_graphs": stray}
    log(json.dumps(rec))
    if len(launches) != 2 or launches[-1] != want or stray:
        raise AssertionError(f"two chunk replays held K4 {launches} (the "
                             f"first a warm-up) and {stray} K4 launches "
                             f"outside them; want {want} in the second")
    return rec


def decode_arena(card, cfg=None, slots=GEN_SLOTS, chunk=GEN_CHUNK,
                 n_prompts=GEN_PROMPTS):
    """16a: the slot arena on K4.  Returns the engine, the fused cell, the
    prompts, budgets and oracle outputs, the record and the main path's
    launches (the continuous decode's)."""
    from mxnet_tpu_torch.generation import (DecodeCell, DecodeEngine,
                                            DecodeService)
    cfg = dict(cfg or PTB_LSTM)
    fused, unfused, order = lm_decode_cells(cfg, slots, "cuda")
    step_errs = _cell_step_err(fused, unfused, order, cfg, slots)
    if max(step_errs.values()) > LSTM_SLICE_TOL:
        raise AssertionError(f"the fused cell's step off the unfused one "
                             f"by {step_errs} > {LSTM_SLICE_TOL}")
    del unfused
    eng = DecodeEngine(fused, slots=slots, chunk_steps=chunk,
                       max_prompt=GEN_PROMPT, max_tokens=GEN_TOKENS)
    prompts, budgets = _gen_prompts(cfg["vocab"], n_prompts, SEED + 16)
    eng.decode(prompts[:2], [2, 2])           # builds both programs
    if eng.traces != 2:
        raise AssertionError(f"the engine built {eng.traces} programs "
                             "for its first decode, want 2")
    replay = chunk_replay_check(eng, cfg["num_layers"] * chunk)
    chunk_run = eng._programs["chunk"]
    chunk_ms = time_ms(chunk_run, iters=50)
    prof = profile_gluon("decode chunk", eng.step_chunk)
    oracle = eng.decode_sequential(prompts, budgets)
    # the main path: continuous decode through the scheduler, counted
    mt.profiler.reset_gen_counters()
    hk.reset_launch_counts()
    occupancy = []
    step = eng.step_chunk

    def counted_step():
        occupancy.append(eng.slots_active / eng.slots)
        return step()
    eng.step_chunk = counted_step
    with DecodeService(eng, continuous=True, queue_limit=n_prompts) as svc:
        cont, cont_s, ttft = _serve_decode(svc, prompts, budgets)
    eng.step_chunk = step
    launches = dict(hk.LAUNCHES)
    chunks = int(mt.profiler.gen_counters()["chunks"])
    if launches["lstm_gates"] != cfg["num_layers"] * chunk * chunks or \
            not chunks:
        raise AssertionError(f"{chunks} chunk replays launched K4 "
                             f"{launches['lstm_gates']} times, want "
                             f"{cfg['num_layers'] * chunk} each")
    _same_tokens("continuous decode", cont, oracle)
    with env(MXTPU_GEN_CONTINUOUS="0"):
        svc = DecodeService(eng, queue_limit=n_prompts)
    with svc:
        if svc.continuous:
            raise AssertionError("MXTPU_GEN_CONTINUOUS=0 left the "
                                 "service continuous")
        stat, stat_s, _ = _serve_decode(svc, prompts, budgets)
    _same_tokens("static decode", stat, oracle)
    # eos: a cell stopping on the third token the first prompt makes
    eos = int(oracle[0][2])
    eos_cell = DecodeCell(fused.step_fn, fused.params, fused.state_specs,
                          fused.vocab_size, eos_id=eos,
                          state_order=fused.state_order, ctx=fused.device)
    eos_eng = DecodeEngine(eos_cell, slots=slots, chunk_steps=chunk,
                           max_prompt=GEN_PROMPT, max_tokens=GEN_TOKENS)
    eos_out = eos_eng.decode(prompts[:slots], budgets[:slots])
    stopped = 0
    for got, want in zip(eos_out, oracle[:slots]):
        hit = np.flatnonzero(want == eos)
        cut = want[:hit[0] + 1] if len(hit) else want
        stopped += bool(len(hit)) and len(cut) < len(want)
        if not np.array_equal(got, cut):
            raise AssertionError("an eos run did not stop at its eos")
    del eos_eng
    if eng.traces != 2:
        raise AssertionError(f"admissions rebuilt the engine's programs: "
                             f"{eng.traces} built, want 2")
    tokens = sum(len(o) for o in oracle)
    rec = {"generation": "arena", "card": card, "slots": slots,
           "chunk_steps": chunk, "prompts": n_prompts, "tokens": tokens,
           "step_err_vs_unfused": step_errs, "replay": replay,
           "chunk_replay_ms": chunk_ms, "chunk_profile_idle_share":
           prof["idle_share"], "chunk_device_busy_ms":
           prof["device_busy_ms"], "chunk_wall_ms": prof["wall_ms"],
           "continuous_s": cont_s, "continuous_tokens_per_s":
           tokens / cont_s, "static_s": stat_s, "static_tokens_per_s":
           tokens / stat_s, "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "mean_occupancy": float(np.mean(occupancy)), "chunks": chunks,
           "eos_id": eos, "eos_stopped": int(stopped),
           "traces": eng.traces, "launches": launches}
    log(json.dumps(rec, default=float))
    return eng, fused, prompts, budgets, oracle, rec, launches


def decode_lane(card, eng, fused, prompts, budgets, oracle, pool, seq,
                vocab, tmpdir, n_requests=GEN_WIRE_REQUESTS,
                clients=SERVE_CLIENTS):
    """16b: the LM cell as a decode blob through the registry and back,
    then `ModelServer(pool, decode=DecodeService(engine))` with 4 client
    threads interleaving ``generate`` and ``infer``.  Returns the path of
    the decode blob, the record and the launches of the traffic."""
    import threading
    from mxnet_tpu_torch.generation import (DecodeEngine, DecodeService,
                                            load_decode_blob,
                                            save_decode_blob)
    from mxnet_tpu_torch.serving import ModelServer, ServeClient
    from mxnet_tpu_torch.serving_fleet import ModelRegistry
    path = os.path.join(tmpdir, "ptb_lm.mxdblob")
    save_decode_blob(path, fused)
    reg = ModelRegistry()
    crc = reg.register("lm-v1", path)
    back = DecodeEngine(load_decode_blob(reg.resolve("lm-v1")[0],
                                         ctx=mt.gpu(0)),
                        slots=eng.slots, chunk_steps=eng.chunk_steps,
                        max_prompt=eng.max_prompt,
                        max_tokens=eng.max_tokens)
    _same_tokens("the decode blob loaded back",
                 back.decode_sequential(prompts[:4], budgets[:4]),
                 oracle[:4])
    del back
    hk.reset_launch_counts()
    results, gens, failures = [], [], []
    lock = threading.Lock()
    with _recording() as seen:
        with env(MXTPU_SERVE_MAX_DELAY_MS=str(SERVE_DELAY_MS)):
            srv = ModelServer(pool, model_version="v1",
                              decode=DecodeService(eng, queue_limit=64))
        with srv:
            host, port = srv.serve()

            def client(k):
                rng = np.random.RandomState(SEED + 165 + k)
                with ServeClient(host, port, retry_deadline=30.0) as cli:
                    for j in range(k, n_requests, clients):
                        try:
                            if j % 2:
                                i = j % len(prompts)
                                got = cli.generate(prompts[i], budgets[i])
                                with lock:
                                    gens.append((i, got))
                            else:
                                feed = _serve_feed(int(rng.randint(1, 4)),
                                                   seq, vocab, rng)
                                out = cli.infer(feed)[0]
                                with lock:
                                    results.append((feed, out, 0.0))
                        except Exception as e:
                            with lock:
                                failures.append(repr(e))

            t0 = time.perf_counter()
            ts = [threading.Thread(target=client, args=(k,), daemon=True)
                  for k in range(clients)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            wall = time.perf_counter() - t0
            with ServeClient(host, port) as cli:
                stats = cli.stats()
    launches = dict(hk.LAUNCHES)
    if failures:
        raise AssertionError(f"{len(failures)} requests failed on the "
                             f"decode lane: {failures[:3]}")
    for i, got in gens:
        if not np.array_equal(got, oracle[i]):
            raise AssertionError(f"generate reply {i} off the oracle")
    checked = _check_replies(seen, results)
    if stats.get("gen_slots") != eng.slots or "gen_continuous" not in stats:
        raise AssertionError(f"stats lack the decode lane: {stats}")
    if not launches["lstm_gates"] or not launches["flash_attn_fwd"]:
        raise AssertionError(f"the mixed traffic launched {launches}")
    rec = {"generation": "wire", "card": card, "blob_crc": crc,
           "blob_bytes": os.path.getsize(path), "generate": len(gens),
           "infer": len(results), "wall_s": wall,
           "replies_checked_per_rung": checked, "launches": launches}
    log(json.dumps(rec))
    return path, rec, launches


def _gpu_memory_sampler():
    """A thread sampling the card's used memory (MiB, ``nvidia-smi``) every
    half second; ``stop()`` returns the peak."""
    import threading
    peak, done = [0], threading.Event()

    def run():
        while not done.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=10).stdout.split()
                peak[0] = max([peak[0]] + [int(v) for v in out[:1]])
            except (OSError, ValueError, subprocess.SubprocessError):
                pass
            done.wait(0.5)

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def stop():
        done.set()
        t.join(timeout=15)
        return peak[0]
    return stop


def _fleet_env():
    """The replicas' knobs: the ladder, the decode arena, the batcher's
    deadline."""
    return {"MXTPU_SERVE_BATCH_LADDER": ",".join(map(str, FLEET_LADDER)),
            "MXTPU_SERVE_MAX_DELAY_MS": str(SERVE_DELAY_MS),
            "MXTPU_GEN_SLOTS": str(GEN_SLOTS),
            "MXTPU_GEN_CHUNK_STEPS": str(GEN_CHUNK),
            "MXTPU_GEN_MAX_PROMPT": str(GEN_PROMPT),
            "MXTPU_GEN_MAX_TOKENS": str(GEN_TOKENS)}


def _fleet_traffic(addr, n_requests, clients, seq, vocab, seed,
                   until=None):
    """``clients`` threads sending 1-3-row requests through ``addr``
    (``n_requests`` in all, and on until ``until`` is set when given):
    ([(request, reply, ms)], lost, sheds, wall s).  A shed is the
    contract; any other failure is a lost request."""
    import threading
    from mxnet_tpu_torch.serving import ServeClient, ServerOverloadError
    results, lost, sheds = [], [], [0]
    lock = threading.Lock()

    def client(k):
        rng = np.random.RandomState(seed + k)
        sent = 0
        with ServeClient(*addr, retry_deadline=30.0, seed=seed + k) as cli:
            while sent < n_requests // clients or \
                    (until is not None and not until.is_set()):
                sent += 1
                feed = _serve_feed(int(rng.randint(1, 4)), seq, vocab, rng)
                t0 = time.perf_counter()
                try:
                    out = cli.infer(feed)[0]
                except ServerOverloadError:
                    with lock:
                        sheds[0] += 1
                    continue
                except Exception as e:
                    with lock:
                        lost.append(repr(e))
                    continue
                with lock:
                    results.append((feed, out,
                                    (time.perf_counter() - t0) * 1e3))

    ts = [threading.Thread(target=client, args=(k,), daemon=True)
          for k in range(clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    return ts, results, lost, sheds, t0


def _join_traffic(traffic):
    ts, results, lost, sheds, t0 = traffic
    for t in ts:
        t.join()
    return results, lost, sheds[0], time.perf_counter() - t0


def _near_pool(pool, results):
    """Each reply within RUNG_TOL of the parent's pool run of its rows;
    returns the worst relative error."""
    worst = 0.0
    for feed, out, _ms in results:
        want = pool.run(feed)[0]
        err = _row_rel_err(out, want)
        if out.shape != want.shape or err > RUNG_TOL:
            raise AssertionError(f"a reply through the fleet is {err} off "
                                 f"the parent's pool (> {RUNG_TOL})")
        worst = max(worst, err)
    return worst


def _traffic_rec(results, lost, sheds, wall):
    lat = np.array([ms for _f, _o, ms in results])
    rows = sum(len(f["data"]) for f, _o, _m in results)
    q = np.percentile(lat, [50, 99]) if len(lat) else [0.0, 0.0]
    return {"requests": len(results), "lost": len(lost), "sheds": sheds,
            "rows": rows, "wall_s": wall, "rows_per_s": rows / wall,
            "p50_ms": float(q[0]), "p99_ms": float(q[1])}


def _wait(cond, what, timeout=FLEET_WAIT_S):
    t_end = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def fleet_phase(card, art, gen_blob, prompts, budgets, oracle,
                replica_ctx=None, n=FLEET_REPLICAS):
    """16c: ``n`` replica processes on the one card behind a Router with
    a ReplicaSupervisor: parity with a direct replica and the parent's
    pool, clean traffic, a SIGKILL mid-traffic, rolling deploys (a good
    one, a canary refusal, a corrupt blob), a rollback, generate."""
    import signal
    import threading
    from mxnet_tpu_torch import fault_injection as fi
    from mxnet_tpu_torch.serving import ServeClient
    from mxnet_tpu_torch.serving_fleet import (CanaryMismatchError,
                                               ModelRegistry,
                                               ReplicaSupervisor, Router,
                                               spawn_replica_process)
    pool, seq, cfg = art["pool"], art["seq"], art["cfg"]
    vocab = cfg["vocab"]
    reg = ModelRegistry()
    for v in ("v1", "v2", "v3"):
        reg.register(v, art[v])
    reg.set_current("v1")
    startup = []

    def spawn(slot):
        path, _ = reg.resolve(reg.current)
        t0 = time.perf_counter()
        out = spawn_replica_process(path, version=reg.current,
                                    env=_fleet_env(), gen_blob=gen_blob,
                                    ctx=replica_ctx,
                                    ready_timeout=FLEET_READY_S)
        startup.append(time.perf_counter() - t0)
        return out

    pre, errs = {}, []

    def prestart(slot):
        try:
            pre[slot] = spawn(slot)
        except Exception as e:
            errs.append(e)
    ts = [threading.Thread(target=prestart, args=(s,)) for s in range(n)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    parallel_start = time.perf_counter() - t0
    sup = router = None
    trickle = threading.Event()
    try:
        if errs:
            raise errs[0]
        rng = np.random.RandomState(SEED + 166)
        canary = _serve_feed(4, seq, vocab, rng)
        router = Router([("127.0.0.1", 1)] * n, registry=reg, canary=canary,
                        start_health=False, breaker_failures=2,
                        breaker_cooldown_s=0.3, health_interval=0.1,
                        seed=SEED)
        sup = ReplicaSupervisor(
            lambda s: pre.pop(s) if s in pre else spawn(s), slots=n,
            router=router, backoff_base_s=0.1, backoff_max_s=0.5,
            crash_limit=10, seed=SEED)
        sup.start(monitor=True)
        router.health_cycle()
        router.start_health()
        addr = router.serve("127.0.0.1", 0)
        # parity: the router's reply against each replica's direct one
        x = _serve_feed(4, seq, vocab, rng)
        routed = router.infer(x)[0]
        for a in sup.addresses:
            with ServeClient(*a) as cli:
                if not np.array_equal(cli.infer(x)[0], routed):
                    raise AssertionError("a replica's direct reply is not "
                                         "bit-equal to the router's")
        parity_err = _row_rel_err(
            routed, pool._exec[0][4]([x[k] for k in pool.input_names],
                                     rows=4)[0])
        if parity_err > RUNG_TOL:
            raise AssertionError(f"the fleet's reply is {parity_err} off "
                                 f"the parent's pool at rung 4")
        clean = _join_traffic(_fleet_traffic(addr, FLEET_REQUESTS,
                                             FLEET_CLIENTS, seq, vocab,
                                             SEED + 167))
        if clean[1] or clean[2]:
            raise AssertionError(f"clean traffic lost {clean[1][:3]} "
                                 f"and shed {clean[2]}")
        worst = _near_pool(pool, clean[0])
        # a SIGKILL mid-traffic
        victim = {}

        def sigkill(_idx):
            proc = sup.procs[1]
            victim["pid"] = proc.pid
            victim["t"] = time.perf_counter()
            os.kill(proc.pid, signal.SIGKILL)
        plan = fi.install(fi.FaultPlan(kill_replica_at=(FLEET_KILL_AT,),
                                       on_kill_replica=sigkill))
        chaos = _join_traffic(_fleet_traffic(addr, FLEET_CHAOS_REQUESTS,
                                             FLEET_CLIENTS, seq, vocab,
                                             SEED + 168))
        fi.clear()
        if plan.summary()["replica_kills"] != 1 or not victim:
            raise AssertionError("the chaos kill never fired")
        if chaos[1]:
            raise AssertionError(f"the SIGKILL lost requests: "
                                 f"{chaos[1][:3]}")
        _near_pool(pool, chaos[0])
        rep1 = router.replicas[1]
        _wait(lambda: sup.procs[1].pid != victim["pid"]
              and rep1.pid == sup.procs[1].pid
              and rep1.breaker.state == "closed" and rep1.state == "active",
              "the killed replica's respawn and readmission")
        readmit_s = time.perf_counter() - victim["t"]
        counters = mt.profiler.router_counters()
        # deploys under a trickle of traffic
        bg = _fleet_traffic(addr, 0, 1, seq, vocab, SEED + 169,
                            until=trickle)
        t0 = time.perf_counter()
        router.deploy("v2")
        deploy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            router.deploy("v3")
        except CanaryMismatchError:
            pass
        else:
            raise AssertionError("the canary let v3 (other weights) in")
        refused_s = time.perf_counter() - t0
        if reg.current != "v2":
            raise AssertionError(f"after the refused v3 the registry names "
                                 f"{reg.current}")
        fi.install(fi.FaultPlan(corrupt_blob_on_deploy=(1,)))
        t0 = time.perf_counter()
        try:
            router.deploy("v1")
        except mt.MXNetError:
            pass
        else:
            raise AssertionError("a corrupt blob was deployed")
        finally:
            fi.clear()
        corrupt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = router.rollback()
        rollback_s = time.perf_counter() - t0
        trickle.set()
        bg = _join_traffic(bg)
        if bg[1] or back != "v1" or reg.current != "v1":
            raise AssertionError(f"deploys lost {bg[1][:3]} or rolled "
                                 f"back to {back}")
        router.health_cycle()
        versions = [r.version for r in router.replicas]
        if versions != ["v1"] * n:
            raise AssertionError(f"replicas serve {versions} after the "
                                 "rollback")
        for i in range(6):
            if not np.array_equal(router.generate(prompts[i], budgets[i]),
                                  oracle[i]):
                raise AssertionError(f"Router.generate {i} off the oracle")
        rec = {"fleet": "replicas", "card": card, "replicas": n,
               "ladder": list(FLEET_LADDER),
               "startup_to_ready_s": startup,
               "parallel_start_s": parallel_start,
               "router_vs_pool_rel_err": parity_err,
               "clean": _traffic_rec(*clean), "worst_vs_pool": worst,
               "chaos": _traffic_rec(*chaos),
               "killed_to_readmitted_s": readmit_s,
               "deploy_s": deploy_s, "canary_refused_s": refused_s,
               "corrupt_refused_s": corrupt_s, "rollback_s": rollback_s,
               "deploy_traffic": _traffic_rec(*bg),
               "router_counters": counters}
        log(json.dumps(rec, default=float))
        return rec
    finally:
        fi.clear()
        trickle.set()
        if sup is not None:
            sup.stop()
        if router is not None:
            router.close()
        for proc, _a in pre.values():
            proc.kill()


def autoscale_phase(card, art, replica_ctx=None):
    """16d: the autoscaler from a floor of 1 replica to at most 3 under a
    burst, a SIGKILL of the fresh replica before its warm-up, back to the
    floor after the idle window; no request lost but sheds."""
    import signal
    import threading
    from mxnet_tpu_torch import fault_injection as fi
    from mxnet_tpu_torch.autoscale import Autoscaler
    from mxnet_tpu_torch.serving import ServeClient
    from mxnet_tpu_torch.serving_fleet import (ReplicaSupervisor, Router,
                                               spawn_replica_process)
    seq, vocab = art["seq"], art["cfg"]["vocab"]
    spawned = []

    def spawn(slot):
        t0 = time.perf_counter()
        out = spawn_replica_process(art["v1"], version="v1",
                                    env=_fleet_env(), ctx=replica_ctx,
                                    ready_timeout=FLEET_READY_S)
        spawned.append((slot, t0, time.perf_counter()))
        return out

    mt.profiler.reset_autoscale_counters()
    mt.profiler.reset_router_counters()
    router = Router([("127.0.0.1", 1)], start_health=False,
                    breaker_failures=2, breaker_cooldown_s=0.3,
                    health_interval=0.1, seed=SEED)
    sup = ReplicaSupervisor(spawn, slots=1, router=router,
                            backoff_base_s=0.1, backoff_max_s=0.5,
                            crash_limit=10, seed=SEED)
    events, burst_stop, base_stop = {}, threading.Event(), threading.Event()
    traffic = []
    scaler = None

    def spike(_n):
        events["spike_t"] = time.perf_counter()
        traffic.append(_fleet_traffic(events["addr"], 0, SCALE_BURST, seq,
                                      vocab, SEED + 170, until=burst_stop))

    def kill_fresh(_n):
        rep = router.replicas[-1]
        events["fresh_state"] = rep.state
        with ServeClient(*rep.addr, retry_deadline=5.0) as cli:
            events["fresh_requests"] = cli.stats().get("requests", 0)
        events["killed"] = (len(router.replicas) - 1, sup.procs[-1].pid,
                            time.perf_counter())
        os.kill(sup.procs[-1].pid, signal.SIGKILL)

    plan = fi.install(fi.FaultPlan(
        traffic_spike_at=(SCALE_SPIKE_AT,), on_traffic_spike=spike,
        kill_replica_during_scale=(1,),
        on_kill_replica_during_scale=kill_fresh))
    try:
        sup.start(monitor=True)
        router.health_cycle()
        router.start_health()
        events["addr"] = router.serve("127.0.0.1", 0)
        base = _fleet_traffic(events["addr"], 0, 1, seq, vocab,
                              SEED + 171, until=base_stop)
        scaler = Autoscaler(router, sup, seed=SEED, **SCALE)
        scaler.start()
        ac = mt.profiler.autoscale_counters
        _wait(lambda: ac().get("scale_ups", 0) >= 1
              and ac().get("warmups", 0) >= 1 and "killed" in events
              and mt.profiler.router_counters().get(
                  "replica_restarts", 0) >= 1,
              "the scale-up, the fresh replica's respawn and warm-up",
              timeout=3 * FLEET_READY_S)
        slot = events["killed"][0]
        _wait(lambda: router.replicas[slot].state == "active",
              "the respawned replica's admission")
        admitted_t = time.perf_counter()
        grown = sum(1 for r in router.replicas if r.state == "active")
        burst_stop.set()
        burst = _join_traffic(traffic[0]) if traffic else ([], [], 0, 0.0)
        _wait(lambda: sum(1 for r in router.replicas
                          if r.state == "active") == SCALE["min_replicas"]
              and ac().get("scale_downs", 0) >= 1
              and not any(r.state == "warming" for r in router.replicas)
              and not router.brownout,
              "the fleet's return to its floor", timeout=3 * FLEET_READY_S)
        floor_t = time.perf_counter()
        base_stop.set()
        base = _join_traffic(base)
        scaler.stop()
        lost = burst[1] + base[1]
        if lost:
            raise AssertionError(f"the autoscale run lost {lost[:3]}")
        # the health thread may probe the fresh replica before the kill:
        # then it was admitted already, and only a warming one must be
        # untouched
        if events.get("fresh_state") == "warming" and \
                events.get("fresh_requests") != 0:
            raise AssertionError(f"the fresh replica took traffic before "
                                 f"its warm-up: {events}")
        _near_pool(art["pool"], burst[0][:50] + base[0][:10])
        starts = [t for s, t, _ in spawned if s == slot]
        counters = ac()
        rec = {"fleet": "autoscale", "card": card, **SCALE,
               "burst_clients": SCALE_BURST, "grown_to": grown,
               "spawn_to_ready_s": [e - s for _, s, e in spawned],
               "scale_up_spawn_to_admitted_s": admitted_t - starts[0],
               "respawn_to_admitted_s": admitted_t - starts[-1],
               "spike_to_floor_s": floor_t - events["spike_t"],
               "burst": _traffic_rec(*burst), "base": _traffic_rec(*base),
               "fresh_state_at_kill": events.get("fresh_state"),
               "fresh_requests_at_kill": events.get("fresh_requests"),
               "autoscale_counters": counters,
               "plan": plan.summary(),
               "router_counters": mt.profiler.router_counters()}
        log(json.dumps(rec, default=float))
        return rec
    finally:
        fi.clear()
        burst_stop.set()
        base_stop.set()
        if scaler is not None:
            scaler.stop()
        sup.stop()
        router.close()


def _other_weights_blob(art):
    """Phase 15's model with other seeded weights, exported beside its
    blobs: the version the canary must refuse."""
    sym, shapes = art["sym"], art["shapes"]
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED + 163)
    blob = dumps_ndarrays({"arg:" + n: NDArray(torch.from_numpy(a))
                           for n, a in params.items()})
    del params
    with pallas_mode("auto"):
        pred = mt.Predictor(sym.tojson(), blob, shapes)
    path = os.path.join(art["tmpdir"], "bert_v3.blob")
    pred.export_compiled(path, dynamic_batch=True)
    return path


def phase_generation(card, art, cfg=None, replica_ctx=None):
    """Phase 16 on phase 15's artifacts (``art``, whose directory it
    removes).  Returns the launches of its main paths (16a's continuous
    decode and 16b's mixed traffic)."""
    import gc
    t_phase = time.perf_counter()
    # the earlier phases' cached blocks go back to the card: the replica
    # processes allocate beside this one
    gc.collect()
    torch.cuda.empty_cache()
    stop_sampler = _gpu_memory_sampler()
    try:
        eng, fused, prompts, budgets, oracle, arena, a_launch = \
            decode_arena(card, cfg)
        gen_blob, wire, b_launch = decode_lane(
            card, eng, fused, prompts, budgets, oracle, art["pool"],
            art["seq"], art["cfg"]["vocab"], art["tmpdir"])
        art["v3"] = _other_weights_blob(art)
        fleet = fleet_phase(card, art, gen_blob, prompts, budgets, oracle,
                            replica_ctx=replica_ctx)
        scale = autoscale_phase(card, art, replica_ctx=replica_ctx)
    finally:
        peak = stop_sampler()
        shutil.rmtree(art["tmpdir"], ignore_errors=True)
    launches = {k: a_launch[k] + b_launch[k] for k in a_launch}
    if launches["flash_attn_bwd_dq"] or launches["flash_attn_bwd_dkv"]:
        raise AssertionError(f"phase 16 launched {launches}")
    rec = {"phase": "generation", "card": card,
           "arena": {k: arena[k] for k in (
               "chunk_replay_ms", "continuous_tokens_per_s",
               "static_tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
               "mean_occupancy", "chunk_profile_idle_share")},
           "wire_s": wire["wall_s"],
           "fleet_rows_per_s": fleet["clean"]["rows_per_s"],
           "fleet_p50_ms": fleet["clean"]["p50_ms"],
           "fleet_p99_ms": fleet["clean"]["p99_ms"],
           "scale_up_spawn_to_admitted_s":
           scale["scale_up_spawn_to_admitted_s"],
           "gpu_memory_peak_mib": peak, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec, default=float))
    log(f"generation: phase 16 in {rec['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 17: several contexts in one process
# ---------------------------------------------------------------------------

def _context_mlm(sym, ctx, params, batch, seq):
    """Phase 5's `Module` over ``ctx`` (a context or a list), bound for
    training and initialized from ``params``, with BERT's Adam."""
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=ctx)
    mod.bind([("data", (batch, seq)), ("positions", (1, seq))],
             [("mlm_label", (batch, seq))])
    mod.init_params(arg_params=params)
    mod.init_optimizer(optimizer="adam", optimizer_params=ADAM)
    return mod


def contexts_fold(cfg, params, batch, seq, steps=CTX_FOLD_STEPS):
    """17a: `Module(context=[gpu(0), gpu(0)])` folds onto gpu(0) and trains
    bit-equal to `Module(context=gpu(0))`: the same ``steps`` steps of
    phase 5's model (dropout 0.1, BERT's Adam) on the same batch, the
    device generator seeded alike before each run.  Returns the folded
    module's launches and the step ms (the steps after the first)."""
    import logging
    data = _mlm_batch(cfg["vocab"], batch, seq)
    sym = bert_mlm(mt.sym, **cfg)
    runs = []
    for ctx in ([mt.gpu(0), mt.gpu(0)], mt.gpu(0)):
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logging.getLogger().addHandler(handler)
        try:
            mod = _context_mlm(sym, ctx, params, batch, seq)
        finally:
            logging.getLogger().removeHandler(handler)
        mt.random.seed(SEED)
        hk.reset_launch_counts()
        for i in range(steps):
            if i == 1:      # the steps after the first, which builds
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            mod.forward(data, is_train=True)
            mod.backward()
            mod.update()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        launches = dict(hk.LAUNCHES)
        _check_launches(f"17a {ctx}", launches, cfg["num_layers"] * steps)
        arg, _ = mod.get_params()
        runs.append((launches, ms, {k: v.data for k, v in arg.items()},
                     [r.getMessage() for r in records]))
        del mod
        torch.cuda.empty_cache()
    (launches, ms, folded, warned), (_, ms1, single, _) = runs
    if not any("duplicate devices" in w for w in warned):
        raise AssertionError(f"17a: no fold warning in {warned}")
    unequal = [k for k in single if not torch.equal(folded[k], single[k])]
    if unequal:
        raise AssertionError(f"17a: {len(unequal)} parameters differ after "
                             f"{steps} steps, e.g. {unequal[:3]}")
    log(f"contexts: 17a the fold {warned[0]!r}; {len(single)} parameters "
        f"bit-equal after {steps} steps; step {ms:.2f} ms folded, "
        f"{ms1:.2f} ms one context")
    return launches, {"folded_step_ms": ms, "single_step_ms": ms1,
                      "bit_equal_params": len(single)}


def _manager_batch(vocab, batch, seq):
    """One batch with one row of positions per sample, with the
    descriptions `DataParallelExecutorManager` slices by."""
    rng = np.random.RandomState(SEED + 17)
    data = rng.randint(0, vocab, (batch, seq)).astype(np.float32)
    label = np.where(rng.rand(batch, seq) < 0.15, data, -1.0) \
        .astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.float32), (batch, 1))
    dev = mt.gpu(0)
    return mt.io.DataBatch(
        [mt.nd.array(data, ctx=dev), mt.nd.array(pos, ctx=dev)],
        [mt.nd.array(label, ctx=dev)],
        provide_data=[mt.io.DataDesc("data", (batch, seq)),
                      mt.io.DataDesc("positions", (batch, seq))],
        provide_label=[mt.io.DataDesc("mlm_label", (batch, seq))])


def _summed_head(cfg):
    """Phase 5's graph with the loss head's gradient summed over the
    masked positions (``normalization='null'``) and dropout off, so the
    slices' gradients add up to the whole batch's."""
    internals = bert_mlm(mt.sym, **dict(cfg, dropout=0.0)).get_internals()
    return mt.sym.SoftmaxOutput(internals["mlm_flat_output"],
                                internals["mlm_label_flat_output"],
                                use_ignore=True, ignore_label=-1,
                                normalization="null", name="mlm")


def _manager(sym, ctxs, batch, params, work_load_list=None):
    from mxnet_tpu_torch.executor_manager import DataParallelExecutorManager
    mgr = DataParallelExecutorManager(sym, ctxs, batch,
                                      work_load_list=work_load_list)
    mgr.set_params(params, {})
    mgr.load_data_batch(batch)
    return mgr


def _event_ms(fn, n=CTX_TIMED):
    """CUDA-event ms of ``fn`` (one warm call first), the mean of ``n``."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def contexts_manager(card, cfg, params, batch, seq):
    """17b: two executors on the one card, `DataParallelExecutorManager`
    over [gpu(0), gpu(0)] with work_load_list [1, 3]: one forward/backward
    whose summed gradients must lie within TRAIN_GRAD_TOL of each gradient's
    largest magnitude of one executor's over the whole batch; K1-K3 launch
    once per layer in each executor.  Returns the launches and the step
    times (each executor's and the manager's)."""
    sym = _summed_head(cfg)
    data = _manager_batch(cfg["vocab"], batch, seq)
    nd_params = {k: mt.nd.array(v, ctx=mt.gpu(0)) for k, v in params.items()}
    mgr = _manager(sym, [mt.gpu(0), mt.gpu(0)], data, nd_params, [1, 3])
    sizes = [s.stop - s.start for s in mgr.slices]
    execs = mgr.curr_execgrp.train_execs
    if sizes != [2, 6] or execs[0].arg_dict["mlm_transform_weight"] is \
            execs[1].arg_dict["mlm_transform_weight"]:
        raise AssertionError(f"17b: slices {sizes}, shared buffers")
    hk.reset_launch_counts()
    mgr.forward(is_train=True)
    mgr.backward()
    torch.cuda.synchronize()
    launches = dict(hk.LAUNCHES)
    _check_launches("17b two executors", launches, 2 * cfg["num_layers"])
    summed = {n: sum(g.data.double() for g in gl)
              for n, gl in zip(mgr.param_names, mgr.grad_arrays)}
    one = _manager(sym, [mt.gpu(0)], data, nd_params)
    one.forward(is_train=True)
    one.backward()
    wants = {n: gl[0].data.double()
             for n, gl in zip(one.param_names, one.grad_arrays)}
    scale = max(float(w.abs().max()) for w in wants.values())
    worst, key_bias = (None, 0.0), 0.0
    for name, want in wants.items():
        diff = float((summed[name] - want).abs().max())
        if name.endswith("_key_bias"):
            # zero in exact arithmetic, as in phase 5: held against the
            # largest gradient of all
            key_bias = max(key_bias, diff / scale)
            continue
        err = diff / max(float(want.abs().max()), 1e-30)
        if err > worst[1]:
            worst = (name, err)
    log(f"contexts: 17b worst summed gradient {worst[0]} {worst[1]:.3e} "
        f"of its largest magnitude; key biases {key_bias:.3e} of the "
        "largest gradient")
    if worst[1] > TRAIN_GRAD_TOL or key_bias > KEY_BIAS_TOL:
        raise AssertionError(f"17b: gradient of {worst[0]} off by "
                             f"{worst[1]}, key biases by {key_bias}")

    def step(texec):
        def run():
            texec.compiled_forward(is_train=True)
            texec.compiled_backward()
        return run

    def both():
        mgr.forward(is_train=True)
        mgr.backward()
    rec = {"executor_ms": [_event_ms(step(e)) for e in execs],
           "manager_ms": _event_ms(both),
           "one_executor_ms": _event_ms(step(one.curr_execgrp
                                             .train_execs[0])),
           "slices": sizes, "worst_grad": worst,
           "key_bias_of_largest": key_bias, "card": card}
    log(json.dumps({"contexts_17b": rec}))
    del mgr, one, execs
    torch.cuda.empty_cache()
    return launches, rec


def _mnist_mlp(ctxs, weights):
    """MXNet's Gluon MNIST MLP (example/gluon/mnist: Dense 128 relu,
    Dense 64 relu, Dense 10) with ``weights`` on every context of
    ``ctxs``."""
    net = mt.gluon.nn.Sequential()
    net.add(mt.gluon.nn.Dense(128, activation="relu", in_units=784),
            mt.gluon.nn.Dense(64, activation="relu", in_units=128),
            mt.gluon.nn.Dense(10, in_units=64))
    net.initialize(ctx=ctxs)
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(w)
    return net


def contexts_replicas(card, steps=CTX_MLP_STEPS, batch=CTX_MLP_BATCH):
    """17c: the MLP's replicas on [gpu(0), cpu(0)], each fed its half of
    the batch by `split_and_load`, `Trainer(kvstore='device')` (SGD, lr
    0.1, momentum 0.9): after ``steps`` steps every parameter within
    CTX_TOL of one context's on the whole batch, of its largest magnitude,
    and the two replicas within CTX_TOL of each other."""
    rng = np.random.RandomState(SEED + 170)
    shapes = [p.shape for p in
              _mnist_mlp([mt.cpu(0)], []).collect_params().values()]
    weights = [(rng.randn(*s) / np.sqrt(s[-1])).astype(np.float32)
               for s in shapes]
    xs = rng.rand(steps, batch, 784).astype(np.float32)
    ys = rng.randint(0, 10, (steps, batch)).astype(np.float32)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    out = {}
    for what, ctxs in (("replicas", [mt.gpu(0), mt.cpu(0)]),
                       ("one", [mt.gpu(0)])):
        net = _mnist_mlp(ctxs, weights)
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd", sgd,
                                   kvstore="device")
        t0 = time.perf_counter()
        for i in range(steps):
            parts = zip(mt.gluon.utils.split_and_load(xs[i], ctxs),
                        mt.gluon.utils.split_and_load(ys[i], ctxs))
            with mt.autograd.record():
                losses = [loss_fn(net(x), y) for x, y in parts]
            for loss in losses:
                loss.backward()
            trainer.step(batch)
        wall = (time.perf_counter() - t0) * 1e3 / steps
        if what == "replicas" and trainer._kvstore is None:
            raise AssertionError("17c: the trainer made no store")
        out[what] = ([[d.data.detach().cpu() for d in p.list_data()]
                      for p in net.collect_params().values()], wall)
    worst_one = worst_pair = 0.0
    for (gpu_w, cpu_w), (want,) in zip(out["replicas"][0], out["one"][0]):
        scale = max(float(want.abs().max()), 1e-30)
        worst_one = max(worst_one, float((gpu_w - want).abs().max()) / scale)
        worst_pair = max(worst_pair,
                         float((gpu_w - cpu_w).abs().max()) / scale)
    rec = {"steps": steps, "batch": batch,
           "replicas_vs_one_context": worst_one,
           "gpu_vs_cpu_replica": worst_pair,
           "step_ms_replicas": out["replicas"][1],
           "step_ms_one": out["one"][1], "card": card}
    log(json.dumps({"contexts_17c": rec}))
    if worst_one > CTX_TOL or worst_pair > CTX_TOL:
        raise AssertionError(f"17c: {rec}")
    return rec


def mf_symbol(num_users, num_items, factor, hidden):
    """MXNet's example/model-parallel/matrix_factorization, as
    example/model_parallel/train_matrix_factorization.py builds it: the
    embeddings in ctx_group "embed", the dense head in "dense"."""
    user, item, score = (mt.sym.var(n) for n in ("user", "item", "score"))
    with mt.AttrScope(ctx_group="embed"):
        u = mt.sym.Embedding(user, input_dim=num_users, output_dim=factor,
                             name="user_embed")
        v = mt.sym.Embedding(item, input_dim=num_items, output_dim=factor,
                             name="item_embed")
    with mt.AttrScope(ctx_group="dense"):
        u = mt.sym.FullyConnected(u, num_hidden=hidden, name="user_fc")
        v = mt.sym.FullyConnected(v, num_hidden=hidden, name="item_fc")
        pred = mt.sym.sum(u * v, axis=1)
        return mt.sym.LinearRegressionOutput(pred, score)


def contexts_model_parallel(card, mf=MF, steps=CTX_MF_STEPS):
    """17d: the matrix factorization with its embedding tables on cpu(0)
    and its dense head on gpu(0) (`Module(group2ctxs=...)`), trained
    ``steps`` steps (Adam, the example's lr) beside the same module on
    gpu(0) alone: every gradient of every step within CTX_TOL of its
    largest magnitude, each group's arrays and gradients on its group's
    device."""
    rng = np.random.RandomState(SEED + 171)
    U = (rng.randn(mf["users"], mf["factor"]) * 0.5).astype(np.float32)
    V = (rng.randn(mf["items"], mf["factor"]) * 0.5).astype(np.float32)
    users = rng.randint(0, mf["users"], (steps, mf["batch"]))
    items = rng.randint(0, mf["items"], (steps, mf["batch"]))
    scores = (U[users] * V[items]).sum(-1).astype(np.float32)
    sym = mf_symbol(mf["users"], mf["items"], mf["factor"], mf["hidden"])
    shapes = {"user": (mf["batch"],), "item": (mf["batch"],),
              "score": (mf["batch"],)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED + 172)
    mods = []
    for kw in ({"group2ctxs": {"embed": mt.cpu(0), "dense": mt.gpu(0)}},
               {}):
        mod = mt.mod.Module(sym, data_names=("user", "item"),
                            label_names=("score",), context=mt.gpu(0), **kw)
        mod.bind([("user", shapes["user"]), ("item", shapes["item"])],
                 [("score", shapes["score"])])
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.gpu(0))
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": mf["lr"]})
        mods.append(mod)
    placed, single = mods
    embed, dense = mt.cpu(0), mt.gpu(0)
    want = {"user_embed_weight": embed, "item_embed_weight": embed,
            "user": embed, "item": embed, "user_fc_weight": dense,
            "item_fc_weight": dense, "score": dense}
    for name, ctx in want.items():
        for arr in (placed._exec.arg_dict[name],
                    placed._exec.grad_dict.get(name)):
            if arr is not None and (arr.data.device != ctx.device
                                    or arr.context != ctx):
                raise AssertionError(f"17d: {name} in {arr.context} on "
                                     f"{arr.data.device}, want {ctx}")
    worst, times = (None, 0.0), {"placed": 0.0, "single": 0.0}
    for i in range(steps):
        grads = []
        for what, mod in (("placed", placed), ("single", single)):
            batch = mt.io.DataBatch(
                [mt.nd.array(users[i], ctx=mt.gpu(0)),
                 mt.nd.array(items[i], ctx=mt.gpu(0))],
                [mt.nd.array(scores[i], ctx=mt.gpu(0))])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward(batch, is_train=True)
            mod.backward()
            torch.cuda.synchronize()
            times[what] += (time.perf_counter() - t0) * 1e3 / steps
            grads.append({k: g.data.to(dense.device, torch.float64)
                          for k, g in mod._exec.grad_dict.items()})
            mod.update()
        for name, want in grads[1].items():
            err = float((grads[0][name] - want).abs().max()) / \
                max(float(want.abs().max()), 1e-30)
            if err > worst[1]:
                worst = (f"{name}@{i}", err)
    rec = {"users": mf["users"], "items": mf["items"],
           "factor": mf["factor"], "batch": mf["batch"], "steps": steps,
           "worst_grad": worst,
           "fwd_bwd_ms_placed": times["placed"],
           "fwd_bwd_ms_gpu_only": times["single"],
           "tables_mb": (mf["users"] + mf["items"]) * mf["factor"] * 4 / 1e6,
           "card": card}
    log(json.dumps({"contexts_17d": rec}))
    if worst[1] > CTX_TOL:
        raise AssertionError(f"17d: gradient {worst[0]} off by {worst[1]}")
    return rec


def phase_contexts(card, cfg=None, batch=8, seq=512):
    """Phase 17: several contexts in one process (17a-17d).  Returns the
    launches of its main paths (17a's folded module and 17b's two
    executors)."""
    t_phase = time.perf_counter()
    cfg = dict(BERT_BASE if cfg is None else cfg)
    shapes = {"data": (batch, seq), "positions": (1, seq),
              "mlm_label": (batch, seq)}
    sym = bert_mlm(mt.sym, **cfg)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    a_launch, fold = contexts_fold(cfg, params, batch, seq)
    b_launch, two = contexts_manager(card, cfg, params, batch, seq)
    del params
    replicas = contexts_replicas(card)
    mp = contexts_model_parallel(card)
    if torch.cuda.device_count() == 1:
        log("contexts: the split of one module's batch across distinct "
            "cards skipped (count == 1)")
    launches = {k: a_launch[k] + b_launch[k] for k in a_launch}
    rec = {"phase": "contexts", "card": card, "fold": fold,
           "executor_ms": two["executor_ms"], "manager_ms": two["manager_ms"],
           "replicas": replicas["replicas_vs_one_context"],
           "model_parallel_worst_grad": mp["worst_grad"],
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec, default=float))
    log(f"contexts: phase 17 in {rec['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the parameter-server plane across processes
# ---------------------------------------------------------------------------

def _free_port_pair():
    """A port whose successor is free too: the group's store binds the
    first, the parameter server the second (`ps_server.ps_port`)."""
    import socket
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s2 = socket.socket()
        try:
            s2.bind(("127.0.0.1", port + 1))
        except OSError:
            s.close()
            continue
        s.close()
        s2.close()
        return port


def _child_env(**extra):
    """The environment of phase 18's processes: the checkout on the path,
    no launcher or hook variables of this process, ``extra`` on top."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "BYTEPS_", "MXTPU_PS_"))}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run_job(what, cmd, env, timeout=DIST_TIMEOUT):
    """Run ``cmd`` in a session of its own; on its time limit, kill the
    whole session (the launcher's workers and server too).  Its output,
    or an error with the output's tail."""
    import signal
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{what}: no end within {timeout} s:\n"
                             f"{out[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}:\n"
                             f"{out[-6000:]}")
    log(f"{what}: {time.perf_counter() - t0:.1f} s")
    return out


def _worker_records(what, out, workdir, mode, n):
    """The records the ``mode`` processes wrote to ``workdir``, by rank;
    ``n`` of them."""
    recs = []
    for rank in range(n):
        path = os.path.join(workdir, f"{mode}-{rank}.json")
        if not os.path.exists(path):
            raise AssertionError(f"{what}: rank {rank} wrote no record:\n"
                                 f"{out[-4000:]}")
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _dist_launches(what, recs, per_process, cuda):
    """Sum the processes' K1-K3 counts; on the card each process must
    have launched each one ``per_process`` times."""
    total = dict.fromkeys(ATTN_KERNELS, 0)
    for rec in recs:
        for k in ATTN_KERNELS:
            n = rec["launches"][k]
            if cuda and n != per_process:
                raise AssertionError(f"{what}: rank {rec['rank']} launched "
                                     f"{k} {n} times, want {per_process}")
            total[k] += n
    return total


def _params_vs_reference(workdir):
    """Every parameter of the dist_sync run against one process on the
    whole batch: max |diff| over the reference's largest magnitude."""
    ref = np.load(os.path.join(workdir, "reference.npz"))
    got = np.load(os.path.join(workdir, "sync.npz"))
    if sorted(ref.files) != sorted(got.files):
        raise AssertionError("18a: parameter sets differ")
    worst = {}
    for k in ref.files:
        a, b = ref[k], got[k]
        if not np.isfinite(b).all():
            raise AssertionError(f"18a: {k} is not finite")
        worst[k] = float(np.abs(a - b).max() /
                         max(float(np.abs(a).max()), 1e-30))
    return sorted(worst.items(), key=lambda kv: -kv[1])


def dist_bert(card, cfg, batch, seq, steps, async_steps, ctx):
    """18a and 18b: BERT-base MLM by worker processes of
    `tests/torch_bert_dist_worker.py` on the one card, over ``dist_sync``
    (a gloo group) and through the async server (``tools/launch.py -s 1``
    with ``BYTEPS_ENABLE_ASYNC=1``)."""
    cuda = ctx == "gpu"
    per_step = cfg["num_layers"]
    workdir = tempfile.mkdtemp(prefix="mxtpu_dist_")
    common = [workdir, "--cfg", json.dumps(cfg), "--batch", str(batch),
              "--seq", str(seq), "--steps", str(steps), "--async-steps",
              str(async_steps), "--ctx", ctx]
    worker = [sys.executable, "-u", DIST_WORKER]
    launch = [sys.executable, DIST_LAUNCH, "--launcher", "local", "-n", "2"]
    try:
        # 18a: one process on the whole batch, then two over dist_sync
        out = _run_job("18a reference", worker + ["reference"] + common,
                       _child_env())
        ref = _worker_records("18a reference", out, workdir, "reference",
                              1)
        out = _run_job("18a dist_sync", launch + ["--"] + worker +
                       ["sync"] + common,
                       _child_env(DMLC_PS_ROOT_PORT=_free_port_pair()))
        sync = _worker_records("18a dist_sync", out, workdir, "sync", 2)
        if sync[0]["digests"] != sync[1]["digests"]:
            raise AssertionError("18a: the workers' parameters differ "
                                 f"({sync[0]['digests']} vs "
                                 f"{sync[1]['digests']})")
        ranked = _params_vs_reference(workdir)
        log(f"18a: two workers bit-equal after each of {steps} steps; "
            f"worst parameters against one process on the whole batch "
            f"{[(n, f'{e:.3e}') for n, e in ranked[:4]]}")
        if ranked[0][1] > TRAIN_GRAD_TOL:
            raise AssertionError(f"18a: {ranked[0][0]} off by "
                                 f"{ranked[0][1]} relative")
        launches = _dist_launches("18a reference", ref, per_step * steps,
                                  cuda)
        for k, v in _dist_launches("18a dist_sync", sync, per_step * steps,
                                   cuda).items():
            launches[k] += v
        # 18b: the fork's async server, with and without its optimizer
        out = _run_job("18b async server", launch + ["-s", "1", "--"] +
                       worker + ["async"] + common,
                       _child_env(DMLC_PS_ROOT_PORT=_free_port_pair(),
                                  BYTEPS_ENABLE_ASYNC=1))
        asyn = _worker_records("18b async server", out, workdir, "async",
                               2)
        server = asyn[0]["server"]
        if server["dead_workers"] or server["sync_mode"]:
            raise AssertionError(f"18b: server {server}")
        for k, v in _dist_launches("18b async server", asyn,
                                   per_step * (steps + async_steps),
                                   cuda).items():
            launches[k] += v
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec = {"sub": "18ab_dist_bert", "card": card, "batch": batch,
           "seq": seq, "layers": cfg["num_layers"], "steps": steps,
           "reference_step_ms": ref[0]["step_ms"],
           "sync_step_ms": [r["step_ms"] for r in sync],
           "sync_comm_ms": [r["comm_ms"] for r in sync],
           "sync_comm_share": [r["comm_share"] for r in sync],
           "sync_comm": sync[0]["comm"],
           "sync_worst_param": ranked[0],
           "async_part1_push_ms": [r["part1_push_ms"] for r in asyn],
           "async_part1_worst_over_bound": [r["part1_worst_over_bound"]
                                            for r in asyn],
           "async_step_ms": [r["step_ms"] for r in asyn],
           "async_comm_share": [r["comm_share"] for r in asyn],
           "async_losses": [r["losses"] for r in asyn],
           "async_comm": asyn[0]["comm"], "server": server,
           "launches": launches}
    log(json.dumps(rec, default=float))
    return launches, rec


def embed_plane_linear(card, dim=AVAZU["dim"], batch=AVAZU["batch"],
                       steps=EMBED_STEPS, nnz=AVAZU["nnz"], lr=AVAZU["lr"],
                       device="cuda"):
    """18c: 11a's sparse linear classification with its weight as a
    ``(dim, 1)`` table of the embedding plane, row-sharded over two
    in-process server shards in sync mode (sparse SGD on the shards), one
    worker on the card, against 11a's local-store path (the updater on
    push, ``row_sparse_pull``) on the same batches."""
    from mxnet_tpu_torch import ps_server, profiler
    from mxnet_tpu_torch.embedding_plane import EmbeddingPlane
    from mxnet_tpu_torch.ndarray import sparse as msp
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    dev = ctx.device
    data = _avazu_batches(dim, batch, steps, nnz, SEED + 11)
    xs = [msp.csr_matrix((v, i, p), shape=(batch, dim), ctx=ctx)
          for p, i, v, _ in data]
    eps = 1e-7

    def probs(z, yb):
        with np.errstate(over="ignore"):
            p = 1.0 / (1.0 + np.exp(-z))
        loss = float(-(yb * np.log(p + eps) +
                       (1 - yb) * np.log(1 - p + eps)).mean())
        return p, loss

    # the local store (11a's loop)
    kv = mt.kv.create("local")
    kv.init("w", mt.nd.zeros((dim, 1), ctx=ctx))
    kv.set_optimizer(mt.optimizer.SGD(learning_rate=lr))
    weight = mt.nd.zeros((dim, 1), ctx=ctx)
    bias, local_ms, local_losses = np.zeros((1,), np.float32), [], []
    for k in range(steps):
        _sync(weight.data)
        t0 = time.perf_counter()
        yb = data[k][3]
        p, loss = probs(msp.dot(xs[k], weight).asnumpy() + bias, yb)
        gz = mt.nd.array((p - yb) / batch, ctx=ctx)
        grad = msp.dot(xs[k], gz, transpose_a=True).tostype("row_sparse")
        kv.push("w", grad)
        kv.pull("w", out=weight)
        bias -= lr * float((p - yb).mean())
        _sync(weight.data)
        local_ms.append((time.perf_counter() - t0) * 1e3)
        local_losses.append(loss)

    # the plane: two shards, sync mode, sparse SGD on the shards
    hook = os.environ.pop("BYTEPS_ENABLE_ASYNC", None)
    srvs = [ps_server.KVStoreServer(num_workers=1).start()
            for _ in range(2)]
    if hook is not None:
        os.environ["BYTEPS_ENABLE_ASYNC"] = hook
    plane = EmbeddingPlane.connect([("127.0.0.1", s.port) for s in srvs],
                                   worker_id="w0", heartbeat=False)
    try:
        tbl = plane.table("w", dim, 1, init="zeros",
                          optimizer={"kind": "sgd", "lr": lr}, ctx=ctx)
        profiler.reset_embed_counters()
        bias, ms, losses, pulled, wanted = \
            np.zeros((1,), np.float32), [], [], [], []
        counts = torch.full((batch,), nnz, dtype=torch.long, device=dev)
        for k in range(steps):
            ids = data[k][1].reshape(batch, nnz)
            yb = data[k][3]
            before = profiler.embed_counters().get("pull_bytes", 0)
            _sync(counts)
            t0 = time.perf_counter()
            lk = tbl.lookup(pending=tbl.prefetch(ids))
            # each row's 15 weights summed in column order, as the CSR
            # product sums them
            z = msp._segment_sum(lk.value.data.reshape(-1, 1), counts)
            p, loss = probs(z.cpu().numpy() + bias, yb)
            gz = torch.as_tensor(((p - yb) / batch).astype(np.float32),
                                 device=dev)
            tbl.push_grad(lk, gz[:, None, :].expand(batch, nnz, 1))
            bias -= lr * float((p - yb).mean())
            _sync(counts)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            pulled.append(profiler.embed_counters()["pull_bytes"] - before)
            wanted.append(int(np.unique(ids).size) * 4)
        touched = np.unique(np.concatenate([d[1] for d in data]))
        rows = tbl._pull_rows(touched)[:, 0]
        local = weight.asnumpy()[:, 0]
        err = float(np.abs(rows - local[touched]).max())
        untouched_zero = bool(np.count_nonzero(local) <=
                              np.count_nonzero(local[touched]))
        stats = plane.clients[0].stats()
        counters = profiler.embed_counters()
    finally:
        plane.close()
        for srv in srvs:
            srv.shutdown()
    bit_equal = err == 0.0
    log(f"18c: {steps} steps at {dim} rows over 2 shards: weight against "
        f"the local store {err:.3e} (bit-equal {bit_equal}); loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; pull bytes a step "
        f"{pulled[:3]}... for the batch's unique ids {wanted[:3]}...")
    if err > EMBED_TOL or not untouched_zero:
        raise AssertionError(f"18c: the plane's weight is off the local "
                             f"store's by {err}")
    if pulled != wanted:
        raise AssertionError(f"18c: pull bytes {pulled} do not follow the "
                             f"batch's unique ids {wanted}")
    if not np.allclose(losses, local_losses, rtol=0, atol=EMBED_TOL):
        raise AssertionError("18c: losses differ from the local store's")
    rec = {"sub": "18c_embedding_plane", "card": card, "dim": dim,
           "batch": batch, "steps": steps, "shards": 2,
           "weight_max_abs_diff": err, "bit_equal": bit_equal,
           "step_p50_ms": float(np.median(ms[2:])),
           "local_store_step_p50_ms": float(np.median(local_ms[2:])),
           "pull_bytes_per_step": pulled, "unique_ids_bytes": wanted,
           "vocab_bytes": dim * 4, "embed_counters": counters,
           "rows_materialized": stats["embed_tables"]["w"][
               "rows_materialized"]}
    log(json.dumps(rec, default=float))
    return rec


def phase_distributed(card, cfg=None, batch=8, seq=512, steps=DIST_STEPS,
                      async_steps=DIST_ASYNC_STEPS, ctx="gpu",
                      embed=None):
    """Phase 18: the parameter-server plane across processes (18a-18c).
    Returns the K1-K3 launches of its worker processes."""
    t_phase = time.perf_counter()
    cfg = dict(dict(BERT_BASE, num_layers=DIST_LAYERS) if cfg is None
               else cfg)
    launches, rec = dist_bert(card, cfg, batch, seq, steps, async_steps,
                              ctx)
    emb = embed_plane_linear(card, **(embed or {}))
    phase_s = time.perf_counter() - t_phase
    log(json.dumps({"phase": "distributed", "card": card,
                    "launches": launches, "phase_s": phase_s,
                    "embed_step_p50_ms": emb["step_p50_ms"]},
                   default=float))
    log(f"distributed: phase 18 in {phase_s:.1f} s")
    launches["lstm_gates"] = 0
    return launches


# ---------------------------------------------------------------------------
# phase 19: the SPMD plane and the training driver
# ---------------------------------------------------------------------------

def _spmd_rank():
    from mxnet_tpu_torch.parallel import distributed as dist
    return dist.rank(), dist.size()


def _spmd_ctx(device):
    """This rank's context: its card (``cuda:rank % count``), or the host."""
    from mxnet_tpu_torch.parallel import devices
    with (mt.cpu() if device == "cpu" else contextlib.nullcontext()):
        dev = devices()[_spmd_rank()[0]].device
    return (mt.gpu(dev.index or 0) if dev.type == "cuda" else mt.cpu()), dev


def _spmd_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _comm_s():
    from mxnet_tpu_torch import profiler
    return float(profiler.comm_counters().get("blocked_s", 0.0))


def _np_rel_err(got, want):
    """max |got - want| over want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _worst(got, want, floor=0.0):
    """The worst array of ``got`` against ``want`` (dicts of arrays) by
    `_np_rel_err`: (name, error); arrays of ``want`` whose largest magnitude
    is at most ``floor`` (zero in exact arithmetic, their values rounding
    noise) are left out."""
    errs = {k: _np_rel_err(got[k], want[k]) for k in want
            if np.abs(want[k]).max() > floor}
    name = max(errs, key=errs.get)
    return name, errs[name]


def _resnet_net(ctx, classes, side, dtype="float32"):
    mt.random.seed(SEED)
    net = vision.resnet50_v1(classes=classes, prefix="resnet50_v1_")
    net.initialize(mt.init.Xavier(magnitude=2), ctx=ctx)
    net(mt.nd.zeros((1, 3, side, side), ctx=ctx))
    if dtype != "float32":
        net.cast(dtype)
    return net


def _net_arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def spmd_resnet(workdir, tag, device="cuda", cfg=None):
    """19a: `resnet50_v1()` at batch SPMD_RESNET["batch"] through
    `SPMDTrainer` over every rank (dp = the group's size, BatchNorm's
    moments over the whole batch), SGD with momentum.  The numbers are
    held in float64: a random-init ResNet-50 in train mode turns fp32
    rounding into gradient differences of a few percent (a different
    but equivalent BatchNorm formula on one process moves them 2 %), so
    fp32 cannot tell a wrong step from a rounding; the steps are timed
    in fp32.  With ``reference`` (one rank) the same float64 steps also
    run through `gluon.Trainer` (phase 8's path) from the same weights.
    Rank 0 writes the float64 weights."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.gluon import loss as gloss
    cfg = dict(SPMD_RESNET, **(cfg or {}))
    rank, n = _spmd_rank()
    ctx, dev = _spmd_ctx(device)
    b, side, classes = cfg["batch"], cfg["side"], cfg["classes"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    x32 = torch.randn((b, 3, side, side), generator=gen, device=dev)
    y = torch.randint(0, classes, (b,), generator=gen, device=dev).float()
    opt = dict(learning_rate=cfg["lr"], momentum=0.9, wd=1e-4)
    rec = {"sub": "19a_resnet50", "ranks": n, "batch": b}
    out = {}
    for dtype in ("float64", "float32"):
        x = x32.to(getattr(torch, dtype))
        if cfg["reference"] and dtype == "float64":
            net = _resnet_net(ctx, classes, side, dtype)
            trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(opt))
            lfn = gloss.SoftmaxCrossEntropyLoss()
            xs, ys = NDArray(x, ctx), NDArray(y.to(x.dtype), ctx)
            for _ in range(cfg["steps"]):
                with mt.autograd.record():
                    loss = lfn(net(xs), ys)
                loss.backward()
                trainer.step(b)
            gluon_w = _net_arrays(net)
            del net, trainer
        net = _resnet_net(ctx, classes, side, dtype)
        tr = par.SPMDTrainer(net, mt.optimizer.SGD(**opt),
                             gloss.SoftmaxCrossEntropyLoss(),
                             mesh=par.auto_mesh(devices=par.devices(dev)))
        losses, ms, comm = [], [], []
        for _ in range(cfg["steps"]):
            _spmd_sync(dev)
            c0, t0 = _comm_s(), time.perf_counter()
            losses.append(float(tr.step(x, y.to(x.dtype))))
            _spmd_sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            comm.append((_comm_s() - c0) * 1e3)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"19a: {dtype} losses {losses}")
        tr.sync_to_block()
        if dtype == "float64":
            w = _net_arrays(net)
            rec["float64_losses"] = losses
            if cfg["reference"]:
                rec["vs_gluon_trainer"] = _worst(w, gluon_w,
                                                 SPMD_ZERO_FLOOR)
                if rec["vs_gluon_trainer"][1] > SPMD_RESNET_TOL:
                    raise AssertionError(
                        f"19a: SPMDTrainer against gluon.Trainer "
                        f"{rec['vs_gluon_trainer']}")
            if rank == 0:
                np.savez(os.path.join(workdir, f"resnet-{tag}.npz"), **w)
            del w
        else:
            rec.update(losses=losses, step_ms=ms, comm_ms=comm,
                       comm_share=[c / m for c, m in zip(comm, ms)])
        del tr, net
    return rec


def spmd_ring_lm(workdir, tag, device="cuda", cfg=None):
    """19b: the ring LM of `model_zoo.ring_lm` (train_ring_lm.py's model)
    at RING_LM_CARD, causal, over sp = the group's size, SPMD_STEPS Adam
    steps on needle batches; K1 on each hop, K2/K3 in the backward.  Rank
    0 writes the first step's logits and gradients."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.model_zoo import (needle_batch, ring_lm_adam,
                                           ring_lm_loss,
                                           ring_lm_numpy_params)
    from mxnet_tpu_torch.serialization import tree_from_numpy
    c = dict(RING_LM_CARD, **(cfg or {}))
    rank, n = _spmd_rank()
    _ctx, dev = _spmd_ctx(device)
    mesh = par.make_mesh({par.SP: n}, devices=par.devices(dev))
    params = tree_from_numpy(
        ring_lm_numpy_params(SEED, c["vocab"], c["dim"], c["seq_len"]),
        dev, requires_grad=True)
    state = tuple({k: torch.zeros_like(v) for k, v in params.items()}
                  for _ in range(2))
    rs = np.random.RandomState(SEED + 19)
    before = dict(hk.LAUNCHES)
    losses, ms, comm = [], [], []
    for t in range(1, c["steps"] + 1):
        tok, tgt = (torch.as_tensor(a, device=dev) for a in needle_batch(
            rs, c["batch"], c["seq_len"], c["vocab"]))
        _spmd_sync(dev)
        c0, t0 = _comm_s(), time.perf_counter()
        loss, logits = ring_lm_loss(params, tok, tgt, mesh, c["heads"])
        grads = torch.autograd.grad(loss, list(params.values()))
        if t == 1 and rank == 0:
            first = {"logits": logits.detach().cpu().numpy()}
            first.update({f"d_{k}": g.cpu().numpy()
                          for k, g in zip(params, grads)})
            np.savez(os.path.join(workdir, f"ring-{tag}.npz"), **first)
        ring_lm_adam(params, dict(zip(params, grads)), state, t, c["lr"])
        losses.append(float(loss.detach()))
        _spmd_sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        comm.append((_comm_s() - c0) * 1e3)
    launches = {k: hk.LAUNCHES[k] - before.get(k, 0) for k in ATTN_KERNELS}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"19b: losses {losses}")
    return {"sub": "19b_ring_lm", "ranks": n, "sp_block": c["seq_len"] // n,
            "losses": losses, "step_ms": ms, "comm_ms": comm,
            "comm_share": [a / b for a, b in zip(comm, ms)],
            "launches": launches,
            "launches_per_step": {k: v / c["steps"]
                                  for k, v in launches.items()}}


_BERT_PARAMS = {}


def _bert_params(sym, shapes):
    """Phase 5's seeded weights for ``sym`` at ``shapes``, made once a
    process."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    want = {k: s for k, s in zip(sym.list_arguments(), arg_shapes)
            if k not in shapes}
    key = tuple(sorted(want.items()))
    if key not in _BERT_PARAMS:
        _BERT_PARAMS.clear()
        _BERT_PARAMS[key] = random_params(want, SEED)
    return _BERT_PARAMS[key]


def _spmd_bert_iter(vocab, batch, seq, steps):
    rng = np.random.RandomState(SEED + 5)
    n = steps * batch
    data = rng.randint(0, vocab, (n, seq)).astype(np.float32)
    label = np.where(rng.rand(n, seq) < 0.15, data, -1.0).astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.float32), (n, 1))
    return mt.io.NDArrayIter({"data": data, "positions": pos},
                             {"mlm_label": label}, batch_size=batch)


def spmd_bert_fit(device="cuda", cfg=None, spmd="auto", zero1=True,
                  batch=8, seq=512, steps=SPMD_STEPS):
    """19c: phase 5's BERT-base MLM (dropout 0) through ``Module.fit`` at
    batch x seq under ``MXTPU_SPMD=spmd`` (unset: the unified step) and
    ``MXTPU_SPMD_ZERO1``; returns (record, trained weights, Adam states)."""
    from mxnet_tpu_torch import profiler
    cfg = dict(BERT_BASE if cfg is None else cfg)
    ctx, dev = _spmd_ctx(device)
    sym = bert_mlm(mt.sym, **dict(cfg, dropout=0.0))
    shapes = {"data": (batch, seq), "positions": (batch, seq),
              "mlm_label": (batch, seq)}
    params = _bert_params(sym, shapes)
    it = _spmd_bert_iter(cfg["vocab"], batch, seq, steps)
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=ctx)
    profiler.reset_spmd_counters()
    stamps = []

    def stamp(_p):
        _spmd_sync(dev)
        stamps.append((time.perf_counter(), _comm_s()))

    with env(MXTPU_SPMD=spmd, MXTPU_SPMD_ZERO1="1" if zero1 else "0"):
        _spmd_sync(dev)
        t0, c0 = time.perf_counter(), _comm_s()
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params=_fit_adam(), batch_end_callback=stamp,
                arg_params={k: mt.nd.array(v, ctx=ctx)
                            for k, v in params.items()})
    marks = [(t0, c0)] + stamps
    ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    comm = [(b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])]
    arg, _ = mod.get_params()
    weights = {k: v.asnumpy() for k, v in arg.items()}
    if mod._spmd_train_step is not None:
        # the states live in the sharded step's buffers (gathered here,
        # by every rank together)
        mod._spmd_train_step.export_states()
    states = {}
    for k, st in mod._active_updater().states.items():
        for i, s in enumerate(st if isinstance(st, tuple) else (st,)):
            states[f"{k}:{i}"] = s.asnumpy()
    rec = {"spmd": spmd, "zero1": zero1, "step_ms": ms, "comm_ms": comm,
           "comm_share": [a / b for a, b in zip(comm, ms)],
           "spmd_counters": profiler.spmd_counters(),
           "sharded": mod._spmd_train_step is not None}
    del mod
    return rec, weights, states


def _bit_equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def spmd_pipe_moe(device="cuda", pipe=None, moe=None):
    """19d: train_pipeline_moe.py's configurations.  The pipeline (its
    run_pipeline: S stages of tanh(x W + b), K microbatches) over pp = the
    group's size, or, on one rank, the same stages applied in sequence;
    the Switch MoE (its run_moe) with its experts over ep = the group's
    size, or on one rank.  Plain SGD; returns the losses."""
    from mxnet_tpu_torch import parallel as par
    p = dict(PIPE_CFG, **(pipe or {}))
    m = dict(MOE_CFG, **(moe or {}))
    _rank, n = _spmd_rank()
    _ctx, dev = _spmd_ctx(device)
    rs = np.random.RandomState(0)
    s, k, b, d = p["stages"], p["micro"], p["batch"], p["width"]
    stages = [{"w": torch.tensor(rs.randn(d, d).astype(np.float32) * 0.3,
                                 device=dev),
               "b": torch.zeros(d, device=dev)} for _ in range(s)]
    x = torch.tensor(rs.randn(k, b, d).astype(np.float32), device=dev)
    target = torch.tanh(x @ torch.tensor(
        rs.randn(d, d).astype(np.float32) * 0.5, device=dev))
    stacked = {key: v.requires_grad_(True) for key, v in
               par.stack_stage_params(stages).items()}

    def fn(q, a):
        return torch.tanh(a @ q["w"] + q["b"])

    mesh = par.auto_mesh(pp=s, devices=par.devices(dev)) if n == s \
        else None
    pipe_losses, t0 = [], time.perf_counter()
    for _ in range(p["steps"]):
        if mesh is not None:
            out = par.pipeline_apply(fn, stacked, x, mesh)
        else:
            out = x
            for i in range(s):
                out = fn({key: v[i] for key, v in stacked.items()}, out)
        loss = ((out - target) ** 2).mean()
        grads = torch.autograd.grad(loss, list(stacked.values()))
        with torch.no_grad():
            for v, g in zip(stacked.values(), grads):
                v.sub_(p["lr"] * g)
        pipe_losses.append(float(loss.detach()))
    pipe_ms = (time.perf_counter() - t0) * 1e3 / p["steps"]
    rs = np.random.RandomState(1)
    params = par.MoEParams(*(a.to(dev).requires_grad_(True) for a in
                             par.init_moe(SEED, m["width"], m["hidden"],
                                          m["experts"])))
    xm = torch.tensor(rs.randn(m["tokens"], m["width"]).astype(np.float32),
                      device=dev)
    tm = torch.sin(xm * 1.5)
    emesh = par.auto_mesh(ep=n, devices=par.devices(dev)) if n > 1 else None
    moe_losses, t0 = [], time.perf_counter()
    for _ in range(m["steps"]):
        y, aux = par.moe_ffn(params, xm, mesh=emesh)
        loss = ((y - tm) ** 2).mean() + 0.01 * aux["aux_loss"]
        grads = torch.autograd.grad(loss, list(params))
        with torch.no_grad():
            for v, g in zip(params, grads):
                v.sub_(m["lr"] * g)
        moe_losses.append(float(loss.detach()))
    moe_ms = (time.perf_counter() - t0) * 1e3 / m["steps"]
    for name, ls in (("pipeline", pipe_losses), ("moe", moe_losses)):
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            raise AssertionError(f"19d: the {name} loss did not fall: {ls}")
    return {"sub": "19d_pipeline_moe", "ranks": n,
            "pipeline_losses": pipe_losses, "pipeline_step_ms": pipe_ms,
            "moe_losses": moe_losses, "moe_step_ms": moe_ms}


def spmd_worker(job_file):
    """A rank of phase 19's two-rank group (`tools/launch.py -n 2`): 19a-19d
    over the gloo group on the shared card, records to ``workdir``."""
    from mxnet_tpu_torch.parallel import distributed as dist
    with open(job_file) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.initialize()
    rank, n = _spmd_rank()
    device, workdir = job["device"], job["workdir"]
    hk.reset_launch_counts()
    rec = {"rank": rank, "ranks": n, "backend": dist.backend()}
    rec["resnet"] = spmd_resnet(workdir, "two", device,
                                dict(job["resnet"], reference=False))
    rec["ring"] = spmd_ring_lm(workdir, "two", device, job["ring"])
    bert = job["bert"]
    one = np.load(os.path.join(workdir, "bert-one.npz"))
    z1, wz1, sz1 = spmd_bert_fit(device, bert["cfg"], "auto", True,
                                 bert["batch"], bert["seq"], bert["steps"])
    ar, war, sar = spmd_bert_fit(device, bert["cfg"], "auto", False,
                                 bert["batch"], bert["seq"], bert["steps"])
    rec["bert"] = {"zero1": z1, "allreduce": ar,
                   "zero1_bit_equal_allreduce": _bit_equal(wz1, war) and
                   _bit_equal(sz1, sar),
                   "vs_one_rank": _worst(wz1, {k: one[k] for k in one.files})}
    del wz1, war, sz1, sar
    rec["pipe_moe"] = spmd_pipe_moe(device, job["pipe"], job["moe"])
    rec["launches"] = dict(hk.LAUNCHES)
    with open(os.path.join(workdir, f"spmd-{rank}.json"), "w") as f:
        json.dump(rec, f, default=float)
    dist.barrier()


def _spmd_group(device):
    """The script's own process as a group of one (NCCL on the card)."""
    from mxnet_tpu_torch.parallel import distributed as dist
    dist.initialize(f"127.0.0.1:{_free_port_pair()}", num_processes=1,
                    process_id=0, backend="nccl" if device == "cuda"
                    else "gloo")
    return dist.backend()


def preempt_child(job_file):
    """19e's preempted run: BERT-base ``Module.fit`` under a
    `TrainingSupervisor` (SIGTERM handlers, ``main_guard``) with the
    checkpoint directory, the anomaly guard and a poisoned step; reports
    each finished batch to ``progress`` (the parent's cue to SIGTERM)."""
    from mxnet_tpu_torch import fault_injection as fi
    from mxnet_tpu_torch import train_driver as drv
    with open(job_file) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fi.install(fi.FaultPlan(poison_step_at=job["poison_at"]))

    def progress(p):
        with open(job["progress"], "w") as f:
            f.write(str(p.nbatch + 1))

    with drv.TrainingSupervisor() as sup:
        with sup.main_guard():
            _preempt_fit(job, batch_end_callback=progress)
            sys.exit(0)


def _preempt_fit(job, batch_end_callback=None):
    """19e's fit: one epoch of job["batches"] BERT batches (dropout 0.1,
    BERT's Adam), weights from the seed; the module."""
    cfg, batch, seq = job["cfg"], job["batch"], job["seq"]
    ctx = mt.gpu(0) if job["device"] == "cuda" else mt.cpu()
    sym = bert_mlm(mt.sym, **cfg)
    shapes = {"data": (batch, seq), "positions": (batch, seq),
              "mlm_label": (batch, seq)}
    params = _bert_params(sym, shapes)
    it = _spmd_bert_iter(cfg["vocab"], batch, seq, job["batches"])
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=ctx)
    mt.random.seed(SEED)
    mod.fit(it, num_epoch=1, optimizer="adam", optimizer_params=_fit_adam(),
            batch_end_callback=batch_end_callback,
            arg_params={k: mt.nd.array(v, ctx=ctx) for k, v in params.items()})
    return mod


def spmd_preempt(card, workdir, device="cuda", cfg=None, batch=8, seq=512):
    """19e: A, this process, fits PREEMPT["batches"] batches under the
    anomaly guard with step PREEMPT["poison_at"] poisoned by the fault
    plan; B, a child, runs the same fit with a checkpoint directory under
    a `TrainingSupervisor` and takes a SIGTERM after its batch
    PREEMPT["sigterm_after"]: it must exit 75 with a committed mid-epoch
    checkpoint; C, this process, resumes from it and must end bit-equal
    to A, parameters and Adam states; each run skips the poisoned step
    once (B's before its checkpoint, so C's none)."""
    import signal as _signal
    from mxnet_tpu_torch import fault_injection as fi
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    p = dict(PREEMPT)
    cfg = dict(dict(BERT_BASE, num_layers=p["layers"]) if cfg is None
               else cfg)
    job = {"cfg": cfg, "batch": batch, "seq": seq, "device": device,
           "batches": p["batches"], "poison_at": p["poison_at"],
           "progress": os.path.join(workdir, "progress"),
           "job": os.path.join(workdir, "preempt.json"),
           "log": os.path.join(workdir, "preempt.log")}
    ckpt = os.path.join(workdir, "ckpt")
    t0 = time.perf_counter()
    with env(MXTPU_ANOMALY_GUARD="1"):
        profiler.reset_driver_counters()
        plan = fi.install(fi.FaultPlan(poison_step_at=p["poison_at"]))
        try:
            a = _module_state(_preempt_fit(job))
        finally:
            fi.clear()
        skipped_a = profiler.driver_counters().get("anomaly_skipped_steps")
        if plan.poisoned_steps != 1 or skipped_a != 1:
            raise AssertionError(f"19e: run A poisoned {plan.poisoned_steps}"
                                 f" steps, the guard skipped {skipped_a}")
        a_s = time.perf_counter() - t0
        with open(job["job"], "w") as f:
            json.dump(job, f)
        t1 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-u", "-c", PREEMPT_ENTRY,
                                 job["job"]], cwd=HERE,
                                env=dict(os.environ, MXTPU_CKPT_DIR=ckpt),
                                stdout=open(job["log"], "w"),
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + CKPT_CHILD_TIMEOUT
            while True:
                done = 0
                if os.path.exists(job["progress"]):
                    with open(job["progress"]) as f:
                        done = int(f.read() or 0)
                if done >= p["sigterm_after"]:
                    break
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError("19e: child B never reached batch "
                                         f"{p['sigterm_after']}:\n"
                                         f"{_child_log(job)}")
                time.sleep(0.01)
            sent_after = done
            proc.send_signal(_signal.SIGTERM)
            code = proc.wait(timeout=CKPT_CHILD_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        b_s = time.perf_counter() - t1
        if code != 75:
            raise AssertionError(f"19e: child B exited {code}, want 75:\n"
                                 f"{_child_log(job)}")
        mgr = CheckpointManager(ckpt)
        ck = mgr.latest_valid()
        loaded = mgr.load(ck)
        cursor = loaded.get("batch")
        if not ((loaded.get("extra") or {}).get("preempted") and
                cursor is not None and 0 < cursor < p["batches"]):
            raise AssertionError(f"19e: the checkpoint is not a mid-epoch "
                                 f"preemption snapshot: {ck.manifest}")
        profiler.reset_driver_counters()
        t2 = time.perf_counter()
        with env(MXTPU_CKPT_DIR=ckpt):
            c = _module_state(_preempt_fit(job))
        c_s = time.perf_counter() - t2
        skipped_c = profiler.driver_counters().get("anomaly_skipped_steps",
                                                   0)
    worst = _worst(c, a)
    rec = {"sub": "19e_preemption", "card": card, "batches": p["batches"],
           "sigterm_after_batch": sent_after, "exit_code": code,
           "checkpoint_batch": cursor, "poisoned_step": p["poison_at"],
           "skipped": {"A": skipped_a, "C": skipped_c},
           "bit_equal": bool(_bit_equal(c, a)), "worst": worst,
           "run_s": {"A": a_s, "B": b_s, "C": c_s}}
    log(json.dumps(rec, default=float))
    if not rec["bit_equal"]:
        raise AssertionError(f"19e: the resumed run is off the "
                             f"uninterrupted one: {worst}")
    if skipped_c:
        raise AssertionError("19e: the resumed run skipped a step")
    return rec


def phase_spmd(card, device="cuda", resnet=None, ring=None, bert=None,
               pipe=None, moe=None, preempt=None):
    """Phase 19: the SPMD plane (19a-19d) and the training driver (19e).
    The one-rank halves run here, in a group of one; the two-rank halves
    in two processes of `tools/launch.py -n 2` started once, sharing the
    card over gloo.  Returns the K1-K3 launches of both."""
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="mxtpu_spmd_")
    bert = dict(SPMD_BERT, **(bert or {}))
    bert["cfg"] = dict(BERT_BASE, **bert.get("cfg", {}))
    job = {"device": device, "workdir": workdir,
           "resnet": dict(SPMD_RESNET, **(resnet or {})),
           "ring": dict(RING_LM_CARD, **(ring or {})), "bert": bert,
           "pipe": dict(PIPE_CFG, **(pipe or {})),
           "moe": dict(MOE_CFG, **(moe or {}))}
    from mxnet_tpu_torch.parallel import distributed as dist
    try:
        backend = _spmd_group(device)
        hop = []
        if device == "cuda":
            # K1-K3 at one ring hop's shapes (sp 2 at the card's config),
            # causal and not, K2/K3 with a random dLSE
            gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
            c = dict(RING_LM_CARD, **job["ring"])
            shape = (c["batch"], c["heads"], c["seq_len"] // 2,
                     c["dim"] // c["heads"])
            with torch.no_grad():
                for causal in (False, True):
                    hop.append(check_attention("ring_hop", shape, shape[2],
                                               torch.float32, causal, gen))
                    hop += check_attention_backward(
                        "ring_hop", shape, shape[2], torch.float32, causal,
                        gen)
        before = dict(hk.LAUNCHES)
        one = {"resnet": spmd_resnet(workdir, "one", device,
                                     dict(job["resnet"], reference=True)),
               "ring": spmd_ring_lm(workdir, "one", device, job["ring"])}
        r1, w1, s1 = spmd_bert_fit(device, bert["cfg"], "1", True,
                                   bert["batch"], bert["seq"], bert["steps"])
        rd, wd, sd = spmd_bert_fit(device, bert["cfg"], "", True,
                                   bert["batch"], bert["seq"], bert["steps"])
        one["bert"] = {"sharded": r1, "unified": rd,
                       "sharded_vs_unified": _worst(w1, wd),
                       "bit_equal": _bit_equal(w1, wd) and
                       _bit_equal(s1, sd)}
        np.savez(os.path.join(workdir, "bert-one.npz"), **w1)
        del w1, wd, s1, sd
        one["pipe_moe"] = spmd_pipe_moe(device, job["pipe"], job["moe"])
        one_launches = {k: hk.LAUNCHES[k] - before.get(k, 0)
                        for k in ATTN_KERNELS}
        one["card"] = card
        log(json.dumps({"sub": "19_one_rank", "backend": backend, **one},
                       default=float))
        if not (r1["sharded"] and not rd["sharded"]):
            raise AssertionError("19c: MXTPU_SPMD=1 did not take the "
                                 "sharded step (or unset did)")
        if one["bert"]["sharded_vs_unified"][1] > SPMD_FIT_TOL:
            raise AssertionError(f"19c: the one-rank sharded step is off "
                                 f"the unified one: "
                                 f"{one['bert']['sharded_vs_unified']}")
        job_file = os.path.join(workdir, "spmd-job.json")
        with open(job_file, "w") as f:
            json.dump(job, f)
        launch = [sys.executable, DIST_LAUNCH, "--launcher", "local", "-n",
                  "2", "--", sys.executable, "-u", "-c", SPMD_ENTRY,
                  job_file]
        out = _run_job("19 two ranks", launch,
                       _child_env(DMLC_PS_ROOT_PORT=_free_port_pair()),
                       timeout=SPMD_TIMEOUT)
        two = _worker_records("19 two ranks", out, workdir, "spmd", 2)
        checks = _spmd_checks(workdir, one, two)
        # 19e at PREEMPT["layers"] of the model's layers
        pre = spmd_preempt(card, workdir, device,
                           {**bert["cfg"], "num_layers": PREEMPT["layers"],
                            **(preempt or {}).get("cfg", {})},
                           (preempt or {}).get("batch", bert["batch"]),
                           (preempt or {}).get("seq", bert["seq"]))
    finally:
        if dist.size() == 1 and dist.backend() is not None:
            import torch.distributed as tdist
            tdist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: one_launches[k] + sum(r["launches"][k] for r in two)
                for k in ATTN_KERNELS}
    rec = {"phase": "spmd", "card": card, "launches": launches,
           "ring_hop_kernel_errors": [
               (r.get("kernel", "flash_attn_fwd"), r["causal"],
                r["max_abs_err"]) for r in hop],
           "one_rank_launches": one_launches,
           "two_rank_launches": [{k: r["launches"][k] for k in ATTN_KERNELS}
                                 for r in two],
           "checks": checks, "preempt": pre,
           "phase_s": time.perf_counter() - t_phase}
    log(json.dumps(rec, default=float))
    log(f"spmd: phase 19 in {rec['phase_s']:.1f} s")
    launches["lstm_gates"] = 0
    return launches


def _spmd_checks(workdir, one, two):
    """Hold the two-rank records against the one-rank ones; the summary
    record."""
    r0 = two[0]
    res1 = np.load(os.path.join(workdir, "resnet-one.npz"))
    res2 = np.load(os.path.join(workdir, "resnet-two.npz"))
    resnet = _worst({k: res2[k] for k in res2.files},
                    {k: res1[k] for k in res1.files}, SPMD_ZERO_FLOOR)
    ring1 = np.load(os.path.join(workdir, "ring-one.npz"))
    ring2 = np.load(os.path.join(workdir, "ring-two.npz"))
    ring_out = _np_rel_err(ring2["logits"], ring1["logits"])
    ring_grad = _worst({k: ring2[k] for k in ring2.files if k != "logits"},
                       {k: ring1[k] for k in ring1.files if k != "logits"})
    bert = r0["bert"]
    pm1, pm2 = one["pipe_moe"], r0["pipe_moe"]
    pipe = _np_rel_err(pm2["pipeline_losses"], pm1["pipeline_losses"])
    moe = _np_rel_err(pm2["moe_losses"], pm1["moe_losses"])
    counters = bert["zero1"]["spmd_counters"]
    rec = {"sub": "19_checks", "card": one["card"],
           "19a_two_vs_one": resnet,
           "19a_step_ms": {"one": one["resnet"]["step_ms"],
                           "two": [r["resnet"]["step_ms"] for r in two]},
           "19a_comm_share_two": [r["resnet"]["comm_share"] for r in two],
           "19a_vs_gluon_trainer": one["resnet"]["vs_gluon_trainer"],
           "19b_outputs": ring_out, "19b_grads": ring_grad,
           "19b_step_ms": {"one": one["ring"]["step_ms"],
                           "two": [r["ring"]["step_ms"] for r in two]},
           "19b_comm_share_two": [r["ring"]["comm_share"] for r in two],
           "19b_launches_per_step": {
               "one": one["ring"]["launches_per_step"],
               "two": [r["ring"]["launches_per_step"] for r in two]},
           "19c_zero1_bit_equal_allreduce":
               [r["bert"]["zero1_bit_equal_allreduce"] for r in two],
           "19c_two_vs_one": bert["vs_one_rank"],
           "19c_step_ms": {"one_sharded": one["bert"]["sharded"]["step_ms"],
                           "one_unified": one["bert"]["unified"]["step_ms"],
                           "two_zero1": bert["zero1"]["step_ms"],
                           "two_allreduce": bert["allreduce"]["step_ms"]},
           "19c_comm_share_two": bert["zero1"]["comm_share"],
           "19c_state_bytes_per_replica": counters.get(
               "state_bytes_per_replica"),
           "19c_state_bytes_total": counters.get("state_bytes_total"),
           "19c_one_rank_bit_equal_unified": one["bert"]["bit_equal"],
           "19d_pipeline": pipe, "19d_moe": moe,
           "19d_losses": {"pipeline": [pm1["pipeline_losses"][0],
                                       pm2["pipeline_losses"][-1]],
                          "moe": [pm1["moe_losses"][0],
                                  pm2["moe_losses"][-1]]},
           "19d_step_ms": {"one": [pm1["pipeline_step_ms"],
                                   pm1["moe_step_ms"]],
                           "two": [pm2["pipeline_step_ms"],
                                   pm2["moe_step_ms"]]}}
    log(json.dumps(rec, default=float))
    for what, err, tol in (("19a: two ranks against one", resnet[1],
                            SPMD_RESNET_TOL),
                           ("19b: outputs", ring_out, RING_OUT_TOL),
                           ("19b: gradients", ring_grad[1], RING_GRAD_TOL),
                           ("19c: two ranks against one",
                            bert["vs_one_rank"][1], SPMD_FIT_TOL),
                           ("19d: the pipeline's losses", pipe, PIPE_TOL),
                           ("19d: the MoE's losses", moe, PIPE_TOL)):
        if not err <= tol:
            raise AssertionError(f"{what} off by {err} (tolerance {tol})")
    if not all(rec["19c_zero1_bit_equal_allreduce"]):
        raise AssertionError("19c: ZeRO-1 is not bit-equal to the "
                             "all-reduce baseline")
    if counters.get("state_bytes_per_replica", 0) * 2 != \
            counters.get("state_bytes_total", -1):
        raise AssertionError(f"19c: state bytes {counters}")
    return rec


# ---------------------------------------------------------------------------
# phase 20: the elastic mesh and the contrib op tail with int8
# ---------------------------------------------------------------------------

from mxnet_tpu_torch.train_driver import TrainingSupervisor  # noqa: E402
from mxnet_tpu_torch.parallel.elastic_mesh import (  # noqa: E402
    CENSUS_TIMEOUT_S, KILLED_EXIT_CODE, _process_state)


class _ElasticSupervisor(TrainingSupervisor):
    """20a-b's supervisor: records when and what the mesh probe raised."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def on_mesh_degraded(self, exc, **kw):
        self.losses.append({"t": time.perf_counter(), "reason": exc.reason,
                            "lost": exc.lost, "mesh_size": exc.mesh_size,
                            "census": {str(k): v
                                       for k, v in exc.census.items()},
                            "step": exc.step, "timeout_s": exc.timeout_s})
        super().on_mesh_degraded(exc, **kw)


def _elastic_fit(job, ctx, dev, sup=None):
    """One 2-epoch ``Module.fit`` of the job's BERT MLM (dropout 0,
    BERT's Adam) on 2 batches an epoch; (module, each batch's end time)."""
    cfg = dict(BERT_BASE, num_layers=job["layers"], **job.get("cfg", {}))
    batch, seq = job["batch"], job["seq"]
    sym = bert_mlm(mt.sym, **dict(cfg, dropout=0.0))
    shapes = {"data": (batch, seq), "positions": (batch, seq),
              "mlm_label": (batch, seq)}
    params = _bert_params(sym, shapes)
    it = _spmd_bert_iter(cfg["vocab"], batch, seq, 2)
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=ctx)
    stamps = []

    def stamp(p):
        _spmd_sync(dev)
        stamps.append((p.epoch, p.nbatch, time.perf_counter()))

    if sup is not None:
        sup.activate()
    try:
        _spmd_sync(dev)
        stamps.append((0, -1, time.perf_counter()))
        mod.fit(it, num_epoch=2, optimizer="adam",
                optimizer_params=_fit_adam(), batch_end_callback=stamp,
                arg_params={k: mt.nd.array(v, ctx=ctx)
                            for k, v in params.items()})
    finally:
        if sup is not None:
            sup.deactivate()
    return mod, stamps


def elastic_worker(job_file):
    """A rank of 20a or 20b (`phase_elastic`): the chaos fit under a
    `TrainingSupervisor`, the mesh's last rank lost at step 3's probe;
    the survivor then fits afresh on one rank from the epoch-0 checkpoint
    and records both."""
    from mxnet_tpu_torch import fault_injection as fi
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import distributed as dist
    from mxnet_tpu_torch.parallel import elastic_mesh as em
    with open(job_file) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.initialize()
    rank, n = _spmd_rank()
    workdir, tag = job["workdir"], job["tag"]
    chaos_dir = os.path.join(workdir, f"ck-{tag}-{rank}")
    os.environ.update(
        MXTPU_SPMD=str(n), MXTPU_SPMD_ZERO1="1",
        MXTPU_SPMD_SHARD_REDUNDANCY=str(job["redundancy"]),
        MXTPU_MESH_STEP_TIMEOUT_S=str(ELASTIC_STEP_TIMEOUT_S),
        MXTPU_CKPT_DIR=chaos_dir)
    ctx, dev = _spmd_ctx(job["device"])
    hk.reset_launch_counts()
    profiler.reset_mesh_counters()
    probes = []
    check = em.MeshHealthMonitor.check

    def timed_check(monitor):
        probes.append(time.perf_counter())
        return check(monitor)

    em.MeshHealthMonitor.check = timed_check
    sup = _ElasticSupervisor()
    fi.install(fi.FaultPlan(**{job["fault"]: [ELASTIC_LOSS_STEP]}))
    try:
        mod, stamps = _elastic_fit(job, ctx, dev, sup)
    finally:
        fi.clear()
    # only the survivor gets here: the victim left at step 3's probe
    em.MeshHealthMonitor.check = check
    mod._spmd_train_step.export_states()
    chaos = _module_state(mod)
    rec = {"rank": rank, "ranks": n, "tag": tag,
           "mesh": profiler.mesh_counters(), "loss": sup.losses,
           "after_n": mod._spmd_train_step._n,
           "shrinks": em.shrink_count(),
           "chaos_launches": dict(hk.LAUNCHES)}
    # the probe that raised: the last one before the supervisor's call
    if sup.losses:
        t_probe = max(t for t in probes if t <= sup.losses[0]["t"])
        rec["detect_s"] = sup.losses[0]["t"] - t_probe
    else:
        rec["detect_s"] = None
    # each batch's ms (batch 3's holds the epoch-0 checkpoint, the
    # detection, the recovery and the retry on one rank)
    rec["step_ms"] = [(b[2] - a[2]) * 1e3 for a, b in zip(stamps, stamps[1:])]
    # the fresh one-rank fit from the checkpoint after step 2
    src = CheckpointManager(chaos_dir).step_dir(0)
    ref_dir = os.path.join(workdir, f"fresh-{tag}")
    shutil.copytree(src, os.path.join(ref_dir, os.path.basename(src)))
    em.reset_state()
    os.environ.update(MXTPU_SPMD="1", MXTPU_CKPT_DIR=ref_dir)
    ref_mod, ref_stamps = _elastic_fit(job, ctx, dev)
    ref_mod._spmd_train_step.export_states()
    ref = _module_state(ref_mod)
    rec["fresh_step_ms"] = [(b[2] - a[2]) * 1e3
                            for a, b in zip(ref_stamps, ref_stamps[1:])]
    rec["bit_equal"] = _bit_equal(chaos, ref)
    rec["worst"] = _worst(chaos, ref) if not rec["bit_equal"] else None
    rec["launches"] = dict(hk.LAUNCHES)
    with open(os.path.join(workdir, f"elastic-{tag}.json"), "w") as f:
        json.dump(rec, f, default=float)
    log(f"RANK {rank} elastic {tag} DONE")
    sys.stdout.flush()
    # the group lost a member: leave without tearing its groups down
    os._exit(0)


def _run_elastic(tag, job, workdir):
    """Start 20a's or 20b's two ranks (the launcher's ``DMLC_*`` env, a
    session each), wait for the survivor, kill the stopped victim; the
    survivor's record and both exit codes."""
    import signal
    job = dict(job, tag=tag, workdir=workdir)
    job_file = os.path.join(workdir, f"elastic-{tag}-job.json")
    with open(job_file, "w") as f:
        json.dump(job, f)
    port = _free_port_pair()
    procs, logs = [], []
    for rank in range(2):
        out = open(os.path.join(workdir, f"elastic-{tag}-{rank}.log"), "w+")
        logs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-c", ELASTIC_ENTRY, job_file],
            env=_child_env(DMLC_ROLE="worker", DMLC_PS_ROOT_URI="127.0.0.1",
                           DMLC_PS_ROOT_PORT=port, DMLC_NUM_WORKER=2,
                           DMLC_NUM_SERVER=0, DMLC_WORKER_ID=rank),
            cwd=HERE, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True))
    deadline = time.monotonic() + ELASTIC_TIMEOUT
    stopped = False
    try:
        while procs[0].poll() is None and time.monotonic() < deadline:
            time.sleep(0.2)
        if procs[1].poll() is None:
            stopped = _process_state(procs[1].pid) == "T"
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    text = ""
    for rank, out in enumerate(logs):
        out.seek(0)
        text += f"--- rank {rank}\n" + out.read()[-4000:]
        out.close()
    codes = [p.returncode for p in procs]
    path = os.path.join(workdir, f"elastic-{tag}.json")
    if codes[0] != 0 or not os.path.exists(path):
        raise AssertionError(f"20 {tag}: the survivor exit {codes[0]}:\n"
                             f"{text[-8000:]}")
    with open(path) as f:
        rec = json.load(f)
    rec.update(exit_codes=codes, victim_stopped=stopped)
    return rec


def phase_elastic(card, device="cuda", elastic=None):
    """20a-b: BERT-base MLM ``fit`` under ``MXTPU_SPMD=2`` on two ranks
    sharing the card over gloo, the second rank lost at step 3's probe
    (killed in 20a, with buddy redundancy; stopped in 20b, without); the
    survivor detects it, recovers, shrinks to one rank and must end
    bit-equal to a fresh one-rank fit from the epoch-0 checkpoint.
    Returns the K1-K3 launches."""
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="mxtpu_elastic_")
    recs = {}
    try:
        for tag, job in (elastic or ELASTIC).items():
            job = dict(job, device=device)
            t_sub = time.perf_counter()
            rec = recs[tag] = _run_elastic(tag, job, workdir)
            rec["sub_s"] = time.perf_counter() - t_sub
            killed = job["fault"] == "kill_device_at"
            loss = rec["loss"][0] if rec["loss"] else {}
            want_codes = [0, KILLED_EXIT_CODE if killed else -9]
            want = dict(buddy_recoveries=1, disk_recoveries=0) \
                if job["redundancy"] else \
                dict(buddy_recoveries=0, disk_recoveries=1)
            m = rec["mesh"]
            log(json.dumps({"sub": f"20{tag}", "card": card,
                            "layers": job["layers"],
                            "fault": job["fault"],
                            "exit_codes": rec["exit_codes"],
                            "victim_stopped": rec["victim_stopped"],
                            "detect_s": rec["detect_s"],
                            "reason": loss.get("reason"),
                            "census": loss.get("census"),
                            "reshard_ms": m.get("reshard_ms"),
                            "mesh": m, "after_n": rec["after_n"],
                            "step_ms_before_after": rec["step_ms"],
                            "fresh_step_ms": rec["fresh_step_ms"],
                            "bit_equal": rec["bit_equal"],
                            "worst": rec["worst"],
                            "launches": rec["launches"],
                            "sub_s": rec["sub_s"]}, default=float))
            if rec["exit_codes"] != want_codes or \
                    (not killed and not rec["victim_stopped"]):
                raise AssertionError(f"20{tag}: exit codes "
                                     f"{rec['exit_codes']} (victim stopped "
                                     f"{rec['victim_stopped']}), want "
                                     f"{want_codes}")
            if loss.get("reason") != ("device_killed" if killed
                                      else "device_hang") or \
                    loss.get("lost") != [1] or \
                    loss.get("census") != {"0": "ok", "1": "lost"}:
                raise AssertionError(f"20{tag}: the loss {loss}")
            # a killed rank within the watchdog's bound; a stopped one
            # after the whole bound, then the census's (and a second of the
            # host's slack)
            limit = ELASTIC_STEP_TIMEOUT_S if killed else \
                ELASTIC_STEP_TIMEOUT_S + CENSUS_TIMEOUT_S + 1.0
            if not rec["detect_s"] or rec["detect_s"] > limit:
                raise AssertionError(f"20{tag}: detected after "
                                     f"{rec['detect_s']} s")
            if any(m.get(k, 0) != v for k, v in want.items()) or \
                    m.get("reshards") != 1 or rec["after_n"] != 1 or \
                    not m.get("degraded_steps"):
                raise AssertionError(f"20{tag}: mesh counters {m}, "
                                     f"n' {rec['after_n']}")
            if not rec["bit_equal"]:
                raise AssertionError(f"20{tag}: the shrunk run is not "
                                     "bit-equal to the fresh one-rank fit: "
                                     f"{rec['worst']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in recs.values())
                for k in ATTN_KERNELS}
    log(f"elastic: 20a-b in {time.perf_counter() - t0:.1f} s, launches "
        f"{launches}")
    if device == "cuda" and any(v == 0 for v in launches.values()):
        raise AssertionError(f"20a-b launched {launches}")
    return launches


def _named_after_weights(sym_json):
    """The exported graph with each convolution and dense layer named
    after its weight (``resnet50_v1_stage1_conv2d0``), as MXNet's Gluon
    export names them: the quantization pass finds a layer's weight by
    its name."""
    graph = json.loads(sym_json)
    nodes = graph["nodes"]
    for node in nodes:
        if node["op"] in ("Convolution", "FullyConnected"):
            w = nodes[node["inputs"][1][0]]["name"]
            node["name"] = w[:-len("_weight")]
    return json.dumps(graph)


def _int8_layer_inputs(qsym, name):
    """The input entries of quantized layer ``name`` as internal output
    names of ``qsym``."""
    graph = json.loads(qsym.tojson())
    nodes = graph["nodes"]
    node = next(n for n in nodes if n["name"] == name)
    outs = qsym.get_internals().list_outputs()
    names = []
    for nid, idx, _ in node["inputs"]:
        src = nodes[nid]
        if src["op"] == "null":
            names.append(src["name"])
        elif f"{src['name']}_output{idx}" in outs:
            names.append(f"{src['name']}_output{idx}")
        else:
            names.append(f"{src['name']}_output")
    return names


def phase_int8(card, cfg=None, device="cuda"):
    """20c: `resnet50_v1()` at its published widths, exported, calibrated
    (naive) on INT8["calib"] synthetic batches, quantized with its first
    convolution and its dense head excluded, served by `Predictor` on the
    card."""
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    c = dict(INT8, **(cfg or {}))
    t0 = time.perf_counter()
    gpu = mt.gpu(0) if device == "cuda" else mt.Context("cpu", 0)
    cpu = mt.cpu()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    batch, side = c["batch"], c["side"]
    rng = np.random.RandomState(SEED + 20)
    net = _resnet_net(gpu, c["classes"], side)
    net.hybridize()
    x = rng.uniform(-1, 1, (batch, 3, side, side)).astype(np.float32)
    net(mt.nd.array(x, ctx=gpu))
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "resnet50_v1_int8")
    net.export(prefix)
    with open(prefix + "-symbol.json") as f:
        sym = mt.sym.load_json(_named_after_weights(f.read()))
    with open(prefix + "-0000.params", "rb") as f:
        fp32_blob = f.read()
    loaded = mt.serialization.loads_ndarrays(fp32_blob)
    args = {k[4:]: v for k, v in loaded.items() if k.startswith("arg:")}
    auxs = {k[4:]: v for k, v in loaded.items() if k.startswith("aux:")}
    layers = [n["name"] for n in json.loads(sym.tojson())["nodes"]
              if n["op"] in ("Convolution", "FullyConnected")]
    excluded = (layers[0], layers[-1])
    calib = mt.io.NDArrayIter(
        rng.uniform(-1, 1, (c["calib"] * batch, 3, side, side))
        .astype(np.float32), batch_size=batch)
    t_q = time.perf_counter()
    qsym, qargs, qauxs = quantize_model(
        sym, args, auxs, excluded_sym_names=excluded, calib_mode="naive",
        calib_data=calib, ctx=gpu)
    quant_s = time.perf_counter() - t_q
    js = qsym.tojson()
    counts = {op: js.count(f'"op": "{op}"') for op in (
        "_contrib_quantized_conv", "_contrib_requantize",
        "_contrib_quantize_v2", "_contrib_dequantize",
        "_contrib_quantized_act", "_contrib_quantized_pooling")}
    if counts["_contrib_quantized_conv"] != len(layers) - 2:
        raise AssertionError(f"20c: {counts} for {len(layers)} layers")
    qblob = {**{f"arg:{k}": v for k, v in qargs.items()},
             **{f"aux:{k}": v for k, v in qauxs.items()}}
    pred = mt.Predictor(js, qblob, {"data": (batch, 3, side, side)},
                        ctx=gpu)
    fp32 = mt.Predictor(sym.tojson(), fp32_blob,
                        {"data": (batch, 3, side, side)}, ctx=gpu)
    req = mt.nd.array(x, ctx=gpu)

    def serve(p):
        p.forward(data=req)
        return p.get_output(0)

    q_out = serve(pred).asnumpy()
    f_out = serve(fp32).asnumpy()
    if not np.isfinite(q_out).all() or q_out.shape != (batch, c["classes"]):
        raise AssertionError(f"20c: int8 outputs {q_out.shape}")
    lat = {}
    for name, p in (("int8", pred), ("fp32", fp32), ("int8_", pred),
                    ("fp32_", fp32)):
        ms = []
        for _ in range(c["timed"]):
            sync()
            t = time.perf_counter()
            serve(p)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
        lat.setdefault(name.rstrip("_"), []).extend(ms)
    # a few int8 layers at their real inputs: the card's int32 sums
    # against the CPU path's, bit for bit
    int8_layers = [n["name"] for n in json.loads(js)["nodes"]
                   if n["op"] == "_contrib_quantized_conv"]
    ks = {n: int(np.prod(qargs[f"{n[:-len('_int8')]}_weight_quantized"]
                         .shape[1:])) for n in int8_layers}
    # the first layer, and the first of each of the two widest reductions
    picks = [int8_layers[0]] + [next(n for n in int8_layers if ks[n] == k)
                                for k in sorted(set(ks.values()))[-2:]]
    internals = qsym.get_internals()
    bits = {}
    for name in picks:
        ins = _int8_layer_inputs(qsym, name)
        group = mt.sym.Group([internals[n] for n in ins
                              if n not in qargs] +
                             [internals[f"{name}_output0"]])
        ex = group.simple_bind(ctx=gpu, grad_req="null",
                               data=(batch, 3, side, side))
        ex.copy_params_from(qargs, qauxs, allow_extra_params=True)
        outs = [o.asnumpy() for o in ex.forward(is_train=False, data=req)]
        feed = dict(zip([n for n in ins if n not in qargs], outs[:-1]))
        vals = [feed[n] if n in feed else qargs[n].asnumpy() for n in ins]
        node = next(nd for nd in json.loads(js)["nodes"]
                    if nd["name"] == name)
        attrs = {k: v for k, v in node.get("attrs", {}).items()}
        card_acc = outs[-1]
        with cpu:
            cpu_acc = mt.nd._contrib_quantized_conv(
                *[mt.nd.array(v, dtype=v.dtype, ctx=cpu) for v in vals],
                **attrs)[0].asnumpy()
        eager = mt.nd._contrib_quantized_conv(
            *[mt.nd.array(v, dtype=v.dtype, ctx=gpu) for v in vals],
            **attrs)[0].asnumpy()
        bits[name] = {"K": ks[name], "shape": list(card_acc.shape),
                      "max_abs": int(np.abs(card_acc).max()),
                      "bit_equal_cpu": bool(np.array_equal(card_acc,
                                                           cpu_acc)),
                      "bit_equal_eager": bool(np.array_equal(card_acc,
                                                             eager))}
    # the whole int8 model on the CPU path at a small batch
    small = x[:c["cpu_batch"]]
    pred_small = mt.Predictor(js, qblob, {"data": small.shape}, ctx=gpu)
    pred_small.forward(data=mt.nd.array(small, ctx=gpu))
    card_small = pred_small.get_output(0).asnumpy()
    with cpu:
        pred_cpu = mt.Predictor(js, {k: v.as_in_context(cpu)
                                     for k, v in qblob.items()},
                                {"data": small.shape}, ctx=cpu)
        pred_cpu.forward(data=mt.nd.array(small, ctx=cpu))
        cpu_small = pred_cpu.get_output(0).asnumpy()
    cpu_err = _np_rel_err(card_small, cpu_small)
    p50 = {k: float(np.percentile(v, 50)) for k, v in lat.items()}
    rec = {"sub": "20c", "card": card, "batch": batch, "side": side,
           "layers": len(layers), "excluded": list(excluded),
           "graph": counts, "quantize_s": quant_s,
           "int32_layers": bits, "int8_vs_cpu_path": cpu_err,
           "int8_vs_fp32": _np_rel_err(q_out, f_out),
           "top1_agree_fp32": float((q_out.argmax(1) ==
                                     f_out.argmax(1)).mean()),
           "p50_ms": p50,
           "images_per_s": {k: batch * 1e3 / v for k, v in p50.items()},
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(rec, default=float))
    bad = [n for n, b in bits.items()
           if not (b["bit_equal_cpu"] and b["bit_equal_eager"])]
    if bad:
        raise AssertionError(f"20c: int32 sums differ from the CPU path in "
                             f"{bad}")
    if cpu_err > INT8_CPU_TOL:
        raise AssertionError(f"20c: int8 outputs off the CPU path by "
                             f"{cpu_err} (tolerance {INT8_CPU_TOL})")
    del pred, fp32, pred_small, net
    return rec


def _ssd300_anchors(ctx):
    """MultiBoxPrior over SSD-300's six feature maps (VGG16-reduced at
    300: 38, 19, 10, 5, 3, 1), concatenated: (1, 8732, 4)."""
    outs = []
    for side, sizes, ratios, step in SSD300:
        feat = mt.nd.zeros((1, 1, side, side), ctx=ctx)
        outs.append(mt.nd.contrib.MultiBoxPrior(feat, sizes=sizes,
                                                ratios=ratios,
                                                steps=(step, step)))
    return mt.nd.concat(*outs, dim=1)


def _ssd300_inputs():
    rng = np.random.RandomState(SEED + 21)
    b, c = SSD300_BATCH, SSD300_CLASSES
    labels = np.full((b, 8, 5), -1.0, np.float32)
    for i in range(b):
        m = rng.randint(1, 9)
        xy = rng.uniform(0, 0.7, (m, 2))
        wh = rng.uniform(0.05, 0.3, (m, 2))
        labels[i, :m, 0] = rng.randint(0, c, m)
        labels[i, :m, 1:] = np.concatenate([xy, xy + wh], 1)
    logits = rng.randn(b, c + 1, 8732).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    probs = (e / e.sum(1, keepdims=True)).astype(np.float32)
    return labels, logits, probs


def _ssd_train(ctx, cfg):
    """`example/ssd/train_ssd.py`'s SSDNet and loss, ``steps`` SGD steps on
    its synthetic shapes; the losses and each step's ms."""
    nd, ag = mt.nd, mt.autograd
    sizes, ratios, ncls = [0.3, 0.5, 0.7], [1.0, 1.5, 0.67], 3
    na = len(sizes) + len(ratios) - 1
    rng = np.random.RandomState(SEED + 22)
    steps = cfg["steps"]
    n, side = cfg["batch"] * 4, cfg["image"]
    X = rng.uniform(0, 0.2, (n, 3, side, side)).astype(np.float32)
    L = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        cls = rng.randint(ncls)
        w, h = rng.uniform(0.3, 0.6, 2)
        x0, y0 = rng.uniform(0.05, 0.9 - w), rng.uniform(0.05, 0.9 - h)
        X[i, cls, int(y0 * side):int((y0 + h) * side),
          int(x0 * side):int((x0 + w) * side)] += 0.8
        L[i, 0] = [cls, x0, y0, x0 + w, y0 + h]
    gl = mt.gluon
    mt.random.seed(SEED)
    with ctx:
        backbone = gl.nn.Sequential()
        for filters in (16, 32, 64):
            backbone.add(gl.nn.Conv2D(filters, 3, padding=1),
                         gl.nn.BatchNorm(), gl.nn.Activation("relu"),
                         gl.nn.MaxPool2D(2))
        cls_head = gl.nn.Conv2D(na * (ncls + 1), 3, padding=1)
        loc_head = gl.nn.Conv2D(na * 4, 3, padding=1)
        blocks = [backbone, cls_head, loc_head]
        for blk in blocks:
            blk.initialize(ctx=ctx)
        feat = backbone(nd.zeros((2, 3, side, side), ctx=ctx))
        cls_head(feat)
        loc_head(feat)
        params = {}
        for blk in blocks:
            params.update(blk.collect_params())
        trainer = gl.Trainer(params, "sgd", {"learning_rate": 0.02,
                                             "momentum": 0.9, "wd": 1e-4})
        ce = gl.loss.SoftmaxCrossEntropyLoss()
        bs = cfg["batch"]
        losses, ms = [], []
        for step in range(steps):
            idx = np.arange(step * bs, (step + 1) * bs) % n
            x = nd.array(X[idx], ctx=ctx)
            y = nd.array(L[idx], ctx=ctx)
            _spmd_sync(ctx.device)
            t = time.perf_counter()
            with ag.record():
                feat = backbone(x)
                anchors = nd.contrib.MultiBoxPrior(feat, sizes=sizes,
                                                   ratios=ratios)
                cls = nd.reshape(nd.transpose(cls_head(feat),
                                              axes=(0, 2, 3, 1)),
                                 shape=(0, -1, ncls + 1))
                loc = nd.reshape(nd.transpose(loc_head(feat),
                                              axes=(0, 2, 3, 1)),
                                 shape=(0, -1))
                loc_t, loc_mask, cls_t = nd.contrib.MultiBoxTarget(
                    anchors, y, nd.transpose(cls, axes=(0, 2, 1)),
                    negative_mining_ratio=3.0, negative_mining_thresh=0.5)
                flat = nd.reshape(cls, shape=(-1, ncls + 1))
                tgt = nd.reshape(cls_t, shape=(-1,))
                per_anchor = ce(flat, nd.maximum(tgt, 0.0))
                num_pos = nd.maximum((cls_t > 0).sum(), 1.0)
                lc = (per_anchor * (tgt >= 0)).sum() / num_pos
                ll = nd.smooth_l1((loc - loc_t) * loc_mask,
                                  scalar=1.0).sum() / num_pos
                loss = lc + ll
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
            ms.append((time.perf_counter() - t) * 1e3)
    return losses, ms


def phase_contrib(card, device="cuda", ssd=None):
    """20d: every contrib case of `tests/torch_contrib_cases.py` (the 57
    names) on the card against the port's CPU path, the samplers by
    structure; SSD-300's detection head (8732 anchors, 21 classes, batch
    32) on the card against the CPU path; `train_ssd.py`'s SSDNet,
    SSD_TRAIN["steps"] steps with the loss falling."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_contrib_cases as cc
    import torch_sweep_cases as cases
    t0 = time.perf_counter()
    gpu = mt.gpu(0) if device == "cuda" else mt.Context("cpu", 0)
    cpu = mt.cpu()
    train = dict(SSD_TRAIN, **(ssd or {}))
    worst = {}
    for case, (name, inputs, attrs, wrt) in sorted(cc.CASES.items()):
        got, ggrad = cases.run_case(mt, name, inputs, attrs, wrt,
                                    make=cc.maker(mt, gpu))
        with cpu:
            want, wgrad = cases.run_case(mt, name, inputs, attrs, wrt,
                                         make=cc.maker(mt, cpu))
        errs = []
        for g, w in list(zip(got, want)) + list(zip(ggrad, wgrad)):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"20d {case}: {g.shape} {g.dtype} "
                                     f"against {w.shape} {w.dtype}")
            if not np.issubdtype(w.dtype, np.floating):
                if not np.array_equal(g, w):
                    raise AssertionError(f"20d {case}: integer outputs "
                                         "differ from the CPU path")
                errs.append(0.0)
            else:
                errs.append(_np_rel_err(g, w) if np.abs(w).max() > 0
                            else float(np.abs(g).max()))
        worst[case] = max(errs)
    for case, (name, inputs, attrs) in sorted(cc.SAMPLERS.items()):
        verts, neigh = getattr(mt.nd, name)(
            *[cc.maker(mt, gpu)(x) for x in inputs], **attrs)
        cc.sampler_structure(inputs[0], inputs[-1], verts.asnumpy(),
                             neigh.asnumpy(), attrs["num_neighbor"],
                             attrs["max_num_vertices"])
    over = {k: v for k, v in worst.items() if v > CONTRIB_TOL}
    # SSD-300's head
    labels, logits, probs = _ssd300_inputs()
    head = {}
    nms_ms = None
    for dev in (gpu, cpu):
        with dev:
            anchors = _ssd300_anchors(dev)
            target = mt.nd.contrib.MultiBoxTarget(
                anchors, mt.nd.array(labels, ctx=dev),
                mt.nd.array(logits, ctx=dev), overlap_threshold=0.5,
                negative_mining_ratio=3.0, negative_mining_thresh=0.5)
            loc = mt.nd.zeros((SSD300_BATCH, 8732 * 4), ctx=dev)
            p = mt.nd.array(probs, ctx=dev)
            det = mt.nd.contrib.MultiBoxDetection(
                p, loc, anchors, nms_threshold=0.45, nms_topk=400)
            head["card" if dev is gpu else "cpu"] = [anchors.asnumpy()] + \
                [t.asnumpy() for t in target] + [det.asnumpy()]
            if dev is gpu and device == "cuda":
                nms_ms = time_ms(lambda: mt.nd.contrib.MultiBoxDetection(
                    p, loc, anchors, nms_threshold=0.45,
                    nms_topk=400).wait_to_read(), iters=5, warmup=1)
    g, c_ = head["card"], head["cpu"]
    n_anchor = g[0].shape[1]
    pos_equal = np.array_equal(g[3] > 0, c_[3] > 0) and \
        np.array_equal(np.where(g[3] > 0, g[3], 0),
                       np.where(c_[3] > 0, c_[3], 0))
    neg_count = np.array_equal((g[3] == 0).sum(1), (c_[3] == 0).sum(1))
    neg_overlap = float(((g[3] == 0) & (c_[3] == 0)).sum() /
                        max((c_[3] == 0).sum(), 1))
    ssd = {"anchors": n_anchor,
           "anchors_equal": bool(np.array_equal(g[0], c_[0])),
           "box_target_err": _np_rel_err(g[1], c_[1]),
           "box_mask_equal": bool(np.array_equal(g[2], c_[2])),
           "positives_equal": bool(pos_equal),
           "negative_counts_equal": bool(neg_count),
           "negative_overlap": neg_overlap,
           "detection_equal": bool(np.array_equal(g[4], c_[4])),
           "kept": int((g[4][..., 0] >= 0).sum()), "nms_ms": nms_ms}
    losses, ms = _ssd_train(gpu, train)
    ssd_train = {"loss_first": float(np.mean(losses[:3])),
                 "loss_last": float(np.mean(losses[-3:])),
                 "step_ms_p50": float(np.percentile(ms[2:], 50))}
    rec = {"sub": "20d", "card": card, "cases": len(worst),
           "worst": max(worst.items(), key=lambda kv: kv[1]),
           "over_tol": over, "ssd300": ssd, "ssd_train": ssd_train,
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(rec, default=float))
    if over:
        raise AssertionError(f"20d: off the CPU path: {over}")
    if n_anchor != 8732 or not (ssd["anchors_equal"] and
                                ssd["box_mask_equal"] and pos_equal and
                                neg_count and ssd["detection_equal"]) or \
            ssd["box_target_err"] > CONTRIB_TOL or \
            neg_overlap < SSD_NEG_OVERLAP:
        raise AssertionError(f"20d: SSD-300's head {ssd}")
    if not ssd_train["loss_last"] < ssd_train["loss_first"]:
        raise AssertionError(f"20d: SSDNet's loss did not fall "
                             f"{ssd_train}")
    return rec


# ---------------------------------------------------------------------------
# phase 21: the front end (gluon.contrib, contrib, rtc, the rest)
# ---------------------------------------------------------------------------

def _sync_fn(device):
    return torch.cuda.synchronize if device == "cuda" else (lambda: None)


def _rel_err_t(got, want):
    """max |got - want| over want's largest magnitude, on the tensors'
    device in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() /
                 want.abs().max().clamp_min(1e-30))


class Lm1bDecoder(mt.gluon.HybridBlock):
    """The softmax layer: a (vocab, proj) table and a bias; its forward
    is the full softmax's log-probabilities."""

    def __init__(self, vocab, proj, **kwargs):
        super().__init__(**kwargs)
        self._vocab = vocab
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(vocab, proj))
            self.bias = self.params.get("bias", shape=(vocab,),
                                        init="zeros")

    def hybrid_forward(self, F, h, weight, bias):
        return F.log_softmax(F.FullyConnected(h, weight, bias,
                                              num_hidden=self._vocab),
                             axis=-1)


class Lm1bLM(mt.gluon.Block):
    """LSTM-2048-512 of "Exploring the Limits of Language Modeling" from
    `gluon.contrib`: a SparseEmbedding, one LSTMPCell inside a
    VariationalDropoutCell, and the softmax layer."""

    def __init__(self, cfg, **kwargs):
        super().__init__(**kwargs)
        self.cfg = cfg
        contrib = mt.gluon.contrib
        with self.name_scope():
            self.embed = contrib.nn.SparseEmbedding(cfg["vocab"],
                                                    cfg["embed"])
            self.cell = contrib.rnn.VariationalDropoutCell(
                contrib.rnn.LSTMPCell(cfg["hidden"], cfg["proj"],
                                      input_size=cfg["embed"]),
                drop_inputs=cfg["dropout"], drop_outputs=cfg["dropout"])
            self.decoder = Lm1bDecoder(cfg["vocab"], cfg["proj"])

    def set_dropout(self, p):
        self.cell.drop_inputs = self.cell.drop_outputs = p

    def encode(self, tokens):
        emb = self.embed(tokens)
        begin = self.cell.begin_state(batch_size=tokens.shape[0],
                                      ctx=tokens.context, dtype=emb.dtype)
        out, _ = self.cell.unroll(tokens.shape[1], emb, begin_state=begin,
                                  layout="NTC", merge_outputs=True)
        return out.reshape((-1, self.cfg["proj"]))

    def forward(self, tokens):
        return self.decoder(self.encode(tokens))


def lm1b_sampled_loss(model, x, y, samples, log_true, log_samp):
    """train_lm's sampled softmax: the true class against the sampled
    ones, each logit less the log of its expected count, accidental hits
    masked; the mean negative log-likelihood of the true class."""
    nd = mt.nd
    c = model.cfg
    h = model.encode(x)
    yf = y.reshape((-1,))
    w = model.decoder.weight.data(x.context)
    b = model.decoder.bias.data(x.context)
    kw = dict(input_dim=c["vocab"], output_dim=c["proj"])
    true_logit = (h * nd.Embedding(yf, w, **kw)).sum(axis=1) + \
        nd.take(b, yf) - log_true
    samp_logit = nd.dot(h, nd.Embedding(samples, w, **kw),
                        transpose_b=True) + \
        (nd.take(b, samples) - log_samp).reshape((1, -1))
    hit = nd.broadcast_equal(samples.reshape((1, -1)), yf.reshape((-1, 1)))
    logits = nd.concat(true_logit.reshape((-1, 1)), samp_logit - hit * 1e9,
                       dim=1)
    return -nd.slice_axis(nd.log_softmax(logits, axis=1), axis=1, begin=0,
                          end=1).mean()


def zipf_markov_stream(vocab, rows, length, seed):
    """Token rows whose next token is the previous one's class (mod 97)
    plus a Zipf draw: a Zipf-skewed marginal with a Markov dependence."""
    rng = np.random.RandomState(seed)
    out = np.empty((rows, length), np.int64)
    out[:, 0] = (rng.zipf(1.3, rows) - 1) % vocab
    for t in range(1, length):
        out[:, t] = (out[:, t - 1] % 97 + rng.zipf(1.3, rows) - 1) % vocab
    return out.astype(np.float32)


def lm1b_language_model(card, device="cuda", cfg=None):
    """21a: LSTM-2048-512 on the card: one step at dropout 0 against the
    same step in float64, the full-softmax evaluation (eager, captured
    and in float64), then Adagrad steps with dropout."""
    c = dict(LM1B, **(cfg or {}))
    gpu = mt.gpu(0) if device == "cuda" else mt.Context("cpu", 0)
    sync = _sync_fn(device)
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mt.random.seed(SEED)
    model = Lm1bLM(c, prefix="lm1b_")
    model.initialize(mt.init.Uniform(c["init"]), ctx=gpu)
    params = list(model.collect_params().values())
    n_params = sum(int(np.prod(p.shape)) for p in params)
    model64 = Lm1bLM(c, prefix="lm1b64_")
    model64.cast("float64")
    model64.initialize(mt.init.Zero(), ctx=gpu)
    params64 = list(model64.collect_params().values())
    for p, q in zip(params, params64):
        q.set_data(p.data().astype("float64"))
    stream = zipf_markov_stream(c["vocab"], c["batch"] + c["eval_batch"],
                                c["bptt"] + 1, SEED + 21)
    x = mt.nd.array(stream[:c["batch"], :-1], ctx=gpu)
    y = mt.nd.array(stream[:c["batch"], 1:], ctx=gpu)
    ex = mt.nd.array(stream[c["batch"]:, :-1], ctx=gpu)
    ey = stream[c["batch"]:, 1:].reshape(-1).astype(np.int64)

    def draw():
        s, e_true, e_samp = mt.nd.contrib.rand_zipfian(
            y.reshape((-1,)), c["sampled"], c["vocab"])
        return (s.astype("float32"), mt.nd.log(e_true),
                mt.nd.log(e_samp))

    # one step at dropout 0 on the same sampled ids, fp32 against float64
    model.set_dropout(0.0)
    model64.set_dropout(0.0)
    samples, log_true, log_samp = draw()
    grads = {}
    losses = {}
    for tag, m in (("fp32", model), ("fp64", model64)):
        cast = (lambda a: a) if tag == "fp32" else \
            (lambda a: a.astype("float64"))
        with mt.autograd.record():
            loss = lm1b_sampled_loss(m, x, y, cast(samples),
                                     cast(log_true), cast(log_samp))
        loss.backward()
        losses[tag] = float(loss.asnumpy())
        grads[tag] = [p.grad().data for p in m.collect_params().values()]
    grad_err = {p.name[len("lm1b_"):]: _rel_err_t(g, g64)
                for p, g, g64 in zip(params, grads["fp32"], grads["fp64"])}
    touched = int(((grads["fp32"][0] != 0).any(dim=1)).sum())
    del grads
    # the full-softmax evaluation: eager, captured, float64
    lp = model(ex)
    lp64 = model64(ex)
    sync()
    lp_err = _rel_err_t(lp.data, lp64.data)
    picked = lp.data[torch.arange(len(ey), device=lp.data.device),
                     torch.as_tensor(ey, device=lp.data.device)]
    ppl = float(torch.exp(-picked.double().mean()))
    del lp64, model64, params64
    if device == "cuda":
        torch.cuda.empty_cache()

    def evaluate():
        out = model(ex)
        sync()
        return out

    t = time.perf_counter()
    evaluate()
    eval_ms = (time.perf_counter() - t) * 1e3
    model.hybridize()
    captured = [evaluate() for _ in range(2)]
    t = time.perf_counter()
    captured.append(evaluate())
    eval_captured_ms = (time.perf_counter() - t) * 1e3
    capture_err = max(_rel_err_t(o.data, lp.data) for o in captured)
    model.hybridize(False)
    del captured, lp
    # Adagrad with dropout: the loss on a fixed batch and fixed samples
    # (predict mode) before and after
    model.set_dropout(c["dropout"])
    fixed = draw()
    before = float(lm1b_sampled_loss(model, x, y, *fixed).asnumpy())
    trainer = mt.gluon.Trainer(model.collect_params(), "adagrad",
                               {"learning_rate": c["lr"], "eps": c["eps"]})
    step_ms = []
    for _ in range(c["steps"]):
        sync()
        t = time.perf_counter()
        s = draw()
        with mt.autograd.record():
            loss = lm1b_sampled_loss(model, x, y, *s)
        loss.backward()
        trainer.step(1)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
    after = float(lm1b_sampled_loss(model, x, y, *fixed).asnumpy())
    tokens = c["batch"] * c["bptt"]
    rec = {"sub": "21a", "card": card, "params": n_params,
           "params_gb": n_params * 4 / 1e9, "loss_fp32": losses["fp32"],
           "loss_fp64": losses["fp64"], "grad_err": grad_err,
           "embedding_rows_touched": touched, "eval_ppl": ppl,
           "eval_logprob_err_fp64": lp_err, "eval_capture_err": capture_err,
           "eval_ms": eval_ms, "eval_captured_ms": eval_captured_ms,
           "loss_before": before, "loss_after": after,
           "step_ms": step_ms,
           "step_ms_p50": float(np.percentile(step_ms[1:] or step_ms, 50)),
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if device == "cuda" else None),
           "phase_s": time.perf_counter() - t0}
    rec["tokens_per_s"] = tokens / rec["step_ms_p50"] * 1e3
    log(json.dumps(rec, default=float))
    bad = {k: v for k, v in grad_err.items() if not v <= LM1B_TOL}
    if bad or not np.isfinite(losses["fp32"]):
        raise AssertionError(f"21a: gradients off float64: {bad}")
    if not (lp_err <= LM1B_TOL and np.isfinite(ppl)):
        raise AssertionError(f"21a: evaluation log-probs {lp_err}, "
                             f"perplexity {ppl}")
    if not capture_err <= CAPTURE_TOL:
        raise AssertionError(f"21a: captured log-probs {capture_err}")
    if not after < before:
        raise AssertionError(f"21a: Adagrad did not lower the loss "
                             f"{before} -> {after}")
    del model, trainer
    if device == "cuda":
        torch.cuda.empty_cache()
    return rec


def onnx_round_trip(card, device="cuda", batch=ONNX_BATCH, side=224,
                    classes=1000, timed=ONNX_TIMED):
    """21b: resnet50_v1 exported by Gluon, written to ONNX on the card and
    on the CPU (the same bytes), read back and served by `Predictor` on
    the card against the Gluon net's own outputs."""
    from mxnet_tpu_torch.contrib import onnx as onnx_mod
    t0 = time.perf_counter()
    gpu = mt.gpu(0) if device == "cuda" else mt.Context("cpu", 0)
    sync = _sync_fn(device)
    net = _resnet_net(gpu, classes, side)
    rng = np.random.RandomState(SEED + 22)
    x = mt.nd.array(rng.uniform(-1, 1, (batch, 3, side, side))
                    .astype(np.float32), ctx=gpu)
    want = net(x).data
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "resnet50_v1_onnx")
    net.export(prefix)
    sym = mt.sym.load(prefix + "-symbol.json")
    loaded = mt.serialization.load_ndarrays(prefix + "-0000.params")
    params = {k.split(":", 1)[-1]: v for k, v in loaded.items()}
    shape = (batch, 3, side, side)
    files = {}
    for tag, ctx in (("card", gpu), ("cpu", mt.cpu())):
        path = f"{prefix}-{tag}.onnx"
        with ctx:
            onnx_mod.export_model(
                sym, {k: v.as_in_context(ctx) for k, v in params.items()},
                [shape], onnx_file_path=path)
        with open(path, "rb") as f:
            files[tag] = f.read()
    with gpu:
        isym, iarg, iaux = onnx_mod.import_model(f"{prefix}-card.onnx")
    blob = {**{f"arg:{k}": v for k, v in iarg.items()},
            **{f"aux:{k}": v for k, v in iaux.items()}}
    pred = mt.Predictor(isym.tojson(), blob, {"data": shape}, ctx=gpu)

    def serve():
        pred.forward(data=x)
        out = pred.get_output(0)
        sync()
        return out

    got = serve().data
    err = _rel_err_t(got, want)
    ms = []
    for _ in range(timed):
        t = time.perf_counter()
        serve()
        ms.append((time.perf_counter() - t) * 1e3)
    nodes = json.loads(isym.tojson())["nodes"]
    rec = {"sub": "21b", "card": card, "batch": batch,
           "onnx_bytes": len(files["card"]),
           "bytes_equal_cpu": files["card"] == files["cpu"],
           "ops": len([n for n in nodes if n["op"] != "null"]),
           "err": err, "p50_ms": float(np.percentile(ms, 50)),
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(rec, default=float))
    if not rec["bytes_equal_cpu"]:
        raise AssertionError("21b: the card's ONNX bytes differ from the "
                             "CPU path's")
    if not (got.shape == want.shape and err <= ONNX_TOL):
        raise AssertionError(f"21b: served ONNX outputs {err} off Gluon's")
    return rec


def _svrg_fit(ctx, X, Y, cfg, logdir):
    """One SVRGModule fit on ``ctx``, its batch-end metrics logged by
    `contrib.tensorboard.LogMetricsCallback` to the TSV writer."""
    sym = mt.sym
    out = sym.FullyConnected(sym.var("data"), num_hidden=1, name="fc")
    out = sym.LinearRegressionOutput(out, sym.var("lro_label"), name="lro")
    tb = mt.contrib.tensorboard
    cb = tb.LogMetricsCallback(logdir, prefix="train",
                               summary_writer=tb._TsvWriter(logdir))
    with ctx:
        it = mt.io.NDArrayIter(X, Y, batch_size=cfg["batch"], shuffle=False,
                               label_name="lro_label")
        mod = mt.contrib.svrg_optimization.SVRGModule(
            out, data_names=("data",), label_names=("lro_label",),
            update_freq=cfg["update_freq"], context=ctx)
        t = time.perf_counter()
        mod.fit(it, num_epoch=cfg["epochs"], optimizer="sgd",
                optimizer_params={"learning_rate": cfg["lr"]},
                initializer=mt.init.Zero(), eval_metric="mse",
                batch_end_callback=cb)
        secs = time.perf_counter() - t
        args, _ = mod.get_params()
    with open(os.path.join(logdir, "events.tsv")) as f:
        rows = f.read().splitlines()
    mse = [float(r.split("\t")[2]) for r in rows]
    return {k: v.asnumpy() for k, v in args.items()}, rows, mse, secs


def svrg_regression(card, device="cuda", cfg=None):
    """21c: SVRGModule on YearPredictionMSD's 90 features (synthetic),
    the card against the CPU path on the same batches, the training MSE
    against least squares, a TSV row a batch."""
    c = dict(SVRG_CFG, **(cfg or {}))
    t0 = time.perf_counter()
    gpu = mt.gpu(0) if device == "cuda" else mt.Context("cpu", 0)
    rng = np.random.RandomState(SEED + 23)
    X = rng.randn(c["rows"], c["features"]).astype(np.float32)
    w = rng.randn(c["features"]).astype(np.float32) * 0.5
    # labels centred, as the years are for regression
    Y = (X @ w + rng.randn(c["rows"]).astype(np.float32) * 3.0
         ).astype(np.float32)
    Xb = np.hstack([X, np.ones((c["rows"], 1), np.float32)]).astype(
        np.float64)
    lsq = np.linalg.lstsq(Xb, Y.astype(np.float64), rcond=None)[0]
    lsq_mse = float(np.mean((Xb @ lsq - Y) ** 2))
    runs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_svrg_",
                           dir=os.path.join(HERE, "build"))
    try:
        for tag, ctx in (("card", gpu), ("cpu", mt.cpu())):
            runs[tag] = _svrg_fit(ctx, X, Y, c, os.path.join(tmp, tag))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (wc, rows, mse, secs), (wp, _, _, cpu_s) = runs["card"], runs["cpu"]
    err = max(_np_rel_err(wc[k], wp[k]) for k in wp)
    n_batches = -(-c["rows"] // c["batch"])
    last = mse[-n_batches:]
    rec = {"sub": "21c", "card": card, "rows": c["rows"],
           "weights_err_cpu": err, "lsq_mse": lsq_mse,
           "train_mse_last_epoch": float(np.mean(last)),
           "tsv_rows": len(rows),
           "fit_s": secs, "cpu_fit_s": cpu_s,
           "batches_per_s": c["epochs"] * n_batches / secs,
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(rec, default=float))
    if not err <= SVRG_TOL:
        raise AssertionError(f"21c: weights {err} off the CPU path")
    if not rec["train_mse_last_epoch"] <= 2 * lsq_mse:
        raise AssertionError(f"21c: training MSE {rec}")
    if len(rows) != c["epochs"] * n_batches:
        raise AssertionError(f"21c: {len(rows)} TSV rows")
    return rec


RTC_SOURCE = r'''
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
'''
RTC_TEMPLATE = r'''
template <typename T>
__global__ void axpy(const T *x, T *y, T alpha, int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) y[i] += alpha * x[i];
}
'''


def rtc_kernels(card):
    """21d: MXNet's `rtc.CudaModule` example compiled by NVRTC and
    launched on torch's stream, templated kernels through ``exports``, a
    compile error carrying NVRTC's log."""
    t0 = time.perf_counter()
    gpu = mt.gpu(0)
    n = RTC_N
    t = time.perf_counter()
    mod = mt.rtc.CudaModule(RTC_SOURCE, options=("--fmad=false",))
    compile_ms = (time.perf_counter() - t) * 1e3
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = NDArray(torch.randn(n, device="cuda", generator=g), gpu)
    y = NDArray(torch.randn(n, device="cuda", generator=g), gpu)
    want = y.data + 3.0 * x.data
    k.launch([x, y, 3.0], gpu, (n // 256,), (256,))
    # a torch op on the same stream reads the kernel's writes
    equal = bool(torch.equal(y.data, want))
    launch_ms = time_ms(lambda: k.launch([x, y, 0.0], gpu, (n // 256,),
                                         (256,)), iters=20)
    t = time.perf_counter()
    tmod = mt.rtc.CudaModule(RTC_TEMPLATE, options=("--fmad=false",),
                             exports=("axpy<float>", "axpy<double>"))
    template_ms = (time.perf_counter() - t) * 1e3
    templ = {}
    for dt, tdt in (("float", torch.float32), ("double", torch.float64)):
        kt = tmod.get_kernel(f"axpy<{dt}>", f"const {dt} *x, {dt} *y, "
                             f"{dt} alpha, int n")
        m = 1000003
        a = NDArray(torch.randn(m, device="cuda", generator=g, dtype=tdt),
                    gpu)
        b = NDArray(torch.randn(m, device="cuda", generator=g, dtype=tdt),
                    gpu)
        expect = b.data + 0.5 * a.data
        kt.launch([a, b, 0.5, m], gpu, (-(-m // 128),), (128,))
        templ[dt] = bool(torch.equal(b.data, expect))
    try:
        mt.rtc.CudaModule('extern "C" __global__ void bad(float *y) '
                          '{ y[0] = undeclared_name; }')
        compile_error = None
    except mt.MXNetError as e:
        compile_error = str(e)
    rec = {"sub": "21d", "card": card, "n": n, "arch": mod.arch,
           "compile_ms": compile_ms, "template_compile_ms": template_ms,
           "axpy_equal": equal, "axpy_ms": launch_ms,
           "axpy_gbs": 3 * 4 * n / launch_ms / 1e6,
           "templates_equal": templ,
           "compile_error_logged": bool(compile_error and
                                        "undeclared_name" in compile_error),
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(rec, default=float))
    if not (equal and all(templ.values())):
        raise AssertionError(f"21d: rtc kernels wrote other values {rec}")
    if not rec["compile_error_logged"]:
        raise AssertionError(f"21d: a compile error gave {compile_error!r}")
    return rec


def _front_blocks():
    """(name, make(prefix), inputs, call) of the contrib blocks and cells
    at small shapes."""
    cnn, crnn = mt.gluon.contrib.nn, mt.gluon.contrib.rnn
    rs = np.random.RandomState(SEED + 24)

    def r(*shape):
        return rs.randn(*shape).astype(np.float32)

    def unroll(steps):
        def call(cell, x):
            outs, states = cell.unroll(steps, x, layout="NTC",
                                       merge_outputs=True)
            return [outs] + list(states)
        return call

    def plain(b, *x):
        return b(*x)

    def conc(cls):
        def make(prefix):
            net = cls(axis=1, prefix=prefix)
            with net.name_scope():
                net.add(mt.gluon.nn.Dense(4, in_units=3),
                        mt.gluon.nn.Dense(6, in_units=3))
            return net
        return make

    out = [
        ("HybridConcurrent", conc(cnn.HybridConcurrent), [r(2, 3)], plain),
        ("Concurrent", conc(cnn.Concurrent), [r(2, 3)], plain),
        ("Identity", lambda p: cnn.Identity(prefix=p), [r(2, 3)], plain),
        ("SparseEmbedding", lambda p: cnn.SparseEmbedding(
            50, 8, prefix=p), [np.array([[1, 7, 7], [0, 49, 3]],
                                        np.float32)], plain),
        ("SyncBatchNorm", lambda p: cnn.SyncBatchNorm(
            in_channels=3, prefix=p), [r(4, 3, 5, 5)], plain),
        ("PixelShuffle1D", lambda p: cnn.PixelShuffle1D(3, prefix=p),
         [r(2, 6, 5)], plain),
        ("PixelShuffle2D", lambda p: cnn.PixelShuffle2D(2, prefix=p),
         [r(2, 8, 3, 4)], plain),
        ("PixelShuffle3D", lambda p: cnn.PixelShuffle3D(2, prefix=p),
         [r(2, 16, 2, 3, 2)], plain),
        ("LSTMPCell", lambda p: crnn.LSTMPCell(16, 8, prefix=p),
         [r(2, 3, 6)], unroll(3)),
        ("VariationalDropoutCell", lambda p: crnn.VariationalDropoutCell(
            crnn.LSTMPCell(16, 8, prefix=p)), [r(2, 3, 6)], unroll(3)),
    ]
    spatial = {1: (6,), 2: (5, 4), 3: (3, 4, 3)}
    for d in (1, 2, 3):
        for kind in ("RNN", "LSTM", "GRU"):
            name = f"Conv{d}D{kind}Cell"
            cls = getattr(crnn, name)
            out.append((name, lambda p, cls=cls, d=d: cls(
                (2,) + spatial[d], 4, 3, 3, prefix=p),
                [r(2, 3, 2, *spatial[d])], unroll(3)))
    return out


def _front_run(make, inputs, call, ctx, values, hybridize):
    blk = make("fb_")
    with ctx:
        blk.initialize(ctx=ctx)
        xs = [mt.nd.array(x, ctx=ctx) for x in inputs]
        call(blk, *xs)
        for i, p in enumerate(blk.collect_params().values()):
            p.set_data(mt.nd.array(values(i, p.shape), ctx=ctx))
        if hybridize:
            blk.hybridize()
        for x in xs:
            x.attach_grad()
        rs = np.random.RandomState(5)
        with mt.autograd.record():
            outs = call(blk, *xs)
            outs = outs if isinstance(outs, list) else [outs]
            loss = None
            for o in outs:
                term = (o * mt.nd.array(rs.randn(*o.shape).astype(
                    np.float32), ctx=ctx)).sum()
                loss = term if loss is None else loss + term
        loss.backward()
        # gradients, and the moving statistics where there is none
        return ([o.asnumpy() for o in outs] +
                [x.grad.asnumpy() for x in xs] +
                [(p.grad() if p.grad_req != "null" else p.data()).asnumpy()
                 for p in blk.collect_params().values()])


def front_end_rest(card, device="cuda"):
    """21e: the contrib blocks and cells (eager and hybridized),
    CustomEmbedding from a 10,000 x 300 file, resource, runtime and a
    TorchBlock, on the card against the CPU path."""
    t0 = time.perf_counter()
    gpu = mt.gpu(0) if device == "cuda" else mt.Context("cpu", 0)
    cpu = mt.cpu()

    def values(i, shape):
        v = np.random.RandomState(100 + i).randn(*shape).astype(
            np.float32) * 0.3
        return v

    worst = {}
    for name, make, inputs, call in _front_blocks():
        want = _front_run(make, inputs, call, cpu, values, False)
        for hyb in (False, True):
            got = _front_run(make, inputs, call, gpu, values, hyb)
            worst[f"{name}{'/hybridized' if hyb else ''}"] = max(
                _np_rel_err(g, w) if np.abs(w).max() > 0 else
                float(np.abs(g).max()) for g, w in zip(got, want))
    # CustomEmbedding from a file written from the seed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_text_",
                           dir=os.path.join(HERE, "build"))
    try:
        rs = np.random.RandomState(SEED + 25)
        n, dim = EMBED_FILE["tokens"], EMBED_FILE["dim"]
        mat = rs.randn(n, dim).astype(np.float32)
        path = os.path.join(tmp, "vectors.txt")
        with open(path, "w") as f:
            for i in range(n):
                f.write(f"tok{i} " + " ".join(f"{v:.6f}" for v in mat[i])
                        + "\n")
        t = time.perf_counter()
        with gpu:
            emb = mt.contrib.text.CustomEmbedding(path)
        load_s = time.perf_counter() - t
        rows = np.loadtxt(path, usecols=range(1, dim + 1),
                          dtype=np.float64).astype(np.float32)
        table = emb.idx_to_vec
        embed_ok = (table.context == gpu and
                    np.array_equal(table.asnumpy()[1:], rows) and
                    not table.asnumpy()[0].any())
        vecs = emb.get_vecs_by_tokens(["tok5", "nope", "tok9999"])
        embed_ok = embed_ok and vecs.context == gpu and np.array_equal(
            vecs.asnumpy(), np.stack([rows[5], np.zeros(dim), rows[9999]]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # resource: temp spaces and streams on the card
    from mxnet_tpu_torch import resource
    with gpu:
        r = resource.request(resource.ResourceRequest.kTempSpace)
        a = r.get_space((64, 64))
        b = r.get_space((16,), dtype=np.int32)
        space_ok = (a.data.device == gpu.device and
                    b.data.data_ptr() == a.data.data_ptr() and
                    r.space_nbytes == 64 * 64 * 4)
        resource.seed(7, gpu)
        d1 = resource.request(resource.ResourceRequest.kRandom).uniform(
            (1000,)).asnumpy()
        p1 = resource.request(
            resource.ResourceRequest.kParallelRandom).normal((1000,))
        resource.seed(7, gpu)
        d2 = resource.request(resource.ResourceRequest.kRandom).uniform(
            (1000,)).asnumpy()
        streams_ok = (np.array_equal(d1, d2) and p1.data.device ==
                      gpu.device and not np.allclose(d1, p1.asnumpy()))
    feats = mt.runtime.Features()
    # a TorchBlock inside a Gluon net
    torch_rec = {}
    for tag, ctx in (("card", gpu), ("cpu", cpu)):
        torch.manual_seed(SEED)
        seen = []

        class Seen(torch.nn.Module):
            def forward(self, x):
                seen.append(x.data_ptr())
                return x

        seq = torch.nn.Sequential(Seen(), torch.nn.Linear(32, 64),
                                  torch.nn.ReLU(), torch.nn.Linear(64, 10))
        net = mt.gluon.nn.Sequential(prefix="tbnet_")
        with net.name_scope():
            net.add(mt.gluon.nn.Dense(32, in_units=16))
            net.add(mt.plugin.TorchBlock(seq))
        net.initialize(mt.init.Xavier(), ctx=ctx)
        for i, p in enumerate(net.collect_params().values()):
            if i < 2:
                p.set_data(mt.nd.array(values(50 + i, p.shape), ctx=ctx))
        x = mt.nd.array(np.random.RandomState(9).randn(8, 16)
                        .astype(np.float32), ctx=ctx)
        x.attach_grad()
        with mt.autograd.record():
            h = net[0](x)
            out = net[1](h)
            loss = (out * out).sum()
        loss.backward()
        torch_rec[tag] = ([out.asnumpy(), x.grad.asnumpy()] +
                          [p.grad().asnumpy()
                           for p in net.collect_params().values()],
                          seen == [h.data.data_ptr()])
    torch_err = max(_np_rel_err(g, w) for g, w in
                    zip(torch_rec["card"][0], torch_rec["cpu"][0]))
    rec = {"sub": "21e", "card": card, "blocks": len(worst),
           "worst": max(worst.items(), key=lambda kv: kv[1]),
           "embedding_equal": bool(embed_ok), "embedding_load_s": load_s,
           "temp_space_ok": bool(space_ok), "streams_ok": bool(streams_ok),
           "features_cuda": feats.is_enabled("CUDA"),
           "torch_block_err": torch_err,
           "torch_block_same_storage": torch_rec["card"][1],
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(rec, default=float))
    over = {k: v for k, v in worst.items() if not v <= FRONT_TOL}
    if over:
        raise AssertionError(f"21e: blocks off the CPU path: {over}")
    if not (embed_ok and space_ok and streams_ok):
        raise AssertionError(f"21e: {rec}")
    if device == "cuda" and not feats.is_enabled("CUDA"):
        raise AssertionError("21e: runtime.Features() has no CUDA")
    if not (torch_err <= FRONT_TOL and torch_rec["card"][1]):
        raise AssertionError(f"21e: the TorchBlock {rec}")
    return rec


def phase_front_end(card, device="cuda", lm=None, svrg=None, onnx=None):
    """Phase 21: 21a-e."""
    t0 = time.perf_counter()
    recs = [lm1b_language_model(card, device, lm),
            onnx_round_trip(card, device, **(onnx or {})),
            svrg_regression(card, device, svrg)]
    if device == "cuda":
        recs.append(rtc_kernels(card))
    recs.append(front_end_rest(card, device))
    log(f"phase 21 in {time.perf_counter() - t0:.1f} s")
    return recs


# ---------------------------------------------------------------------------
# phase 22: mixed precision on the captured step, and the repaired ops
# ---------------------------------------------------------------------------

def _mp_fit(sym, it, params, ctx, fused, opt_params, losses):
    """One `Module.fit` epoch over ``it`` (``MXTPU_FUSED_STEP`` on or
    off), with each batch's masked-LM loss appended to ``losses``."""
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=ctx)

    def on_batch(param):
        losses.append(_batch_loss(mod, param.locals["data_batch"]))

    it.reset()
    with env(MXTPU_FUSED_STEP="1" if fused else "0"):
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(opt_params), arg_params=params,
                batch_end_callback=on_batch)
    return mod


def _mp_states(mod):
    """(weights, fp32 master copies, momenta) of a module under
    multi-precision SGD, by parameter name."""
    names = mod._exec._grad_arg_names
    idx = {n: i for i, n in enumerate(mod._exec.arg_names)}
    states = mod._updater.states
    return ({n: mod._exec.arg_dict[n].data for n in names},
            {n: states[idx[n]][1].data for n in names},
            {n: states[idx[n]][0].data for n in names})


def _bf16_instantiation(name, kernel):
    """Whether profiler kernel name ``kernel`` is attention kernel
    ``name``'s bf16 instantiation (True), its fp32 one (False) or another
    kernel (None).  K1-K3's bf16 kernels are wgmma kernels of their own
    (``<name>_wgmma_kernel``); their fp32 kernels are `FP32_KERNEL`'s."""
    if name + "_wgmma_kernel" in kernel:
        return True
    return False if FP32_KERNEL[name] in kernel else None


def mixed_precision_fit(card, device="cuda", cfg=None, batch=None,
                        seq=None, steps=None, timed=None):
    """22a: BERT-base MLM in bfloat16 (`bert_mlm(dtype="bfloat16")`)
    through ``Module.fit`` with SGD(momentum 0.9, multi_precision): the
    captured step against the eager per-parameter one, bit for bit, and
    against the same steps in fp32.  Returns the bf16 fits' launches and,
    on the card, K1-K3's records at this path's call."""
    cfg = dict(BERT_BASE if cfg is None else cfg, dropout=0.0)
    batch = batch or MP_FIT["batch"]
    seq = seq or MP_FIT["seq"]
    steps = steps or MP_FIT["steps"]
    timed = timed or MP_FIT["timed"]
    n_layers = cfg["num_layers"]
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    on_card = device == "cuda"
    rng = np.random.RandomState(SEED + 22)
    n = steps * batch
    data = rng.randint(0, cfg["vocab"], (n, seq)).astype(np.float32)
    label = np.where(rng.rand(n, seq) < 0.15, data, -1.0).astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.float32), (n, 1))
    it = mt.io.NDArrayIter({"data": data, "positions": pos},
                           {"mlm_label": label}, batch_size=batch)
    shapes = {d.name: d.shape for d in it.provide_data + it.provide_label}
    sym = bert_mlm(mt.sym, dtype="bfloat16", **cfg)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, SEED)
    opt = dict(learning_rate=MP_FIT["lr"], momentum=0.9,
               multi_precision=True)
    names = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")

    # K1-K3 in bf16 at this path's call against their plain versions,
    # timed beside their bounds (before the counted fits)
    kernel_recs = {}
    if on_card:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
        heads = cfg["heads"]
        shape = (batch, heads, seq, cfg["hidden"] // heads)
        with torch.no_grad():
            kernel_recs["flash_attn_fwd"] = check_attention(
                "mixed_precision_fit", shape, seq, torch.bfloat16, False,
                gen)
            for rec in check_attention_backward(
                    "mixed_precision_fit", shape, seq, torch.bfloat16,
                    False, gen):
                kernel_recs[rec["kernel"]] = rec

    hk.reset_launch_counts()
    mt.profiler.reset_step_counters()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cap_losses, eag_losses, f32_losses = [], [], []
    t0 = time.perf_counter()
    cap = _mp_fit(sym, it, params, ctx, True, opt, cap_losses)
    fit_s = time.perf_counter() - t0
    fused = mt.profiler.step_counters().get("fused_steps", 0)
    cap_launches = dict(hk.LAUNCHES)
    step = cap._fused_train_step
    if fused != steps or step is None or step.captured != on_card:
        raise AssertionError(f"fit took {fused} fused steps of {steps} "
                             "(captured on the card)")
    w, w32, mom = _mp_states(cap)
    if not all(t.dtype == torch.bfloat16 for t in w.values()) or \
            not all(t.dtype == torch.float32 for t in w32.values()):
        raise AssertionError("the weights are not bf16 with fp32 masters")
    eag = _mp_fit(sym, it, params, ctx, False, opt, eag_losses)
    ew, ew32, emom = _mp_states(eag)
    differ = [n for n in w if not (torch.equal(w[n], ew[n]) and
                                   torch.equal(w32[n], ew32[n]) and
                                   torch.equal(mom[n], emom[n]))]
    if differ or cap_losses != eag_losses:
        raise AssertionError(f"captured against eager per-parameter steps: "
                             f"{len(differ)} parameters differ ({differ[:4]})"
                             f", losses {cap_losses} / {eag_losses}")
    bf16_launches = dict(hk.LAUNCHES)
    del ew, ew32, emom
    if on_card:
        for name in names:
            if cap_launches[name] != n_layers * steps or \
                    bf16_launches[name] != 2 * n_layers * steps:
                raise AssertionError(f"{name}: {cap_launches[name]} launches "
                                     f"in the captured fit, "
                                     f"{bf16_launches[name]} in both; want "
                                     f"{n_layers} a step")
    f32 = _mp_fit(bert_mlm(mt.sym, **cfg), it, params, ctx, True, opt,
                  f32_losses)
    del f32
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cap_losses,
                                                      f32_losses))
    log(f"mixed precision: {steps} bf16 steps in {fit_s:.2f} s, captured "
        f"bit-equal to eager per-parameter steps (weights, fp32 masters, "
        f"momenta); losses bf16 {cap_losses}, fp32 {f32_losses}, worst "
        f"{loss_err:.3e} relative")
    if not loss_err <= MP_LOSS_TOL:
        raise AssertionError(f"bf16 loss {loss_err} from fp32's, above "
                             f"{MP_LOSS_TOL}")
    if on_card:
        torch.cuda.empty_cache()

    rec = {"slice": "bert_base_mlm_mixed_precision_fit", "card": card,
           "batch": batch, "seq": seq, "layers": n_layers,
           "dtype": "bfloat16", "optimizer": "sgd", "momentum": 0.9,
           "multi_precision": True, "steps": steps,
           "fused_steps": fused, "captured": bool(step.captured),
           "bf16_losses": cap_losses, "fp32_losses": f32_losses,
           "loss_rel_err_vs_fp32": loss_err,
           "captured_vs_eager": "bit-equal",
           "launches_captured_fit": {k: cap_launches[k] for k in names},
           "launches_bf16_fits": {k: bf16_launches[k] for k in names}}
    if on_card:
        it.reset()
        b = next(iter(it))
        # the instantiations by name in the trace of one replay: bf16
        # only, K1 as its wgmma kernel (the counts a step are LAUNCHES'
        # above: in a whole run CUPTI may drop records of a replay, 5 of 12
        # K1 once)
        kernels, host = replay_launches(lambda: cap.fused_step(b))
        got = {n: {dt: sum(c for k, c in kernels.items()
                           if _bf16_instantiation(n, k) == (dt == "bf16"))
                   for dt in ("bf16", "other")} for n in names}
        graphs = sum(v for k, v in host.items() if "GraphLaunch" in k)
        log(json.dumps({"replay": "mixed-precision fit step",
                        "kernel_launches_by_type": got,
                        "all_kernels": sum(kernels.values()),
                        "host_launch_calls": host}))
        if graphs < 1 or any(not g["bf16"] or g["other"]
                             for g in got.values()):
            raise AssertionError(f"one replay launched {got} in {graphs} "
                                 "graph launch(es), want bf16 K1-K3 only")
        rec["captured_ms"] = _step_ms(lambda: cap.fused_step(b), timed)
        with env(MXTPU_FUSED_STEP="0"):
            rec["eager_ms"] = _step_ms(lambda: (eag.forward_backward(b),
                                                eag.update()), timed)
        rec["tokens_per_s"] = batch * seq / (rec["captured_ms"] / 1e3)
        rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["kernels_bf16"] = {
            k: {f: r[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_share", "bound_by", "library_ms",
                                  "library_device_ms", "max_abs_err")}
            for k, r in kernel_recs.items()}
        log(f"mixed precision: step ms captured {rec['captured_ms']:.3f}, "
            f"eager per-parameter {rec['eager_ms']:.3f}")
    log(json.dumps(rec))
    del cap, eag
    return ({k: bf16_launches[k] for k in names + ("lstm_gates",)},
            kernel_recs)


def _potrf_grad(a, head, ctx, dtype):
    x = mt.nd.array(a, ctx=ctx, dtype=dtype)
    x.attach_grad()
    with mt.autograd.record():
        loss = (mt.nd.linalg_potrf(x) *
                mt.nd.array(head, ctx=ctx, dtype=dtype)).sum()
    loss.backward()
    return x.grad.data


def potrf_gradient(card, device="cuda"):
    """22b: linalg_potrf's gradient (the symmetric part's, as the JAX
    package's) on the card against the CPU path, and in float64 against
    central differences of the forward."""
    dev = torch.device(device)
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    rng = np.random.RandomState(SEED + 26)
    m = rng.randn(POTRF_N, POTRF_N)
    a = m @ m.T / POTRF_N + np.eye(POTRF_N)
    a[0, 1] += 0.25     # not symmetric: every element counts
    head = rng.randn(POTRF_N, POTRF_N)
    g = _potrf_grad(a, head, ctx, "float32").cpu()
    g_cpu = _potrf_grad(a, head, mt.cpu(), "float32")
    err_cpu = _rel(g, g_cpu.double())
    g64 = _potrf_grad(a, head, ctx, "float64")
    # central differences, every element at once: a batch of perturbed
    # copies through the card's float64 Cholesky of the symmetric part
    a_t = torch.tensor(a, dtype=torch.float64, device=dev)
    w_t = torch.tensor(head, dtype=torch.float64, device=dev)
    fd = torch.empty(POTRF_N * POTRF_N, dtype=torch.float64, device=dev)
    eye = torch.eye(POTRF_N * POTRF_N, dtype=torch.float64, device=dev)
    for lo in range(0, POTRF_N * POTRF_N, 512):
        d = eye[lo:lo + 512].reshape(-1, POTRF_N, POTRF_N) * POTRF_EPS
        f = [(torch.linalg.cholesky((x + x.transpose(-1, -2)) / 2) * w_t)
             .sum((-1, -2)) for x in (a_t + d, a_t - d)]
        fd[lo:lo + 512] = (f[0] - f[1]) / (2 * POTRF_EPS)
    fd = fd.reshape(POTRF_N, POTRF_N)
    err_fd = _rel(g64, fd)
    err_f32_fd = _rel(g.to(dev), fd)
    asym = _rel(g64, g64.transpose(0, 1))
    rec = {"check": "linalg_potrf_gradient", "card": card, "n": POTRF_N,
           "card_vs_cpu_rel_err": err_cpu, "float64_vs_fd_rel_err": err_fd,
           "fp32_vs_fd_rel_err": err_f32_fd, "asymmetry": asym}
    log(json.dumps(rec))
    if not (err_cpu <= POTRF_TOL and err_fd <= POTRF_FD_TOL
            and asym <= POTRF_FD_TOL):
        raise AssertionError(f"linalg_potrf's gradient: {rec}")
    return rec


def _mnist_mlp_sym():
    data = mt.sym.var("data")
    net = mt.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mt.sym.Activation(net, act_type="relu", name="relu1")
    net = mt.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mt.sym.Activation(net, act_type="relu", name="relu2")
    net = mt.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mt.sym.SoftmaxOutput(net, mt.sym.var("softmax_label"),
                                name="softmax")


def ftrl_fit(card, device="cuda"):
    """22b: Ftrl through ``Module.fit`` on MXNet's MNIST MLP: the captured
    step (on the card) bit-equal to the eager per-parameter one, the
    weights, z and n."""
    ctx = mt.gpu(0) if device == "cuda" else mt.cpu()
    cfg = FTRL_FIT
    rng = np.random.RandomState(SEED + 28)
    n = cfg["batch"] * cfg["batches"]
    x = rng.rand(n, cfg["features"]).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    sym = _mnist_mlp_sym()
    arg_shapes, _, _ = sym.infer_shape(data=(cfg["batch"], cfg["features"]))
    params = {nm: (0.05 * rng.randn(*shp)).astype(np.float32)
              for nm, shp in zip(sym.list_arguments(), arg_shapes)
              if nm not in ("data", "softmax_label")}
    it = mt.io.NDArrayIter(x, y, batch_size=cfg["batch"])
    mods = []
    for fused in (True, False):
        mt.profiler.reset_step_counters()
        mod = mt.mod.Module(sym, context=ctx)
        it.reset()
        with env(MXTPU_FUSED_STEP="1" if fused else "0"):
            mod.fit(it, num_epoch=1, optimizer="ftrl",
                    optimizer_params=dict(learning_rate=cfg["lr"],
                                          lamda1=cfg["lamda1"]),
                    arg_params={k: mt.nd.array(v, ctx=ctx)
                                for k, v in params.items()})
        took = mt.profiler.step_counters().get("fused_steps", 0)
        if took != (cfg["batches"] if fused else 0):
            raise AssertionError(f"Ftrl fit took {took} fused steps")
        mods.append(mod)
    cap, eag = mods
    if cap._fused_train_step.captured != (device == "cuda"):
        raise AssertionError("Ftrl's steps were not captured")
    differ = []
    for i, name in enumerate(cap._exec.arg_names):
        if name not in params:
            continue
        same = torch.equal(cap._exec.arg_dict[name].data,
                           eag._exec.arg_dict[name].data)
        for s, t in zip(cap._updater.states[i], eag._updater.states[i]):
            same = same and torch.equal(s.data, t.data)
        if not same:
            differ.append(name)
    zero = sum(int((cap._exec.arg_dict[k].data == 0).sum()) for k in params)
    rec = {"check": "ftrl_mnist_mlp_fit", "card": card,
           "steps": cfg["batches"], "captured": cap._fused_train_step.captured,
           "captured_vs_eager": "bit-equal" if not differ else differ,
           "zero_weights": zero}
    log(json.dumps(rec))
    if differ:
        raise AssertionError(f"Ftrl: captured against eager, {differ} differ")
    return rec


def phase_mixed_precision(card, device="cuda", fit=None):
    """Phase 22: 22a-b.  Returns 22a's launches and K1-K3's bf16
    records."""
    t0 = time.perf_counter()
    launches, kernel_recs = mixed_precision_fit(card, device, **(fit or {}))
    potrf_gradient(card, device)
    ftrl_fit(card, device)
    log(f"phase 22 in {time.perf_counter() - t0:.1f} s")
    return launches, kernel_recs


class _Background(threading.Thread):
    """``fn()`` on a thread of its own; `result` joins it and re-raises
    what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn = fn
        self._error = None
        self.start()

    def run(self):
        try:
            self._fn()
        except BaseException as e:  # handed to the joining thread
            self._error = e

    def result(self):
        self.join()
        if self._error is not None:
            raise self._error


def main():
    card = phase_device()
    # the kernels build (one nvcc a source) while the phases that launch
    # none of them run: Gluon, the zoo, the op surface, the data plane
    build = _Background(phase_build)
    phase_gluon(card)
    phase_zoo(card)
    ops_launches = phase_ops(card)
    data_launches = phase_data(card)
    build.result()
    k1 = phase_kernels()
    bwd = phase_backward_kernels()
    k4, _ = phase_lstm_kernels()
    serve_launches = phase_slice(card)
    train_launches = phase_train(card)
    lstm_launches = phase_lstm_serving(card)
    fit_launches = phase_fit(card)
    rnn_launches = phase_rnn(card)
    state_launches = phase_state(card)
    cf_launches = phase_control_flow(card)
    plane_launches, served = phase_serving(card, keep=True)
    gen_launches = phase_generation(card, served)
    ctx_launches = phase_contexts(card)
    dist_launches = phase_distributed(card)
    spmd_launches = phase_spmd(card)
    elastic_launches = phase_elastic(card)
    phase_int8(card)
    phase_contrib(card)
    phase_front_end(card)
    mp_launches, mp_kernels = phase_mixed_precision(card)
    leaked = [m for m in ("jax", "mxnet_tpu") if m in sys.modules]
    if leaked:
        raise SystemExit(f"chip_smoke: the port imported {leaked}")
    log(f"launches: serving {serve_launches}, training {train_launches}, "
        f"LSTM serving {lstm_launches}, fit {fit_launches}, RNN "
        f"{rnn_launches}, state {state_launches}, ops {ops_launches}, "
        f"data {data_launches}, control flow {cf_launches}, serving plane "
        f"{plane_launches}, generation {gen_launches}, contexts "
        f"{ctx_launches}, distributed {dist_launches}, spmd "
        f"{spmd_launches}, elastic {elastic_launches}, mixed precision "
        f"{mp_launches}")
    def entry(name, source, line, launches, rec):
        return {"name": name, "route": "cuda",
                "source": f"mxnet_tpu_torch/csrc/{source}.cu",
                "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
                "launches": launches,
                **{f: rec[f] for f in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}

    # fp32 K1 (its three-pass TF32 wgmma kernel) and K2-K3 (mma.sync) on
    # every path but 22a; bf16 K1-K3 (their wgmma kernels) on 22a's
    kernels = [entry(
        "flash_attn_fwd_tf32", "flash_attn_fwd", 92,
        serve_launches["flash_attn_fwd"] + train_launches["flash_attn_fwd"] +
        fit_launches["flash_attn_fwd"] + state_launches["flash_attn_fwd"] +
        plane_launches["flash_attn_fwd"] + gen_launches["flash_attn_fwd"] +
        ctx_launches["flash_attn_fwd"] + dist_launches["flash_attn_fwd"] +
        spmd_launches["flash_attn_fwd"] + elastic_launches["flash_attn_fwd"],
        k1)]
    for name, line in (("flash_attn_bwd_dq", 141),
                       ("flash_attn_bwd_dkv", 184)):
        kernels.append(entry(
            name, "flash_attn_bwd", line,
            train_launches[name] + fit_launches[name] +
            state_launches[name] + ctx_launches[name] +
            dist_launches[name] + spmd_launches[name] +
            elastic_launches[name], bwd[name]))
    for name, source, line in (("flash_attn_fwd", "flash_attn_fwd", 92),
                               ("flash_attn_bwd_dq", "flash_attn_bwd", 141),
                               ("flash_attn_bwd_dkv", "flash_attn_bwd", 184)):
        kernels.append(entry(name + "_wgmma", source, line,
                             mp_launches[name], mp_kernels[name]))
    kernels.append(entry(
        "lstm_gates", "lstm_gates", 452,
        lstm_launches["lstm_gates"] + rnn_launches["lstm_gates"] +
        cf_launches["lstm_gates"] + gen_launches["lstm_gates"], k4))
    if any(k["launches"] == 0 for k in kernels):
        raise SystemExit("chip_smoke: a kernel of the path never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
