#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``simple_tensorflow_tpu_torch``) on one
NVIDIA GPU and check every kernel of its serving and training paths
(causal LM and ResNet-50) and of its TF-1 front end (``stf.Session``
training the MNIST convnet, the seq2seq transformer, the causal LM,
ResNet-50 and BERT-base, with and without per-layer recompute, the two
RNN graphs on ``stf.scan``: the PTB LSTM and the attention seq2seq, the
transformer's beam search on ``stf.while_loop``, and BERT and the MNIST
journey fed by ``stf.data`` from TFRecord shards).

    python3 chip_smoke.py [--serving | --lc-attribution | --seq2seq]

``--serving`` runs only phase 3 (no kernel phases, no ``{"ok": ...}``
line) and asks its traces for no kernel by name, so this script placed
beside another tree's package measures that tree's serving path.
``--lc-attribution`` runs only phase 15's bf16 check of the long-context
LM cut to 2 layers (no ``{"ok": ...}`` line), adding the same run with the
flash path alone on its plain versions: how much of the check's gaps the
flash kernels own.

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written CUDA kernels from ``simple_tensorflow_tpu_torch/csrc/``
   with ``nvcc`` for ``sm_90a``.
2. Kernel phases: each kernel against its plain PyTorch version on the
   card, at the serving and training paths' shapes (f32: rtol 1e-5, atol
   1e-5; bf16: 2e-2; QuantMatMul and Adam bit-exact; the training
   kernels' outputs within a bound scaled by the largest reference value:
   f32 1e-5 for forward values and 1e-4 for gradients and column sums,
   bf16 2e-2; the xent backward, whose values span many orders of
   magnitude, element by element within 1e-5 (f32) or 1e-2 (bf16) of
   each value plus that times the mean magnitude, a limit the phase shows
   failing planted faults; the dropout kernels, whose masks are integer
   functions of a seed or key, bit-exact, with 0 mask mismatches on x =
   ones and a planted fault (another salt, key or seed) that must fail;
   Momentum bit-exact over ResNet-50's two flat groups, plain and
   Nesterov, from non-zero accumulators, with ``mu`` one ulp off and the
   Nesterov flag flipped as planted faults that must differ; the xent
   kernels also at ResNet-50's f32 256 x 1000 logits),
   with its device time, its bound (the larger of bytes over 3.35 TB/s
   and operations over the peak of their type), the plain
   version's time and one PyTorch library call's time as a yardstick
   (never called by the port). Times come from CUDA graphs of
   back-to-back launches timed with CUDA events, over input copies that
   together exceed the 50 MB L2 where the inputs are large, so large
   inputs are read cold as the paths read them; library calls that run
   an optimizer or PyTorch's dropout RNG are timed with CUDA events around
   repeated calls instead. The flash backward kernels' yardstick is SDPA's
   backward alone (on a saved forward, one call computing dq, dk and dv:
   its flash backward in bf16, its memory-efficient backward in f32),
   graph-timed, beside SDPA forward + backward captured in a graph; the
   f32 dK/dV + dQ print their sum beside it. The f32 dK/dV and dQ
   (``csrc/flash_bwd_f32.cu``) also run at the long-context f32 check's
   shape (``@f32_d128``: 8 heads of 2048, D 128, causal) and the
   transformer f32 check's (``@f32_s64``: 128 heads of 64, the pad bias
   with a row all padding, dropout 0.1), each row counting the launches
   of its paths (``F32_BWD_PATHS``), and two planted faults of the f32
   backward (``F32_MUTANTS``: dK/dV without its last query tile, dQ
   without the bias) must fail their limits. The bf16 flash forward's dropout mask is
   also read off its output (q = 0, v one-hot) at the training shape, and
   the bf16 backward's off each of dV, dK and dQ (``keep_mask_readoff``):
   0 mismatches with the plain mask, and the next seed's mask must differ.
   DecodeAttention runs at every decode bucket (Kq = 1, B = 1, 4, 16,
   each with the splits of the cache axis it takes) and a ragged L in
   f32 and bf16, beside SDPA with the same mask;
   QuantMatMul runs on a K-major weight at m = 1, 4, 16 and 32 (a
   row-major weight must be refused);
   the LayerNorm forward on both of its paths (the vector path at n =
   1024, f32 and bf16, 16 to 4096 rows, the row statistics checked at
   4096; the general one at n = 1000), the backward on both of its paths
   (the vector path at n = 1024, the general one at n = 1000 and forced
   at 1024), its dgamma and dbeta bitwise equal over two runs; the fused
   dropout-residual (K4) on both of its paths at four shapes; the threefry
   Dropout forward (values and keep bits) and its backward from those
   bits at both training shapes, the next key's values, bits and backward
   as planted faults. The registers, static shared memory and spills
   ``ptxas`` reports for the tensor-core backward kernels, the f32 flash
   forward, dK/dV and dQ, the xent forward, QuantMatMul, the LayerNorm
   kernels, the Kq = 1 DecodeAttention and the dropout kernels are printed
   after the build, and the f32 flash kernels' tiles and dynamic shared
   memory at their paths' shapes. The redesigned kernels (the Dropout and K4) and
   those that must hold their times get one line each at the end: the
   time before the redesign (``EARLIER_MS``), this run's, the bound and
   the library call's; the LM training phase prints its device time a
   step beside the one before and one step's peak memory at both dropout
   rates, and its profiler windows must show both LayerNorm kernels and,
   at dropout 0.1, the three dropout kernels on their vector paths.
3. Serving phase: ``GenerativeEngine`` over ``CausalLMGenerativeModel``
   at ``TransformerConfig.big()`` width (6 layers, d_model 1024, 16
   heads, vocab 32768) with seeded random weights, 12 requests of 17-96
   prompt tokens (four share a 32-token prefix), 24 new tokens each,
   once with the f32 logits head and once with ``int8=True``. Launch
   counters are zeroed just before each run and read just after; every
   kernel of the run must have launched. Every emitted token is checked,
   teacher-forced on the engine's own stream, against a plain full
   re-forward on the card (PyTorch ops only, no kernel). Then 16 more
   requests fill decode bucket 16 and a ``torch.profiler`` window over
   ``TRACE_STEPS`` engine steps gives the device ms a decode step beside
   the host p50 step, and the top kernels. The model captures every
   decode and prefill bucket as a CUDA graph when it is built
   (``aot_warmup``, the default); its launches count through the
   replays. Then, per head, the model with ``aot_warmup`` on and off on
   one fixed script of prefill and decode calls (every bucket, partial
   buckets, a small batch right after a larger one): tokens int-exact
   and log-probs bit-identical. Last, the f32 head served with
   ``aot_warmup=False`` (eager dispatch) on the same prompts, its
   tokens/s, p50 decode step, p50 time to first token and traced
   bucket-16 step printed beside the graphs'.
4. Training phase: the eager trainer ``causal_lm_trainer`` at
   ``TransformerConfig.big()``,
   batch 16 x 256, weights from ``init_params(seed=0)``. At dropout 0 and
   at the shipped 0.1: one f32 step through the kernels against the same
   step through the plain versions (a trainer built with ``plain=True``,
   drawing the same dropout masks): the loss within rtol 1e-5, every
   parameter's gradient within relative norm 1e-3 (2e-3 at dropout 0.1;
   the attention key biases, whose exact gradient is zero, below 1e-5 of
   the key kernel's gradient norm on both sides). That limit covers the
   few FFN-input units whose ReLU gate flips on f32 roundoff between the
   runs, which the phase counts; with the plain run's ReLU masks shared
   the limit is
   1e-4, and two planted faults (dQ x 1.001, the xent backward without
   smoothing) must fail it. Then ``TRAIN_STEPS`` bf16 steps of
   ``TransformerConfig.big()`` as shipped (dropout 0.1) on one repeated
   batch with a ``TRAIN_WARMUP``-step noam warm-up: every loss finite, the
   mean of the last ``LOSS_MEAN_OF`` below the mean of the first ones and
   the last loss below the first (dropout makes the loss noisy from step
   to step), the exact launches per step, the p50 step time, tokens/s,
   the kernels' device time per step, the host time to derive a step's
   dropout keys and seeds, and the peak device memory. Interleaved step
   by step with it, the same window at dropout 0 (its loss must fall at
   every step), for the cost of dropout in one call: the p50 steps and
   the device time a step from a profiler window of each.

5. ResNet-50 phase: the eager trainer ``resnet50_trainer`` (batch 256 x
   224^2, 1000
   classes, bf16, lr 0.1, Momentum 0.9, weight decay 1e-4) with weights
   from ``init_resnet_params(seed=0)`` on one repeated
   ``synthetic_imagenet`` batch (seed 0). First ``RESNET_F32_STEPS`` f32
   steps at ``RESNET_F32_B`` x 224^2 through the kernels against the same
   steps through the plain versions, cuDNN deterministic: each loss
   within rtol 1e-5, every parameter and the accumulators within the
   ``RESNET_*_TOL`` relative norms, which two planted Momentum faults must
   fail. Then ``RESNET_STEPS`` bf16 steps at full size: every loss finite,
   the mean of steps 5-8 below that of steps 1-4 (the recipe overshoots on
   a repeated batch later in the window), exactly
   2 Momentum and 1 + 1 xent launches a step; the p50 step, images/s and
   its share of the bf16 peak at 3 x ``resnet_flops_per_image``, the
   peak memory, and a profiler window of 3 steps with its top kernels.

6. Session phase (the TF-1 front end): ``models/mnist.py`` built with the
   port's ``stf`` API and run by ``stf.Session`` on the card. First the
   path's kernels at its shapes against their plain versions (the xent
   forward and backward at f32 512 x 10, Adam over the convnet's f32
   group of 3,274,634 parameters, bit-exact, the threefry Dropout at f32
   (512, 1024), keep_prob 0.5, bit-exact), each with its time, bound and
   library call. Then ``SESSION_CHECK_STEPS`` ``convnet_model`` steps
   (batch 512, f32, keep_prob 0.5) through the kernels against the same
   steps under ``fused_ops.plain_versions()``, cuDNN deterministic: each
   loss within rtol 1e-5, the first step's Dropout output equal, every
   step's masks equal on live units, every variable and Adam slot within
   relative norm 1e-5; Adam's beta1 x (1 + 1e-4) and the Dropout op's
   stream id + 1 are planted faults that must fail (these steps
   dispatch eagerly, ``_capture`` off). The Dropout forward's device-key
   entry (the key read through a pointer, as a captured step launches
   it) is held bit for bit against the launch-argument entry and the
   plain version at the MNIST shape and at both training shapes. Then the
   Session's CUDA graphs: ``GRAPH_CHECK_STEPS`` convnet steps of a
   Session that captures its step (step 1 eager, step 2 captured, then
   replays) against the same steps dispatched eagerly from the same run
   counters: losses, Dropout outputs, every variable and Adam slot
   bit-identical, exactly one capture; a planted fault (the key buffer
   not refilled before the replays) must change the Dropout outputs.
   Then two windows of ``SESSION_STEPS`` ``Session.run([train_op,
   loss])`` steps on one repeated ``synthetic_mnist(512, seed=0)`` batch
   fed as numpy, the graph one first, then the eager one: the loss falls,
   exactly 1 + 1 xent, 1 Adam and 1 + 1 Dropout launches a step (in the
   graph window the first step's Dropout is the launch-argument entry,
   the other 15 the device-key entry, all counted through the replays),
   no plan-cache miss and no further capture after the first step; each
   window's p50 step, images/s, the device ms a step from a
   ``torch.profiler`` window of 3 steps, the host ms a step (p50 minus
   device) and the host time by kind (op dispatch, autograd, feeds; for
   the graph, staging and replay). Last, ``softmax_model``
   (GradientDescent at ``SOFTMAX_LR``) for ``SESSION_STEPS`` steps, its
   loss falling at every step.
7. Transformer Session phase: ``models/transformer.py``
   ``transformer_train_model`` (the reference's headline model) built with
   the port's ``stf`` API and trained by ``stf.Session``. First its new
   kernel shapes against their plain versions: the bf16 flash kernels at
   64 x 16 heads of S = 64, D = 64, non-causal with a pad bias, dropout
   0.1, through the launch-argument entry and the seed-pointer entry
   (bit-identical; both timed in the same call; the next seed's mask must
   fail), the dropout-residual kernel and its dx through the seed-pointer
   entry at bf16 4096 x 1024 (bit-exact, beside the launch-argument
   entry's time), Adam over the transformer's bf16 group (176,295,936
   bf16 parameters, f32 m and v). Then ``TF_CHECK_STEPS`` f32 steps at
   ``TransformerConfig.big()`` widths with the depth cut to
   ``TF_CHECK_LAYERS`` + ``TF_CHECK_LAYERS`` layers, batch ``TF_CHECK_B``
   x 64 / 64 with pads in src and tgt, dropout 0.1, through the kernels
   against the same steps under ``plain_versions()`` (eager): the losses
   within rtol 1e-5, the parameters (as the flat vector the Adam kernel
   updates) and the beta powers within relative norm 1e-4, the flat Adam
   slots (gradient averages) within the LM check's f32 gradient limit at
   dropout 0.1 (2e-3: ReLU gates that flip on roundoff), and a planted
   fault (the decoder's first cross-attention drawn
   with its self-attention's seed) that must fail. Then the shipped config uncut (bf16, 6 + 6 layers, batch 64, 64
   / 64, ``warmup_steps`` ``TF_WARMUP``) on one repeated
   ``synthetic_wmt_batch(64, 64, 64, seed=0)``: ``TF_GRAPH_STEPS`` steps
   captured and replayed against the same steps dispatched eagerly,
   losses, the first encoder flash and dropout-residual outputs, every
   variable and Adam slot bit-identical, one capture; replays whose seed
   buffer is not refilled (a planted fault) must change the flash and
   dropout-residual outputs. Last, two windows of ``TF_STEPS``
   ``Session.run([loss, train_op])`` steps, the graph one first: every
   loss finite and the mean of steps 9-16 below that of steps 1-8; the
   exact launches a step (18 of each flash kernel, 30 + 30 LayerNorm, 1 +
   1 xent, 18 + 18 dropout-residual, 14 + 14 Dropout, 2 Adam; in the graph
   window step 1 through the launch-argument entries and the 15 replays
   through the seed-pointer and device-key ones); one capture and no
   plan-cache miss after step 1; each window's p50 step, target tokens/s,
   source + target tokens/s and the share of the dense bf16 peak at 3 x
   ``transformer_flops_per_token`` a token (the reference's count), the
   device ms a step from a ``torch.profiler`` window of 3 steps, the host
   ms a step and the host time by kind.

7b. Training-loop phase: the same model and batch (bf16, 6 + 6 layers,
   dropout 0.1) with ``stf.summary.scalar("loss", loss)`` under graph
   seed 1, through the TF-1 training loop, all under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the ops
   it warns about are printed). First 17 sequential captured
   ``Session.run([train_op, loss])`` steps, the reference. Run A:
   ``MonitoredTrainingSession(checkpoint_dir, save_checkpoint_steps=16,
   save_summaries_steps=4, log_step_count_steps=4, loop_fusion_steps=4,
   StopAtStepHook(last_step=16), Saver(max_to_keep=2))`` driven by
   ``run_steps([train_op, loss, global_step], 4)`` until it stops: the
   window sizes, checkpoint steps, summary steps of the JAX hooks
   (``LOOP_WINDOWS``, ``LOOP_CKPT_STEPS``; the CPU tests hold the port's
   hooks to JAX's), every fetched loss and the step-17 checkpoint
   (every variable and Adam slot) bit-identical to the sequential runs,
   the event files read back with the loss and ``global_step/sec``. Then
   4 ``run_steps`` windows of 4 (``"stacked"``) from the initializer:
   each window n replays of the compiled step; the 16 losses and the
   state bit-identical to the sequential runs, launches exactly one dry
   warm-up plus 16 x ``tf_per_step``, no fallback; the same windows with
   the key and seed buffers not refilled between replays (a planted
   fault) must differ; a restore of A's step-17 checkpoint into that live
   session (in place: no capture anew) and its seconds; the p50 ms a
   step of windows of 4 against that of the captured per-step runs, both
   in this process; a ``torch.profiler`` trace of one window and of 4
   runs (device and host ms a step, busy share, the longest device idle
   gap; the one between two replays of the window must stay under
   ``LOOP_GAP_MS``, in the best of up to ``LOOP_TRACES`` traces, as a
   trace can drop kernel records). Run B stops at step 8;
   run C, a new graph and session on B's directory, resumes from B's last
   checkpoint and runs to the end: C's losses and step-17 checkpoint
   bit-identical to A's and the sequential runs'. A copy of a checkpoint
   with one payload byte flipped must raise ``DataLossError``. The hook's
   last save (async, as the JAX hook's): its step-loop cost, the writer's
   seconds (D2H read, npz and sha256, commit) and bytes, and the captures
   over the phase, are printed. The checkpoints live in a
   temporary directory, removed at the end.

8. Causal-LM Session phase: ``models/causal_lm.py``
   ``causal_lm_train_model`` built with the port's ``stf`` API and trained
   by ``stf.Session`` at ``TransformerConfig.big()``, batch 16 x 256,
   bf16, dropout 0.1, ``warmup_steps`` ``TRAIN_WARMUP`` (the eager LM
   smoke's configuration). First the causal flash kernels at 16 x 16
   heads of S = 256 through their seed-pointer entries, bit-identical to
   the launch-argument entries and timed beside them. Then
   ``LM_CHECK_STEPS`` f32 steps with the depth cut to ``LM_CHECK_LAYERS``
   layers through the kernels against the same steps under
   ``plain_versions()``: losses within rtol 1e-5, the flat parameters and
   beta powers within 1e-4, the flat Adam slots within the f32 gradient
   limit at dropout 0.1, and a planted fault (layer 1's flash drawn with
   layer 0's seed) that must fail. Then ``LM_GRAPH_STEPS`` bf16 steps
   captured and replayed against eager dispatch, bit-identical, with
   stale-seed replays as a planted fault. Last, a graph and an eager
   window of ``LM_STEPS`` steps: exact launches a step (6 of each flash
   kernel, 12 + 12 LayerNorm, 6 + 6 dropout-residual, 7 + 7 Dropout, 1 + 1
   xent, 2 Adam), p50, tokens/s, device and host ms a step, and the device
   ms beside the eager ``CausalLMTrainer``'s from phase 4.
9. ResNet Session phase: ``models/resnet.py`` ``resnet50_train_model()``
   as shipped (v1.5, 256 x 224^2, bf16, lr 0.1, Momentum 0.9, weight decay
   1e-4) trained by ``stf.Session`` on one ``synthetic_imagenet(256)``
   batch fed as numpy. First ``RESNET_F32_STEPS`` f32 steps at
   ``RESNET_F32_B`` x 224^2 through the kernels against the same steps
   under ``plain_versions()``, cuDNN deterministic, held to phase 5's
   limits, with two planted faults in the ``FusedMomentumUpdate`` lowering
   (``mu`` x 0.5, Nesterov on) that must fail. Then ``RS_GRAPH_STEPS``
   bf16 steps captured against eager dispatch with cuDNN deterministic,
   bit-identical, the moving statistics untouched by ``train_op`` (the
   same comparison without cuDNN's determinism printed beside it). Then a
   graph and an eager window of ``RS_STEPS`` steps: every loss finite,
   the mean of steps 5-8 below that of steps 1-4, exactly 2 Momentum and 1
   + 1 xent launches a step, p50, images/s, the share of the bf16 peak at
   3 x ``resnet_flops_per_image``, device and host ms a step and the peak
   memory beside the eager trainer's. Last, Momentum at the Session's two
   flat groups and the xent at f32 256 x 1000, against their plain
   versions, with their times, bounds and library calls.
10. BERT phase: ``models/bert.py`` ``bert_pretrain_model`` at
   ``BertConfig.base()`` as ``bench.py`` measures it (bf16, batch 32 x
   512, 76 predictions, ``use_input_mask``, Adam lr 1e-4), fed
   ``synthetic_pretrain_batch(..., input_mask=True)`` (row lengths from
   the seed in [384, 512]). First its kernel shapes against their plain
   versions: the bf16 flash kernels at 32 x 12 heads of S = 512 with the
   batch's key bias and dropout 0.1 through both entries; LayerNorm at n =
   768 (16384 and 2432 rows) on its vector path, forward and backward,
   beside the general path forced on the same inputs and
   ``F.layer_norm``/aten; the MLM xent at bf16 2432 x 30522 and the NSP
   xent at f32 32 x 2; Adam over BERT's two groups (85,608,192 bf16 Dense
   parameters, 24,498,236 f32); the threefry Dropout at bf16 (32, 512,
   768) with its device-key entry and backward. Then ``BERT_CHECK_STEPS``
   f32 steps at ``BertConfig.base()`` widths cut to ``BERT_CHECK_LAYERS``
   layers, batch 4 x 128, through the kernels against
   ``plain_versions()`` (the transformer check's limits; a seed planted on
   layer 1's flash op must fail), and the same size with ``recompute=True``
   rematerializing against ``function.without_rematerialization()`` (the
   same limits; a re-forward that draws fresh dropout seeds, planted, must
   fail). Then, for ``recompute`` False and True: ``BERT_GRAPH_STEPS``
   steps captured against eager, bit for bit (stale seeds planted must
   differ); a graph and an eager window of ``BERT_STEPS`` steps (exact
   launches a step: 12 of each flash kernel, 26 + 26 LayerNorm, 25 + 25
   Dropout, 2 + 2 xent, 2 Adam; with recompute 24 flash forwards, 50
   LayerNorm and 49 Dropout forwards), p50, tokens/s (the bench's count),
   the share of the dense bf16 peak at 3 x ``bert_flops_per_token``,
   device and host ms a step, the memory, each figure counted above what
   the process held just before the window's Session was built (the peak
   over the first two steps and over the rest, what stays allocated
   between steps, what is reserved: with a captured step, its pool). Last
   ``recompute=True`` at batch 40 (the bench's ``recompute_bigger_batch``):
   a graph window's tokens/s and memory. Recompute must lower an eager
   step's peak and a captured step's reserved memory at batch 32.
11. RNN phase: ``models/ptb_lstm.py`` ``ptb_lm_model`` at
   ``PTBConfig.medium()`` as shipped (vocab 10000, hidden 650, 2 layers,
   35 steps, keep_prob 0.5, f32, clip 5.0, SGD lr 1.0) at batch
   ``PTB_B``, truncated BPTT (the LSTM state fetched from each run and fed
   to the next), and ``models/rnn_seq2seq.py`` ``seq2seq_model`` at
   ``Seq2SeqConfig()`` (hidden 64, vocab 120, lengths 12, Adam 0.01) at
   batch ``S2S_B``, fetching the greedy ``decoded`` ids, both under graph
   seed 1 on one repeated synthetic batch. First their kernel shapes
   against the plain versions: the xent at f32 700 x 10000 and 768 x 120
   (seq2seq's [64, 12, 120] logits as rows), the Dropout at f32 (20,
   650), a body Dropout's (70 a run, through the device-key entry in a
   replay), and (20, 35, 650), the embedding's, keep_prob 0.5, both
   entries and the backward from the bits, 0 mismatches on x = ones and
   the next key as a planted fault; Adam over seq2seq's f32 group of
   113,784. Then ``RNN_CHECK_STEPS`` f32 PTB runs through the kernels
   against ``plain_versions()`` (losses within ``RNN_TOL``, fetched states
   and every variable within ``RNN_TOL`` by relative norm, the embedding
   mask equal, exactly 71 + 71 Dropout and 1 + 1 xent launches a run: the
   probe cell that ``dynamic_rnn`` builds outside its loop stays out of
   the plan), with two planted faults that must fail (a body Dropout
   drawing a fresh key at every step; SGD at lr x 0.5 through
   ``lr_update``); ``RNN_GRAPH_STEPS`` runs captured against eager, bit
   for bit, stale keys caught; ``lr_update`` to ``PTB_NEW_LR`` scaling the
   next step; a graph and an eager window of ``RNN_STEPS`` runs (exact
   launches, the mean loss of the last 4 below that of the first 4, p50,
   words/s, device and host ms, busy share, device operations a run,
   memory). The same for seq2seq (the f32 check with Adam's beta1 x (1 +
   1e-4) planted, captured vs eager with ``decoded`` int-exact, the two
   windows in target tokens/s), then ``S2S_TRAIN_STEPS`` captured steps
   after which the loss is below half its start and the greedy decode is
   right on more than half of the real target tokens.
12. Beam phase: TF-1 control flow on the card and the reference's
   inference path, ``models/transformer.py`` ``beam_search_decode`` (one
   ``stf.while_loop``) at ``TransformerConfig.big()``, batch ``BEAM_B`` x
   beam ``BEAM_K``, a source of ``BEAM_SRC`` tokens whose last
   ``BEAM_PADS`` are padding, weights from the initializers under graph
   seed 1. First K6 (the single-query DecodeAttention) at the beam shapes
   (B = 16, L = 64, 16 x 64 heads; self-attention at lengths 1, 32 and
   64, the cross-attention with the pad bias; f32 and bf16) against its
   plain version, each with a planted fault that must fail (the reference
   at lengths - 1, or without its bias), its bound from the positions the
   lengths admit and SDPA's time; the conditional-node setter
   (``csrc/control_flow.cu``) against the host read of its predicates
   over 64 IF nodes. Then a control-flow probe (a data-dependent
   ``while_loop``, a ``cond`` whose untaken branch is NaN, the gradient of
   a bounded loop whose body is NaN past its exit), eager against
   captured, bit for bit, no host predicate read in a replay. Then f32 at
   ``decode_len`` ``BEAM_LEN``: the KV-cached search against the naive
   re-forward in one graph, ids int-exact and scores within 1e-4, which a
   planted cache fault (lengths ``i`` for ``i + 1``) must fail. Then the
   bf16 cached search: an eager and a captured window of ``BEAM_RUNS``
   decodes, bit for bit equal, column 0 EOS, exactly 2 x 6 x 63
   DecodeAttention launches and, eager, 64 host predicate reads a decode
   (captured: none), p50, output tokens/s (batch x (decode_len - 1) a
   decode), device ms and operations a decode, the captured graph's nodes
   (its WHILE body's included); last the default ``decode_len``
   (``cfg.max_len`` = 256: 255 iterations) captured and replayed, each
   replay equal to the eager decode.
13. Data phase: the input pipeline. 512 BERT pretraining Examples
   (``synthetic_pretrain_batch(32, 512, 76, input_mask=True)``, seeds
   0-15) written as 8 TFRecord shards (``bert.write_pretrain_records``);
   the stream ``TFRecordDataset(files, num_parallel_reads=AUTOTUNE)
   .repeat().batch(32).parse_example(spec)``, the int64 features cast to
   int32, ``.prefetch_to_device(2, superbatch=4)`` for two epochs, every
   superbatch int-exact against the arrays written, the native parser's
   batch count above 0 and the Python parser's 0 (a native runtime that
   does not build fails the phase); the same with each copy queued behind
   a GPU sleep on the pipeline's stream (still exact), and with slots
   reused without waiting for their copies (a planted fault that must
   corrupt a superbatch). The pipeline alone in records/s, the sequential
   chain against the parallel one as ``bench.py _measure_input_pipeline``
   builds them. Then BERT-base as phase 10 trains it (bf16, 32 x 512,
   dropout 0.1, Adam lr 1e-4), ``DATA_WINDOWS`` ``run_steps`` windows of 4
   (captured, ``"stacked"``), fed the shuffled training stream's
   superbatches by a one-shot iterator (``prefetch_to_device``, a
   device-to-device copy into the window's buffers), a ``train.Saver``
   checkpoint after window 4; the same windows fed the same superbatches
   as numpy in a second Session, and in a third fed by the pipeline with
   every superbatch taken before the first window (no pipeline thread
   running during the windows): losses, every variable and Adam slot bit
   for bit, exact launches; p50 a step, tokens/s, device and host ms a
   step, the busy share and the longest device idle gap of a traced
   window, for each. A new graph and Session restored from the checkpoint
   (its iterator at position 4) runs windows 5 on to the uninterrupted
   run's losses and state bit for bit; the restore with its position
   reset to 0 and the numpy batches fed one step shifted are planted
   faults that must differ. Last the port's
   ``examples/train_mnist_end_to_end.py`` steps 1-4
   (``models.mnist.records_model``): ``get_next()`` in the graph as the
   host stage of a captured step under ``MonitoredTrainingSession`` with
   checkpoints and summaries, 40 steps against 20 and a resumed 20 whose
   losses equal the uninterrupted run's bit for bit (cuDNN
   deterministic), the resumed session at the saved step and iterator
   position, one xent forward and backward and one Adam launch a step.
14. Checkpoint and numerics phase: phase 7b's transformer cell (bf16,
   dropout 0.1, graph seed 1, windows of 4, deterministic algorithms).
   One Session runs windows with the numerics plane off and in
   ``metrics`` (the process default; both plans captured), alternating:
   their p50 steps, the taps a step and the ``numeric_summary`` launches
   (one a step); the tapped tensors of the first metrics step, and a copy
   of one with NaN, +-Inf and zeros planted, hold the kernel to its plain
   version (counts and max_abs exact, l2_norm and zero_fraction within
   1e-6, the same bits twice), and a max_abs over nonfinite values (a
   planted fault built from the plain version) must fail. Then in that
   Session a blocking save, an async save with the writer's copy to the
   host not waiting for the snapshot's event (a planted fault: the
   snapshot held back ~3 s behind a GPU sleep; its data file must differ)
   and an async save (held back ~0.1 s; its data file's sha256 must equal
   the blocking one's): the blocking stall against the async save's
   step-loop cost, the writer's seconds, the device memory during the
   write, the p50 step of windows while the writer works against after.
   Run A: ``MonitoredTrainingSession`` (numerics ``metrics``, async
   ``CheckpointSaverHook`` every 32 steps, so at step 0 and at the end,
   ``StopAtStepHook(last_step=24)``). Run B: the same with a
   ``PreemptionHandler(manager=)`` and a SIGTERM after step 12: it
   drains, saves and stops. C: a new graph
   ``restore_or_initialize``-d from B's directory trains on to A's last
   step, bit for bit A's state; D: B's checkpoint's ``.meta`` imported
   into a fresh graph and restored trains one window bit for bit as C's
   first. Last a step poisoned by a ``Log`` of -1: ``raise`` names the
   tap's op, ``dump`` the first bad op ``poison_log``, in a captured run
   and in a window (index 2).
15. The static cost model and the single-card graphs: what
   ``recompute="auto"`` resolves to for the five graph entry points at
   the smoke's cells (the graphs built, no step run). The long-context
   LM's kernels at ``LongContextConfig()`` (d_model 1024, 8 heads of 128,
   vocab 32000), seq 32768, bf16: the flash forward, dK/dV and dQ at (8,
   32768, 128) causal, rate 0 (all three on the wgmma kernels), against
   their plain versions a head at a time (bf16 2e-2 scaled and each block
   of 128 rows within 2e-2 of its norm, lse 1e-5; planted, these must
   fail: the non-causal kernel, and the wgmma pipelines built from copies
   of their sources with the diagonal key tile of each query tile but the
   first, the diagonal query sub-tile of each key tile, or the last,
   skipped in the forward and dK/dV, and dQ's two diagonal key tiles or
   its first key tile skipped), timed beside SDPA
   ``is_causal=True`` (the same
   function here), with the TFLOP/s and the share of the bound; the
   wgmma kernels at a ragged length (S = 4000 - 40, 2 x 4 heads,
   non-causal with a key bias, rate 0 and 0.1) against their plain
   versions; the LayerNorm at 32768 x 1024; the xent at bf16 32768 x
   32000; Adam over the model's two flat groups (bit-exact).
   ``lm_train_model`` cut to 2 layers and seq 2048, f32 and bf16: 2 steps
   through the kernels against ``plain_versions()`` (losses rtol 1e-5,
   variables and slots 1e-4 by relative norm, exact launches; the causal
   flag dropped in the ``RingAttention`` lowering, planted, must fail).
   At the full
   cell (batch 1, seq 32768, 8 layers, bf16, Adam 3e-4): the cost model's
   estimate, 3 runs captured (warm-up, capture, replay) against eager bit
   for bit, ``run_steps`` windows of 4 (p50 a step, tokens/s, device and
   host ms, busy share, peak memory, the share of the dense bf16 peak at
   3 x the cost model's forward FLOPs and with the attention FLOPs
   counted from the shapes added), and a ``MonitoredTrainingSession``
   whose ``StepCounterHook.last_perf`` must equal
   ``cost_model.predicted_vs_measured`` at its measured seconds. word2vec
   at ``skipgram_model()``'s defaults (vocab 50000, 128 wide, batch 128,
   64 sampled, SGD 1.0): 3 runs captured against eager bit for bit (loss,
   sampled ids, variables), new ids every run; the sampler drawing from a
   host key taken once, planted, must fail; windows. DLRM at
   ``dlrm_model()``'s defaults on Zipf batches: 2 SGD steps through the
   fused lookup against a plain gather (1e-6; the scatter-add dropping
   duplicate ids, planted, must fail), 3 runs captured against eager bit
   for bit, windows.
16. Encoder-decoder serving: ``GenerativeEngine`` over
   ``TransformerGenerativeModel(TransformerConfig.big())`` (6 + 6 layers,
   d_model 1024, 16 heads, vocab 32768), random f32 weights from a seed,
   src_len 64, 16 slots, max_decode_len 128, decode buckets {1, 4, 16},
   prefill {1, 4}, every program captured (``aot_warmup``); the target
   built with ``speculative_k=4`` serves the plain arm too. First the
   kernels at this path's shapes against their plain versions, with
   bounds and SDPA with the same mask: the one-query DecodeAttention on the
   slot cache (L = 128) and over the source with its pad bias (L = 64), the
   query block of 4 with ``causal_offset`` and with the bias and no
   offset, at B = 1, 4, 16; the f32 flash forward at the encoder's
   (B x 16, 64, 64) for B = 1, 4, 16 (the prefill buckets' head counts,
   each beside SDPA f32 with the same mask) and the bf16 one at B = 4,
   with the pad bias, one row all padding (finite); planted, two copies
   of the f32 forward's source, one leaving each block's last 4-query
   sub-tile unstored and one dropping the bias, must fail its check. The
   p50 prefill and time to first token of the f32 plain arm print beside
   their times before the f32 forward's redesign. Then 24 sources of 8-64 tokens with budgets staggered 8-120,
   served plain, with a self-draft (the target's weights) and with a
   one-layer draft from its own seed, its table drawn 1000x smaller, so
   that it proposes a token of the position rather than echo its input as
   random tied-embedding models do (``draft_steps=3``), at 16 slots and
   (the first 8) at 1 slot; then the int8 head, plain and with its
   self-draft, at 16 slots. Each run's launches are held exactly to its
   engine steps and to the prefill runs of the engine's admissions (one
   a prefill bucket the admitted rows fill) (a decode step 12 one-query DecodeAttention and
   18 LayerNorms, + 1 QuantMatMul with int8; a verify 12 query-block
   DecodeAttention and 18 LayerNorms, + 1; a draft call 3 steps of the
   draft's layers; a prefill 6 flash forwards and 12 LayerNorms and the
   draft's share), and every emitted token, teacher-forced on the stream,
   to the plain re-forward (``seq2seq_hidden_plain``) under the serving
   rule; printed: tokens/s, p50 decode step, p50 time to first token, p50
   prefill, acceptance, the tokens equal to the plain stream, speculative
   against plain tokens/s, and the device ms of a decode step at bucket 16
   from a profiler window. Planted, the token check must fail: verify's
   self-attention without ``causal_offset``, the cross bias dropped (both
   on a target dispatched eagerly) and the bonus token taken from the
   one-layer draft's proposal.

``python3 chip_smoke.py --seq2seq`` runs phase 16 alone (no ``{"ok": ...}``
line).

Each path (the three serving runs, the two f32 kernel steps, the two
causal-LM bf16 windows, the ResNet f32 kernel steps, the ResNet bf16
window, the Session's checked steps and its two windows, the transformer's,
the causal LM's and ResNet's f32 checked steps and their two windows, the
training loop's run A and its checked windows, BERT's two checks and its
five windows, the RNN graphs' checks, windows and seq2seq's 60 steps,
the beam search's f32 check and its bf16 windows, the data phase's BERT
runs and its MNIST journey, the checkpoint phase's metrics windows and
run A, the long-context checks, captured run and windows, the word2vec
and DLRM windows, phase 16's runs) is counted from zero
just before it; a kernel's ``launches`` sum over the
paths, the flash rows split by the path's dropout rate (the seed-pointer
entries are rows of their own). The rows at a Session path's own shape
(``@causal_lm``, ``@session_*``, ``@resnet_session``, ``@bert``,
``@ptb``, ``@seq2seq``, ``@beam``, ``@long_context``, ``@s2s_*``) count
that path's launches alone
(``@bert``: the shipped-config windows, the data phase's included;
``@ptb``, ``@seq2seq``: the
windows and the 60 steps; ``@beam``: the f32 check for the f32 rows, the
bf16 windows for the bf16 rows; ``@s2s_self`` / ``@s2s_cross``: all of
phase 16's one-query or query-block launches, self- and cross-attention
alike, each row timed at its role's shape; ``quant_matmul@s2s``: all of
the int8 runs' launches, decode, verify and draft steps, timed at
verify's m = 64; the f32 dK/dV and dQ rows ``@f32``, ``@f32_d128`` and
``@f32_s64``: both entries' launches on the f32 training steps, the
long-context f32 check and the transformer f32 check, which the other rows
leave out). A kernel in a conditional node's body
counts once per run of the body (``DeviceGraph.settle``). Prints a
``{"kernels": [...]}`` line and ends with ``{"ok": true, "device":
{...}}``. Exits non-zero, without that last line, on any
failure, when no CUDA device is available, or without the package
beside it.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import dataclasses
import faulthandler
import gc
import hashlib
import importlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12,      # f32 outside tensor cores
                  torch.bfloat16: 989e12,    # dense bf16 tensor cores
                  torch.int8: 1979e12}       # dense int8 tensor cores
# 32-bit integer operations: an SM issues at most 4 warp instructions (128
# lane operations) a clock, half the 67e12 f32 rate, which counts an FMA as
# two operations. Adds, multiplies, shifts and rotates may issue on the FMA
# pipe (IMAD, IMAD.SHL, IMAD.HI, IMAD.WIDE) as well as the integer ALU;
# logic ops and compares (LOP3, ISETP) run only on the ALU, 64 lanes a clock
# an SM: half that rate.
INT32_OPS_PER_S = 67e12 / 2
ALU_OPS_PER_S = INT32_OPS_PER_S / 2
# integer operations an element: K0 (the counter-hash keep mask, two
# murmur finalizers of 3 shifts, 3 xors and 2 multiplies, two xors and a
# compare; the per-(seed, salt) hash hoisted)
K0_OPS = 19
# threefry-2x32 and the keep test, an element, in the fewest instructions:
# 20 round adds, 5 injections into b, the last injection into a (the other
# four fold into the next round's IADD3), the counter's add and 20 rotates,
# any of which may issue on the FMA pipe (a rotate as IMAD.WIDE.U32 by 2^r,
# its two halves OR-ed inside the round's 3-input xor); only the 20 xors of
# the rounds, the final xor and the integer compare need the ALU
THREEFRY_ALU_OPS = 22
THREEFRY_OPS = 69
DROPOUT_RATE = 0.1               # TransformerConfig.big() as it ships
# times before a redesign ("redesigned") and of the kernels that must hold
# theirs within 5% ("unchanged"): this script's runs on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §6). The threefry Dropout and K4 rows are from
# run 4 before their redesign; the f32 flash forward (@f32: 256 x 256 x 64
# causal; @s2s_encoder: the prefill's 64 heads of 64) and the xent forward
# at small and middle vocabularies (@mnist 512 x 10, @seq2seq 768 x 120,
# @resnet and @resnet_session 256 x 1000, @ptb 700 x 10000) from the runs
# PERF.md §6 names before theirs; its large vocabularies (the LM's bf16
# 4096 x 32768, @bert 2432 x 30522, @long_context 32768 x 32000) must hold
# theirs. Any row more than 5% over its earlier time prints "OUTSIDE 5%"
EARLIER_MS = {"dropout": (0.07672, "redesigned"),
              "dropout_bwd": (0.07645, "redesigned"),
              "dropout@embedding": (0.02124, "redesigned"),
              "dropout_bwd@embedding": (0.02127, "redesigned"),
              "dropout_residual": (0.01564, "redesigned"),
              "dropout_residual_bwd": (0.01459, "redesigned"),
              "dropout_residual@ragged_f32": (0.00173, "redesigned"),
              "dropout_residual_bwd@ragged_f32": (0.00163, "redesigned"),
              "dropout_residual@ragged_bf16": (0.00172, "redesigned"),
              "dropout_residual_bwd@ragged_bf16": (0.00170, "redesigned"),
              "dropout_residual@f32": (None, "redesigned"),
              "decode_attention": (0.01025, "unchanged"),
              "decode_attention@B1": (0.00659, "unchanged"),
              "decode_attention@B4": (0.00771, "unchanged"),
              "decode_attention@bf16": (0.00794, "unchanged"),
              "layer_norm": (0.00251, "unchanged"),
              "layer_norm@train": (0.00741, "unchanged"),
              "layer_norm@train_f32": (0.01177, "unchanged"),
              "layer_norm@general": (0.01606, "unchanged"),
              "quant_matmul": (0.01869, "unchanged"),
              "layer_norm_bwd": (0.01363, "unchanged"),
              "flash_attention_dkdv": (0.03412, "unchanged"),
              "flash_attention_dq": (0.02863, "unchanged"),
              "flash_attention_dkdv_dropout": (0.04034, "unchanged"),
              "flash_attention_dq_dropout": (0.03524, "unchanged"),
              "flash_attention_fwd": (0.03059, "unchanged"),
              "flash_attention_fwd_dropout": (0.03430, "unchanged"),
              "flash_attention_fwd@f32": (0.16322, "redesigned"),
              "flash_attention_fwd@s2s_encoder": (0.01653, "redesigned"),
              "flash_attention_fwd@s2s_encoder_bh16": (None, "redesigned"),
              "flash_attention_fwd@s2s_encoder_bh256": (None, "redesigned"),
              "flash_attention_dkdv@f32": (0.27737, "redesigned"),
              "flash_attention_dq@f32": (0.22444, "redesigned"),
              "flash_attention_dkdv@f32_d128": (None, "redesigned"),
              "flash_attention_dq@f32_d128": (None, "redesigned"),
              "flash_attention_dkdv@f32_s64": (None, "redesigned"),
              "flash_attention_dq@f32_s64": (None, "redesigned"),
              "decode_attention_block": (0.01416, "unchanged"),
              "softmax_xent_fwd": (0.15316, "unchanged"),
              "softmax_xent_fwd@bert": (0.08708, "unchanged"),
              "softmax_xent_fwd@long_context": (1.14551, "unchanged"),
              "softmax_xent_bwd": (0.20225, "unchanged"),
              "softmax_xent_fwd@resnet": (0.00390, "redesigned"),
              "softmax_xent_fwd@resnet_session": (0.00392, "redesigned"),
              "softmax_xent_fwd@mnist": (0.00322, "redesigned"),
              "softmax_xent_fwd@seq2seq": (0.00453, "redesigned"),
              "softmax_xent_fwd@ptb": (0.01770, "redesigned"),
              "softmax_xent_bwd@resnet": (0.00309, "unchanged"),
              "adam_update": (0.70266, "unchanged"),
              "momentum_update": (0.13832, "unchanged")}
# LM training device ms a step at dropout 0.1 and 0 before this redesign
# (the same run)
EARLIER_TRAIN_DEVICE_MS = {0.1: 10.9258, 0.0: 9.5895}
L2_BYTES = 50 * 2 ** 20
GIB = 2 ** 30
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
SRC = "simple_tensorflow_tpu_torch/csrc/"
TPU = "simple_tensorflow_tpu/ops/pallas/"


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

def device_ms(fns, rounds=5, min_calls=16):
    """Device time of one call, from a CUDA graph that runs ``fns``
    (closures over different input copies) round-robin, timed with CUDA
    events; the median over ``rounds`` replays."""
    calls = [fns[i % len(fns)] for i in range(max(min_calls, len(fns)))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def n_copies(bytes_per_call: int) -> int:
    """Input copies whose total is twice the L2 (capped)."""
    return max(1, min(64, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1))))


def bound_ms(nbytes: float, ops: float, op_dtype, int_ops: float = 0.0,
             alu_ops: float = 0.0) -> tuple:
    """The least time for ``nbytes`` moved, ``ops`` operations of
    ``op_dtype`` and ``int_ops`` 32-bit integer operations, ``alu_ops`` of
    them ALU-only (the kinds of operation run on separate units: the
    slowest one bounds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / PEAK_OPS_PER_S[op_dtype], int_ops / INT32_OPS_PER_S,
                alu_ops / ALU_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- kernel phases -----------------------------------------------------------

def check_close(name, out, ref, dtype):
    rtol, atol = TOL[dtype]
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
    return err


def check_scaled(name, out, ref, tol):
    """max |out - ref| <= tol * max(1, max |ref|); returns the error."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    bound = tol * max(1.0, ref.abs().max().item())
    if not err <= bound:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e} > {bound:.3e})")
    return err


def elementwise_ratio(out, ref, tol):
    """The largest |out - ref| / (tol * (|ref| + mean |ref|)): each value
    held to ``tol`` of its own size, with a floor of ``tol`` times the
    mean magnitude where the reference cancels to near zero. Above 1
    fails."""
    ref = ref.float()
    bound = tol * (ref.abs() + ref.abs().mean())
    diff = (out.float() - ref).abs()
    return (diff / bound.clamp_min(torch.finfo(torch.float32).tiny)).max(
        ).item(), diff.max().item()


def check_elementwise(name, out, ref, tol):
    """``elementwise_ratio`` within 1; returns the max abs error."""
    ratio, err = elementwise_ratio(out, ref, tol)
    if not ratio <= 1.0:
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e}; worst element at {ratio:.3e} of its bound)")
    return err


def event_ms(fn, reps=5):
    """Time of one call from CUDA events around ``reps`` calls, after one
    warm-up call: for library calls that run autograd or an optimizer,
    which the graph-based timer does not capture."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_row(err, ms, plain, bnd, lib, shape):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            "shape": shape}


def report(name, err, ms, plain, bnd, lib):
    b_ms, b_by = bnd
    lib_txt = "null" if lib is None else f"{lib:.5f}"
    print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.5f} ms  "
          f"plain {plain:.5f} ms  bound {b_ms:.5f} ms ({b_by})  "
          f"library {lib_txt} ms", flush=True)


def phase_decode_attention(K, rng, dev):
    """DecodeAttention at the decode (Kq=1, B = decode buckets 1, 4, 16)
    and page-block prefill (Kq=16, causal_offset, B = prefill buckets)
    shapes, L = 16 pages x 16 = 256, H=16, D=64; one biased case each;
    a ragged L for each (Kq=1: B=4, L=200, which splits the cache axis;
    Kq=16: B=2) to cover the tails. Each Kq=1 case prints the splits of
    the cache axis its B takes."""
    import torch.nn.functional as F

    kda = importlib.import_module(KMOD + "decode_attention")
    H, D = 16, 64
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for kq, causal, bs in ((1, False, (1, 4, 16)),
                               (16, True, (1, 4, 16))):
            for b in bs:
                cases.append((dtype, kq, causal, b, 256, False))
            cases.append((dtype, kq, causal, 16, 256, True))
        cases.append((dtype, 1, False, 4, 200, False))
        cases.append((dtype, 16, True, 2, 200, False))
    main = {}
    for dtype, kq, causal, b, L, biased in cases:
        qshape = (b, H, D) if kq == 1 else (b, kq, H, D)
        lo, hi = 1, L - (kq if causal else 0)
        lens = rng.randint(lo, hi + 1, size=b)
        lens[0] = hi                        # one row walks the whole cache
        if b > 1:
            lens[-1] = 1                    # a scratch-page padding row
        per_call = (2 * b * L * H * D + 2 * int(np.prod(qshape))) * \
            torch.tensor([], dtype=dtype).element_size()
        copies = []
        for _ in range(n_copies(per_call)):
            q = torch.from_numpy(rng.standard_normal(qshape)).to(dev, dtype)
            k = torch.from_numpy(
                rng.standard_normal((b, L, H, D))).to(dev, dtype)
            v = torch.from_numpy(
                rng.standard_normal((b, L, H, D))).to(dev, dtype)
            copies.append((q, k, v))
        lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
        bias = (torch.from_numpy(rng.standard_normal((b, L))).to(
            dev, torch.float32) if biased else None)
        q, k, v = copies[0]
        out = K.decode_attention(q, k, v, lengths, bias=bias,
                                 causal_offset=causal)
        ref = K.decode_attention_plain(q, k, v, lengths, bias=bias,
                                       causal_offset=causal)
        torch.cuda.synchronize()
        name = (f"decode_attention{'_block' if kq > 1 else ''} "
                f"{str(dtype)[6:]} B={b} Kq={kq} L={L}"
                f"{' bias' if biased else ''}")
        if kq == 1:
            splits = math.ceil(L / kda.one_split_len(
                b, H, L, torch.cuda.get_device_properties(
                    dev).multi_processor_count))
            name += f" ({splits} split{'s' if splits > 1 else ''})"
        err = check_close(name, out, ref, dtype)

        def kern(c):
            return lambda: K.decode_attention(c[0], c[1], c[2], lengths,
                                              bias=bias,
                                              causal_offset=causal)

        def plain(c):
            return lambda: K.decode_attention_plain(
                c[0], c[1], c[2], lengths, bias=bias, causal_offset=causal)

        # the yardstick: one SDPA call on the same tensors as (B, H, Kq,
        # D) views, with the same mask (and bias) as an additive mask
        span = torch.arange(L, device=dev).view(1, 1, L)
        allowed = lengths.view(b, 1, 1).long()
        if causal:
            allowed = allowed + 1 + torch.arange(kq, device=dev).view(
                1, kq, 1)
        add = torch.where(span < allowed, 0.0, float("-inf"))
        if bias is not None:
            add = add + bias.view(b, 1, L)
        add = add.view(b, 1, kq, L).to(dtype)

        def lib(c):
            qv = (c[0].view(b, 1, H, D) if kq == 1 else c[0]).transpose(1, 2)
            kv, vv = c[1].transpose(1, 2), c[2].transpose(1, 2)
            return lambda: F.scaled_dot_product_attention(
                qv, kv, vv, attn_mask=add)

        ms = device_ms([kern(c) for c in copies])
        plain_ms = device_ms([plain(c) for c in copies])
        lib_ms = device_ms([lib(c) for c in copies])
        # the bytes and operations this run's lengths need: each query
        # reads its allowed positions; K and V rows up to the furthest
        # allowed position of the row, once
        reach = np.minimum(lens + (kq if causal else 0), L)
        allowed_pos = sum(min(int(n) + (j + 1 if causal else 0), L)
                          for n in lens for j in range(kq))
        elem = q.element_size()
        moved = (int(reach.sum()) * H * D * 2 * elem + 2 * q.numel() * elem
                 + lengths.numel() * 4 + (b * L * 4 if biased else 0))
        ops = 4 * allowed_pos * H * D
        bnd = bound_ms(moved, ops, dtype)
        report(name, err, ms, plain_ms, bnd, lib_ms)
        row = kernel_row(err, ms, plain_ms, bnd, lib_ms, name)
        if biased or L != 256:
            continue
        # the JSON rows: f32, the largest decode / prefill bucket; the
        # other Kq=1 buckets and bf16 for the summary
        if kq > 1 and dtype == torch.float32 and b == 4:
            main["decode_attention_block"] = row
        if kq == 1 and dtype == torch.float32:
            main["decode_attention" + ("" if b == 16 else f"@B{b}")] = row
        if kq == 1 and dtype == torch.bfloat16 and b == 16:
            main["decode_attention@bf16"] = row
    return main


def phase_layer_norm(K, rng, dev):
    """LayerNorm forward at n = d_model 1024: rows 16 (decode bucket 16,
    one prefill chunk), 64 (prefill bucket 4 x page_len), 256, and 4096
    (a training batch of 16 x 256 tokens), f32 and bf16, all on the
    vector path (a warp per row); then n = 1000 at 4096 rows, which
    takes the general path. The row statistics (mean, rstd) are checked
    too at 4096 rows, where the training path asks for them."""
    import torch.nn.functional as F

    kln = importlib.import_module(KMOD + "layer_norm")
    main = {}
    cases = [(dtype, rows, 1024) for dtype in (torch.float32, torch.bfloat16)
             for rows in (16, 64, 256, 4096)]
    cases.append((torch.bfloat16, 4096, 1000))
    for dtype, rows, n in cases:
        elem = torch.tensor([], dtype=dtype).element_size()
        copies = [torch.from_numpy(rng.standard_normal((rows, n))).to(
            dev, dtype) for _ in range(n_copies(2 * rows * n * elem))]
        gamma = torch.from_numpy(
            1.0 + 0.1 * rng.standard_normal(n)).to(dev, torch.float32)
        beta = torch.from_numpy(
            0.1 * rng.standard_normal(n)).to(dev, torch.float32)
        x = copies[0]
        nv = kln.vectors_per_lane(n, dtype, x, gamma, beta)
        path = f"vector path, {nv} vectors a lane" if nv else "general path"
        name = f"layer_norm {str(dtype)[6:]} rows={rows} n={n}"
        if rows == 4096:
            y, mean, rstd = K.layer_norm_fwd(x, gamma, beta,
                                             return_stats=True)
            ry, rmean, rrstd = K.layer_norm_plain(x, gamma, beta,
                                                  return_stats=True)
            err = max(check_close(name, y, ry, dtype),
                      check_close(f"{name} mean", mean, rmean,
                                  torch.float32),
                      check_close(f"{name} rstd", rstd, rrstd,
                                  torch.float32))
        else:
            err = check_close(name, K.layer_norm(x, gamma, beta),
                              K.layer_norm_plain(x, gamma, beta), dtype)
        ms = device_ms([lambda c=c: K.layer_norm(c, gamma, beta)
                        for c in copies])
        plain_ms = device_ms([
            lambda c=c: K.layer_norm_plain(c, gamma, beta)
            for c in copies])
        g_t, b_t = gamma.to(dtype), beta.to(dtype)
        lib_ms = device_ms([
            lambda c=c: F.layer_norm(c, (n,), g_t, b_t, eps=1e-6)
            for c in copies])
        # read x, gamma, beta once, write y; ~8 flops an element
        bnd = bound_ms(2 * x.numel() * elem + 2 * n * 4,
                       8 * rows * n, torch.float32)
        report(f"{name} ({path})", err, ms, plain_ms, bnd, lib_ms)
        row = kernel_row(err, ms, plain_ms, bnd, lib_ms, name)
        if n != 1024:
            main["layer_norm@general"] = row
        elif dtype == torch.float32 and rows == 16:
            main["layer_norm"] = row
        elif rows == 4096:
            main["layer_norm@train" + (
                "" if dtype == torch.bfloat16 else "_f32")] = row
    return main


def phase_quant_matmul(K, rng, dev):
    """Int8 QuantMatMul, the int8 logits head: x (m, 1024) f32 against
    wq (1024, 32768) int8 in the K-major layout the kernel takes (strides
    (1, k): the .t() of a contiguous (32768, 1024) tensor), m = decode
    buckets 1, 4, 16 and 32 (where ``torch._int_mm`` runs the same rows).
    Bit-exact; a row-major weight must be refused."""
    k, n = 1024, 32768
    main = {}
    copies = [torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(
        np.int8)).to(dev).t() for _ in range(n_copies(k * n))]
    w_scale = torch.from_numpy(
        (rng.random_sample(n) * 0.01 + 1e-4).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((4, k))).to(dev, torch.float32)
    try:
        K.quant_matmul(x, copies[0].contiguous(), w_scale)
    except ValueError as e:
        if "K-major" not in str(e):
            fail(f"quant_matmul: a row-major weight raised {e!r}")
        print("  quant_matmul refuses a row-major (k, n) weight: "
              f"{str(e)[:60]}...", flush=True)
    else:
        fail("quant_matmul: the kernel took a row-major weight")
    for m in (1, 4, 16, 32, 64):
        x = torch.from_numpy(rng.standard_normal((m, k))).to(
            dev, torch.float32)
        wq = copies[0]
        name = f"quant_matmul f32 m={m} k={k} n={n}"
        out = K.quant_matmul(x, wq, w_scale)
        ref = K.quant_matmul_plain(x, wq, w_scale)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"{name}: kernel is not bit-exact with its plain version "
                 f"(max abs err "
                 f"{(out - ref).abs().max().item():.3e})")
        err = 0.0
        ms = device_ms([lambda w=w: K.quant_matmul(x, w, w_scale)
                        for w in copies])
        plain_ms = device_ms([lambda w=w: K.quant_matmul_plain(x, w,
                                                               w_scale)
                              for w in copies])
        # yardstick: torch._int_mm on the quantized rows (it takes more
        # than 16 rows, so below 32 they are zero-padded to 32) and the
        # same K-major weights, the layout cuBLASLt's int8 GEMM takes
        xq, _ = K.quantize_rowwise_plain(x)
        xq32 = torch.zeros((max(m, 32), k), dtype=torch.int8, device=dev)
        xq32[:m] = xq
        lib_ms = device_ms([lambda w=w: torch._int_mm(xq32, w)
                            for w in copies])
        bnd = bound_ms(x.numel() * 4 + k * n + n * 4 + m * n * 4,
                       2 * m * k * n, torch.int8)
        report(name, err, ms, plain_ms, bnd, lib_ms)
        if m in (16, 64):
            main["quant_matmul" + ("" if m == 16 else "@s2s")] = \
                kernel_row(err, ms, plain_ms, bnd, lib_ms, name)
    del copies
    return main


# -- training kernel phases --------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_D = 16, 256, 16, 64


KMOD = "simple_tensorflow_tpu_torch.ops.kernels."


def elem_size(dtype):
    return torch.tensor([], dtype=dtype).element_size()


FLASH_SEED = 424242


def check_flash_fault(K, q, k, v, do, rlse, delta, args, outs, tols, tag):
    """The limits above must fail the plain versions run under the next
    seed (a wrong mask): each of o, dK, dV and dQ."""
    bad = dict(args, dropout_seed=args["dropout_seed"] + 1)
    bo, _ = K.flash_attention_fwd_plain(q, k, v, **bad)
    bdk, bdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **bad)
    bdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **bad)
    readings = []
    for part, out, ref, tol in zip(("o", "dk", "dv", "dq"), outs,
                                   (bo, bdk, bdv, bdq), tols):
        ref = ref.float()
        ratio = ((out.float() - ref).abs().max().item()
                 / (tol * max(1.0, ref.abs().max().item())))
        if not ratio > 1.0:
            fail(f"flash {tag}: the check passes the mask of seed + 1 "
                 f"({part} at {ratio:.3e} of its bound)")
        readings.append(f"{part} {ratio:.3e}x")
    print(f"  flash {tag}: the check fails the mask of seed + 1: "
          f"{', '.join(readings)} its bound", flush=True)


def phase_flash_attention(K, gen, dev):
    """FlashAttention forward, dK/dV and dQ at the training shape (B=16,
    H=16, D=64: 256 heads of S=256, causal) without and with dropout 0.1
    (seed ``FLASH_SEED``; the limits must fail the next seed's mask), at a
    ragged S=200, and non-causal with a (B, S) key bias; f32 and bf16. The
    backward kernels get the plain forward's lse and delta = rowsum(dO *
    O)."""
    import torch.nn.functional as F

    B, H, D = TRAIN_B, TRAIN_H, TRAIN_D
    bh = B * H
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        tol_f, tol_g = (1e-5, 1e-4) if f32 else (2e-2, 2e-2)
        elem = elem_size(dtype)
        for s, causal, biased, rate in ((256, True, False, 0.0),
                                        (256, True, False, DROPOUT_RATE),
                                        (200, True, False, 0.0),
                                        (256, False, True, 0.0)):
            copies = [tuple(torch.randn((bh, s, D), generator=gen,
                                        device=dev).to(dtype)
                            for _ in range(4))
                      for _ in range(n_copies(4 * bh * s * D * elem))]
            bias = (torch.randn((B, s), generator=gen, device=dev)
                    if biased else None)
            args = dict(heads=H, sm_scale=D ** -0.5, causal=causal,
                        bias=bias)
            if rate:
                args.update(dropout_rate=rate, dropout_seed=FLASH_SEED)
            stats = []
            for q, k, v, do in copies:
                ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
                stats.append((ro, rlse, (do.float() * ro.float()).sum(-1)))
            q, k, v, do = copies[0]
            ro, rlse, delta = stats[0]
            o, lse = K.flash_attention_fwd(q, k, v, **args)
            dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
            rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta,
                                                    **args)
            dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
            rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
            torch.cuda.synchronize()
            tag = (f"{str(dtype)[6:]} BH={bh} S={s} D={D}"
                   f"{' causal' if causal else ''}{' bias' if biased else ''}"
                   f"{f' dropout {rate}' if rate else ''}")
            err = {
                "fwd": max(check_scaled(f"flash fwd o {tag}", o, ro, tol_f),
                           check_scaled(f"flash fwd lse {tag}", lse, rlse,
                                        1e-5)),
                "dkdv": max(check_scaled(f"flash dk {tag}", dk, rdk, tol_g),
                            check_scaled(f"flash dv {tag}", dv, rdv, tol_g)),
                "dq": check_scaled(f"flash dq {tag}", dq, rdq, tol_g)}
            if rate:
                check_flash_fault(K, q, k, v, do, rlse, delta, args,
                                  (o, dk, dv, dq),
                                  (tol_f, tol_g, tol_g, tol_g), tag)
            del o, lse, dk, dv, rdk, rdv, dq, rdq
            fns = {
                "fwd": (K.flash_attention_fwd, K.flash_attention_fwd_plain,
                        lambda c, st: c[:3]),
                "dkdv": (K.flash_attention_dkdv,
                         K.flash_attention_dkdv_plain,
                         lambda c, st: (*c, st[1], st[2])),
                "dq": (K.flash_attention_dq, K.flash_attention_dq_plain,
                       lambda c, st: (*c, st[1], st[2]))}
            times = {}
            for part, (kern, plain, pick) in fns.items():
                times[part] = tuple(device_ms([
                    lambda f=f, c=c, st=st: f(*pick(c, st), **args)
                    for c, st in zip(copies, stats)]) for f in (kern, plain))
            # yardsticks on the same tensors as (B, H, S, D) views: SDPA
            # forward; SDPA's backward alone (bf16 without a bias: its
            # flash backward on the saved out and logsumexp), which
            # computes dq, dk and dv in one call; SDPA forward + backward
            # (torch.autograd.grad). At rate 0 all graph-timed; with
            # dropout, SDPA's own dropout (similar work, another mask)
            # timed with CUDA events around eager calls (its RNG is kept
            # out of a graph) and no backward alone
            mask = bias.view(B, 1, 1, s).to(dtype) if biased else None

            def sdpa(c):
                q4, k4, v4 = (t.view(B, H, s, D) for t in c[:3])
                return lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, is_causal=causal,
                    dropout_p=rate)

            def sdpa_fb(c):
                qg, kg, vg = (t.view(B, H, s, D).detach().requires_grad_()
                              for t in c[:3])
                do4 = c[3].view(B, H, s, D)
                return lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(
                        qg, kg, vg, attn_mask=mask, is_causal=causal,
                        dropout_p=rate), (qg, kg, vg), do4)

            lib_bwd = None
            if rate:
                lib_fwd = event_ms(sdpa(copies[0]), reps=20)
                lib_fb = event_ms(sdpa_fb(copies[0]))
            else:
                lib_fwd = device_ms([sdpa(c) for c in copies])
                lib_fb = device_ms([sdpa_fb(c) for c in copies])
                if f32:
                    lib_bwd = device_ms([sdpa_bwd_f32(c, B, H, s, D, causal,
                                                      bias, 0.0)
                                         for c in copies])
                elif not biased:
                    lib_bwd = device_ms([sdpa_bwd(c, B, H, s, D, causal)
                                         for c in copies])
            # the work these inputs need: live (query, key) pairs only
            pairs = bh * (s * (s + 1) // 2 if causal else s * s)
            io = bh * s * D * elem
            extra = (B * s * 4 if biased else 0)
            hashes = K0_OPS * pairs if rate else 0   # one mask per pair
            bnds = {"fwd": bound_ms(4 * io + bh * s * 4 + extra,
                                    4 * D * pairs, dtype, hashes),
                    "dkdv": bound_ms(6 * io + 2 * bh * s * 4 + extra,
                                     8 * D * pairs, dtype, hashes),
                    "dq": bound_ms(5 * io + 2 * bh * s * 4 + extra,
                                   6 * D * pairs, dtype, hashes)}
            lib_g = lib_fb if lib_bwd is None else lib_bwd
            libs = {"fwd": lib_fwd, "dkdv": lib_g, "dq": lib_g}
            for part in ("fwd", "dkdv", "dq"):
                name = f"flash_attention_{part} {tag}"
                report(name, err[part], times[part][0], times[part][1],
                       bnds[part], libs[part])
                row = kernel_row(err[part], times[part][0], times[part][1],
                                 bnds[part], libs[part], name)
                if not f32 and s == 256 and causal:
                    main[f"flash_attention_{part}"
                         + ("_dropout" if rate else "")] = row
                if f32 and s == 256 and causal and not rate:
                    main[f"flash_attention_{part}@f32"] = row
            bwd_txt = "n/a" if lib_bwd is None else f"{lib_bwd:.5f}"
            print(f"  flash library {tag}: SDPA backward alone {bwd_txt} ms,"
                  f" forward + backward {lib_fb:.5f} ms "
                  f"({'CUDA events, eager' if rate else 'graph-timed'})",
                  flush=True)
            if lib_bwd is not None and s == 256 and causal:
                c = copies[0]
                alone = (sdpa_bwd_f32(c, B, H, s, D, causal, bias, 0.0) if f32
                         else sdpa_bwd(c, B, H, s, D, causal))
                print(f"  flash library {tag}: kernels of SDPA forward + "
                      f"backward {device_kernels(sdpa_fb(c))}; of the "
                      f"backward alone {device_kernels(alone)}", flush=True)
            if s == 256 and causal and not rate:
                pair = times["dkdv"][0] + times["dq"][0]
                shares = ", ".join(
                    f"{part} {bnds[part][0] / times[part][0]:.1%}"
                    for part in ("dkdv", "dq"))
                print(f"  flash bwd {tag}: dK/dV + dQ {pair:.5f} ms, "
                      f"{pair / lib_bwd:.3f}x SDPA's backward alone "
                      f"({lib_bwd:.5f} ms); of their bounds {shares}",
                      flush=True)
            if not f32 and s == 256 and causal and rate:
                check_flash_fwd_mask(K, dev, bh, s, rate)
                check_flash_bwd_mask(K, dev, bh, s, rate)
                for part in ("fwd", "dkdv", "dq"):
                    ratio = (times[part][0]
                             / main[f"flash_attention_{part}"]["ms"])
                    print(f"  flash {part} {tag}: {times[part][0]:.5f} ms, "
                          f"{ratio:.3f}x the rate-0 kernel", flush=True)
            del copies, stats
        print("  (flash library: fwd = SDPA forward; dkdv/dq = SDPA's "
              "backward alone at rate 0 (bf16 without a bias: its flash "
              "backward; f32: its memory-efficient backward, what autograd "
              "runs for f32), else SDPA forward + backward: one call "
              "computes dq, dk and dv together; with dropout, SDPA's "
              "dropout_p: similar work, another mask)", flush=True)
    return main


def device_kernels(fn):
    """The names (cut to 60 characters) of the device kernels one call of
    ``fn`` runs, from a profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def sdpa_bwd(c, B, H, s, D, causal):
    """SDPA's flash backward alone on the saved output and logsumexp of
    one forward call over the (BH, S, D) tensors ``c`` (q, k, v, dO)."""
    q4, k4, v4, do4 = (t.view(B, H, s, D) for t in c)
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal, False, scale=D ** -0.5)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset,
        scale=D ** -0.5)


def sdpa_bwd_f32(c, B, H, s, D, causal, bias, rate):
    """SDPA's f32 backward alone: its memory-efficient attention backward
    (what ``torch.autograd.grad`` of an f32 SDPA runs, beside a few
    elementwise kernels) on the saved output, logsumexp and dropout seed of
    one forward call over the (BH, S, D) tensors ``c`` (q, k, v, dO), with
    the key bias (B, S) as its attention bias. A captured
    ``torch.autograd.grad`` of a forward made outside the capture fails
    (its saved state), so the backward op is called as autograd calls
    it."""
    q4, k4, v4, do4 = (t.view(B, H, s, D) for t in c)
    mask = None if bias is None else bias.view(B, 1, 1, s).expand(
        B, H, s, s).contiguous()
    out, lse, seed, off = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            q4, k4, v4, mask, True, rate, causal, scale=D ** -0.5)[:4]
    return lambda: \
        torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            do4, q4, k4, v4, mask, out, lse, seed, off, rate,
            [True, True, True, False], causal, scale=D ** -0.5)


# the f32 backward's other path shapes: (tag, B, H, S, D, causal, pad
# bias, dropout rate): the long-context f32 check (2 layers x 2048, D 128)
# and the transformer f32 check (8 x 64/64, the pad bias, dropout 0.1; its
# decoder's self- and cross-attention run the same kernels at the same S)
F32_BWD_SHAPES = (("f32_d128", 1, 8, 2048, 128, True, False, 0.0),
                  ("f32_s64", 8, 16, 64, 64, False, True, DROPOUT_RATE))
# the paths whose launches the f32 backward rows count, by row
F32_BWD_PATHS = {"f32": "train f32", "f32_d128": "long_context check float32",
                 "f32_s64": "transformer f32 check"}


def phase_flash_f32_bwd(K, gen, dev, f32_mutant):
    """The f32 dK/dV and dQ (csrc/flash_bwd_f32.cu) at the long-context
    and transformer f32 checks' shapes (``F32_BWD_SHAPES``): each against
    its plain version (1e-4 of max |ref|; at D = 128 also each 128-row
    block to 1e-4 of its norm, ``check_flash``), timed beside the plain
    version, its bound and SDPA's f32 backward alone; then the planted
    faults of ``F32_MUTANTS`` in the backward, each of which the limits
    must fail: dK/dV without its last query tile at the training shape
    (256 heads of 256, causal), dQ without the bias at the transformer
    check's (the pad bias)."""
    main = {}
    fault_inputs = {}
    for tag, B, H, s, D, causal, padded, rate in F32_BWD_SHAPES:
        bh = B * H
        copies = [tuple(torch.randn((bh, s, D), generator=gen, device=dev)
                        for _ in range(4))
                  for _ in range(n_copies(4 * bh * s * D * 4))]
        bias = None
        if padded:
            pads = torch.zeros((B, s), device=dev)
            pads[0, 3 * s // 4:] = 1.0
            pads[-1, :] = 1.0          # a row of nothing but padding
            bias = pads * -1e9
        args = dict(heads=H, sm_scale=D ** -0.5, causal=causal, bias=bias)
        if rate:
            args.update(dropout_rate=rate, dropout_seed=FLASH_SEED)
        stats = []
        for q, k, v, do in copies:
            ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
            stats.append((rlse, (do * ro).sum(-1)))
        q, k, v, do = copies[0]
        rlse, delta = stats[0]
        dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
        dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
        rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta,
                                                **args)
        rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
        torch.cuda.synchronize()
        name = (f"f32 BH={bh} S={s} D={D}{' causal' if causal else ''}"
                f"{' pad bias' if padded else ''}"
                f"{f' dropout {rate}' if rate else ''}")
        err = {}
        for part, outs in (("dkdv", ((dk, rdk), (dv, rdv))),
                           ("dq", ((dq, rdq),))):
            err[part] = 0.0
            for out, ref in outs:
                if not bool(torch.isfinite(out).all()):
                    fail(f"flash {part} {name}: non-finite output")
                if D == 128:
                    e, _ = check_flash(f"flash {part} {name}", out, ref,
                                       1e-4)
                else:
                    e = check_scaled(f"flash {part} {name}", out, ref, 1e-4)
                err[part] = max(err[part], e)
        if padded:
            fault_inputs["dq"] = (q, k, v, do, bias, H)
        del dk, dv, dq, rdk, rdv, rdq
        times = {}
        for part, kern, plain in (
                ("dkdv", K.flash_attention_dkdv, K.flash_attention_dkdv_plain),
                ("dq", K.flash_attention_dq, K.flash_attention_dq_plain)):
            times[part] = tuple(device_ms([
                lambda f=f, c=c, st=st: f(*c, *st, **args)
                for c, st in zip(copies, stats)]) for f in (kern, plain))
        if rate:
            # a capture of its backward reads the dropout seed and offset a
            # forward outside the capture left on the host: an illegal
            # address on the card, so it is timed eagerly
            lib_bwd = event_ms(sdpa_bwd_f32(copies[0], B, H, s, D, causal,
                                            bias, rate), reps=20)
            how = "CUDA events, eager"
        else:
            lib_bwd = device_ms([sdpa_bwd_f32(c, B, H, s, D, causal, bias,
                                              rate) for c in copies])
            how = "graph-timed"
        pairs = bh * (s * (s + 1) // 2 if causal else s * s)
        io = bh * s * D * 4
        extra = B * s * 4 if padded else 0
        hashes = K0_OPS * pairs if rate else 0
        bnds = {"dkdv": bound_ms(6 * io + 2 * bh * s * 4 + extra,
                                 8 * D * pairs, torch.float32, hashes),
                "dq": bound_ms(5 * io + 2 * bh * s * 4 + extra,
                               6 * D * pairs, torch.float32, hashes)}
        for part in ("dkdv", "dq"):
            row_name = f"flash_attention_{part} {name}"
            report(row_name, err[part], times[part][0], times[part][1],
                   bnds[part], lib_bwd)
            main[f"flash_attention_{part}@{tag}"] = kernel_row(
                err[part], times[part][0], times[part][1], bnds[part],
                lib_bwd, row_name)
            print(f"  flash {part} {name}: {bnds[part][0] / times[part][0]:.1%}"
                  f" of its bound", flush=True)
        pair = times["dkdv"][0] + times["dq"][0]
        print(f"  flash bwd {name}: dK/dV + dQ {pair:.5f} ms, "
              f"{pair / lib_bwd:.3f}x SDPA's f32 backward alone "
              f"({lib_bwd:.5f} ms, {how}; with dropout its own mask)",
              flush=True)
        del copies, stats
    f32_bwd_faults(K, gen, dev, f32_mutant, fault_inputs["dq"])
    return main


def f32_bwd_faults(K, gen, dev, handle, dq_inputs):
    """The backward's planted faults of ``F32_MUTANTS``: dK/dV without its
    last query tile at the training shape (causal, 256 heads of 256, D 64)
    and dQ without the bias at the transformer check's (the pad bias);
    each must fail the limit the kernel rows hold it to (1e-4 of max
    |ref|)."""
    lib = f32_mutant_lib(handle)
    bh, s, D = TRAIN_B * TRAIN_H, TRAIN_S, TRAIN_D
    q, k, v, do = (torch.randn((bh, s, D), generator=gen, device=dev)
                   for _ in range(4))
    args = dict(heads=TRAIN_H, sm_scale=D ** -0.5, causal=True)
    ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
    delta = (do * ro).sum(-1)
    rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **args)
    # the transformer check's inputs at rate 0, as the mutants run
    q2, k2, v2, do2, bias, heads = dq_inputs
    args2 = dict(heads=heads, sm_scale=D ** -0.5, causal=False, bias=bias)
    ro2, rlse2 = K.flash_attention_fwd_plain(q2, k2, v2, **args2)
    delta2 = (do2 * ro2).sum(-1)
    rdq = K.flash_attention_dq_plain(q2, k2, v2, do2, rlse2, delta2, **args2)
    cases = {"dK/dV": ((q, k, v, do, rlse, delta, None, TRAIN_H, True),
                       (rdk, rdv)),
             "dQ": ((q2, k2, v2, do2, rlse2, delta2, bias, heads, False),
                    (rdq,))}
    txt = []
    for i, (what, src, *_) in enumerate(F32_MUTANTS):
        if src != "flash_bwd_f32.cu":
            continue
        (q_, k_, v_, do_, lse_, delta_, bias_, heads, causal), refs = \
            cases[what.split()[0]]
        outs = [torch.zeros_like(r) for r in refs]
        rc = getattr(lib, f"stf_mutant_{i}")(
            q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), do_.data_ptr(),
            lse_.data_ptr(), delta_.data_ptr(),
            None if bias_ is None else bias_.data_ptr(), outs[0].data_ptr(),
            outs[-1].data_ptr(), q_.shape[0], q_.shape[1], heads, D,
            D ** -0.5, int(causal), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc:
            fail(f"planted f32 fault ({what}): the launch returned {rc}")
        # a non-finite output (the padded keys' p without their bias
        # overflows) is as far off as can be
        ratios = [(o - r).abs().max().item()
                  / (1e-4 * max(1.0, r.abs().max().item()))
                  if bool(torch.isfinite(o).all()) else math.inf
                  for o, r in zip(outs, refs)]
        if not max(ratios) > 1.0:
            fail(f"flash f32 backward: the check passes the planted fault "
                 f"({what})")
        txt.append(f"{what}: {max(ratios):.3e}x its limit")
    print("  planted faults in the f32 backward: " + "; ".join(txt),
          flush=True)


def check_flash_fwd_mask(K, dev, bh, s, rate):
    """The bf16 forward's dropout mask read off its output at the
    training shape: with q = 0 every live score is 0 and p = 1, and v
    one-hot over a block of D keys makes o[:, r, d] nonzero exactly where
    key blk * D + d of row r was live and kept. 0 mismatches against the
    plain K0 mask; the next seed's mask must differ (a planted fault)."""
    fa = importlib.import_module(KMOD + "flash_attention")
    D = TRAIN_D
    q = torch.zeros((bh, s, D), device=dev, dtype=torch.bfloat16)
    k = torch.ones((bh, s, D), device=dev, dtype=torch.bfloat16)
    parts = []
    for blk in range(s // D):
        keys = torch.arange(s, device=dev)[:, None] - blk * D
        v = (keys == torch.arange(D, device=dev)[None, :]).to(torch.bfloat16)
        o, _ = K.flash_attention_fwd(
            q, k, v.expand(bh, s, D).contiguous(), heads=TRAIN_H,
            sm_scale=D ** -0.5, causal=True, dropout_rate=rate,
            dropout_seed=FLASH_SEED)
        parts.append(o != 0)
    got = torch.cat(parts, dim=-1)
    live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    want = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED, dev) & live
    bad = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED + 1, dev) & live
    miss, fault = mismatches(got, want), mismatches(got, bad)
    print(f"  flash fwd bf16 BH={bh} S={s} dropout {rate}: mask read off "
          f"the output, mismatches {miss} of {got.numel()} (kept "
          f"{got.sum().item()} of {live.sum().item() * bh} live); against "
          f"the mask of seed + 1 {fault}", flush=True)
    if miss or not fault:
        fail(f"flash fwd mask: {miss} mismatches, seed + 1 fault "
             f"mismatches {fault}")


def check_flash_bwd_mask(K, dev, bh, s, rate):
    """The bf16 backward's dropout mask read off each of dV, dK and dQ at
    the training shape (``keep_mask_readoff``: lse = delta = 0, a zero q
    or k so every live p is 1, one-hot dO, Q or K over blocks of D rows):
    0 mismatches with the plain K0 mask; the next seed's mask must differ
    (a planted fault)."""
    fa = importlib.import_module(KMOD + "flash_attention")
    args = dict(heads=TRAIN_H, sm_scale=TRAIN_D ** -0.5, causal=True,
                dropout_rate=rate, dropout_seed=FLASH_SEED)

    def bwd(q, k, v, do, lse, delta):
        dk, dv = K.flash_attention_dkdv(q, k, v, do, lse, delta, **args)
        return dk, dv, K.flash_attention_dq(q, k, v, do, lse, delta, **args)

    live = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    want = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED, dev) & live
    bad = fa.keep_mask_plain(bh, s, s, rate, FLASH_SEED + 1, dev) & live
    got = fa.keep_mask_readoff(bwd, bh, s, TRAIN_D, torch.bfloat16, dev)
    for part, mask in zip(("dV", "dK", "dQ"), got):
        miss, fault = mismatches(mask, want), mismatches(mask, bad)
        print(f"  flash bwd bf16 BH={bh} S={s} dropout {rate}: mask read "
              f"off {part}, mismatches {miss} of {mask.numel()} (kept "
              f"{mask.sum().item()}); against the mask of seed + 1 {fault}",
              flush=True)
        if miss or not fault:
            fail(f"flash bwd mask from {part}: {miss} mismatches, seed + 1 "
                 f"fault mismatches {fault}")


K4_SEED = 918273
DROPOUT_KEY = (123456789, 987654321)


def mismatches(a, b) -> int:
    return int((a != b).sum().item())


def check_exact(name, out, ref):
    """Bit-exact (``torch.equal``); returns the max abs error, 0."""
    if not torch.equal(out, ref):
        fail(f"{name}: kernel is not bit-exact with its plain version "
             f"({mismatches(out, ref)} elements differ)")
    return 0.0


def phase_dropout_residual(K, gen, dev):
    """The fused dropout-residual kernel (K4) at the training shape, bf16
    (4096, 1024) without a bias (the attention tail of every layer), at
    ragged f32 (300, 96) and bf16 (37, 1000) with a bias, and at f32
    (4096, 1024); forward and the backward's dx through the wrappers
    (``dropout_residual_fwd``, ``dropout_residual_bwd``: the path
    ``vectors_per_lane`` picks, the vector path, a warp per row, but for
    37 rows) and with the other path forced. Bit-exact with the plain
    versions on both paths, on random inputs and on x = ones, where the
    output is the mask itself (0 mismatches); the mask of salt 1 must
    differ (a planted fault). Yardstick: ``F.dropout(x) +
    residual`` and ``F.dropout(g)``, similar work with another mask."""
    import torch.nn.functional as F

    kdr = importlib.import_module(KMOD + "dropout_residual")
    main = {}
    for dtype, rows, n, biased, key in (
            (torch.bfloat16, 4096, 1024, False, ""),
            (torch.float32, 300, 96, True, "@ragged_f32"),
            (torch.bfloat16, 37, 1000, True, "@ragged_bf16"),
            (torch.float32, 4096, 1024, False, "@f32")):
        elem = elem_size(dtype)
        copies = [tuple(torch.randn((rows, n), generator=gen, device=dev)
                        .to(dtype) for _ in range(2))
                  for _ in range(n_copies(3 * rows * n * elem))]
        bias = (torch.randn(n, generator=gen, device=dev).to(dtype)
                if biased else None)
        kw = dict(rate=DROPOUT_RATE, seed=K4_SEED)
        x, res = copies[0]
        tensors = [x, res] + ([bias] if biased else [])
        picked = kdr.vectors_per_lane(rows, n, dtype, *tensors)
        # the vector path's count at this width, taken at any row count
        nv = kdr.vectors_per_lane(max(rows, kdr.VEC_MIN_ROWS), n, dtype,
                                  *tensors)
        tag = (f"{str(dtype)[6:]} rows={rows} n={n}"
               f"{' bias' if biased else ''}")
        if not nv:
            fail(f"dropout_residual {tag}: no vector path at this width")

        # path None: the wrappers, which pick the path; else the path forced
        def fwd(c, path, b=bias):
            if path is None:
                return K.dropout_residual_fwd(c[0], c[1], b, **kw)
            return kdr.launch("dropout_residual", c[0], c[1], b,
                              DROPOUT_RATE, K4_SEED, path)

        def bwd(c, path):
            if path is None:
                return K.dropout_residual_bwd(c[0], **kw)
            return kdr.launch("dropout_residual_bwd", c[0], None, None,
                              DROPOUT_RATE, K4_SEED, path)

        ones = torch.ones((rows, n), dtype=dtype, device=dev)
        zeros = torch.zeros_like(ones)
        rr = torch.arange(rows, device=dev)[:, None]
        cc = torch.arange(n, device=dev)[None, :]
        salt1 = K.counter_keep_mask_plain(K4_SEED, 1, rr, cc,
                                          1.0 - DROPOUT_RATE)
        paths = ((None, f"vector path, {nv} vectors a lane, picked"),
                 (0, "general path, forced")) if picked else \
            ((None, "general path, picked"),
             (nv, f"vector path, {nv} vectors a lane, forced"))
        for path, label in paths:
            err_f = check_exact(f"dropout_residual {tag} ({label})",
                                fwd(copies[0], path),
                                K.dropout_residual_fwd_plain(x, res, bias,
                                                             **kw))
            err_b = check_exact(f"dropout_residual_bwd {tag} ({label})",
                                bwd(copies[0], path),
                                K.dropout_residual_bwd_plain(x, **kw))
            got = fwd((ones, zeros), path, None)
            miss = mismatches(got, K.dropout_residual_fwd_plain(
                ones, zeros, None, **kw))
            miss_b = mismatches(bwd((ones,), path),
                                K.dropout_residual_bwd_plain(ones, **kw))
            fault = mismatches(got != 0, salt1)
            kept = (got != 0).float().mean().item()
            print(f"  dropout_residual {tag} ({label}): x = ones, kernel vs "
                  f"plain mismatches fwd {miss} bwd {miss_b}; against the "
                  f"salt-1 mask {fault}; kept {kept:.5f}", flush=True)
            if miss or miss_b or not fault:
                fail(f"dropout_residual {tag} ({label}): mask mismatches "
                     f"{miss}/{miss_b}, salt-1 fault mismatches {fault}")
            ms_f = device_ms([lambda c=c: fwd(c, path) for c in copies])
            ms_b = device_ms([lambda c=c: bwd(c, path) for c in copies])
            if path is None:
                plain_f = device_ms([
                    lambda c=c: K.dropout_residual_fwd_plain(
                        c[0], c[1], bias, **kw) for c in copies])
                plain_b = device_ms([
                    lambda c=c: K.dropout_residual_bwd_plain(c[0], **kw)
                    for c in copies])
                lib_f = event_ms(lambda: F.dropout(x, DROPOUT_RATE) + res,
                                 reps=20)
                lib_b = event_ms(lambda: F.dropout(x, DROPOUT_RATE),
                                 reps=20)
            nb = elem * (n if biased else 0)
            bnd_f = bound_ms(3 * rows * n * elem + nb, 2 * rows * n,
                             torch.float32, K0_OPS * rows * n)
            bnd_b = bound_ms(2 * rows * n * elem, rows * n, torch.float32,
                             K0_OPS * rows * n)
            report(f"dropout_residual {tag} ({label})", err_f, ms_f,
                   plain_f, bnd_f, lib_f)
            report(f"dropout_residual_bwd {tag} ({label})", err_b, ms_b,
                   plain_b, bnd_b, lib_b)
            if path is None:
                main["dropout_residual" + key] = kernel_row(
                    err_f, ms_f, plain_f, bnd_f, lib_f,
                    f"dropout_residual {tag}")
                main["dropout_residual_bwd" + key] = kernel_row(
                    err_b, ms_b, plain_b, bnd_b, lib_b,
                    f"dropout_residual_bwd {tag}")
        del copies
    print("  (dropout_residual library: F.dropout(x) + residual and "
          "F.dropout(g), similar work with another mask, CUDA events "
          "around eager calls; the forced path's plain and library "
          "columns are the picked path's)", flush=True)
    return main


def key_tensor(key, dev):
    """A threefry key's two uint32 words as the ``(2,)`` int32 device
    tensor the device-key entry reads."""
    return torch.tensor(np.array(key, np.uint32).view(np.int32), device=dev)


def device_key_row(K, kdo, key, tag, copies, keep_prob, dtype, dev, main):
    """The Dropout forward's device-key entry (the key read through a
    pointer, as a captured Session step launches it) against the
    launch-argument entry and the plain version on the same key, at the
    same inputs: values and bits bit-identical, 0 mask mismatches on x =
    ones, and the next key (the buffer refilled) must differ. Times it and
    the plain version with the key tensor. Returns the row's pieces for
    :func:`report_device_key`."""
    kt = key_tensor(DROPOUT_KEY, dev)
    nxt = key_tensor((DROPOUT_KEY[0], DROPOUT_KEY[1] + 1), dev)
    x = copies[0]
    want, want_bits = K.dropout_fwd(x, keep_prob, DROPOUT_KEY,
                                    return_bits=True)
    got, got_bits = K.dropout_fwd(x, keep_prob, kt, return_bits=True)
    err = check_exact(f"dropout_device_key {tag}", got, want)
    check_exact(f"dropout_device_key {tag} bits", got_bits, want_bits)
    check_exact(f"dropout_device_key {tag} vs plain", got,
                kdo.dropout_plain(x, keep_prob, kt))
    ones = torch.ones(x.shape, dtype=dtype, device=dev)
    miss = mismatches(K.dropout_fwd(ones, keep_prob, kt),
                      K.dropout_fwd(ones, keep_prob, DROPOUT_KEY))
    fault = mismatches(K.dropout_fwd(ones, keep_prob, nxt),
                       K.dropout_fwd(ones, keep_prob, DROPOUT_KEY))
    print(f"  dropout_device_key {tag}: x = ones, device-key vs "
          f"launch-argument entry mismatches {miss}; the next key in the "
          f"buffer: {fault}", flush=True)
    if miss or not fault:
        fail(f"dropout_device_key {tag}: mismatches {miss}, next-key "
             f"fault {fault}")
    ms = device_ms([lambda c=c: K.dropout_fwd(c, keep_prob, kt,
                                              return_bits=True)
                    for c in copies])
    plain = device_ms([lambda c=c: kdo.dropout_plain(c, keep_prob, kt)
                       for c in copies])
    name = key.replace("dropout", "dropout_device_key")
    return name, err, ms, plain, tag


def report_device_key(main, kkey, bnd, lib):
    name, err, ms, plain, tag = kkey
    report(f"dropout_device_key {tag}", err, ms, plain, bnd, lib)
    main[name] = kernel_row(err, ms, plain, bnd, lib,
                            f"dropout_device_key {tag}")


def phase_dropout(K, gen, dev):
    """The threefry Dropout kernels at the training shapes, bf16: (16,
    256, 4096) after each FFN-input ReLU and (16, 256, 1024) on the
    embedding; the forward (values and keep bits) and the backward from
    those bits. Bit-exact with the plain versions, on random inputs and on
    x = ones (0 mismatches); the key's second word plus one must differ in
    the values and in the bits (planted faults). Yardsticks: ``F.dropout``
    (similar work, another mask) and ``aten.native_dropout_backward`` on a
    bool mask (the backward's same work, a mask byte an element)."""
    import torch.nn.functional as F

    kdo = importlib.import_module(KMOD + "dropout")
    main = {}
    keep_prob = 1.0 - DROPOUT_RATE
    other = (DROPOUT_KEY[0], DROPOUT_KEY[1] + 1)
    for shape, key in (((TRAIN_B, TRAIN_S, 4096), "dropout"),
                       ((TRAIN_B, TRAIN_S, 1024), "dropout@embedding")):
        dtype = torch.bfloat16
        elem = elem_size(dtype)
        numel = math.prod(shape)
        copies = [torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for _ in range(n_copies(2 * numel * elem))]
        x = copies[0]
        tag = f"bf16 {shape} keep_prob {keep_prob}"
        if not kdo.vector_path(numel, x):
            fail(f"dropout {tag}: not on the vector path")
        keep = kdo.keep_mask_plain(shape, keep_prob, DROPOUT_KEY, dev)
        out, bits = K.dropout_fwd(x, keep_prob, DROPOUT_KEY,
                                  return_bits=True)
        err_f = check_exact(f"dropout {tag}", out,
                            K.dropout_plain(x, keep_prob, DROPOUT_KEY))
        check_exact(f"dropout {tag} bits", bits,
                    kdo.pack_keep_bits_plain(keep))
        g = copies[-1]
        err_b = check_exact(f"dropout_bwd {tag}",
                            K.dropout_bwd(g, keep_prob, bits),
                            K.dropout_plain(g, keep_prob, DROPOUT_KEY))
        ones = torch.ones(shape, dtype=dtype, device=dev)
        got, got_bits = K.dropout_fwd(ones, keep_prob, DROPOUT_KEY,
                                      return_bits=True)
        miss = mismatches(got, K.dropout_plain(ones, keep_prob,
                                                DROPOUT_KEY))
        miss_b = mismatches(K.dropout_bwd(ones, keep_prob, got_bits),
                            K.dropout_plain(ones, keep_prob, DROPOUT_KEY))
        fault = mismatches(got, K.dropout_plain(ones, keep_prob, other))
        bad_bits = kdo.pack_keep_bits_plain(
            kdo.keep_mask_plain(shape, keep_prob, other, dev))
        fault_bits = mismatches(got_bits, bad_bits)
        fault_b = mismatches(K.dropout_bwd(ones, keep_prob, got_bits),
                             kdo.dropout_bwd_bits_plain(ones, bad_bits,
                                                        keep_prob))
        kept = (got != 0).float().mean().item()
        print(f"  dropout {tag}: x = ones, kernel vs plain mismatches fwd "
              f"{miss} bwd {miss_b}; against the next key: values {fault}, "
              f"mask bytes {fault_bits}, backward {fault_b}; kept "
              f"{kept:.5f}, kept value {got.max().item()}", flush=True)
        if miss or miss_b or not (fault and fault_bits and fault_b):
            fail(f"dropout {tag}: mask mismatches {miss}/{miss_b}, "
                 f"next-key faults {fault}/{fault_bits}/{fault_b}")
        del ones, got, got_bits, bad_bits, keep
        kkey = device_key_row(K, kdo, key, tag, copies, keep_prob, dtype,
                              dev, main)
        saved = [K.dropout_fwd(c, keep_prob, DROPOUT_KEY,
                               return_bits=True)[1] for c in copies]
        ms_f = device_ms([lambda c=c: K.dropout_fwd(
            c, keep_prob, DROPOUT_KEY, return_bits=True) for c in copies])
        plain_f = device_ms([lambda c=c: K.dropout_plain(c, keep_prob,
                                                          DROPOUT_KEY)
                             for c in copies])
        ms_b = device_ms([lambda c=c, b=b: K.dropout_bwd(c, keep_prob, b)
                          for c, b in zip(copies, saved)])
        plain_b = device_ms([
            lambda c=c, b=b: kdo.dropout_bwd_bits_plain(c, b, keep_prob)
            for c, b in zip(copies, saved)])
        lib_f = event_ms(lambda: F.dropout(x, DROPOUT_RATE), reps=20)
        masks = [torch.rand(shape, generator=gen, device=dev) < keep_prob
                 for _ in copies]
        lib_b = device_ms([
            lambda c=c, m=m: torch.ops.aten.native_dropout_backward(
                c, m, 1.0 / keep_prob) for c, m in zip(copies, masks)])
        del masks, saved
        bits_bytes = -(-numel // 8)
        bnd_f = bound_ms(2 * numel * elem + bits_bytes, 0, torch.float32,
                         THREEFRY_OPS * numel, THREEFRY_ALU_OPS * numel)
        bnd_b = bound_ms(2 * numel * elem + bits_bytes, numel,
                         torch.float32)
        report(f"dropout {tag}", err_f, ms_f, plain_f, bnd_f, lib_f)
        report(f"dropout_bwd {tag} (from the bits)", err_b, ms_b, plain_b,
               bnd_b, lib_b)
        bkey = key.replace("dropout", "dropout_bwd")
        print(f"  dropout_bwd {tag}: from the saved bits {ms_b:.5f} ms, "
              f"by regenerating the mask before this redesign "
              f"{EARLIER_MS[bkey][0]:.5f} ms", flush=True)
        main[key] = kernel_row(err_f, ms_f, plain_f, bnd_f, lib_f,
                               f"dropout {tag}")
        main[bkey] = kernel_row(err_b, ms_b, plain_b, bnd_b, lib_b,
                                f"dropout_bwd {tag}")
        report_device_key(main, kkey, bnd_f, lib_f)
        del copies
    print(f"  (dropout bounds: the forward's the largest of its bytes "
          f"(2 + 2 + 1/8 an element), {THREEFRY_OPS} integer instructions "
          f"an element at 128 lanes a clock an SM and {THREEFRY_ALU_OPS} "
          f"ALU-only ones at 64; the backward's its bytes. Library: "
          f"F.dropout, similar work with another mask, CUDA events around "
          f"eager calls; native_dropout_backward on a bool mask)",
          flush=True)
    return main


def phase_layer_norm_bwd(K, gen, dev):
    """LayerNorm backward at the training shape, rows 4096, n 1024, bf16
    and f32 (the vector path: a warp per row); then n = 1000 bf16, which
    takes the general path, and the general path forced at n = 1024 for
    the two designs side by side. dgamma and dbeta must be bitwise equal
    over two runs."""
    kln = importlib.import_module(KMOD + "layer_norm")
    rows = TRAIN_B * TRAIN_S
    main = {}
    cases = ((torch.bfloat16, 1024, None), (torch.float32, 1024, None),
             (torch.bfloat16, 1000, None), (torch.bfloat16, 1024, 0))
    for dtype, n, force in cases:
        elem = elem_size(dtype)
        copies = [(torch.randn((rows, n), generator=gen, device=dev)
                   .mul(2).add(0.5).to(dtype),
                   torch.randn((rows, n), generator=gen, device=dev)
                   .to(dtype))
                  for _ in range(n_copies(3 * rows * n * elem))]
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
        beta = 0.1 * torch.randn(n, generator=gen, device=dev)
        stats = [K.layer_norm_plain(x, gamma, beta, return_stats=True)[1:]
                 for x, _ in copies]
        (x, dy), (mean, rstd) = copies[0], stats[0]
        nv = kln.vectors_per_lane(n, dtype, x, dy, gamma)
        if force is not None:
            nv = force

        def bwd(c, st):
            return kln.launch_bwd(c[0], gamma, st[0], st[1], c[1], nv)

        path = f"vector path, {nv} vectors a lane" if nv else "general path"
        dx, dg, db = bwd(copies[0], stats[0])
        again = bwd(copies[0], stats[0])
        rdx, rdg, rdb = K.layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
        torch.cuda.synchronize()
        name = f"layer_norm_bwd {str(dtype)[6:]} rows={rows} n={n}"
        if not (torch.equal(dg, again[1]) and torch.equal(db, again[2])):
            fail(f"{name}: dgamma/dbeta differ between two runs")
        err = max(check_scaled(f"{name} dx", dx, rdx,
                               1e-4 if dtype == torch.float32 else 2e-2),
                  check_scaled(f"{name} dgamma", dg, rdg, 1e-4),
                  check_scaled(f"{name} dbeta", db, rdb, 1e-4))
        ms = device_ms([lambda c=c, st=st: bwd(c, st)
                        for c, st in zip(copies, stats)])
        plain_ms = device_ms([lambda c=c, st=st: K.layer_norm_bwd_plain(
            c[0], gamma, st[0], st[1], c[1])
            for c, st in zip(copies, stats)])
        g_t, b_t = gamma.to(dtype), beta.to(dtype)
        lib_ms = device_ms([
            lambda c=c, st=st: torch.ops.aten.native_layer_norm_backward(
                c[1], c[0], [n], st[0][:, None], st[1][:, None], g_t, b_t,
                [True, True, True])
            for c, st in zip(copies, stats)])
        # read x, dO, gamma and the row statistics, write dx, dgamma,
        # dbeta; ~12 flops an element
        bnd = bound_ms(3 * rows * n * elem + 12 * n + 8 * rows,
                       12 * rows * n, torch.float32)
        report(f"{name} ({path})", err, ms, plain_ms, bnd, lib_ms)
        if dtype == torch.bfloat16 and n == 1024 and force is None:
            main["layer_norm_bwd"] = kernel_row(err, ms, plain_ms, bnd,
                                                lib_ms, name)
        del copies, stats
    print("  (layer_norm_bwd library: aten native_layer_norm_backward with "
          "gamma/beta in the input dtype; dgamma/dbeta bitwise equal over "
          "two runs on every path)", flush=True)
    return main


# (rows, vocab, dtypes, smoothings, key suffix of the JSON row): the causal
# LM's logits (4096, 32768) and ResNet-50's (batch 256, 1000 classes, f32
# after the fc, no smoothing)
XENT_CASES = ((TRAIN_B * TRAIN_S, 32768, (torch.bfloat16, torch.float32),
               (0.1, 0.0), ""),
              (256, 1000, (torch.float32,), (0.0,), "@resnet"))


def phase_softmax_xent(K, gen, dev):
    """Softmax cross-entropy forward and backward at the training shapes
    of ``XENT_CASES``."""
    main = {}
    for rows, vocab, dtypes, smoothings, suffix in XENT_CASES:
        main.update(xent_case(K, gen, dev, rows, vocab, dtypes, smoothings,
                              suffix))
    print("  (xent library: F.cross_entropy with label_smoothing=0, a "
          "different smoothing convention; bwd = its forward + backward)",
          flush=True)
    return main


def xent_case(K, gen, dev, rows, vocab, dtypes, smoothings, suffix):
    import torch.nn.functional as F

    main = {}
    labels = torch.randint(0, vocab, (rows,), generator=gen, device=dev,
                           dtype=torch.int32)
    labels_l = labels.long()
    g = torch.rand(rows, generator=gen, device=dev)
    for dtype in dtypes:
        f32 = dtype == torch.float32
        elem = elem_size(dtype)
        copies = [(3.0 * torch.randn((rows, vocab), generator=gen,
                                     device=dev)).to(dtype)
                  for _ in range(n_copies(rows * vocab * elem))]
        for smoothing in smoothings:
            x = copies[0]
            loss, lse = K.softmax_xent_fwd(x, labels, smoothing=smoothing)
            rloss, rlse = K.softmax_xent_fwd_plain(x, labels,
                                                   smoothing=smoothing)
            dx = K.softmax_xent_bwd(x, labels, rlse, g, smoothing=smoothing)
            rdx = K.softmax_xent_bwd_plain(x, labels, rlse, g,
                                           smoothing=smoothing)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]} rows={rows} V={vocab} ls={smoothing}"
            err_f = max(check_scaled(f"xent loss {tag}", loss, rloss, 1e-5),
                        check_scaled(f"xent lse {tag}", lse, rlse, 1e-5))
            tol_b = 1e-5 if f32 else 1e-2
            err_b = check_elementwise(f"xent dx {tag}", dx, rdx, tol_b)
            if smoothing > 0:
                check_xent_bwd_faults(x, labels, rlse, g, rdx, smoothing,
                                      tol_b, tag)
            del dx, rdx
            lses = [K.softmax_xent_fwd_plain(c, labels,
                                             smoothing=smoothing)[1]
                    for c in copies]
            ms_f = device_ms([lambda c=c: K.softmax_xent_fwd(
                c, labels, smoothing=smoothing) for c in copies])
            plain_f = device_ms([lambda c=c: K.softmax_xent_fwd_plain(
                c, labels, smoothing=smoothing) for c in copies])
            ms_b = device_ms([lambda c=c, ls=ls: K.softmax_xent_bwd(
                c, labels, ls, g, smoothing=smoothing)
                for c, ls in zip(copies, lses)])
            plain_b = device_ms([lambda c=c, ls=ls: K.softmax_xent_bwd_plain(
                c, labels, ls, g, smoothing=smoothing)
                for c, ls in zip(copies, lses)])
            # yardstick: F.cross_entropy WITHOUT smoothing (PyTorch's
            # smoothing convention is another function), forward, and
            # forward + backward
            lib_f = device_ms([lambda c=c: F.cross_entropy(
                c, labels_l, reduction="none") for c in copies])
            xg = x.detach().requires_grad_()
            lib_fb = event_ms(lambda: torch.autograd.grad(
                F.cross_entropy(xg, labels_l, reduction="none"), xg, g))
            bnd_f = bound_ms(rows * vocab * elem + 12 * rows,
                             5 * rows * vocab, torch.float32)
            bnd_b = bound_ms(2 * rows * vocab * elem + 12 * rows,
                             4 * rows * vocab, torch.float32)
            report(f"softmax_xent_fwd {tag}", err_f, ms_f, plain_f, bnd_f,
                   lib_f)
            report(f"softmax_xent_bwd {tag}", err_b, ms_b, plain_b, bnd_b,
                   lib_fb)
            if suffix or (not f32 and smoothing > 0):
                main["softmax_xent_fwd" + suffix] = kernel_row(
                    err_f, ms_f, plain_f, bnd_f, lib_f,
                    f"softmax_xent_fwd {tag}")
                main["softmax_xent_bwd" + suffix] = kernel_row(
                    err_b, ms_b, plain_b, bnd_b, lib_fb,
                    f"softmax_xent_bwd {tag}")
            del xg
        del copies
    return main


def check_xent_bwd_faults(x, labels, lse, g, rdx, smoothing, tol, tag):
    """The dx check above must fail a backward that leaves out the
    smoothing mass ``low * g`` of every non-label column, and (at f32,
    where the values resolve it) one that scales ``p`` by 1.001: both
    faults built from the plain version on this phase's inputs."""
    low = smoothing / (x.shape[-1] - 1)
    gl = low * g
    faults = {"no low": rdx.float() + gl[:, None]}
    faults["no low"].scatter_add_(1, labels.long()[:, None], -gl[:, None])
    if x.dtype == torch.float32:
        p = torch.exp(x.float() - lse[:, None])
        faults["p x 1.001"] = rdx.float() + 1e-3 * p * g[:, None]
        del p
    readings = []
    for fault, dx in faults.items():
        ratio, err = elementwise_ratio(dx.to(x.dtype), rdx, tol)
        if not ratio > 1.0:
            fail(f"xent dx {tag}: the check passes a planted fault "
                 f"({fault}: max abs err {err:.3e}, {ratio:.3e} of the "
                 f"bound)")
        readings.append(f"{fault} at {ratio:.3e}x its bound")
    print(f"  xent dx {tag}: the check fails planted faults: "
          f"{', '.join(readings)}", flush=True)


def adam_group_sizes(cfg):
    """Elements of the (f32, f32) and (bf16, f32) Adam groups of the
    causal LM under bf16 compute: the embedding and LayerNorm parameters,
    and the Dense kernels and biases."""
    from simple_tensorflow_tpu_torch import convert

    sizes = [0, 0]
    for name, shape in convert._shapes(cfg).items():
        dense = name.endswith((".kernel", ".bias"))
        sizes[int(dense)] += math.prod(shape)
    return sizes


def phase_adam(K, gen, dev, cfg):
    """Fused Adam over the two flat groups of the bf16 training path: f32
    parameters (embedding, LayerNorm) and bf16 parameters (Dense), f32
    slots. Bit-exact with the plain version."""
    main = {}
    kw = dict(beta1=0.9, beta2=0.997, eps=1e-9)
    alpha = torch.tensor(1e-3, device=dev)
    for dtype, n in zip((torch.float32, torch.bfloat16),
                        adam_group_sizes(cfg)):
        p = torch.randn(n, generator=gen, device=dev).to(dtype)
        m = 0.1 * torch.randn(n, generator=gen, device=dev)
        v = 0.01 * torch.rand(n, generator=gen, device=dev)
        g = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
        got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
        ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                                  **kw)
        torch.cuda.synchronize()
        name = f"adam_update {str(dtype)[6:]} params n={n}"
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{name}: kernel is not bit-exact with its plain version")
        del got, ref
        err = 0.0
        ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
        plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                          **kw)])
        pt = torch.nn.Parameter(p.clone())
        pt.grad = g.clone()
        opt = torch.optim.Adam([pt], lr=1e-3, betas=(0.9, 0.997), eps=1e-9,
                               fused=True)
        lib_ms = event_ms(opt.step)
        pe = elem_size(dtype)
        # read p, g, m, v; write p, m, v; ~12 flops an element
        bnd = bound_ms(n * (3 * pe + 16), 12 * n, torch.float32)
        report(name, err, ms, plain_ms, bnd, lib_ms)
        if dtype == torch.bfloat16:
            main["adam_update"] = kernel_row(err, ms, plain_ms, bnd, lib_ms,
                                             name)
        del p, m, v, g, pt, opt
    print("  (adam library: torch.optim.Adam(fused=True).step, whose slots "
          "take the parameter's dtype)", flush=True)
    return main


def resnet_group_sizes():
    """Elements of ResNet-50's two Momentum groups under bf16: the conv
    kernels (bf16 parameters) and BatchNorm gamma/beta with the fc (f32)."""
    from simple_tensorflow_tpu_torch.models import resnet

    model = resnet.ResNet(50, 1000, device="meta")
    sizes = [0, 0]
    for p in model.parameters():
        sizes[int(p.dim() != 4)] += p.numel()
    return sizes


MOMENTUM_LR, MOMENTUM_MU = 0.1, 0.9           # resnet50_train_model's recipe


def phase_momentum(K, gen, dev):
    """Fused Momentum over the two flat groups of the ResNet-50 path:
    bf16 parameters (the conv kernels) and f32 parameters (BatchNorm and
    fc), f32 accumulators, plain and Nesterov, from non-zero accumulators
    (a step from zero never reads ``mu``). Bit-exact with the plain
    version (0 mismatches in p and acc); two planted faults, ``mu`` one
    ulp larger and the Nesterov flag flipped, must each differ."""
    main = {}
    lr = torch.tensor(MOMENTUM_LR, device=dev)
    mu = torch.tensor(MOMENTUM_MU, device=dev)
    mu_off = torch.nextafter(mu, torch.tensor(1.0, device=dev))
    for dtype, n in zip((torch.bfloat16, torch.float32),
                        resnet_group_sizes()):
        p = torch.randn(n, generator=gen, device=dev).to(dtype)
        acc = 0.5 * torch.randn(n, generator=gen, device=dev)
        g = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
        pe = elem_size(dtype)
        for nesterov in (False, True):
            # the timed launches update copies in place: repeated steps
            # with one g drive acc to g / (1 - mu), where Nesterov and
            # plain Momentum take the same step, so the checks below
            # always see the fresh inputs
            name = (f"momentum_update {str(dtype)[6:]} params n={n}"
                    f"{' nesterov' if nesterov else ''}")
            got = K.momentum_update(p.clone(), acc.clone(), g, lr, mu,
                                    use_nesterov=nesterov)
            ref = K.momentum_update_plain(p.clone(), acc.clone(), g, lr, mu,
                                          use_nesterov=nesterov)
            torch.cuda.synchronize()
            miss = [mismatches(a, b) for a, b in zip(got, ref)]
            faults = {
                "mu + 1 ulp": K.momentum_update_plain(
                    p.clone(), acc.clone(), g, lr, mu_off,
                    use_nesterov=nesterov),
                "nesterov flipped": K.momentum_update_plain(
                    p.clone(), acc.clone(), g, lr, mu,
                    use_nesterov=not nesterov)}
            seen = {f: [mismatches(a, b) for a, b in zip(got, bad)]
                    for f, bad in faults.items()}
            print(f"  {name}: kernel vs plain mismatches p {miss[0]} acc "
                  f"{miss[1]}; planted faults (p, acc) {seen}", flush=True)
            if any(miss):
                fail(f"{name}: kernel is not bit-exact with its plain "
                     f"version ({miss} elements of p, acc differ)")
            missed = [f for f, m in seen.items() if not any(m)]
            if missed:
                fail(f"{name}: the check passes planted faults {missed}")
            del got, ref, faults
            # copies past the L2 (the f32 group's 42 MB fits in it), read
            # cold as the step after a backward reads them
            copies = [(p.clone(), acc.clone(), g.clone()) for _ in
                      range(n_copies(n * (3 * pe + 8)))]
            ms = device_ms([lambda c=c: K.momentum_update(
                *c, lr, mu, use_nesterov=nesterov) for c in copies])
            plain_ms = device_ms([lambda c=c: K.momentum_update_plain(
                *c, lr, mu, use_nesterov=nesterov) for c in copies])
            del copies
            pt = torch.nn.Parameter(p.clone())
            pt.grad = g.clone()
            opt = torch.optim.SGD([pt], lr=MOMENTUM_LR,
                                  momentum=MOMENTUM_MU, nesterov=nesterov,
                                  fused=True)
            lib_ms = event_ms(opt.step)
            # read p, g, acc; write p, acc; mu * acc + g, lr * acc and the
            # subtraction (Nesterov: two more) an element
            bnd = bound_ms(n * (3 * pe + 8), (6 if nesterov else 4) * n,
                           torch.float32)
            report(name, 0.0, ms, plain_ms, bnd, lib_ms)
            if dtype == torch.bfloat16 and not nesterov:
                main["momentum_update"] = kernel_row(0.0, ms, plain_ms, bnd,
                                                     lib_ms, name)
            del pt, opt
        del p, acc, g
    print("  (momentum library: torch.optim.SGD(momentum=0.9, fused=True)"
          ".step, whose buffer takes the parameter's dtype: bf16 for the "
          "bf16 group)", flush=True)
    return main


# -- serving phase -------------------------------------------------------------

PROMPT_LENS = (17, 23, 96, 31, 40, 48, 55, 63, 70, 77, 85, 90)
SHARED_AT = (2, 4, 7, 9)         # these four start with the same 32 tokens
# request 9 is the head of request 2: its cached tail is a proper prefix
# of one of request 2's pages, so admission builds it by copy-on-write
PREFIX_OF = {9: 2}
MAX_NEW = 24
# the traced decode window: this many requests (bucket 16) of TRACE_PROMPT
# tokens and TRACE_NEW new ones (slack for the profiler's start while the
# engine steps on), traced over TRACE_STEPS engine steps
TRACE_REQUESTS, TRACE_PROMPT, TRACE_NEW, TRACE_STEPS = 16, 20, 96, 16


def make_prompts(vocab, seed=1):
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(2, vocab, 32))
    prompts = []
    for i, n in enumerate(PROMPT_LENS):
        if i in PREFIX_OF:
            prompts.append(prompts[PREFIX_OF[i]][:n])
            continue
        head = shared if i in SHARED_AT else []
        prompts.append(head + list(rng.randint(2, vocab, n - len(head))))
    return prompts


def stream_errors(h, model, result, int8):
    """The teacher-forced rule on the plain hidden states ``h (T, d)`` of a
    request's stream: every emitted token is an argmax of the plain logits
    within rel 1e-4 of the largest |logit|, and its log-prob is within
    1e-3 of the plain one. With the int8 head, one activation element
    that rounds the other way (the hidden states differ by f32 round-off)
    moves a logit by up to x_scale * max|w_scale * wq|, so each bound
    also takes twice that step. Returns ``(steps not argmax, steps whose
    log-prob is off, max log-prob error)``."""
    from simple_tensorflow_tpu_torch.ops import kernels as K

    toks = [int(t) for t in result["tokens"]]
    if int8:
        logits = K.quant_matmul_plain(h, model.wq, model.w_scale).float()
        _, xs = K.quantize_rowwise_plain(h)
        wmax = (model.w_scale[None, :] * model.wq.abs().float()).max()
        extra = 2.0 * xs * wmax
    else:
        logits = torch.matmul(h, model.stack.shared_embedding.t()).float()
        extra = torch.zeros(len(toks), device=h.device)
    tok_t = torch.tensor(toks, dtype=torch.long, device=h.device)
    chosen = logits.gather(1, tok_t[:, None])[:, 0]
    top = logits.max(dim=1).values
    arg_tol = 1e-4 * logits.abs().max(dim=1).values + extra
    logp_ref = torch.log_softmax(logits, dim=1).gather(
        1, tok_t[:, None])[:, 0]
    logp = torch.from_numpy(np.asarray(result["logprobs"],
                                       np.float32)).to(h.device)
    lp_err = (logp - logp_ref).abs()
    bad_arg = (chosen < top - arg_tol).nonzero().flatten().tolist()
    bad_lp = (lp_err > 1e-3 + extra).nonzero().flatten().tolist()
    return bad_arg, bad_lp, lp_err.max().item()


def check_stream(model, prompt, result, int8):
    """Teacher-forced check of one request against the plain re-forward
    on the card (``stream_errors``)."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    seq = list(prompt) + [int(t) for t in result["tokens"]]
    ids = torch.tensor([seq[:-1]], dtype=torch.long, device=model.device)
    h = clm.causal_lm_hidden_plain(model.stack, ids)[0, len(prompt) - 1:]
    bad_arg, bad_lp, err = stream_errors(h, model, result, int8)
    if bad_arg or bad_lp:
        fail(f"token stream disagrees with the plain re-forward "
             f"(int8={int8}): not argmax at steps {bad_arg}, logp off at "
             f"steps {bad_lp} (max logp err {err:.3e})")
    return err


def wait_for(cond, what, timeout=120.0):
    t_end = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > t_end:
            fail(f"timed out waiting for {what}")
        time.sleep(0.0005)


def trace_window(eng, vocab, seed):
    """One traced window (``trace_decode``): ``(device_times, engine
    steps, host step seconds)``. The profiler starts and stops only while
    the engine thread is parked in a token callback, between two steps:
    stopping it while that thread launched a CUDA graph deadlocked the
    two (the profiler's flush and the graph launch)."""
    from torch.profiler import ProfilerActivity, profile

    gate, parked = threading.Event(), threading.Event()
    gate.set()

    def park(tok, lp):
        if not gate.is_set():
            parked.set()
            gate.wait()

    def pause():
        parked.clear()
        gate.clear()
        if not parked.wait(120):
            fail("the engine did not reach a token callback")

    rng = np.random.RandomState(seed)
    futs = [eng.generate(list(rng.randint(2, vocab, TRACE_PROMPT)),
                         max_new_tokens=TRACE_NEW, on_token=park)
            for _ in range(TRACE_REQUESTS)]
    wait_for(lambda: eng.metrics.slots_active == TRACE_REQUESTS,
             "the traced requests to start decoding")
    s0 = eng.metrics.steps
    wait_for(lambda: eng.metrics.steps > s0, "a decode step")
    pause()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            s1, n0 = eng.metrics.steps, len(eng.metrics.step_seconds)
            gate.set()
            wait_for(lambda: eng.metrics.steps >= s1 + TRACE_STEPS,
                     "the traced decode steps")
            pause()
            steps = eng.metrics.steps - s1
            host = list(eng.metrics.step_seconds)[n0:]
    finally:
        gate.set()
    for f in futs:
        f.result(timeout=600)
    return device_times(prof), steps, host


def trace_decode(eng, vocab, head, need, attempts=3):
    """Device time a decode step of the engine at bucket 16: once
    ``TRACE_REQUESTS`` fresh requests are all decoding, a
    ``torch.profiler`` window (CUDA activity, which CUPTI records for the
    engine's thread too) spans at least ``TRACE_STEPS`` engine steps,
    counted by the engine; the window opens and closes while the engine
    is parked between two steps (``trace_window``), so it holds exactly
    those steps; device ms a step is the trace's device time over them. A window whose trace
    kept fewer kernel launches than steps lost its kernel records (seen
    once in five windows: only the copies were traced) and is taken again
    with fresh requests, up to ``attempts`` windows. Prints the device ms
    a step beside the host p50 step of the same window and the top
    kernels; fails when a kernel named in ``need`` is not in the trace.
    The engine runs as it does without the trace but for the two parks,
    which fall outside its steps' timed spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # set the tracer up
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    tag = f"serving[{head}] trace"
    for attempt in range(attempts):
        by_name, steps, host = trace_window(eng, vocab, 5 + attempt)
        launches = sum(k for nm, (_, k) in by_name.items()
                       if not nm.startswith(("Memcpy", "Memset")))
        if launches >= steps:
            break
        print(f"{tag}: window {attempt + 1} kept {launches} kernel "
              f"launches in {steps} steps (records lost); tracing again",
              flush=True)
    else:
        print(f"{tag}: every window lost its kernel records; device ms a "
              f"decode step not measured", flush=True)
        return None
    check_traced(tag, by_name, need)
    dev_ms = sum(ms for ms, _ in by_name.values()) / steps
    p50 = statistics.median(host) * 1e3
    print(f"{tag}: {steps} decode steps at bucket {TRACE_REQUESTS} "
          f"traced, device {dev_ms:.4f} ms a step beside a host p50 step "
          f"of {p50:.4f} ms in the same window ({100 * dev_ms / p50:.1f}% "
          f"busy)", flush=True)
    for nm, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {ms / steps:9.4f} ms/step  {k / steps:5.2f} launches/step"
              f"  {nm[:100]}", flush=True)
    return dev_ms, p50


def serve(params, cfg, int8, prompts, dev, need, aot=True):
    """Serve ``prompts`` through ``GenerativeEngine`` at the model's
    published width, the decode and prefill buckets captured as CUDA
    graphs (``aot_warmup``) or, with ``aot`` False, dispatched eagerly.
    Returns the run's launches and its numbers: tokens/s, p50 decode
    step, p50 time to first token, device ms a decode step at bucket 16
    and the host p50 step of that traced window."""
    from simple_tensorflow_tpu_torch import serving
    from simple_tensorflow_tpu_torch.models import causal_lm as clm
    from simple_tensorflow_tpu_torch.ops import kernels as K

    head = ("int8" if int8 else "f32") + ("" if aot else " eager")
    t_build = time.perf_counter()
    model = clm.CausalLMGenerativeModel(
        cfg, page_len=16, pages_per_seq=16, num_pages=256, max_live=16,
        decode_bucket_sizes=[1, 4, 16], prefill_bucket_sizes=[1, 4],
        int8=int8, params=params, aot_warmup=aot, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t_build
    policy = serving.DecodePolicy(num_slots=16, max_decode_len=256,
                                  bucket_sizes=[1, 4, 16],
                                  max_new_tokens=MAX_NEW)
    with serving.GenerativeEngine(f"smoke_{head}", model, policy) as eng:
        # warm-up: one unrelated request (library loads, cuBLAS handles)
        eng.generate(list(range(2, 20)), max_new_tokens=2).result(600)
        torch.cuda.synchronize()
        steps0 = eng.metrics.steps
        samples0 = len(eng.metrics.step_seconds)
        pc0 = eng.statusz_info()["prefix_cache"]
        hits0 = pc0["hit_pages"] + pc0["cow_hits"]
        first = [None] * len(prompts)

        def on_token(i):
            def cb(tok, lp):
                if first[i] is None:
                    first[i] = time.perf_counter()
            return cb

        K.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [eng.generate(p, max_new_tokens=MAX_NEW, on_token=on_token(i))
                for i, p in enumerate(prompts)]
        results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        steps = eng.metrics.steps - steps0
        step_s = list(eng.metrics.step_seconds)[samples0:]
        pc = eng.statusz_info()["prefix_cache"]
        hits = pc["hit_pages"] + pc["cow_hits"] - hits0
        traced = trace_decode(eng, cfg.vocab_size, head, need)
    ttft = statistics.median(f - t0 for f in first if f is not None) * 1e3
    emitted = sum(len(r["tokens"]) for r in results)
    p50 = statistics.median(step_s) * 1e3
    print(f"serving[{head}]: {len(results)} requests, {emitted} tokens in "
          f"{wall:.4f} s = {emitted / wall:.2f} tokens/s, {steps} decode "
          f"steps, p50 decode step {p50:.4f} ms, p50 time to first token "
          f"{ttft:.4f} ms (the 12 requests submitted together), "
          f"prefix-cache hit pages {hits} (cow {pc['cow_hits']}), outcomes "
          f"{sorted({r['outcome'] for r in results})}; model built "
          f"{'with its bucket graphs captured ' if aot else ''}in "
          f"{t_build:.3f} s", flush=True)
    print(f"serving[{head}]: launches {counts}", flush=True)
    need = ["decode_attention", "decode_attention_block", "layer_norm"]
    if int8:
        need.append("quant_matmul")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        fail(f"serving[{head}]: kernels {missing} were not launched")
    # per decode step: one DecodeAttention and two LayerNorms per layer
    # (and one QuantMatMul with the int8 head); per prefill chunk: one
    # block DecodeAttention and two LayerNorms per layer
    n_layers = cfg.num_layers
    if counts["decode_attention"] != n_layers * steps or \
            counts["layer_norm"] != 2 * (counts["decode_attention"]
                                         + counts["decode_attention_block"]) \
            or counts["quant_matmul"] != (steps if int8 else 0):
        fail(f"serving[{head}]: launch counts {counts} do not match "
             f"{steps} decode steps of {n_layers} layers")
    if hits == 0:
        fail(f"serving[{head}]: no prefix-cache hit")
    worst = 0.0
    for p, r in zip(prompts, results):
        if r["outcome"] not in ("eos", "length") or not len(r["tokens"]):
            fail(f"serving[{head}]: bad result {r}")
        if not np.all(np.isfinite(r["logprobs"])):
            fail(f"serving[{head}]: non-finite log-probs")
        err = check_stream(model, p, r, int8)
        worst = max(worst, err)
    print(f"serving[{head}]: every token matches the plain re-forward "
          f"(max logp err {worst:.3e})", flush=True)
    return counts, {"tokens_s": emitted / wall, "p50_ms": p50,
                    "ttft_ms": ttft, "traced": traced}


# the fixed call script of check_serving_graphs: decode batch sizes (rows
# 0 .. n-1), every bucket, partial buckets, and a small batch replayed
# right after a larger one in the same bucket
GRAPH_DECODE_ROWS = (16, 3, 1, 9, 4, 2, 16, 1, 3)


def check_serving_graphs(params, cfg, dev):
    """The serving model with ``aot_warmup=True`` against ``False`` at the
    published width, both heads, on one fixed script of calls: prefill of
    16 sequences' first page (four bucket-4 replays), five sequences'
    second page (buckets 4 and 1), then decode steps of
    ``GRAPH_DECODE_ROWS`` rows. Tokens int-exact and log-probs
    bit-identical at every step."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    rng = np.random.RandomState(3)
    n, pl = 16, 16
    chunks = rng.randint(2, cfg.vocab_size, (n, 2, pl)).astype(np.int32)
    for int8 in (False, True):
        got = {}
        for aot in (True, False):
            model = clm.CausalLMGenerativeModel(
                cfg, page_len=pl, pages_per_seq=16, num_pages=256,
                max_live=16, decode_bucket_sizes=[1, 4, 16],
                prefill_bucket_sizes=[1, 4], int8=int8, params=params,
                aot_warmup=aot, device=dev)
            tables = np.full((n, 16), model.scratch_page, np.int32)
            tables[:, :3] = np.arange(3 * n).reshape(n, 3)
            model.prefill_chunk(chunks[:, 0], np.zeros(n, np.int32), tables,
                                tables[:, 0])
            model.prefill_chunk(chunks[:5, 1], np.full(5, pl, np.int32),
                                tables[:5], tables[:5, 1])
            pos = np.where(np.arange(n) < 5, 2 * pl, pl).astype(np.int32)
            last = np.where(np.arange(n) < 5, chunks[:, 1, -1],
                            chunks[:, 0, -1]).astype(np.int32)
            outs = []
            for rows in GRAPH_DECODE_ROWS:
                tok, lp, _ = model.decode(last[:rows], pos[:rows],
                                          tables[:rows])
                outs.append((tok.copy(), lp.copy()))
                last[:rows], pos[:rows] = tok, pos[:rows] + 1
            got[aot] = outs
            model.close()
            del model
        tok_eq = all(np.array_equal(a[0], b[0])
                     for a, b in zip(got[True], got[False]))
        lp_eq = all(np.array_equal(a[1], b[1])
                    for a, b in zip(got[True], got[False]))
        rel = max(float(np.max(np.abs(a[1] - b[1])
                               / np.maximum(np.abs(b[1]), 1e-30)))
                  for a, b in zip(got[True], got[False]))
        head = "int8" if int8 else "f32"
        print(f"serving graphs[{head}]: aot_warmup True vs False over "
              f"{len(GRAPH_DECODE_ROWS)} decode steps of {GRAPH_DECODE_ROWS}"
              f" rows after 6 prefill replays: tokens identical {tok_eq}, "
              f"log-probs bit-identical {lp_eq} (max relative difference "
              f"{rel:.3e})", flush=True)
        if not (tok_eq and lp_eq):
            fail(f"serving graphs[{head}]: the captured buckets are off the "
                 f"eager ones")


# -- training phase ------------------------------------------------------------

TRAIN_STEPS = 16
# a warm-up this long keeps the learning rate (1.2e-4 at step 16) below
# the point where Adam overshoots on one repeated batch: with 16 the loss
# stalled after five steps (at dropout 0)
TRAIN_WARMUP = 256
# the bf16 window's loss check compares the means of its first and last
# this many steps: with dropout, each step draws other masks, so the loss
# on the repeated batch is noisy from step to step
LOSS_MEAN_OF = 4


def per_step(cfg):
    """Launches of one training step: per layer one flash attention (fwd,
    dK/dV, dQ) and two LayerNorms (fwd, bwd); one xent (fwd, bwd); with
    dropout, per layer one dropout-residual (fwd, bwd) and one FFN
    Dropout, and one embedding Dropout (fwd, bwd). Adam is counted apart
    (one launch per flat group)."""
    n = cfg.num_layers
    want = {"flash_attention_fwd": n, "flash_attention_dkdv": n,
            "flash_attention_dq": n, "layer_norm": 2 * n,
            "layer_norm_bwd": 2 * n, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1}
    if cfg.dropout > 0:
        want.update(dropout_residual=n, dropout_residual_bwd=n,
                    dropout=n + 1, dropout_bwd=n + 1)
    return want


def expected_counts(names, steps, adam_groups, cfg):
    want = {k: 0 for k in names}
    for k, v in per_step(cfg).items():
        want[k] = v * steps
    want["adam_update"] = adam_groups * steps
    return want


def train_batch(vocab, seed=7):
    """One LM batch: random tokens, targets shifted by one, the last
    target of every row the pad id (weight 0)."""
    rng = np.random.RandomState(seed)
    tok_in = rng.randint(2, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    tok_out = np.roll(tok_in, -1, axis=1)
    tok_out[:, -1] = 0
    return tok_in, tok_out


def grad_rel_errs(a, b):
    """{parameter: relative norm error of a's gradient against b's}, the
    attention key biases apart (their exact gradient is zero: a softmax
    does not change when the same q . b_k is added to every score of a
    row, so both sides hold roundoff only)."""
    grads_b = dict(b.stack.named_parameters())
    out = {}
    for name, pa in a.stack.named_parameters():
        if not name.endswith("self_attn.k.bias"):
            ga, gb = pa.grad.float(), grads_b[name].grad.float()
            out[name] = ((ga - gb).norm() / gb.norm()).item()
    return out


def relu_recording(trainer, signs=None, masks=None):
    """Swap each layer's FFN-input ReLU for one that appends its
    pre-activation's sign mask to ``signs``; with ``masks`` (one per
    layer), gate by those masks instead of the pre-activation's own
    signs."""
    for i, layer in enumerate(trainer.stack.layers):
        def act(y, i=i):
            if signs is not None:
                signs.append(y.detach() > 0)
            if masks is not None:
                return y * masks[i].to(y.dtype)
            return torch.relu(y)
        layer.ffn["in"].activation = act


@contextlib.contextmanager
def planted(module, name, wrap):
    """Within the block, ``module.name`` is ``wrap(module.name)``."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


# kernels vs plain, each run with its own ReLU gates: the few gates that
# flip on f32 roundoff carry their whole gradient row into the error. On an
# H100 80GB HBM3 at 700 W dropout 0 reads 5.194e-4 (a few flips per layer)
# and dropout 0.1 reads 1.170e-3 (two flips in layer 1, its activations
# scaled by 1 / 0.9), so that rate takes 2e-3. The limit that planted
# faults must fail is the shared-mask one, the same at both rates.
F32_GRAD_TOL = {0.0: 1e-3, DROPOUT_RATE: 2e-3}
F32_SHARED_TOL = 1e-4        # kernels vs plain, the plain run's ReLU mask


def check_f32_step(K, cfg, params, batch, dev):
    """One f32 step through the kernels against the same step through
    the plain versions, both on the card: the loss, and every parameter's
    gradient by relative norm. Three more readings explain and test the
    gradient limit: the FFN-input units whose ReLU gate differs between
    the two runs; the kernel step again with the plain run's ReLU masks,
    held to the tighter ``F32_SHARED_TOL``; and two planted faults under
    those shared masks (dQ scaled by 1.001, the xent backward without
    smoothing), each of which must fail that limit. A second plain step
    gives the floor: the plain step is deterministic on the card. With
    ``cfg.dropout > 0`` every trainer starts at the same RNG counter, so
    each run draws the same dropout masks. Returns the kernel run's
    launches."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    # the modules (the package re-exports functions under their names)
    flash_attention = importlib.import_module(KMOD + "flash_attention")
    softmax_xent = importlib.import_module(KMOD + "softmax_xent")

    def run(plain=False, signs=None, masks=None):
        t = clm.causal_lm_trainer(
            TRAIN_B, TRAIN_S, cfg, compute_dtype=torch.float32,
            params=params, device=dev, plain=plain)
        relu_recording(t, signs, masks)
        return t, t.step(*batch).item()

    tag = f"train[f32 dropout {cfg.dropout}]"
    grad_tol = F32_GRAD_TOL[cfg.dropout]
    signs_p, signs_k = [], []
    tp, loss_p = run(plain=True, signs=signs_p)
    before = K.launch_counts()
    tp2, _ = run(plain=True)
    floor = max(grad_rel_errs(tp2, tp).values())
    del tp2
    if K.launch_counts() != before:
        fail(f"{tag}: the plain step launched kernels")
    K.reset_launch_counts()
    tk, loss_k = run(signs=signs_k)
    counts = K.launch_counts()
    want = expected_counts(counts, 1, 1, cfg)
    if counts != want:
        fail(f"{tag}: launches {counts}, expected per step {want}")
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        fail(f"{tag}: loss {loss_k} through the kernels, {loss_p} "
             f"through the plain versions")
    grads_p = dict(tp.stack.named_parameters())
    for name, pk in tk.stack.named_parameters():
        if name.endswith("self_attn.k.bias"):
            scale = grads_p[name[:-4] + "kernel"].grad.float().norm().item()
            for g in (pk.grad, grads_p[name].grad):
                if g.float().norm().item() > 1e-5 * scale:
                    fail(f"{tag}: {name} gradient is not roundoff")
    errs = grad_rel_errs(tk, tp)
    del tk
    flips = [int((a != b).sum().item()) for a, b in zip(signs_k, signs_p)]
    tm, _ = run(masks=signs_p)
    shared = grad_rel_errs(tm, tp)
    del tm
    faults = {}
    for fault, module, name, wrap in (
            ("dq x 1.001", flash_attention, "flash_attention_dq",
             lambda f: lambda *a, **k: f(*a, **k) * 1.001),
            ("xent bwd without smoothing", softmax_xent, "softmax_xent_bwd",
             lambda f: lambda *a, **k: f(*a, **dict(k, smoothing=0.0)))):
        with planted(module, name, wrap):
            tf, _ = run(masks=signs_p)
        faults[fault] = max(grad_rel_errs(tf, tp).values())
        del tf
    del tp

    def worst(e, n=3):
        return [(k, f"{v:.3e}") for k, v in
                sorted(e.items(), key=lambda kv: -kv[1])[:n]]

    units = signs_p[0].numel()
    print(f"{tag}: loss {loss_k:.7f} (kernels) vs {loss_p:.7f} "
          f"(plain); launches {counts}", flush=True)
    print(f"{tag}: gradient rel err, worst: {worst(errs)} (limit "
          f"{grad_tol}); plain vs plain worst {floor:.3e}", flush=True)
    print(f"{tag}: FFN-input ReLU gates that differ, kernels vs plain, "
          f"per layer (of {units}): {flips}", flush=True)
    print(f"{tag}: with the plain run's ReLU masks shared, gradient "
          f"rel err, worst: {worst(shared)} (limit {F32_SHARED_TOL})",
          flush=True)
    print(f"{tag}: planted faults, shared masks, worst gradient rel "
          f"err: {', '.join(f'{k} {v:.3e}' for k, v in faults.items())}",
          flush=True)
    bad = {n: e for n, e in errs.items() if not e <= grad_tol}
    if bad:
        fail(f"{tag}: gradient rel err above {grad_tol}: {bad}")
    bad = {n: e for n, e in shared.items() if not e <= F32_SHARED_TOL}
    if bad:
        fail(f"{tag}: with shared ReLU masks, gradient rel err above "
             f"{F32_SHARED_TOL}: {bad}")
    missed = [k for k, v in faults.items() if not v > F32_SHARED_TOL]
    if missed:
        fail(f"{tag}: the shared-mask limit passes planted faults "
             f"{missed}: {faults}")
    return counts


def key_derivation_us(trainer, reps=20):
    """Host microseconds a step to derive its dropout keys and seeds, as
    the trainer does: one :meth:`StepRNG.for_steps` pass over a block of
    ``RNG_BLOCK`` steps, divided by the block; the median of ``reps``
    blocks."""
    from simple_tensorflow_tpu_torch.framework.random_seed import StepRNG
    from simple_tensorflow_tpu_torch.models.causal_lm import RNG_BLOCK

    times = []
    for i in range(reps):
        block = range(i * RNG_BLOCK + 1, (i + 1) * RNG_BLOCK + 1)
        t0 = time.perf_counter()
        StepRNG.for_steps(block, trainer._key_sites, trainer._seed_sites)
        times.append((time.perf_counter() - t0) / RNG_BLOCK)
    return statistics.median(times) * 1e6


def train_phase(K, cfg, params, dev, kernel_rows, notes):
    """The training main paths (module docstring, phase 4). Returns
    ``[(path, dropout, launches)]``: the two f32 kernel steps and the two
    bf16 windows, each counted from zero just before it. Leaves the
    shipped config's device ms a step in ``notes["lm_device_ms"]`` (the
    causal-LM Session phase compares against it)."""
    batch = train_batch(cfg.vocab_size)
    paths = []
    for rate in (0.0, cfg.dropout):
        cfg_f32 = dataclasses.replace(cfg, dropout=rate)
        paths.append((f"train f32 dropout {rate}", rate,
                      check_f32_step(K, cfg_f32, params, batch, dev)))
        torch.cuda.empty_cache()

    # the shipped config's window and, interleaved step by step in the
    # same call, the same window at dropout 0: the cost of dropout
    rates = (cfg.dropout, 0.0)
    runs = bf16_windows(K, [dataclasses.replace(cfg, dropout=r)
                            for r in rates], params, batch, dev)
    (trainer, losses, times, counts), (trainer0, losses0, times0,
                                       counts0) = runs
    peak = torch.cuda.max_memory_allocated()
    n_groups = len(trainer.optimizer.flat_groups)
    paths.append(("train bf16", cfg.dropout, counts))
    paths.append(("train bf16 dropout 0", 0.0, counts0))
    first = statistics.mean(losses[:LOSS_MEAN_OF])
    last = statistics.mean(losses[-LOSS_MEAN_OF:])
    if not (last < first and losses[-1] < losses[0]):
        fail(f"train[bf16]: the loss does not fall (mean of the first "
             f"{LOSS_MEAN_OF} {first}, of the last {last}): {losses}")
    if not all(b < a for a, b in zip(losses0, losses0[1:])):
        fail(f"train[bf16 dropout 0]: the loss does not fall at every "
             f"step: {losses0}")
    p50, p50_0 = statistics.median(times), statistics.median(times0)
    tokens = TRAIN_B * TRAIN_S
    steps = per_step(cfg)
    suffix = "_dropout" if cfg.dropout > 0 else ""
    rows = {k: kernel_rows[k + suffix if k.startswith("flash") else k]
            for k in steps if k != "layer_norm"}
    rows["layer_norm"] = kernel_rows["layer_norm@train"]
    rows["adam_update"] = kernel_rows["adam_update"]
    kern_ms = sum(rows[k]["ms"] * v for k, v in steps.items())
    kern_ms += rows["adam_update"]["ms"] * n_groups
    if cfg.dropout > 0:
        # one of the Dropouts (fwd and bwd) is the embedding's, narrower
        for k in ("dropout", "dropout_bwd"):
            kern_ms += kernel_rows[k + "@embedding"]["ms"] - rows[k]["ms"]
    rng_us = key_derivation_us(trainer)
    print(f"train[bf16]: TransformerConfig.big() as shipped (dropout "
          f"{cfg.dropout}), batch {TRAIN_B} x {TRAIN_S}, warmup_steps "
          f"{TRAIN_WARMUP}, {TRAIN_STEPS} steps on one repeated batch, "
          f"each step followed by a step of a second trainer at dropout 0",
          flush=True)
    print(f"train[bf16]: losses {[round(x, 5) for x in losses]} (mean of "
          f"the first {LOSS_MEAN_OF} {first:.5f}, of the last {last:.5f})",
          flush=True)
    print(f"train[bf16]: p50 step {p50 * 1e3:.4f} ms (min "
          f"{min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}), "
          f"{tokens / p50:.1f} tokens/s; the kernels at their phase times "
          f"{kern_ms:.4f} ms a step ({100 * kern_ms / (p50 * 1e3):.1f}% of "
          f"the p50 step; Adam counted once per group at the bf16 group's "
          f"time); peak device memory, both trainers resident, "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"train[bf16]: deriving the step's {len(trainer.dropout_sites)} "
          f"dropout keys and seeds on the host: {rng_us:.2f} us a step "
          f"(one pass over a block of steps, median of 20 blocks)",
          flush=True)
    print(f"train[bf16]: launches {counts}", flush=True)
    print(f"train[bf16 dropout 0]: losses {[round(x, 5) for x in losses0]}"
          f"; p50 step {p50_0 * 1e3:.4f} ms (min {min(times0) * 1e3:.4f}, "
          f"max {max(times0) * 1e3:.4f}), {tokens / p50_0:.1f} tokens/s; "
          f"dropout {cfg.dropout} takes {(p50 - p50_0) * 1e3:.4f} ms more "
          f"at the p50", flush=True)
    # the LayerNorm forward and backward on their vector paths
    ln_vec = ("layer_norm_fwd_vec_kernel", "layer_norm_bwd_vec_kernel")
    # and at dropout 0.1 the three dropout kernels on theirs
    drop_vec = ("dropout_vec_kernel", "dropout_bwd_vec_kernel",
                "dropout_residual_vec_kernel")
    busy = profile_steps(trainer, batch, f"dropout {cfg.dropout}",
                         need=ln_vec + (drop_vec if cfg.dropout else ()))
    notes["lm_device_ms"] = busy
    busy0 = profile_steps(trainer0, batch, "dropout 0", top=5, need=ln_vec)
    if busy is not None and busy0 is not None:
        print(f"train[bf16]: dropout {cfg.dropout} adds {busy - busy0:.4f} "
              f"ms of device time a step", flush=True)
        for rate, ms in ((cfg.dropout, busy), (0.0, busy0)):
            old = EARLIER_TRAIN_DEVICE_MS[rate]
            print(f"train[bf16]: device time a step at dropout {rate}: "
                  f"{ms:.4f} ms, before the redesign {old:.4f} ms "
                  f"({ms - old:+.4f} ms)", flush=True)
    peaks = {rate: step_peak_mib(t, batch)
             for rate, t in ((cfg.dropout, trainer), (0.0, trainer0))}
    tok = TRAIN_B * TRAIN_S
    bits_mib = (cfg.num_layers * -(-tok * cfg.d_ff // 8)
                + -(-tok * cfg.d_model // 8)) / 2 ** 20
    print(f"train[bf16]: peak device memory of one step above the "
          f"trainer's resident state: {peaks[cfg.dropout]:.3f} MiB at "
          f"dropout {cfg.dropout}, {peaks[0.0]:.3f} MiB at 0 "
          f"({peaks[cfg.dropout] - peaks[0.0]:+.3f} MiB); the Dropout keep "
          f"bits saved for the backward take {bits_mib:.3f} MiB of it",
          flush=True)
    return paths


def step_peak_mib(trainer, batch):
    """MiB one training step allocates at its peak above what was
    allocated before it (activations saved for the backward, gradients'
    temporaries)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer.step(*batch)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def bf16_windows(K, cfgs, params, batch, dev):
    """``TRAIN_STEPS`` bf16 steps of one fresh trainer per config on one
    repeated batch, interleaved step by step (so both see the same host),
    each step timed on the host clock to its ``synchronize`` and its
    launches counted around it; every loss finite and the launches exact.
    Returns ``[(trainer, losses, times, launches)]``."""
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    runs = []
    for cfg in cfgs:
        trainer = clm.causal_lm_trainer(
            TRAIN_B, TRAIN_S, cfg, compute_dtype=torch.bfloat16,
            params=params, warmup_steps=TRAIN_WARMUP, device=dev)
        runs.append((trainer, [], [], {k: 0 for k in K.launch_counts()}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        for trainer, losses, times, counts in runs:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            loss = trainer.step(*batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for k, v in K.launch_counts().items():
                counts[k] += v
            losses.append(loss.item())
    for cfg, (trainer, losses, _, counts) in zip(cfgs, runs):
        tag = f"train[bf16 dropout {cfg.dropout}]"
        n_groups = len(trainer.optimizer.flat_groups)
        want = expected_counts(counts, TRAIN_STEPS, n_groups, cfg)
        if n_groups != 2 or counts != want:
            fail(f"{tag}: {n_groups} Adam groups, launches {counts}, "
                 f"expected {want}")
        if not all(math.isfinite(x) for x in losses):
            fail(f"{tag}: non-finite loss in {losses}")
    return runs


def device_times(prof):
    """``{name: (ms, launches)}`` of the device kernels, copies and fills
    in a ``torch.profiler`` trace; not the user-annotation ranges (e.g.
    the optimizer's step) that span kernels already counted."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    return by_name


def check_traced(tag, by_name, need):
    """Fail unless every name in ``need`` is part of a traced kernel's."""
    missing = [k for k in need if not any(k in nm for nm in by_name)]
    if missing:
        fail(f"{tag}: no {missing} kernel in the trace (the path did not "
             f"take it)")


def profile_steps(trainer, batch, tag, n=3, top=10, label="train",
                  need=()):
    """Device time of ``n`` more training steps from a ``torch.profiler``
    trace (CUDA kernels, copies and fills, summed), against the host
    clock around them, and the ``top`` kernels that take the most of it;
    returns the device ms a step (None when the trace saw no device
    time). Run after the counted window; the profiler's host-side tracing
    slows the host, so the busy share here is a lower bound. Fails when
    a trace with device time lacks a kernel named in ``need``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name = {k: ms / n for k, (ms, _) in device_times(prof).items()}
    if not by_name:
        print(f"{label}[bf16 {tag}]: the profiler saw no device time; the "
              f"device busy share is not measured", flush=True)
        return None
    check_traced(f"{label}[bf16 {tag}]", by_name, need)
    dev_ms = sum(by_name.values())
    print(f"{label}[bf16 {tag}]: profiler, {n} steps: device busy "
          f"{dev_ms:.4f} ms a step of {wall_ms:.4f} ms on the host clock "
          f"({100 * dev_ms / wall_ms:.1f}%)", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.4f} ms/step  {name[:110]}", flush=True)
    return dev_ms


# -- ResNet-50 training phase ---------------------------------------------------

RESNET_B, RESNET_SIZE = 256, 224       # resnet50_train_model as shipped
RESNET_F32_B = 32                      # the f32 kernels-vs-plain check
RESNET_F32_STEPS = 2                   # the second step reads mu
RESNET_STEPS = 16
# kernels vs plain after RESNET_F32_STEPS f32 steps, by relative norm per
# parameter (parameters) and over the group (accumulators). cuDNN runs in
# its deterministic mode there (plain vs plain reads 0), so the two runs
# differ only by the softmax-xent kernels' roundoff, which the BatchNorm
# backward amplifies: it cancels most of every gradient, and a parameter
# that starts at 0 (bn0's beta) holds nothing but those gradients. On an
# H100 80GB HBM3 at 700 W that reads 4.733e-2 (bn0.beta) and 2.264e-2;
# the planted faults read 0.256-1.58 and 0.434-0.513
RESNET_PARAM_TOL, RESNET_ACC_TOL = 0.15, 0.1
# launches a step besides Momentum's one per flat group, counted by the
# group's dtype (under bf16: the conv kernels, and BatchNorm with the fc;
# under f32 one group)
RESNET_PER_STEP = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
RESNET_GROUPS = {torch.bfloat16: ("bfloat16", "float32"),
                 torch.float32: ("float32",)}


def resnet_launches(counts, steps, dtype):
    """The launches ``steps`` ResNet steps at ``dtype`` must make: every
    other kernel 0."""
    want = {k: 0 for k in counts}
    want.update({k: v * steps for k, v in RESNET_PER_STEP.items()})
    groups = RESNET_GROUPS[dtype]
    want["momentum_update"] = len(groups) * steps
    for g in groups:
        want[f"momentum_update_{g}"] = steps
    return want


def resnet_trainer(params, batch, dtype, dev, plain=False):
    from simple_tensorflow_tpu_torch.models import resnet

    return resnet.resnet50_trainer(
        batch_size=batch, image_size=RESNET_SIZE, dtype=dtype,
        params=params, device=dev, plain=plain)


def resnet_state(trainer):
    """Every parameter and the flat accumulators, as f32 copies."""
    params = {n: p.detach().float().clone()
              for n, p in trainer.model.named_parameters()}
    accs = [grp.momentum.clone() for grp in trainer.optimizer.flat_groups]
    return params, accs


def resnet_errs(a, b):
    """(worst parameter rel-norm error and its name, worst accumulator
    rel-norm error) of state ``a`` against state ``b``."""
    (pa, aa), (pb, ab) = a, b
    errs = {n: ((pa[n] - pb[n]).norm() / pb[n].norm()).item() for n in pb}
    worst = max(errs, key=errs.get)
    acc = max(((x - y).norm() / y.norm()).item() for x, y in zip(aa, ab))
    return errs[worst], worst, acc


def check_resnet_f32(K, params, images, labels, dev):
    """``RESNET_F32_STEPS`` f32 steps at ``RESNET_F32_B`` x 224^2 through
    the kernels against the same steps through the plain versions
    (``plain=True``), both on the card with cuDNN deterministic: the loss
    of each step within rtol 1e-5, then every parameter and the
    accumulators within ``RESNET_PARAM_TOL``/``RESNET_ACC_TOL`` by
    relative norm. A second plain run gives the floor; two planted
    Momentum faults (the Nesterov flag flipped, ``mu`` x 0.5) must fail
    the limits. Returns the kernel run's launches."""
    from simple_tensorflow_tpu_torch.models import resnet

    tag = f"train resnet[f32 {RESNET_F32_B} x {RESNET_SIZE}^2]"
    x, y = images[:RESNET_F32_B], labels[:RESNET_F32_B]

    def run(plain=False):
        t = resnet_trainer(params, RESNET_F32_B, torch.float32, dev, plain)
        losses = [t.step(x, y).item() for _ in range(RESNET_F32_STEPS)]
        state = resnet_state(t)
        if len(t.optimizer.flat_groups) != 1:
            fail(f"{tag}: {len(t.optimizer.flat_groups)} Momentum groups "
                 f"under f32, expected 1")
        del t
        return losses, state

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss_p, state_p = run(plain=True)
        before = K.launch_counts()
        _, state_p2 = run(plain=True)
        if K.launch_counts() != before:
            fail(f"{tag}: the plain steps launched kernels")
        K.reset_launch_counts()
        loss_k, state_k = run()
        counts = K.launch_counts()
        faults = {}
        for fault, wrap in (
                ("nesterov flipped", lambda f: lambda *a, **k: f(
                    *a, **dict(k, use_nesterov=not k["use_nesterov"]))),
                ("mu x 0.5", lambda f: lambda p, acc, g, lr, mu, **k: f(
                    p, acc, g, lr, mu * 0.5, **k))):
            with planted(resnet, "momentum_update", wrap):
                faults[fault] = resnet_errs(run()[1], state_p)
    finally:
        torch.backends.cudnn.deterministic = prev
    want = resnet_launches(counts, RESNET_F32_STEPS, torch.float32)
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    floor = resnet_errs(state_p2, state_p)
    errs = resnet_errs(state_k, state_p)
    print(f"{tag}: losses {loss_k} (kernels) vs {loss_p} (plain)",
          flush=True)
    print(f"{tag}: after {RESNET_F32_STEPS} steps, worst parameter rel err "
          f"{errs[0]:.3e} ({errs[1]}), accumulators {errs[2]:.3e} (limits "
          f"{RESNET_PARAM_TOL}, {RESNET_ACC_TOL}); plain vs plain "
          f"{floor[0]:.3e} / {floor[2]:.3e}", flush=True)
    print(f"{tag}: planted Momentum faults, (parameter, accumulator) rel "
          f"err: " + ", ".join(f"{k} ({v[0]:.3e} {v[1]}, {v[2]:.3e})"
                               for k, v in faults.items()), flush=True)
    bad = [f"step {i + 1}: {a} vs {b}" for i, (a, b) in
           enumerate(zip(loss_k, loss_p)) if not abs(a - b) <= 1e-5 * abs(b)]
    if bad:
        fail(f"{tag}: losses through the kernels vs the plain versions: "
             f"{bad}")
    if not (errs[0] <= RESNET_PARAM_TOL and errs[2] <= RESNET_ACC_TOL):
        fail(f"{tag}: state after {RESNET_F32_STEPS} steps off the plain "
             f"run's: {errs}")
    missed = [k for k, v in faults.items()
              if v[0] <= RESNET_PARAM_TOL and v[2] <= RESNET_ACC_TOL]
    if missed:
        fail(f"{tag}: the limits pass planted faults {missed}: {faults}")
    return counts


def resnet_phase(K, dev, notes):
    """The ResNet-50 training path (module docstring, phase 5). Returns
    ``[(path, dropout, launches)]``: the f32 kernel steps and the bf16
    window, each counted from zero just before it. Leaves the bf16
    window's peak memory (GiB) and device ms a step in ``notes`` (the
    ResNet Session phase compares against them)."""
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import resnet

    params = convert.init_resnet_params(seed=0)
    images, labels = resnet.synthetic_imagenet(RESNET_B, RESNET_SIZE)
    paths = [("train resnet f32", 0.0,
              check_resnet_f32(K, params, images, labels, dev))]
    # the batch lives on the card, as a data pipeline would leave it
    images = torch.from_numpy(images).to(dev, torch.bfloat16)
    labels = torch.from_numpy(labels).to(dev)
    torch.cuda.empty_cache()

    tag = f"train resnet[bf16 {RESNET_B} x {RESNET_SIZE}^2]"
    trainer = resnet_trainer(params, RESNET_B, torch.bfloat16, dev)
    sizes = [len(grp) for grp in trainer.optimizer.flat_groups]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    counts = {k: 0 for k in K.launch_counts()}
    K.reset_launch_counts()
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss = trainer.step(images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    paths.append(("train resnet bf16", 0.0, counts))
    want = resnet_launches(counts, RESNET_STEPS, torch.bfloat16)
    if len(sizes) != 2 or counts != want:
        fail(f"{tag}: Momentum groups {sizes}, launches {counts}, expected "
             f"{want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss in {losses}")
    # the recipe as shipped (lr 0.1, momentum 0.9, no warm-up) overshoots
    # on one repeated batch after some ten steps, in the JAX package as in
    # the port (PERF.md §6), so the window's first half is held to a
    # falling loss: the mean of its second LOSS_MEAN_OF steps below that of
    # its first
    first = statistics.mean(losses[:LOSS_MEAN_OF])
    second = statistics.mean(losses[LOSS_MEAN_OF:2 * LOSS_MEAN_OF])
    last = statistics.mean(losses[-LOSS_MEAN_OF:])
    if not second < first:
        fail(f"{tag}: the loss does not fall (mean of steps 1-{LOSS_MEAN_OF}"
             f" {first}, of steps {LOSS_MEAN_OF + 1}-{2 * LOSS_MEAN_OF} "
             f"{second}): {losses}")
    p50 = statistics.median(times)
    ips = RESNET_B / p50
    flops = 3 * resnet.resnet_flops_per_image(50, RESNET_SIZE)
    print(f"{tag}: resnet50_train_model as shipped (lr 0.1, momentum 0.9, "
          f"weight decay 1e-4), Momentum groups {sizes}, {RESNET_STEPS} "
          f"steps on one repeated synthetic_imagenet batch (seed 0)",
          flush=True)
    print(f"{tag}: losses {[round(v, 5) for v in losses]} (means of "
          f"{LOSS_MEAN_OF}: the first {first:.5f}, the next {second:.5f}, "
          f"the last {last:.5f})", flush=True)
    print(f"{tag}: p50 step {p50 * 1e3:.4f} ms (min {min(times) * 1e3:.4f},"
          f" max {max(times) * 1e3:.4f}), {ips:.2f} images/s; 3 x "
          f"resnet_flops_per_image at that rate: "
          f"{ips * flops / 1e12:.2f} TFLOP/s, "
          f"{100 * ips * flops / PEAK_OPS_PER_S[torch.bfloat16]:.2f}% of the "
          f"dense bf16 peak; peak device memory {peak / 2 ** 30:.3f} GiB",
          flush=True)
    print(f"{tag}: launches {counts}", flush=True)
    notes["resnet_peak_gib"] = peak / 2 ** 30
    notes["resnet_device_ms"] = profile_steps(
        trainer, (images, labels), "resnet", top=12, label="train resnet")
    return paths


# -- Session (TF-1 front end) phase ------------------------------------------

MNIST_B = 512                 # convnet_model at batch 512, f32 as shipped
MNIST_CLASSES = 10
MNIST_ADAM_N = 3_274_634      # the convnet's trainable parameters
SESSION_STEPS = 16
SESSION_CHECK_STEPS = 3
SESSION_KEEP_PROB = 0.5
# softmax_model's shipped learning rate, 0.5, diverges on synthetic_mnist's
# uniform pixels in the JAX package as in the port (PERF.md §6); 0.05 falls
SOFTMAX_LR = 0.05
# kernels vs plain after SESSION_CHECK_STEPS steps: each loss by rtol, every
# variable (the Adam slots included) by relative norm
SESSION_LOSS_RTOL, SESSION_STATE_TOL = 1e-5, 1e-5
SESSION_PER_STEP = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                    "adam_update": 1, "dropout": 1, "dropout_bwd": 1}
MNIST_DROP_SHAPE = (MNIST_B, 1024)   # fc1's activations


def session_kernel_rows(K, gen, dev):
    """The Session path's kernels at its shapes, against their plain
    versions: the xent forward and backward at f32 512 x 10, Adam over
    the convnet's one f32 group (n = 3,274,634; 28 bytes an element) and
    the threefry Dropout at f32 (512, 1024), keep_prob 0.5."""
    import torch.nn.functional as F

    kdo = importlib.import_module(KMOD + "dropout")
    main = xent_case(K, gen, dev, MNIST_B, MNIST_CLASSES, (torch.float32,),
                     (0.0,), "@mnist")
    n = MNIST_ADAM_N
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    alpha = torch.tensor(1e-3, device=dev)
    p = 0.05 * torch.randn(n, generator=gen, device=dev)
    m = 0.01 * torch.randn(n, generator=gen, device=dev)
    v = 1e-4 * torch.rand(n, generator=gen, device=dev)
    g = 0.01 * torch.randn(n, generator=gen, device=dev)
    got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
    ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                              **kw)
    torch.cuda.synchronize()
    name = f"adam_update float32 params n={n} (mnist)"
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        fail(f"{name}: kernel is not bit-exact with its plain version")
    del got, ref
    ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
    plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                      **kw)])
    pt = torch.nn.Parameter(p.clone())
    pt.grad = g.clone()
    opt = torch.optim.Adam([pt], lr=1e-3, fused=True)
    lib_ms = event_ms(opt.step)
    bnd = bound_ms(28 * n, 12 * n, torch.float32)
    report(name, 0.0, ms, plain_ms, bnd, lib_ms)
    main["adam_update@mnist"] = kernel_row(0.0, ms, plain_ms, bnd, lib_ms,
                                           name)
    del p, m, v, g, pt, opt

    kp, key = SESSION_KEEP_PROB, DROPOUT_KEY
    numel = math.prod(MNIST_DROP_SHAPE)
    copies = [torch.randn(MNIST_DROP_SHAPE, generator=gen, device=dev)
              for _ in range(n_copies(8 * numel))]
    x = copies[0]
    tag = f"float32 {MNIST_DROP_SHAPE} keep_prob {kp} (mnist)"
    if not kdo.vector_path(numel, x):
        fail(f"dropout {tag}: not on the vector path")
    out, bits = K.dropout_fwd(x, kp, key, return_bits=True)
    err_f = check_exact(f"dropout {tag}", out, K.dropout_plain(x, kp, key))
    check_exact(f"dropout {tag} bits", bits, kdo.pack_keep_bits_plain(
        kdo.keep_mask_plain(MNIST_DROP_SHAPE, kp, key, dev)))
    err_b = check_exact(f"dropout_bwd {tag}", K.dropout_bwd(x, kp, bits),
                        K.dropout_plain(x, kp, key))
    kkey = device_key_row(K, kdo, "dropout@mnist", tag, copies, kp,
                          torch.float32, dev, main)
    saved = [K.dropout_fwd(c, kp, key, return_bits=True)[1] for c in copies]
    ms_f = device_ms([lambda c=c: K.dropout_fwd(c, kp, key, return_bits=True)
                      for c in copies])
    plain_f = device_ms([lambda c=c: K.dropout_plain(c, kp, key)
                         for c in copies])
    ms_b = device_ms([lambda c=c, b=b: K.dropout_bwd(c, kp, b)
                      for c, b in zip(copies, saved)])
    plain_b = device_ms([lambda c=c, b=b: kdo.dropout_bwd_bits_plain(
        c, b, kp) for c, b in zip(copies, saved)])
    lib_f = event_ms(lambda: F.dropout(x, 1.0 - kp), reps=20)
    masks = [torch.rand(MNIST_DROP_SHAPE, generator=gen, device=dev) < kp
             for _ in copies]
    lib_b = device_ms([
        lambda c=c, mk=mk: torch.ops.aten.native_dropout_backward(
            c, mk, 1.0 / kp) for c, mk in zip(copies, masks)])
    bits_bytes = -(-numel // 8)
    bnd_f = bound_ms(8 * numel + bits_bytes, 0, torch.float32,
                     THREEFRY_OPS * numel, THREEFRY_ALU_OPS * numel)
    bnd_b = bound_ms(8 * numel + bits_bytes, numel, torch.float32)
    report(f"dropout {tag}", err_f, ms_f, plain_f, bnd_f, lib_f)
    report(f"dropout_bwd {tag} (from the bits)", err_b, ms_b, plain_b, bnd_b,
           lib_b)
    main["dropout@mnist"] = kernel_row(err_f, ms_f, plain_f, bnd_f, lib_f,
                                       f"dropout {tag}")
    main["dropout_bwd@mnist"] = kernel_row(err_b, ms_b, plain_b, bnd_b,
                                           lib_b, f"dropout_bwd {tag}")
    report_device_key(main, kkey, bnd_f, lib_f)
    return main


def mnist_session(stf, build):
    """A graph from ``build()``, a Session on the card and its initializer
    run: ``(graph, model dict, session)``."""
    g = stf.Graph()
    with g.as_default():
        m = build()
        init = stf.global_variables_initializer()
    sess = stf.Session(graph=g)
    sess.run(init)
    return g, m, sess


def session_state(sess):
    return {k: v.detach().clone()
            for k, v in sess._variable_store.values.items()}


def session_errs(a, b):
    """The worst relative-norm difference over the variables, and which."""
    errs = {k: ((a[k].double() - b[k].double()).norm()
                / b[k].double().norm().clamp_min(1e-30)).item() for k in b}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def check_session_steps(K, stf, mnist, feeds):
    """``SESSION_CHECK_STEPS`` convnet steps through ``stf.Session`` with
    the kernels against the same steps under
    ``fused_ops.plain_versions()``, each from the same initializer run
    (the same run counter, so the same Dropout masks), cuDNN
    deterministic: each loss within ``SESSION_LOSS_RTOL``, the first
    step's Dropout output equal, every step's mask equal where both ReLUs
    are live, every variable and slot within ``SESSION_STATE_TOL`` by
    relative norm. Two planted faults must fail: Adam's beta1 x (1 +
    1e-4) and the Dropout op's stream id + 1."""
    from simple_tensorflow_tpu_torch.framework import random_seed
    from simple_tensorflow_tpu_torch.ops import fused_ops

    tag = f"session convnet[f32 {MNIST_B}]"

    def run(plain=False, fault=None):
        g, m, sess = mnist_session(stf, mnist.convnet_model)
        sess._capture = False
        if fault == "adam beta1":
            op = g.get_operation_by_name("Adam/fused_adam_update")
            op.attrs["beta1"] = op.attrs["beta1"] * (1 + 1e-4)
        elif fault == "dropout stream + 1":
            op = g.get_operation_by_name("convnet/dropout")
            op.attrs["_graph_seed"] = 0
            op.attrs["seed"] = random_seed.fold_in_value(op.name) + 1
        fetch = [m["train_op"], m["loss"], "convnet/dropout:0",
                 "convnet/fc1/Relu:0"]
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()):
            outs = [sess.run(fetch, feeds(m))[1:]
                    for _ in range(SESSION_CHECK_STEPS)]
        state = session_state(sess)
        sess.close()
        return outs, state

    def compare(outs, state, ref, ref_state):
        """``(bad losses, first-step dropout mismatches, mask mismatches
        on live units, (worst relative state error, variable))``."""
        bad = [(a[0], b[0]) for a, b in zip(outs, ref)
               if not abs(a[0] - b[0]) <= SESSION_LOSS_RTOL * abs(b[0])]
        first = int((outs[0][1] != ref[0][1]).sum())
        masks = 0
        for a, b in zip(outs, ref):
            live = (a[2] != 0) & (b[2] != 0)
            masks += int(((a[1] != 0) != (b[1] != 0))[live].sum())
        return bad, first, masks, session_errs(state, ref_state)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_state = run(plain=True)
        before = K.launch_counts()
        floor = compare(*run(plain=True), ref, ref_state)
        if K.launch_counts() != before:
            fail(f"{tag}: the plain steps launched kernels")
        K.reset_launch_counts()
        got = compare(*run(), ref, ref_state)
        counts = K.launch_counts()
        faults = {f: compare(*run(fault=f), ref, ref_state)
                  for f in ("adam beta1", "dropout stream + 1")}
    finally:
        torch.backends.cudnn.deterministic = prev
    want = {k: 0 for k in counts}
    want.update({k: v * SESSION_CHECK_STEPS
                 for k, v in SESSION_PER_STEP.items()})
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    print(f"{tag}: {SESSION_CHECK_STEPS} steps, kernels vs plain: losses "
          f"{[float(o[0]) for o in ref]} (plain); off the plain run: "
          f"{got[0]} losses, first-step dropout values {got[1]}, masks "
          f"{got[2]}, worst variable rel err {got[3][0]:.3e} ({got[3][1]}); "
          f"plain vs plain {floor[3][0]:.3e}", flush=True)
    print(f"{tag}: planted faults (bad losses, dropout values, masks, "
          f"worst variable): " + "; ".join(
              f"{k}: {len(v[0])}, {v[1]}, {v[2]}, {v[3][0]:.3e} ({v[3][1]})"
              for k, v in faults.items()), flush=True)

    def ok(r):
        return not r[0] and r[1] == 0 and r[2] == 0 and \
            r[3][0] <= SESSION_STATE_TOL

    if not ok(got):
        fail(f"{tag}: the kernels' steps are off the plain steps: {got}")
    missed = [k for k, v in faults.items() if ok(v)]
    if missed:
        fail(f"{tag}: the check passes planted faults {missed}: {faults}")
    return counts


GRAPH_CHECK_STEPS = 5   # a warm-up, a capture, then 3 replayed steps


def check_session_graph(K, stf, mnist, feeds):
    """``GRAPH_CHECK_STEPS`` convnet steps through a Session that captures
    its step as a CUDA graph (step 1 eager, the warm-up; step 2 captured
    and replayed; then replays) against the same steps with ``_capture``
    off, each session from its own initializer run (so the same run
    counters), cuDNN deterministic: every loss, Dropout output and, after
    the steps, every variable and Adam slot bit-identical. The planted
    fault replays without refilling the key buffer (``_refresh_keys``
    off after the capture): its Dropout outputs must differ."""
    tag = f"session graph convnet[f32 {MNIST_B}]"

    def run(capture, stale_keys=False):
        _, m, sess = mnist_session(stf, mnist.convnet_model)
        sess._capture = capture
        fetch = [m["train_op"], m["loss"], "convnet/dropout:0"]
        outs = []
        for i in range(GRAPH_CHECK_STEPS):
            if stale_keys and i == 2:
                sess._refresh_keys = False
            outs.append(sess.run(fetch, feeds(m))[1:])
        state = session_state(sess)
        captures = sess.captures
        sess.close()
        return outs, state, captures

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_state, _ = run(False)
        got, state, captures = run(True)
        stale, _, _ = run(True, stale_keys=True)
    finally:
        torch.backends.cudnn.deterministic = prev
    losses = sum(a[0] != b[0] for a, b in zip(got, ref))
    drops = [mismatches(torch.from_numpy(a[1]), torch.from_numpy(b[1]))
             for a, b in zip(got, ref)]
    bad_vars = [k for k in ref_state
                if not torch.equal(state[k], ref_state[k])]
    fault = [mismatches(torch.from_numpy(a[1]), torch.from_numpy(b[1]))
             for a, b in zip(stale, ref)]
    print(f"{tag}: {GRAPH_CHECK_STEPS} steps (eager warm-up, capture, "
          f"{GRAPH_CHECK_STEPS - 2} replays) vs the eager session: losses "
          f"{[float(a[0]) for a in got]}, {losses} differ; Dropout output "
          f"mismatches by step {drops}; variables and slots differing "
          f"{bad_vars} of {len(ref_state)}; captures {captures}", flush=True)
    print(f"{tag}: planted fault, the key buffer not refilled from step 3: "
          f"Dropout output mismatches by step {fault}", flush=True)
    if losses or any(drops) or bad_vars or captures != 1:
        fail(f"{tag}: the replayed steps are off the eager steps")
    if not all(fault[2:]):
        fail(f"{tag}: the check passes replays with stale keys: {fault}")


def session_window(K, sess, fetch, feeds, steps, capture, n_prof=3,
                   peaks=False):
    """``steps`` steps of ``sess.run(fetch, feeds)`` (``fetch[0]`` the
    loss; ``feeds`` a dict, or a function of the previous run's fetched
    values, None before the first, for a state carried from run to run),
    the step captured as a CUDA graph or (``capture`` False)
    dispatched eagerly, then a ``torch.profiler`` window of ``n_prof``
    steps: losses, step seconds, launches (counted from zero just before
    the window), plan-cache misses and captures after the first step, the
    host seconds a step by kind (``Session._timings``), the device ms a
    step by kernel and the device operations (kernels, copies, fills) a
    step in the trace (``device_ops``). With ``peaks``, the peak allocated device memory (GiB)
    over the first two steps (the warm-up, which builds the optimizer's
    flat buffers, and the capture) and over the rest (``peak_first_gib``,
    ``peak_gib``; a replay allocates nothing, its memory is the capture's
    pool) and the memory reserved at the end, idle cached blocks released
    (``reserved_gib``: a captured step's pool and what is allocated), all
    of the process."""
    from torch.profiler import ProfilerActivity, profile

    sess._capture = capture
    losses, times = [], []
    sess._timings = {}
    K.reset_launch_counts()
    out = {}
    if peaks:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    got = None

    def feed():
        return feeds(got) if callable(feeds) else feeds

    for i in range(steps):
        if peaks and i == 2:
            torch.cuda.synchronize()
            out["peak_first_gib"] = torch.cuda.max_memory_allocated() / GIB
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = sess.run(fetch, feed())
        times.append(time.perf_counter() - t0)
        losses.append(float(got[0]))
        if i == 0:
            misses, captures = sess.plan_cache_misses, sess.captures
    counts = K.launch_counts()
    if peaks:
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        torch.cuda.empty_cache()   # what a step holds: no idle cache
        out["reserved_gib"] = torch.cuda.memory_reserved() / GIB
    split = {k: v / steps for k, v in sess._timings.items()}
    sess._timings = None
    late = (sess.plan_cache_misses - misses, sess.captures - captures)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            got = sess.run(fetch, feed())
        torch.cuda.synchronize()
    traced = device_times(prof)
    by_name = {k: ms / n_prof for k, (ms, _) in traced.items()}
    # device kernels, copies and fills a step in the trace
    out["device_ops"] = sum(k for _, k in traced.values()) / n_prof
    return dict(out, losses=losses, times=times, counts=counts, split=split,
                late=late, by_name=by_name, captures=sess.captures,
                steps=steps + n_prof)


def report_window(tag, w, expect, items, unit,
                  first=slice(0, LOSS_MEAN_OF),
                  last=slice(-LOSS_MEAN_OF, None), last_below_first=True):
    """Check one Session window (launches ``expect``, no plan-cache miss
    after the first step, every loss finite, the mean of the losses
    ``last`` (a slice of the window's steps) below that of the losses
    ``first`` and, with ``last_below_first``, the last loss below the
    first) and print its numbers, ``items`` ``unit`` a step; returns its
    p50 step and device ms a step (None when the trace saw no device
    time)."""
    counts = w["counts"]
    want = {k: 0 for k in counts}
    want.update(expect)
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    losses = w["losses"]
    if w["late"][0]:
        fail(f"{tag}: {w['late'][0]} plan-cache misses after the first step")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss in {losses}")
    steps = range(1, len(losses) + 1)
    a, b = steps[first], steps[last]
    mean_a = statistics.mean(losses[first])
    mean_b = statistics.mean(losses[last])
    if not (mean_b < mean_a and (losses[-1] < losses[0]
                                 or not last_below_first)):
        fail(f"{tag}: the loss does not fall (mean of steps {a[0]}-{a[-1]} "
             f"{mean_a}, of steps {b[0]}-{b[-1]} {mean_b}): {losses}")
    times = w["times"]
    p50 = statistics.median(times)
    print(f"{tag}: losses {[round(v, 5) for v in losses]} (mean of steps "
          f"{a[0]}-{a[-1]} {mean_a:.5f}, of steps {b[0]}-{b[-1]} "
          f"{mean_b:.5f})", flush=True)
    print(f"{tag}: launches {counts}; after the first step: plan-cache "
          f"misses {w['late'][0]}, captures {w['late'][1]} (in all "
          f"{w['captures']})", flush=True)
    by_name = w["by_name"]
    dev_ms = sum(by_name.values()) if by_name else None
    split = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in
                      sorted(w["split"].items()))
    if dev_ms is None:
        print(f"{tag}: p50 step {p50 * 1e3:.4f} ms, {items / p50:.2f} "
              f"{unit}/s; the profiler saw no device time: device and "
              f"host ms a step not measured; host ms a step by kind "
              f"(window mean): {split}", flush=True)
        return p50, None
    print(f"{tag}: p50 step {p50 * 1e3:.4f} ms (min "
          f"{min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}), "
          f"{items / p50:.2f} {unit}/s; device {dev_ms:.4f} ms a step "
          f"(torch.profiler, 3 steps), host {p50 * 1e3 - dev_ms:.4f} ms a "
          f"step (p50 minus device); host ms a step by kind (window "
          f"mean, Session._timings): {split}", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.4f} ms/step  {name[:110]}", flush=True)
    return p50, dev_ms


def mnist_window(K, stf, mnist, feeds, capture):
    """``SESSION_STEPS`` convnet steps (:func:`session_window`) of a new
    Session; checks the global step after them."""
    _, m, sess = mnist_session(stf, mnist.convnet_model)
    w = session_window(K, sess, [m["loss"], m["train_op"]], feeds(m),
                       SESSION_STEPS, capture)
    gs = int(sess.run(m["global_step"]))
    sess.close()
    if gs != w["steps"]:
        fail(f"session convnet: global_step {gs} after {w['steps']} steps")
    return w


def session_phase(K, dev, kernel_rows):
    """The TF-1 front end on the card (module docstring, phase 6).
    Returns ``[(path, dropout, launches)]``: the checked steps and the
    training windows, each counted from zero just before it."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import mnist

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    print("session kernels at the MNIST shapes:", flush=True)
    kernel_rows.update(session_kernel_rows(K, gen, dev))
    x, labels, onehot = mnist.synthetic_mnist(MNIST_B, seed=0)
    x4 = x.reshape(-1, 28, 28, 1)

    def feeds(m):
        return {m["x"]: x4, m["y_"]: labels, m["keep_prob"]:
                SESSION_KEEP_PROB}

    paths = [("session convnet f32 check", 0.0,
              check_session_steps(K, stf, mnist, feeds))]
    check_session_graph(K, stf, mnist, feeds)
    print(f"session convnet[f32 {MNIST_B}]: models/mnist.py convnet_model "
          f"through stf.Session, Adam lr 1e-3, keep_prob "
          f"{SESSION_KEEP_PROB}, {SESSION_STEPS} steps of Session.run("
          f"[train_op, loss]) on one repeated synthetic_mnist({MNIST_B}, "
          f"seed=0) batch fed as numpy; the graph window first (step 1 "
          f"eager, step 2 captured), then the eager one", flush=True)
    graph = mnist_window(K, stf, mnist, feeds, capture=True)
    eager = mnist_window(K, stf, mnist, feeds, capture=False)
    per = {k: v * SESSION_STEPS for k, v in SESSION_PER_STEP.items()}
    # the graph window's first step is its eager warm-up: one launch of
    # the launch-argument Dropout entry, then the device-key entry
    want_graph = dict(per, dropout=1,
                      dropout_device_key=SESSION_STEPS - 1)
    # one bucket and one keep_prob: exactly one capture, at step 2
    if graph["late"][1] != 1 or graph["captures"] != 1:
        fail(f"session graph: captures {graph['captures']} (after the "
             f"first step {graph['late'][1]}), expected exactly 1")
    if eager["captures"]:
        fail(f"session eager: {eager['captures']} captures")
    g50, gdev = report_window(f"session graph convnet[f32 {MNIST_B}]",
                              graph, want_graph, MNIST_B, "images")
    e50, edev = report_window(f"session eager convnet[f32 {MNIST_B}]",
                              eager, per, MNIST_B, "images")
    if graph["by_name"]:
        check_traced("session graph", graph["by_name"],
                     ("dropout_vec_kernel",))
    if eager["by_name"]:
        check_traced("session eager", eager["by_name"],
                     ("dropout_vec_kernel",))
    print(f"session convnet[f32 {MNIST_B}]: graph vs eager p50 step "
          f"{g50 * 1e3:.4f} vs {e50 * 1e3:.4f} ms ({e50 / g50:.3f}x), "
          f"images/s {MNIST_B / g50:.2f} vs {MNIST_B / e50:.2f}; device ms "
          f"a step {gdev} vs {edev}", flush=True)
    paths += [("session convnet f32 graph", 0.0, graph["counts"]),
              ("session convnet f32 eager", 0.0, eager["counts"])]

    stag = f"session softmax[f32 {MNIST_B}]"
    _, sm, ssess = mnist_session(
        stf, lambda: mnist.softmax_model(learning_rate=SOFTMAX_LR))
    slosses = [float(ssess.run([sm["train_op"], sm["loss"]],
                               {sm["x"]: x, sm["y_"]: onehot})[1])
               for _ in range(SESSION_STEPS)]
    acc = float(ssess.run(sm["accuracy"], {sm["x"]: x, sm["y_"]: onehot}))
    ssess.close()
    print(f"{stag}: softmax_model, GradientDescent lr {SOFTMAX_LR}, "
          f"{SESSION_STEPS} steps (captured from the second): losses "
          f"{[round(v, 5) for v in slosses]}, accuracy after {acc:.4f}",
          flush=True)
    if not all(b < a for a, b in zip(slosses, slosses[1:])):
        fail(f"{stag}: the loss does not fall at every step: {slosses}")
    return paths


# -- the transformer Session phase (TF-1, the seq2seq headline model) -------

TF_B, TF_SRC, TF_TGT = 64, 64, 64   # transformer_train_model's defaults
TF_WARMUP = 256                 # the LM smoke's choice (module docstring)
TF_CHECK_B, TF_CHECK_LAYERS, TF_CHECK_STEPS = 8, 2, 2
TF_GRAPH_STEPS = 5              # a warm-up, a capture, then 3 replays
TF_STEPS = 16
TF_LOSS_RTOL, TF_STATE_TOL = 1e-5, 1e-4
# the graph's fused and dropout ops per layer of encoder and decoder
FLASH_PARTS = ("flash_attention_fwd", "flash_attention_dkdv",
               "flash_attention_dq")
SEEDED = FLASH_PARTS + ("dropout_residual", "dropout_residual_bwd")


def tf_per_step(layers, adam_groups):
    """Launches a training step of ``transformer_train_model`` with
    ``layers`` + ``layers`` layers at dropout > 0: 3 flash ops a layer pair
    (encoder self, decoder self and cross), 2 + 3 LayerNorms, 1 + 2
    dropout-residual tails, a Dropout on each embedding and FFN
    activation, the xent, one Adam per group (at bf16 compute two: the
    bf16 Dense variables, the f32 embedding and LayerNorm ones; at f32
    one)."""
    per = {k: 3 * layers for k in SEEDED}
    per.update(layer_norm=5 * layers, layer_norm_bwd=5 * layers,
               dropout=2 + 2 * layers, dropout_bwd=2 + 2 * layers,
               softmax_xent_fwd=1, softmax_xent_bwd=1,
               adam_update=adam_groups)
    return per


def tf_batch(b, src, tgt, vocab, pads):
    """``synthetic_wmt_batch(b, src, tgt, vocab, seed=0)``; with ``pads``
    the ends of two rows padded (id 0) in src, tgt_in and tgt_out."""
    from simple_tensorflow_tpu_torch.models import transformer as tr

    batch = tr.synthetic_wmt_batch(b, src, tgt, vocab_size=vocab, seed=0)
    if pads:
        batch["src_ids"][0, -9:] = 0
        batch["src_ids"][b - 1, -2:] = 0
        batch["tgt_in"][1, -5:] = 0
        batch["tgt_out"][1, -6:] = 0
    return batch


def seeded_session(stf, build, same_seed=None):
    """``build()`` (a model dict) in a new graph under ``set_random_seed(
    1)`` and a Session on the card after its initializer run:
    ``(model dict, session)``. ``same_seed``: ``(op, other op)`` names;
    the first is given the second's seed (a planted fault: another
    mask)."""
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(1)
        m = build()
        init = stf.global_variables_initializer()
    if same_seed is not None:
        op, other = (g.get_operation_by_name(n) for n in same_seed)
        op.attrs["seed"] = other.attrs["seed"]
    sess = stf.Session(graph=g)
    sess.run(init)
    return m, sess


def tf_session(stf, tr, cfg, b, dtype, fault=False):
    """``transformer_train_model(b, TF_SRC, TF_TGT, cfg, warmup_steps=
    TF_WARMUP, compute_dtype=dtype)`` in a :func:`seeded_session`;
    ``fault``: the decoder's first cross-attention drawn with its
    self-attention's seed."""
    at = "transformer_1/decoder/layer_0/"
    return seeded_session(
        stf, lambda: tr.transformer_train_model(
            b, TF_SRC, TF_TGT, cfg=cfg, warmup_steps=TF_WARMUP,
            compute_dtype=dtype),
        same_seed=(at + "cross_attn/flash_attention",
                   at + "self_attn/flash_attention") if fault else None)


def tf_feeds(m, batch):
    return {m[k]: batch[k] for k in ("src_ids", "tgt_in", "tgt_out")}


def tf_group_errs(state, ref):
    """``{part: relative-norm error}`` of a transformer Session state
    against ``ref``: each Adam group's parameters as one flat vector (the
    buffer the kernel updates: the variables of one dtype, in name order)
    and each of the other store entries (the flat ``m`` and ``v`` slots,
    the beta powers, the global step) on its own."""
    def rel(a, b):
        return ((a.double() - b.double()).norm()
                / b.double().norm().clamp_min(1e-30)).item()

    slots = [k for k in ref if k.startswith("Adam/") or k == "global_step"]
    groups = {}
    for k in sorted(ref):
        if k not in slots:
            groups.setdefault(str(ref[k].dtype), []).append(k)
    errs = {f"params {dt} ({len(ks)} variables)": rel(
        torch.cat([state[k].reshape(-1) for k in ks]),
        torch.cat([ref[k].reshape(-1) for k in ks]))
        for dt, ks in groups.items()}
    errs.update({k: rel(state[k], ref[k]) for k in slots})
    return errs


def check_f32_session(K, tag, make, feeds, steps, per_step, fault_txt):
    """``steps`` f32 steps of the Session ``make(fault)`` builds (``(model
    dict, session)``, one graph seed: the same initial values and masks)
    through the kernels against the same steps under
    ``fused_ops.plain_versions()``, all dispatched eagerly, cuDNN
    deterministic: each loss within ``TF_LOSS_RTOL``; the parameters, as
    the flat vector per group the Adam kernel updates, and the beta powers
    within ``TF_STATE_TOL`` by relative norm (:func:`tf_group_errs`; the
    worst single variable is printed: the attention key biases, whose
    gradient is zero in exact arithmetic, hold only Adam's lr-sized steps
    on roundoff); the flat ``m`` and ``v`` slots, averages of the
    gradients and their squares, within the f32 gradient limit of the LM
    check at dropout 0.1 (``F32_GRAD_TOL``: a few FFN-input units whose
    ReLU gate flips on f32 roundoff between the two runs move their
    gradients); exactly ``per_step`` launches a step. The planted fault
    (``make(True)``, ``fault_txt``) must fail. Returns the kernel run's
    launches."""
    from simple_tensorflow_tpu_torch.ops import fused_ops

    def run(plain=False, fault=False):
        m, sess = make(fault)
        sess._capture = False
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()):
            outs = [sess.run([m["loss"], m["train_op"]], feeds(m))[0]
                    for _ in range(steps)]
        state = session_state(sess)
        sess.close()
        return outs, state

    def compare(outs, state, ref, ref_state):
        """``(bad losses, {part: error}, (worst variable error, name))``."""
        bad = [(float(a), float(b)) for a, b in zip(outs, ref)
               if not abs(a - b) <= TF_LOSS_RTOL * abs(b)]
        return bad, tf_group_errs(state, ref_state), session_errs(
            state, ref_state)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_state = run(plain=True)
        K.reset_launch_counts()
        got = compare(*run(), ref, ref_state)
        counts = K.launch_counts()
        fault = compare(*run(fault=True), ref, ref_state)
    finally:
        torch.backends.cudnn.deterministic = prev
    want = {k: 0 for k in counts}
    want.update({k: v * steps for k, v in per_step.items()})
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")

    def txt(errs):
        return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())

    print(f"{tag}: {steps} steps, kernels vs plain: losses "
          f"{[float(o) for o in ref]} (plain); off the plain run: "
          f"{got[0]} losses; relative norms: {txt(got[1])}; the worst "
          f"single variable {got[2][0]:.3e} ({got[2][1]})", flush=True)
    print(f"{tag}: planted fault ({fault_txt}): bad losses {fault[0]}; "
          f"{txt(fault[1])}", flush=True)

    def ok(r):
        return not r[0] and all(
            v <= (F32_GRAD_TOL[DROPOUT_RATE] if "/fused_" in k
                  else TF_STATE_TOL) for k, v in r[1].items())

    if not ok(got):
        fail(f"{tag}: the kernels' steps are off the plain steps: {got}")
    if ok(fault):
        fail(f"{tag}: the check passes the planted seed fault: {fault}")
    return counts


def check_transformer_f32(K, stf, tr):
    """:func:`check_f32_session` over ``TF_CHECK_STEPS`` f32 steps of
    ``transformer_train_model`` at ``TransformerConfig.big()`` widths cut
    to ``TF_CHECK_LAYERS`` + ``TF_CHECK_LAYERS`` layers, batch
    ``TF_CHECK_B`` x 64 / 64 with pads, dropout 0.1; the planted fault
    draws the decoder's first cross-attention with another op's seed."""
    cfg = dataclasses.replace(tr.TransformerConfig.big(),
                              num_layers=TF_CHECK_LAYERS)
    batch = tf_batch(TF_CHECK_B, TF_SRC, TF_TGT, cfg.vocab_size, pads=True)
    return check_f32_session(
        K, f"transformer[f32 {TF_CHECK_LAYERS}+{TF_CHECK_LAYERS} layers "
        f"{TF_CHECK_B}x{TF_SRC}/{TF_TGT}]",
        lambda fault: tf_session(stf, tr, cfg, TF_CHECK_B, stf.float32,
                                 fault=fault),
        lambda m: tf_feeds(m, batch), TF_CHECK_STEPS,
        tf_per_step(TF_CHECK_LAYERS, 1),
        "the decoder's first cross-attention drawn with its "
        "self-attention's seed")


def check_graph_replays(tag, make, feeds, probes, steps):
    """``steps`` steps of the Session ``make()`` builds (``(model dict,
    session)``, one graph seed) with the step captured (step 1 eager, the
    warm-up; step 2 captured and replayed; then replays) against the same
    steps with ``_capture`` off: every loss, the ``probes`` (a flash
    op's and a dropout-residual tail's outputs) and after the steps every
    variable and Adam slot bit-identical; one capture. The planted fault
    replays without refilling the seed buffer (``_refresh_seeds`` off):
    the probes of the replayed steps must differ."""
    def run(capture, refresh=True):
        m, sess = make()
        sess._capture = capture
        sess._refresh_seeds = refresh
        outs = [sess.run([m["loss"], m["train_op"]] + probes, feeds(m))
                for _ in range(steps)]
        state = session_state(sess) if refresh else None
        captures = sess.captures
        sess.close()
        return outs, state, captures

    ref, ref_state, _ = run(False)
    got, state, captures = run(True)
    stale, _, _ = run(True, refresh=False)

    def diffs(outs):
        return [(int(a[0] != b[0]),
                 mismatches(torch.from_numpy(a[2].astype(np.float32)),
                            torch.from_numpy(b[2].astype(np.float32))),
                 mismatches(torch.from_numpy(a[3].astype(np.float32)),
                            torch.from_numpy(b[3].astype(np.float32))))
                for a, b in zip(outs, ref)]

    d_got, d_stale = diffs(got), diffs(stale)
    bad_vars = [k for k in ref_state
                if not torch.equal(state[k], ref_state[k])]
    print(f"{tag}: {steps} steps (eager warm-up, capture, {steps - 2} "
          f"replays) vs the eager session: losses "
          f"{[float(a[0]) for a in got]}; (loss differs, flash output "
          f"mismatches, tail mismatches) by step {d_got}; variables and "
          f"slots differing {bad_vars[:5]} ({len(bad_vars)} of "
          f"{len(ref_state)}); captures {captures}", flush=True)
    print(f"{tag}: planted fault, the seed buffer not refilled before the "
          f"replays: by step {d_stale}", flush=True)
    if any(any(d) for d in d_got) or bad_vars or captures != 1:
        fail(f"{tag}: the replayed steps are off the eager steps")
    if not all(d[1] and d[2] for d in d_stale[1:]):
        fail(f"{tag}: the check passes replays with stale seeds: {d_stale}")


def check_transformer_graph(K, stf, tr, cfg, batch):
    """:func:`check_graph_replays` over ``TF_GRAPH_STEPS`` bf16 steps of
    ``transformer_train_model`` as shipped, probing the first encoder
    flash op and dropout-residual tail."""
    at = "transformer/encoder/layer_0/"
    check_graph_replays(
        f"transformer graph[bf16 {TF_B}x{TF_SRC}/{TF_TGT}]",
        lambda: tf_session(stf, tr, cfg, TF_B, stf.bfloat16),
        lambda m: tf_feeds(m, batch),
        [at + "self_attn/flash_attention:0",
         at + "fused_dropout_residual:0"], TF_GRAPH_STEPS)


def flash_seed_ptr_rows(K, gen, dev, B, s, causal, label, H=16,
                        lengths=None):
    """The bf16 flash kernels at B x H heads of S = ``s``, D = 64, dropout
    0.1, through the launch-argument entry and the seed-pointer entry
    (bit-identical, both timed in the same call) against their plain
    versions, with the next seed's mask as a planted fault; causal, or
    non-causal with a (B, S) pad bias (-1e9 on padded keys: the ends of
    every third row, or past ``lengths[b]`` in row b; the transformer's
    encoder and cross-attention case, BERT's attention). Returns ``{part:
    (launch-argument row, seed-pointer row)}``."""
    import torch.nn.functional as F

    D = 64
    bh, rate = B * H, DROPOUT_RATE
    dtype, elem = torch.bfloat16, 2
    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device=dev)
    copies = [tuple(torch.randn((bh, s, D), generator=gen, device=dev).to(
        dtype) for _ in range(4))
        for _ in range(n_copies(4 * bh * s * D * elem))]
    if causal:
        bias = mask = None
    else:
        bias = torch.zeros((B, s), device=dev)
        if lengths is None:
            bias[::3, -11:] = -1e9
        else:
            for b, n in enumerate(lengths):
                bias[b, n:] = -1e9
        mask = bias.view(B, 1, 1, s).to(dtype)
    args = dict(heads=H, sm_scale=D ** -0.5, causal=causal, bias=bias,
                dropout_rate=rate)
    host = dict(args, dropout_seed=FLASH_SEED)
    ptr = dict(args, dropout_seed=seed_t)
    stats = []
    for q, k, v, do in copies:
        ro, rlse = K.flash_attention_fwd_plain(q, k, v, **host)
        stats.append((ro, rlse, (do.float() * ro.float()).sum(-1)))
    q, k, v, do = copies[0]
    ro, rlse, delta = stats[0]
    tag = (f"bf16 BH={bh} S={s} D={D} {'causal' if causal else 'bias'} "
           f"dropout {rate} ({label})")
    outs = {}
    for entry, a in (("host", host), ("ptr", ptr)):
        o, lse = K.flash_attention_fwd(q, k, v, **a)
        dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **a)
        dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **a)
        outs[entry] = (o, lse, dk, dv, dq)
    torch.cuda.synchronize()
    for a, b_ in zip(outs["host"], outs["ptr"]):
        if not torch.equal(a, b_):
            fail(f"flash {tag}: the seed-pointer entry is not bit-identical "
                 "to the launch-argument entry")
    o, lse, dk, dv, dq = outs["ptr"]
    rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta, **host)
    rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **host)
    err = {"fwd": max(check_scaled(f"flash fwd o {tag}", o, ro, 2e-2),
                      check_scaled(f"flash fwd lse {tag}", lse, rlse, 1e-5)),
           "dkdv": max(check_scaled(f"flash dk {tag}", dk, rdk, 2e-2),
                       check_scaled(f"flash dv {tag}", dv, rdv, 2e-2)),
           "dq": check_scaled(f"flash dq {tag}", dq, rdq, 2e-2)}
    check_flash_fault(K, q, k, v, do, rlse, delta, host, (o, dk, dv, dq),
                      (2e-2,) * 4, tag)
    del outs, o, lse, dk, dv, dq, rdk, rdv, rdq
    fns = {"fwd": (K.flash_attention_fwd, K.flash_attention_fwd_plain,
                   lambda c, st: c[:3]),
           "dkdv": (K.flash_attention_dkdv, K.flash_attention_dkdv_plain,
                    lambda c, st: (*c, st[1], st[2])),
           "dq": (K.flash_attention_dq, K.flash_attention_dq_plain,
                  lambda c, st: (*c, st[1], st[2]))}
    q4, k4, v4 = (t.view(B, H, s, D) for t in copies[0][:3])
    lib_fwd = event_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, is_causal=causal, dropout_p=rate),
        reps=20)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    do4 = copies[0][3].view(B, H, s, D)
    lib_fb = event_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                       is_causal=causal, dropout_p=rate),
        (qg, kg, vg), do4))
    # the work these inputs need: live (query, key) pairs only
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    io = bh * s * D * elem
    extra = 0 if causal else B * s * 4
    hashes = K0_OPS * pairs
    bnds = {"fwd": bound_ms(4 * io + bh * s * 4 + extra, 4 * D * pairs,
                            dtype, hashes),
            "dkdv": bound_ms(6 * io + 2 * bh * s * 4 + extra,
                             8 * D * pairs, dtype, hashes),
            "dq": bound_ms(5 * io + 2 * bh * s * 4 + extra,
                           6 * D * pairs, dtype, hashes)}
    libs = {"fwd": lib_fwd, "dkdv": lib_fb, "dq": lib_fb}
    rows = {}
    for part, (kern, plain, pick) in fns.items():
        t = {entry: device_ms([
            lambda c=c, st=st, a=a: kern(*pick(c, st), **a)
            for c, st in zip(copies, stats)]) for entry, a in
            (("host", host), ("ptr", ptr))}
        plain_ms = device_ms([lambda c=c, st=st: plain(*pick(c, st), **host)
                              for c, st in zip(copies, stats)])
        name = f"flash_attention_{part}"
        report(f"{name} {tag}", err[part], t["host"], plain_ms, bnds[part],
               libs[part])
        report(f"{name}_device_seed {tag}", err[part], t["ptr"], plain_ms,
               bnds[part], libs[part])
        print(f"  {name} {tag}: seed-pointer entry {t['ptr']:.5f} ms, "
              f"{t['ptr'] / t['host']:.3f}x the launch-argument entry "
              f"{t['host']:.5f} ms (same call)", flush=True)
        rows[part] = (kernel_row(err[part], t["host"], plain_ms, bnds[part],
                                 libs[part], f"{name} {tag}"),
                      kernel_row(err[part], t["ptr"], plain_ms, bnds[part],
                                 libs[part], f"{name}_device_seed {tag}"))
    print(f"  (flash library at the {label} shape: SDPA with "
          f"{'is_causal' if causal else 'the pad mask'} and dropout_p, CUDA "
          "events; dkdv/dq = SDPA forward + backward)", flush=True)
    return rows


def tf_kernel_rows(K, gen, dev, tf_adam_n):
    """The transformer path's new kernel shapes against their plain
    versions: the bf16 flash kernels at B x H = 64 x 16 heads of S = 64,
    D = 64, non-causal with a pad bias, dropout 0.1, through both entries
    (:func:`flash_seed_ptr_rows`); the dropout-residual kernel and its dx
    at bf16 4096 x 1024 through the seed-pointer entry beside the
    launch-argument one; Adam over the transformer's bf16 group (bf16
    parameters, f32 m and v)."""
    import torch.nn.functional as F

    kdr = importlib.import_module(KMOD + "dropout_residual")
    rate, dtype = DROPOUT_RATE, torch.bfloat16
    seed_t = torch.tensor([FLASH_SEED], dtype=torch.int32, device=dev)
    main = {}
    for part, (host_row, ptr_row) in flash_seed_ptr_rows(
            K, gen, dev, TF_B, TF_SRC, False, "transformer").items():
        main[f"flash_attention_{part}@transformer"] = host_row
        main[f"flash_attention_{part}_device_seed"] = ptr_row

    rows, n = TF_B * TF_TGT, 1024
    tag = f"bf16 rows={rows} n={n} (transformer, seed pointer)"
    kc = [tuple(torch.randn((rows, n), generator=gen, device=dev).to(dtype)
                for _ in range(2)) for _ in range(n_copies(6 * rows * n))]
    x, res = kc[0]
    for name, fn, pl in (
            ("dropout_residual",
             lambda c, sd: kdr.dropout_residual_fwd(c[0], c[1], rate=rate,
                                                    seed=sd),
             lambda c: kdr.dropout_residual_fwd_plain(c[0], c[1], rate=rate,
                                                      seed=FLASH_SEED)),
            ("dropout_residual_bwd",
             lambda c, sd: kdr.dropout_residual_bwd(c[0], rate=rate,
                                                    seed=sd),
             lambda c: kdr.dropout_residual_bwd_plain(c[0], rate=rate,
                                                      seed=FLASH_SEED))):
        err_d = check_exact(f"{name} {tag}", fn(kc[0], seed_t), pl(kc[0]))
        check_exact(f"{name} {tag} vs the launch-argument entry",
                    fn(kc[0], seed_t), fn(kc[0], FLASH_SEED))
        t_ptr = device_ms([lambda c=c: fn(c, seed_t) for c in kc])
        t_host = device_ms([lambda c=c: fn(c, FLASH_SEED) for c in kc])
        plain_ms = device_ms([lambda c=c: pl(c) for c in kc])
        fwd = name == "dropout_residual"
        bnd = bound_ms((6 if fwd else 4) * rows * n, 0, dtype,
                       K0_OPS * rows * n)
        lib = device_ms([lambda c=c: F.dropout(c[0], rate) + c[1]
                         for c in kc]) if fwd else \
            device_ms([lambda c=c: F.dropout(c[0], rate) for c in kc])
        report(f"{name}_device_seed {tag}", err_d, t_ptr, plain_ms, bnd, lib)
        print(f"  {name} {tag}: seed-pointer entry {t_ptr:.5f} ms, "
              f"{t_ptr / t_host:.3f}x the launch-argument entry "
              f"{t_host:.5f} ms (same call)", flush=True)
        main[f"{name}_device_seed"] = kernel_row(
            err_d, t_ptr, plain_ms, bnd, lib, f"{name}_device_seed {tag}")
    del kc, x, res

    n = tf_adam_n
    kw = dict(beta1=0.9, beta2=0.997, eps=1e-9)
    alpha = torch.tensor(1e-4, device=dev)
    p = (0.03 * torch.randn(n, generator=gen, device=dev)).to(dtype)
    m = 0.01 * torch.randn(n, generator=gen, device=dev)
    v = 1e-4 * torch.rand(n, generator=gen, device=dev)
    g = (0.01 * torch.randn(n, generator=gen, device=dev)).to(dtype)
    got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
    ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                              **kw)
    torch.cuda.synchronize()
    name = f"adam_update bfloat16 params n={n} f32 m/v (transformer)"
    if not all(torch.equal(a, b_) for a, b_ in zip(got, ref)):
        fail(f"{name}: kernel is not bit-exact with its plain version")
    del got, ref
    ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
    plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                      **kw)])
    pt = torch.nn.Parameter(p.clone())
    pt.grad = g.clone()
    opt = torch.optim.Adam([pt], lr=1e-4, betas=(0.9, 0.997), eps=1e-9,
                           fused=True)
    lib_ms = event_ms(opt.step)
    # p, g bf16 read, p written; m, v f32 read and written: 14 + 8 bytes
    bnd = bound_ms(22 * n, 12 * n, torch.float32)
    report(name, 0.0, ms, plain_ms, bnd, lib_ms)
    main["adam_update@transformer"] = kernel_row(0.0, ms, plain_ms, bnd,
                                                 lib_ms, name)
    del p, m, v, g, pt, opt
    torch.cuda.empty_cache()
    return main


def tf_adam_groups(cfg):
    """The element counts of ``transformer_train_model``'s two Adam groups
    at ``cfg``: the bf16 Dense kernels and biases, and the f32 embedding
    with the LayerNorm gammas and betas."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    attn = 4 * (d * d + d)
    ffn = d * ff + ff + ff * d + d
    bf16 = L * (attn + ffn) + L * (2 * attn + ffn)
    f32 = cfg.vocab_size * d + L * 2 * 2 * d + L * 3 * 2 * d
    return bf16, f32


def transformer_session_phase(K, dev, kernel_rows):
    """The reference's headline model through the TF-1 front end
    (module docstring, phase 7). Returns ``[(path, dropout,
    launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig.big()
    bf16_n, f32_n = tf_adam_groups(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    print("transformer kernels at the transformer_train_model shapes:",
          flush=True)
    kernel_rows.update(tf_kernel_rows(K, gen, dev, bf16_n))
    paths = [("transformer f32 check", DROPOUT_RATE,
              check_transformer_f32(K, stf, tr))]
    torch.cuda.empty_cache()
    batch = tf_batch(TF_B, TF_SRC, TF_TGT, cfg.vocab_size, pads=False)
    check_transformer_graph(K, stf, tr, cfg, batch)
    torch.cuda.empty_cache()
    tag = f"transformer[bf16 {TF_B}x{TF_SRC}/{TF_TGT}]"
    print(f"{tag}: transformer_train_model(TransformerConfig.big()) as "
          f"shipped ({cfg.num_layers}+{cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, dropout {cfg.dropout}, label smoothing "
          f"{cfg.label_smoothing}, bf16, Adam 0.9/0.997/1e-9, noam lr with "
          f"warmup_steps {TF_WARMUP}), Adam groups bf16 {bf16_n} and f32 "
          f"{f32_n} elements; {TF_STEPS} steps of Session.run([loss, "
          f"train_op]) on one repeated synthetic_wmt_batch({TF_B}, "
          f"{TF_SRC}, {TF_TGT}, seed=0) fed as numpy; the graph window "
          f"first (step 1 eager, step 2 captured), then the eager one",
          flush=True)
    windows = {}
    for capture in (True, False):
        m, sess = tf_session(stf, tr, cfg, TF_B, stf.bfloat16)
        windows[capture] = session_window(
            K, sess, [m["loss"], m["train_op"]], tf_feeds(m, batch),
            TF_STEPS, capture)
        gs = int(sess.run(m["global_step"]))
        sess.close()
        if gs != windows[capture]["steps"]:
            fail(f"{tag}: global_step {gs} after "
                 f"{windows[capture]['steps']} steps")
        torch.cuda.empty_cache()
    graph, eager = windows[True], windows[False]
    per = {k: v * TF_STEPS
           for k, v in tf_per_step(cfg.num_layers, 2).items()}
    # the graph window's first step is its eager warm-up (launch-argument
    # entries), the 15 replays launch the device-key and seed-pointer ones
    want_graph = dict(per)
    for k in SEEDED:
        want_graph[k] = per[k] // TF_STEPS
        want_graph[k + "_device_seed"] = per[k] // TF_STEPS * (TF_STEPS - 1)
    want_graph["dropout"] = per["dropout"] // TF_STEPS
    want_graph["dropout_device_key"] = \
        per["dropout"] // TF_STEPS * (TF_STEPS - 1)
    if graph["late"][1] != 1 or graph["captures"] != 1:
        fail(f"{tag}: captures {graph['captures']} (after the first step "
             f"{graph['late'][1]}), expected exactly 1")
    if eager["captures"]:
        fail(f"{tag}: the eager window captured {eager['captures']} times")
    tokens = TF_B * TF_TGT
    half = TF_STEPS // 2
    g50, gdev = report_window(f"transformer graph[bf16 {TF_B}x{TF_SRC}/"
                              f"{TF_TGT}]", graph, want_graph, tokens,
                              "target tokens", first=slice(0, half),
                              last=slice(-half, None),
                              last_below_first=False)
    e50, edev = report_window(f"transformer eager[bf16 {TF_B}x{TF_SRC}/"
                              f"{TF_TGT}]", eager, per, tokens,
                              "target tokens", first=slice(0, half),
                              last=slice(-half, None),
                              last_below_first=False)
    for w, name in ((graph, "graph"), (eager, "eager")):
        if w["by_name"]:
            check_traced(f"transformer {name}", w["by_name"],
                         ("flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
                          "flash_bwd_dq_mma_kernel",
                          "dropout_residual_vec_kernel"))
    flops = 3 * tr.transformer_flops_per_token(cfg, TF_SRC, TF_TGT)
    both = TF_B * (TF_SRC + TF_TGT)
    for name, p50 in (("graph", g50), ("eager", e50)):
        print(f"{tag} {name}: p50 {p50 * 1e3:.4f} ms, {tokens / p50:.2f} "
              f"target tokens/s, {both / p50:.2f} source + target tokens/s "
              f"(the reference's transformer_big_tokens_per_sec_per_chip "
              f"count), {both * flops / p50 / 1e12:.2f} TFLOP/s at 3 x "
              f"transformer_flops_per_token a source + target token "
              f"({100 * both * flops / p50 / PEAK_OPS_PER_S[torch.bfloat16]:.2f}% "
              f"of the dense bf16 peak)", flush=True)
    print(f"{tag}: graph vs eager p50 step {g50 * 1e3:.4f} vs "
          f"{e50 * 1e3:.4f} ms ({e50 / g50:.3f}x); device ms a step {gdev} "
          f"vs {edev}", flush=True)
    return paths + [("transformer bf16 graph", DROPOUT_RATE,
                     graph["counts"]),
                    ("transformer bf16 eager", DROPOUT_RATE,
                     eager["counts"])]


# -- training-loop phase (Session.run_steps, MonitoredTrainingSession, Saver,
# summaries) -----------------------------------------------------------------

LOOP_N = 4                  # run_steps windows: ConfigProto(loop_fusion_steps)
LOOP_STEPS = 16             # 4 windows of 4 against 16 sequential runs
LOOP_TIMED = 8              # windows (and runs) timed for the p50s
# run A saves at 0 (twice: at the session's creation and at its timer's
# first trigger), 16 and the end; the windows do not depend on the save steps
LOOP_SAVE_STEPS, LOOP_SUMMARY_STEPS, LOOP_LOG_STEPS = 16, 4, 4
LOOP_KEEP = 2               # Saver(max_to_keep=2): checkpoints of 1.76 GB
# JAX's hooks on this graph (tests/test_torch_monitored_session.py holds
# the port's equal to them): the hooks fetch global_step beside train_op,
# before its increment, so StopAtStepHook(last_step=16) ends at step 17
# and the checkpoint named -16 holds step 17; SummarySaverHook writes its
# first summary (step 0) only and then votes windows of one step
LOOP_WINDOWS = [1, 3] + [1] * 13
LOOP_CKPT_STEPS = [0, 16, 17]
LOOP_B_WINDOWS = [1, 3, 1, 1, 1, 1, 1]          # StopAtStepHook(last_step=8)
LOOP_GAP_MS = 0.1           # longest device idle gap between two replays
LOOP_TRACES = 3             # traces of a window, the best kept


def loop_build(stf, tr, cfg, saver=False):
    """``transformer_train_model(TF_B, TF_SRC, TF_TGT, cfg, warmup_steps=
    TF_WARMUP, compute_dtype=bf16)`` and ``stf.summary.scalar("loss",
    loss)`` in a new graph under ``set_random_seed(1)``: ``(graph, model,
    summary, initializer, Saver(max_to_keep=LOOP_KEEP) or None)``."""
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(1)
        m = tr.transformer_train_model(TF_B, TF_SRC, TF_TGT, cfg=cfg,
                                       warmup_steps=TF_WARMUP,
                                       compute_dtype=stf.bfloat16)
        summ = stf.summary.scalar("loss", m["loss"])
        init = stf.global_variables_initializer()
        sv = stf.train.Saver(max_to_keep=LOOP_KEEP) if saver else None
    return g, m, summ, init, sv


def store_bits(sess):
    """``{store name: (dtype, shape, bytes)}``: the raw state (bf16 as its
    2-byte values, as a checkpoint holds it)."""
    from simple_tensorflow_tpu_torch.checkpoint import snapshot

    out = {}
    for k, v in sess._variable_store.values.items():
        a = snapshot.host_array(v)
        out[k] = (a.dtype.itemsize, a.shape, a.tobytes())
    return out


def ckpt_bits(prefix):
    from simple_tensorflow_tpu_torch.train import saver as saver_mod

    return {k: (a.dtype.itemsize, a.shape, a.tobytes())
            for k, a in saver_mod.load_checkpoint_values(prefix).items()}


def bits_differ(a, b):
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def no_recapture(tag, sess):
    """Fail when a plan of ``sess`` was captured twice (a save or a
    restore that moved a store tensor forces a capture anew)."""
    live = sum(len(p.executables) for p in sess._cache.values())
    if sess.captures != live:
        fail(f"{tag}: {sess.captures} captures for {live} captured plans: "
             "a plan was captured anew")
    return sess.captures


def loop_trace(fn, n):
    """Run ``fn()`` (``n`` steps) under ``torch.profiler``: device ms a
    step (kernels, copies, fills), the busy share of the host clock
    around it, the longest idle gap between two device activities, that
    next to a device-to-device copy (the staging before a replay of a
    window: a replay boundary) and elsewhere, and the device-to-device
    copies' ms a step, and the device ms a step by name (``kernels``);
    ``None`` when the trace saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, dev_us, d2d_us, by_name = [], 0.0, 0.0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            d2d = "DtoD" in e.name
            spans.append((e.time_range.start, e.time_range.end, d2d))
            dev_us += e.time_range.elapsed_us()
            d2d_us += e.time_range.elapsed_us() if d2d else 0.0
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / n
    if not spans:
        return None
    spans.sort()
    busy, gaps, end, last_d2d = 0.0, {True: 0.0, False: 0.0}, \
        spans[0][0], spans[0][2]
    for s, e, d2d in spans:
        if s > end:
            edge = d2d or last_d2d
            gaps[edge] = max(gaps[edge], s - end)
            busy += e - s
        elif e > end:
            busy += e - end
        if e >= end:
            last_d2d = d2d
        end = max(end, e)
    return dict(dev_ms=dev_us / 1e3 / n, busy=busy / 1e3 / wall_ms,
                gap_ms=max(gaps.values()) / 1e3,
                edge_gap_ms=gaps[True] / 1e3, inner_gap_ms=gaps[False] / 1e3,
                d2d_ms=d2d_us / 1e3 / n, wall_ms=wall_ms / n,
                kernels=by_name)


def loop_monitored(stf, tr, cfg, feeds_of, directory, last_step):
    """``MonitoredTrainingSession`` over a new graph (``loop_build``) on
    ``directory`` with the phase's hooks, driven by ``run_steps([train_op,
    loss, global_step], LOOP_N)`` until it stops: the window sizes, the
    ``(loss, step)`` each ``run_steps`` returned, the global step the
    session started at, the captures, the last save's statistics."""
    g, m, summ, _, sv = loop_build(stf, tr, cfg, saver=True)
    with g.as_default():
        ms = stf.train.MonitoredTrainingSession(
            checkpoint_dir=directory,
            scaffold=stf.train.Scaffold(saver=sv),
            save_checkpoint_steps=LOOP_SAVE_STEPS,
            save_summaries_steps=LOOP_SUMMARY_STEPS,
            log_step_count_steps=LOOP_LOG_STEPS,
            config=stf.ConfigProto(loop_fusion_steps=LOOP_N),
            hooks=[stf.train.StopAtStepHook(last_step=last_step)])
        sess = ms.raw_session
        start = int(sess.variable_value(m["global_step"]).item())
        sizes, orig = [], ms._run_once

        def run_once(*a, window=1, **k):
            sizes.append(window)
            return orig(*a, window=window, **k)

        ms._run_once = run_once
        fetched = []
        with ms:
            while not ms.should_stop():
                out = ms.run_steps([m["train_op"], m["loss"],
                                    m["global_step"]], LOOP_N,
                                   feed_dict=feeds_of(m))
                # the global step fetched beside train_op is the step's own
                # number less one
                fetched.append((float(out[1]), int(out[2]) + 1))
            captures = no_recapture(f"monitored {directory}", sess)
    return dict(sizes=sizes, fetched=fetched, start=start,
                captures=captures, save=dict(sv.last_save_stats))


def loop_events(directory):
    """``[(step, tag, value)]`` of every event file of ``directory``, read
    by the port's ``summary_iterator``."""
    from simple_tensorflow_tpu_torch.summary import summary_iterator

    out = []
    for name in sorted(os.listdir(directory)):
        if ".tfevents." in name:
            for e in summary_iterator(os.path.join(directory, name)):
                if e.summary is not None:
                    out += [(e.step, v.tag, v.simple_value)
                            for v in e.summary.value]
    return sorted(out)


def loop_phase(K, dev):
    """The TF-1 training loop on the headline model (module docstring,
    phase 7b). Returns ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.framework import errors
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig.big()
    batch = tf_batch(TF_B, TF_SRC, TF_TGT, cfg.vocab_size, pads=False)

    def feeds_of(m):
        return tf_feeds(m, batch)

    tag = f"loop[bf16 {TF_B}x{TF_SRC}/{TF_TGT}]"
    print(f"{tag}: transformer_train_model(TransformerConfig.big()) as in "
          f"phase 7 with stf.summary.scalar('loss', loss), graph seed 1, "
          f"under torch.use_deterministic_algorithms(True, warn_only=True)"
          f": 17 sequential captured runs; MonitoredTrainingSession("
          f"save_checkpoint_steps={LOOP_SAVE_STEPS}, save_summaries_steps="
          f"{LOOP_SUMMARY_STEPS}, log_step_count_steps={LOOP_LOG_STEPS}, "
          f"loop_fusion_steps={LOOP_N}, StopAtStepHook(last_step=16), "
          f"Saver(max_to_keep={LOOP_KEEP})) driven by run_steps(..., "
          f"{LOOP_N}) (run A), stopped at 8 (run B) and resumed in a new "
          f"graph (run C); {LOOP_STEPS // LOOP_N} run_steps windows of "
          f"{LOOP_N} against the sequential runs, and with stale keys and "
          f"seeds as a planted fault", flush=True)
    root = tempfile.mkdtemp(prefix="stf_loop_")
    prev_fill = torch.utils.deterministic.fill_uninitialized_memory
    paths, captures = [], {}
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            paths = loop_checks(K, stf, tr, cfg, feeds_of, tag, root,
                                errors, captures)
        ops = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "determinis" in str(w.message)})
        print(f"{tag}: ops without a deterministic path (warnings under "
              f"use_deterministic_algorithms): {ops or 'none'}", flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = prev_fill
        shutil.rmtree(root, ignore_errors=True)
    print(f"{tag}: captures over the phase {sum(captures.values())} "
          f"{captures}", flush=True)
    return paths


def loop_checks(K, stf, tr, cfg, feeds_of, tag, root, errors, captures):
    """The checks and measurements of :func:`loop_phase`; returns its
    paths."""
    card = card_line()
    paths = []
    per = tf_per_step(cfg.num_layers, 2)
    fetch_names = ("train_op", "loss")

    # -- the reference: sequential captured runs --------------------------------
    g, m, _, init, _ = loop_build(stf, tr, cfg)
    sess = stf.Session(graph=g)
    sess.run(init)
    fetch = [m[k] for k in fetch_names]
    seq, run_s = [], []
    state16 = None
    for i in range(17):
        t0 = time.perf_counter()
        seq.append(float(sess.run(fetch, feeds_of(m))[1]))
        run_s.append(time.perf_counter() - t0)
        if i == LOOP_STEPS - 1:
            state16 = store_bits(sess)
    state17 = store_bits(sess)
    run_trace = loop_trace(
        lambda: [sess.run(fetch, feeds_of(m)) for _ in range(LOOP_N)],
        LOOP_N)
    captures["sequential"] = no_recapture(f"{tag} sequential", sess)
    sess.close()
    torch.cuda.empty_cache()
    run_p50 = statistics.median(run_s[2:])   # the captured replays

    # -- run A: the monitored run -------------------------------------------
    dir_a = os.path.join(root, "A")
    K.reset_launch_counts()
    a = loop_monitored(stf, tr, cfg, feeds_of, dir_a, 16)
    paths.append(("transformer loop monitored A", DROPOUT_RATE,
                  K.launch_counts()))
    captures["A"] = a["captures"]
    torch.cuda.empty_cache()
    steps_a = [p for p in os.listdir(dir_a) if p.endswith(".stfz")]
    kept = sorted(int(p[len("model.ckpt-"):-len(".stfz")]) for p in steps_a)
    events = loop_events(dir_a)
    loss_ev = [(s, v) for s, t, v in events if t == "loss"]
    rate_ev = [s for s, t, _ in events if t == "global_step/sec"]
    bad = []
    if a["sizes"] != LOOP_WINDOWS:
        bad.append(f"windows {a['sizes']} != {LOOP_WINDOWS}")
    if kept != LOOP_CKPT_STEPS[-LOOP_KEEP:]:
        bad.append(f"checkpoints kept {kept}")
    if [(x, s) for x, s in a["fetched"]] != [(seq[s - 1], s)
                                              for _, s in a["fetched"]]:
        bad.append(f"losses {a['fetched']} off the sequential runs")
    if loss_ev != [(0, np.float32(seq[0]))]:
        bad.append(f"loss summaries {loss_ev}")
    if rate_ev != [4, 8, 12, 16]:
        bad.append(f"global_step/sec at {rate_ev}")
    a17 = ckpt_bits(os.path.join(dir_a, "model.ckpt-17"))
    differ = bits_differ(a17, state17)
    if differ:
        bad.append(f"step-17 checkpoint differs from the sequential state "
                   f"in {differ[:5]} ({len(differ)} of {len(a17)})")
    print(f"{tag} A: windows {a['sizes']}, (loss, step) a run_steps call "
          f"{a['fetched']}; checkpoints kept {kept}; summaries: loss "
          f"{loss_ev}, global_step/sec at steps {rate_ev}; step-17 "
          f"checkpoint vs 17 sequential runs: {len(differ)} of {len(a17)} "
          f"variables and slots differ; captures {a['captures']}", flush=True)
    if bad:
        fail(f"{tag} A: " + "; ".join(bad))
    save = a["save"]
    # the hook saves asynchronously (phase 14 times a blocking
    # save beside it): the step loop's cost, then the writer's seconds
    print(f"{card}: {tag} async save (model.ckpt-17): step-loop cost "
          f"{save['stall'] * 1e3:.4f} ms, {save['bytes']} bytes; the writer "
          f"{save['write']:.4f} s: D2H {save['d2h']:.4f} s, npz and sha256 "
          f"{save['serialize']:.4f} s, commit (fsync, rename, index) "
          f"{save['commit']:.4f} s", flush=True)

    # -- windows of n replays against the sequential runs ---------------------
    win = {}
    for fault in (False, True):
        g, m, _, init, sv = loop_build(stf, tr, cfg, saver=True)
        sess = stf.Session(graph=g)
        sess.run(init)
        sess._refresh_keys = sess._refresh_seeds = not fault
        fetch = [m[k] for k in fetch_names]
        K.reset_launch_counts()
        losses = []
        for _ in range(LOOP_STEPS // LOOP_N):
            out = sess.run_steps(fetch, LOOP_N, feed_dict=feeds_of(m),
                                 output_mode="stacked")
            losses += [float(x) for x in out[1]]
        counts = K.launch_counts()
        diff = bits_differ(store_bits(sess), state16)
        same = [x == y for x, y in zip(losses, seq)]
        win[fault] = (losses, diff, same)
        print(f"{tag} window{' (stale keys and seeds)' if fault else ''}: "
              f"{LOOP_STEPS // LOOP_N} run_steps windows of {LOOP_N}: losses "
              f"{[round(x, 5) for x in losses]}; equal to the sequential "
              f"runs' {sum(same)} of {len(same)}; state after step "
              f"{LOOP_STEPS}: {len(diff)} variables and slots differ; "
              f"fallbacks {sess.loop_fusion_fallbacks}", flush=True)
        if not fault:
            want = {k: v * (LOOP_STEPS + 1) for k, v in per.items()}
            for k in SEEDED:
                want[k] = per[k]
                want[k + "_device_seed"] = per[k] * LOOP_STEPS
            want["dropout"] = per["dropout"]
            want["dropout_device_key"] = per["dropout"] * LOOP_STEPS
            full = {k: 0 for k in counts}
            full.update(want)
            if counts != full:
                fail(f"{tag} window: launches {counts}, expected {full} "
                     f"(one dry warm-up, {LOOP_STEPS} replays)")
            print(f"{tag} window: launches {counts} ({LOOP_STEPS} replays "
                  f"x tf_per_step + one dry warm-up)", flush=True)
            paths.append(("transformer loop window", DROPOUT_RATE, counts))
            if not all(same) or diff or sess.loop_fusion_fallbacks or \
                    sess.fused_steps != LOOP_STEPS:
                fail(f"{tag} window: the windows are off the sequential runs")
            # a restore into the live session: in place, nothing re-captured
            t0 = time.perf_counter()
            with g.as_default():
                sv.restore(sess, os.path.join(dir_a, "model.ckpt-17"))
            restore_s = time.perf_counter() - t0
            off = bits_differ(store_bits(sess), state17)
            if off:
                fail(f"{tag}: the restored state is not the checkpoint's: "
                     f"{off[:5]} ({len(off)} differ)")
            # timed: windows and per-step runs alternate, both captured
            win_s = []
            for _ in range(LOOP_TIMED):
                t0 = time.perf_counter()
                sess.run_steps(fetch, LOOP_N, feed_dict=feeds_of(m))
                win_s.append((time.perf_counter() - t0) / LOOP_N)
            # a trace can drop kernel records (tests/test_torch_cuda.py's
            # trace readers retry for it), which reads as an idle gap: the
            # window is traced up to LOOP_TRACES times and the trace with
            # the shortest gap at a replay boundary is kept
            traces = []
            for _ in range(LOOP_TRACES):
                traces.append(loop_trace(lambda: sess.run_steps(
                    fetch, LOOP_N, feed_dict=feeds_of(m)), LOOP_N))
                if traces[-1] is None or \
                        traces[-1]["edge_gap_ms"] <= LOOP_GAP_MS:
                    break
            win_trace = min(traces, key=lambda t: 0 if t is None
                            else t["edge_gap_ms"])
            print(f"{tag}: window traces (longest idle gap next to a "
                  f"device-to-device copy, elsewhere; ms): "
                  f"{[None if t is None else (round(t['edge_gap_ms'], 4), round(t['inner_gap_ms'], 4)) for t in traces]}",
                  flush=True)
            captures["window"] = no_recapture(f"{tag} window", sess)
        else:
            captures["stale"] = sess.captures
        sess.close()
        torch.cuda.empty_cache()
    if all(win[True][2]) or not win[True][1]:
        fail(f"{tag}: windows with stale keys and seeds pass the "
             "sequential check")
    win_p50 = statistics.median(win_s)
    print(f"{card}: {tag} restore of model.ckpt-17 into the live session "
          f"(read, sha256, copy into the store's tensors): {restore_s:.4f} s",
          flush=True)
    print(f"{card}: {tag} p50 ms a step: run_steps windows of {LOOP_N} "
          f"{win_p50 * 1e3:.4f} ({LOOP_TIMED} windows), per-step run "
          f"{run_p50 * 1e3:.4f} (15 captured runs), {run_p50 / win_p50:.4f}x",
          flush=True)
    for name, tr_ in (("run_steps window", win_trace),
                      (f"{LOOP_N} runs", run_trace)):
        if tr_ is None:
            print(f"{card}: {tag} {name}: the profiler saw no device time: "
                  "device and host ms not measured", flush=True)
            continue
        print(f"{card}: {tag} {name}: device {tr_['dev_ms']:.4f} ms a step, "
              f"host {tr_['wall_ms'] - tr_['dev_ms']:.4f} ms a step (traced "
              f"wall {tr_['wall_ms']:.4f} minus device), busy "
              f"{100 * tr_['busy']:.2f}%, longest device idle gap "
              f"{tr_['gap_ms']:.4f} ms (next to a device-to-device copy "
              f"{tr_['edge_gap_ms']:.4f}, elsewhere "
              f"{tr_['inner_gap_ms']:.4f}), device-to-device staging "
              f"{tr_['d2d_ms']:.4f} ms a step", flush=True)
    if win_trace is not None and win_trace["edge_gap_ms"] > max(
            LOOP_GAP_MS, win_trace["d2d_ms"]):
        fail(f"{tag}: the device idled {win_trace['edge_gap_ms']:.4f} ms "
             "between two replays of a window: a replay waited for the host")

    # -- runs B and C: stop at 8, resume in a new graph -------------------------
    dir_b = os.path.join(root, "B")
    b = loop_monitored(stf, tr, cfg, feeds_of, dir_b, 8)
    captures["B"] = b["captures"]
    torch.cuda.empty_cache()
    latest_b = stf.train.latest_checkpoint(dir_b)
    c = loop_monitored(stf, tr, cfg, feeds_of, dir_b, 16)
    captures["C"] = c["captures"]
    torch.cuda.empty_cache()
    c17 = ckpt_bits(os.path.join(dir_b, "model.ckpt-17"))
    differ = bits_differ(c17, a17)
    c_off = [(x, s) for x, s in c["fetched"] if x != seq[s - 1]]
    print(f"{tag} B: windows {b['sizes']}, (loss, step) {b['fetched']}, "
          f"latest checkpoint {os.path.basename(latest_b)}; C: resumed at "
          f"global_step {c['start']}, windows {c['sizes']}, (loss, step) "
          f"{c['fetched']}; C's step-17 checkpoint vs A's: {len(differ)} of "
          f"{len(c17)} variables and slots differ", flush=True)
    if b["sizes"] != LOOP_B_WINDOWS or not latest_b.endswith("-9") or \
            c["start"] != 9 or c["fetched"][-1][1] != 17 or differ or c_off:
        fail(f"{tag}: the resumed run is off the uninterrupted one "
             f"({differ[:5]}; losses off {c_off})")

    # -- a flipped payload byte --------------------------------------------------
    bad = os.path.join(root, "flipped")
    for suffix in (".stfz", ".index.json"):
        shutil.copyfile(os.path.join(dir_b, "model.ckpt-17") + suffix,
                        bad + suffix)
    with open(bad + ".stfz", "r+b") as f:
        f.seek(os.path.getsize(bad + ".stfz") // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x01]))
    g, _, _, _, sv = loop_build(stf, tr, cfg, saver=True)
    with g.as_default(), stf.Session(graph=g) as sess:
        try:
            sv.restore(sess, bad)
        except errors.DataLossError as e:
            print(f"{tag}: a copy of model.ckpt-17 with one payload byte "
                  f"flipped: DataLossError ({str(e)[:90]}...)", flush=True)
        else:
            fail(f"{tag}: a flipped payload byte restored without an error")
    return paths


# -- causal-LM Session phase --------------------------------------------------

LM_CHECK_LAYERS, LM_CHECK_STEPS = 2, 2
LM_GRAPH_STEPS = 5              # a warm-up, a capture, then 3 replays
LM_STEPS = 16


def lm_per_step(cfg, adam_groups):
    """Launches a step of ``causal_lm_train_model`` at ``cfg``: the eager
    trainer's (:func:`per_step`) and one Adam per group."""
    return dict(per_step(cfg), adam_update=adam_groups)


def lm_session(stf, clm, cfg, dtype, fault=False):
    """``causal_lm_train_model(TRAIN_B, TRAIN_S, cfg, warmup_steps=
    TRAIN_WARMUP, compute_dtype=dtype)`` in a :func:`seeded_session`;
    ``fault``: layer 1's flash attention drawn with layer 0's seed."""
    at = "causal_lm/decoder/layer_{}/self_attn/flash_attention"
    return seeded_session(
        stf, lambda: clm.causal_lm_train_model(
            TRAIN_B, TRAIN_S, cfg=cfg, warmup_steps=TRAIN_WARMUP,
            compute_dtype=dtype),
        same_seed=(at.format(1), at.format(0)) if fault else None)


def lm_feeds(m, batch):
    return {m["tok_in"]: batch[0], m["tok_out"]: batch[1]}


def check_lm_f32(K, stf, clm):
    """:func:`check_f32_session` over ``LM_CHECK_STEPS`` f32 steps of
    ``causal_lm_train_model`` at ``TransformerConfig.big()`` widths cut to
    ``LM_CHECK_LAYERS`` layers, batch ``TRAIN_B`` x ``TRAIN_S``, dropout
    0.1; the planted fault draws layer 1's flash attention with layer 0's
    seed."""
    cfg = dataclasses.replace(clm.TransformerConfig.big(),
                              num_layers=LM_CHECK_LAYERS)
    batch = train_batch(cfg.vocab_size)
    return check_f32_session(
        K, f"causal_lm[f32 {LM_CHECK_LAYERS} layers {TRAIN_B}x{TRAIN_S}]",
        lambda fault: lm_session(stf, clm, cfg, stf.float32, fault=fault),
        lambda m: lm_feeds(m, batch), LM_CHECK_STEPS, lm_per_step(cfg, 1),
        "layer 1's flash attention drawn with layer 0's seed")


def check_lm_graph(K, stf, clm, cfg, batch):
    """:func:`check_graph_replays` over ``LM_GRAPH_STEPS`` bf16 steps of
    ``causal_lm_train_model`` at ``TransformerConfig.big()``, probing
    layer 0's flash op and dropout-residual tail."""
    at = "causal_lm/decoder/layer_0/"
    check_graph_replays(
        f"causal_lm graph[bf16 {TRAIN_B}x{TRAIN_S}]",
        lambda: lm_session(stf, clm, cfg, stf.bfloat16),
        lambda m: lm_feeds(m, batch),
        [at + "self_attn/flash_attention:0",
         at + "fused_dropout_residual:0"], LM_GRAPH_STEPS)


def graph_window_counts(per, steps):
    """The launches of a graph window of ``steps`` steps whose per-step
    launches are ``per``: step 1 (the eager warm-up) through the
    launch-argument entries, the replays through the seed-pointer and
    device-key ones."""
    want = {k: v * steps for k, v in per.items()}
    for k in SEEDED:
        if per.get(k):
            want[k] = per[k]
            want[k + "_device_seed"] = per[k] * (steps - 1)
    if per.get("dropout"):
        want["dropout"] = per["dropout"]
        want["dropout_device_key"] = per["dropout"] * (steps - 1)
    return want


def lm_session_phase(K, dev, kernel_rows, notes):
    """The causal LM through the TF-1 front end (module docstring, phase
    8). Returns ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import causal_lm as clm

    cfg = clm.TransformerConfig.big()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    print("causal-LM Session kernels: the causal flash kernels through the "
          "seed-pointer entries at the training shape:", flush=True)
    for part, (_, ptr_row) in flash_seed_ptr_rows(
            K, gen, dev, TRAIN_B, TRAIN_S, True, "causal LM").items():
        kernel_rows[f"flash_attention_{part}_device_seed@causal_lm"] = \
            ptr_row
    torch.cuda.empty_cache()
    paths = [("lm session f32 check", DROPOUT_RATE,
              check_lm_f32(K, stf, clm))]
    torch.cuda.empty_cache()
    batch = train_batch(cfg.vocab_size)
    check_lm_graph(K, stf, clm, cfg, batch)
    torch.cuda.empty_cache()
    tag = f"causal_lm[bf16 {TRAIN_B}x{TRAIN_S}]"
    print(f"{tag}: causal_lm_train_model(TransformerConfig.big()) as "
          f"shipped ({cfg.num_layers} layers, d_model {cfg.d_model}, dropout "
          f"{cfg.dropout}, label smoothing {cfg.label_smoothing}, bf16, Adam "
          f"0.9/0.997/1e-9, noam lr with warmup_steps {TRAIN_WARMUP}); "
          f"{LM_STEPS} steps of Session.run([loss, train_op]) on the LM "
          f"phase's repeated batch fed as numpy; the graph window first "
          f"(step 1 eager, step 2 captured), then the eager one", flush=True)
    windows = {}
    for capture in (True, False):
        m, sess = lm_session(stf, clm, cfg, stf.bfloat16)
        windows[capture] = session_window(
            K, sess, [m["loss"], m["train_op"]], lm_feeds(m, batch),
            LM_STEPS, capture)
        gs = int(sess.run(m["global_step"]))
        sess.close()
        if gs != windows[capture]["steps"]:
            fail(f"{tag}: global_step {gs} after "
                 f"{windows[capture]['steps']} steps")
        torch.cuda.empty_cache()
    graph, eager = windows[True], windows[False]
    per = lm_per_step(cfg, 2)
    if graph["late"][1] != 1 or graph["captures"] != 1:
        fail(f"{tag}: captures {graph['captures']} (after the first step "
             f"{graph['late'][1]}), expected exactly 1")
    if eager["captures"]:
        fail(f"{tag}: the eager window captured {eager['captures']} times")
    tokens = TRAIN_B * TRAIN_S
    half = LM_STEPS // 2
    g50, gdev = report_window(f"causal_lm graph[bf16 {TRAIN_B}x{TRAIN_S}]",
                              graph, graph_window_counts(per, LM_STEPS),
                              tokens, "tokens", first=slice(0, half),
                              last=slice(-half, None),
                              last_below_first=False)
    e50, edev = report_window(f"causal_lm eager[bf16 {TRAIN_B}x{TRAIN_S}]",
                              eager, {k: v * LM_STEPS for k, v in
                                      per.items()}, tokens, "tokens",
                              first=slice(0, half), last=slice(-half, None),
                              last_below_first=False)
    for w, name in ((graph, "graph"), (eager, "eager")):
        if w["by_name"]:
            check_traced(f"causal_lm {name}", w["by_name"],
                         ("flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
                          "flash_bwd_dq_mma_kernel",
                          "dropout_residual_vec_kernel", "dropout_vec_kernel",
                          "layer_norm_fwd_vec_kernel"))
    trainer_ms = notes.get("lm_device_ms")
    gap = "not measured" if gdev is None or trainer_ms is None else \
        f"{gdev - trainer_ms:+.4f} ms ({100 * (gdev / trainer_ms - 1):+.2f}%)"
    print(f"{tag}: graph vs eager p50 step {g50 * 1e3:.4f} vs "
          f"{e50 * 1e3:.4f} ms ({e50 / g50:.3f}x), {tokens / g50:.2f} vs "
          f"{tokens / e50:.2f} tokens/s; device ms a step {gdev} (graph) vs "
          f"{edev} (eager Session) vs {trainer_ms} (the eager "
          f"CausalLMTrainer, training phase, same run): the graph's gap to "
          f"the trainer {gap}", flush=True)
    return paths + [("lm session bf16 graph", DROPOUT_RATE, graph["counts"]),
                    ("lm session bf16 eager", DROPOUT_RATE,
                     eager["counts"])]


# -- ResNet Session phase -----------------------------------------------------

RS_GRAPH_STEPS = 5              # a warm-up, a capture, then 3 replays
RS_STEPS = 16
RS_SLOT = "Momentum/Momentum/fused_momentum_g"


def resnet_session(stf, resnet, b, dtype):
    """``resnet50_train_model(batch_size=b, image_size=RESNET_SIZE,
    dtype=dtype)`` (the shipped recipe) in a :func:`seeded_session`."""
    return seeded_session(stf, lambda: resnet.resnet50_train_model(
        batch_size=b, image_size=RESNET_SIZE, dtype=dtype))


def resnet_session_errs(state, ref):
    """(worst parameter rel-norm error and its name, worst flat Momentum
    slot rel-norm error) of a ResNet Session state against ``ref``."""
    def rel(a, b):
        return ((a.double() - b.double()).norm()
                / b.double().norm().clamp_min(1e-30)).item()

    params = {k: rel(state[k], ref[k]) for k in ref
              if k.startswith("resnet/") and "moving_" not in k}
    worst = max(params, key=params.get)
    acc = max(rel(state[k], ref[k]) for k in ref if k.startswith(RS_SLOT))
    return params[worst], worst, acc


def check_resnet_session_f32(K, stf, resnet, images, labels):
    """``RESNET_F32_STEPS`` f32 steps of ``resnet50_train_model`` at
    ``RESNET_F32_B`` x 224^2 through the kernels against the same steps
    under ``fused_ops.plain_versions()`` (eager dispatch, cuDNN
    deterministic, one graph seed): each loss within rtol 1e-5, every
    parameter and the flat Momentum slot within the eager check's
    ``RESNET_*_TOL`` relative norms, which two planted Momentum faults in
    the graph's ``FusedMomentumUpdate`` lowering (``mu`` x 0.5, Nesterov
    on) must fail. Returns the kernel run's launches."""
    from simple_tensorflow_tpu_torch.ops import fused_ops
    from simple_tensorflow_tpu_torch.train import optimizers

    tag = f"resnet session[f32 {RESNET_F32_B} x {RESNET_SIZE}^2]"
    x, y = images[:RESNET_F32_B], labels[:RESNET_F32_B]

    def run(plain=False):
        m, sess = resnet_session(stf, resnet, RESNET_F32_B, stf.float32)
        sess._capture = False
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()):
            losses = [float(sess.run([m["loss"], m["train_op"]],
                                     {m["images"]: x, m["labels"]: y})[0])
                      for _ in range(RESNET_F32_STEPS)]
        state = session_state(sess)
        groups = len(sess._flat_groups)
        sess.close()
        if groups != 1:
            fail(f"{tag}: {groups} Momentum groups under f32, expected 1")
        return losses, state

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss_p, state_p = run(plain=True)
        K.reset_launch_counts()
        loss_k, state_k = run()
        counts = K.launch_counts()
        faults = {}
        for fault, wrap in (
                ("mu x 0.5", lambda f: lambda p, acc, g, lr, mu, **k: f(
                    p, acc, g, lr, mu * 0.5, **k)),
                ("nesterov on", lambda f: lambda *a, **k: f(
                    *a, **dict(k, use_nesterov=True)))):
            with planted(optimizers, "momentum_update", wrap):
                faults[fault] = resnet_session_errs(run()[1], state_p)
    finally:
        torch.backends.cudnn.deterministic = prev
    want = resnet_launches(counts, RESNET_F32_STEPS, torch.float32)
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")
    errs = resnet_session_errs(state_k, state_p)
    print(f"{tag}: losses {loss_k} (kernels) vs {loss_p} (plain)",
          flush=True)
    print(f"{tag}: after {RESNET_F32_STEPS} steps, worst parameter rel err "
          f"{errs[0]:.3e} ({errs[1]}), Momentum slot {errs[2]:.3e} (limits "
          f"{RESNET_PARAM_TOL}, {RESNET_ACC_TOL})", flush=True)
    print(f"{tag}: planted Momentum faults, (parameter, slot) rel err: "
          + ", ".join(f"{k} ({v[0]:.3e} {v[1]}, {v[2]:.3e})"
                      for k, v in faults.items()), flush=True)
    bad = [f"step {i + 1}: {a} vs {b}" for i, (a, b) in
           enumerate(zip(loss_k, loss_p)) if not abs(a - b) <= 1e-5 * abs(b)]
    if bad:
        fail(f"{tag}: losses through the kernels vs the plain versions: "
             f"{bad}")
    if not (errs[0] <= RESNET_PARAM_TOL and errs[2] <= RESNET_ACC_TOL):
        fail(f"{tag}: state after {RESNET_F32_STEPS} steps off the plain "
             f"run's: {errs}")
    missed = [k for k, v in faults.items()
              if v[0] <= RESNET_PARAM_TOL and v[2] <= RESNET_ACC_TOL]
    if missed:
        fail(f"{tag}: the limits pass planted faults {missed}: {faults}")
    return counts


def check_resnet_session_graph(K, stf, resnet, feeds_of):
    """``RS_GRAPH_STEPS`` bf16 steps of ``resnet50_train_model`` as shipped
    through a Session that captures its step against the same steps with
    ``_capture`` off, cuDNN deterministic (its weight gradients may
    otherwise sum in another order from run to run): losses and every
    variable and slot bit-identical, one capture, the moving statistics
    at their initial values. The same comparison with cuDNN free to
    choose is printed, not checked: it says whether determinism was
    needed."""
    tag = f"resnet session graph[bf16 {RESNET_B} x {RESNET_SIZE}^2]"

    def run(capture):
        m, sess = resnet_session(stf, resnet, RESNET_B, stf.bfloat16)
        sess._capture = capture
        losses = [float(sess.run([m["loss"], m["train_op"]],
                                 feeds_of(m))[0])
                  for _ in range(RS_GRAPH_STEPS)]
        state, captures = session_state(sess), sess.captures
        sess.close()
        torch.cuda.empty_cache()
        return losses, state, captures

    def differ(a, b):
        return [k for k in b if not torch.equal(a[k], b[k])]

    prev = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = True
        ref, ref_state, _ = run(False)
        got, state, captures = run(True)
        torch.backends.cudnn.deterministic = False
        free, free_state, _ = run(True)
    finally:
        torch.backends.cudnn.deterministic = prev
    bad = differ(state, ref_state)
    free_bad = differ(free_state, ref_state)
    moved = [k for k in state if "moving_" in k and not torch.equal(
        state[k], torch.zeros_like(state[k]) if k.endswith("mean")
        else torch.ones_like(state[k]))]
    print(f"{tag}: {RS_GRAPH_STEPS} steps (eager warm-up, capture, "
          f"{RS_GRAPH_STEPS - 2} replays) vs the eager session, cuDNN "
          f"deterministic: losses {got} vs {ref}; variables and slots "
          f"differing {bad[:5]} ({len(bad)} of {len(ref_state)}); captures "
          f"{captures}; moving statistics off their initial values: "
          f"{moved[:5]}", flush=True)
    print(f"{tag}: the captured steps with cuDNN free to choose its "
          f"algorithms, against the same eager reference: losses equal "
          f"{free == ref}, {len(free_bad)} variables and slots differ "
          f"({free_bad[:3]})", flush=True)
    if got != ref or bad or captures != 1:
        fail(f"{tag}: the replayed steps are off the eager steps")
    if moved:
        fail(f"{tag}: train_op moved the moving statistics {moved[:5]}")


def session_momentum_rows(K, gen, dev, sizes):
    """Momentum at the Session's two flat groups (``sizes``: the bf16
    convolution kernels, the f32 BatchNorm and fc variables), f32 slots,
    from non-zero slots: bit-exact with the plain version, timed over
    copies past the L2, with the bound and ``SGD(momentum=0.9,
    fused=True)`` (whose buffer takes the parameter's dtype: bf16 for the
    bf16 group, another function)."""
    rows = {}
    lr = torch.tensor(MOMENTUM_LR, device=dev)
    mu = torch.tensor(MOMENTUM_MU, device=dev)
    for dtype, n in zip((torch.bfloat16, torch.float32), sizes):
        pe = elem_size(dtype)
        p = torch.randn(n, generator=gen, device=dev).to(dtype)
        acc = 0.5 * torch.randn(n, generator=gen, device=dev)
        g = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
        name = f"momentum_update {str(dtype)[6:]} params n={n} (Session)"
        got = K.momentum_update(p.clone(), acc.clone(), g, lr, mu)
        ref = K.momentum_update_plain(p.clone(), acc.clone(), g, lr, mu)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{name}: kernel is not bit-exact with its plain version")
        del got, ref
        copies = [(p.clone(), acc.clone(), g.clone()) for _ in
                  range(n_copies(n * (3 * pe + 8)))]
        ms = device_ms([lambda c=c: K.momentum_update(*c, lr, mu)
                        for c in copies])
        plain_ms = device_ms([lambda c=c: K.momentum_update_plain(
            *c, lr, mu) for c in copies])
        del copies
        pt = torch.nn.Parameter(p.clone())
        pt.grad = g.clone()
        opt = torch.optim.SGD([pt], lr=MOMENTUM_LR, momentum=MOMENTUM_MU,
                              fused=True)
        lib_ms = event_ms(opt.step)
        bnd = bound_ms(n * (3 * pe + 8), 4 * n, torch.float32)
        report(name, 0.0, ms, plain_ms, bnd, lib_ms)
        rows[f"momentum_update@session_{str(dtype)[6:]}"] = kernel_row(
            0.0, ms, plain_ms, bnd, lib_ms, name)
        del p, acc, g, pt, opt
    return rows


def resnet_session_phase(K, dev, kernel_rows, notes):
    """ResNet-50 through the TF-1 front end (module docstring, phase 9).
    Returns ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import resnet

    images, labels = resnet.synthetic_imagenet(RESNET_B, RESNET_SIZE)
    paths = [("resnet session f32 check", 0.0,
              check_resnet_session_f32(K, stf, resnet, images, labels))]
    torch.cuda.empty_cache()
    # the batch fed as numpy in the placeholder's dtype, converted once
    # (as a bf16 input pipeline hands it over)
    images = images.astype(stf.bfloat16.np_dtype)

    def feeds_of(m):
        return {m["images"]: images, m["labels"]: labels}

    check_resnet_session_graph(K, stf, resnet, feeds_of)
    tag = f"resnet session[bf16 {RESNET_B} x {RESNET_SIZE}^2]"
    print(f"{tag}: resnet50_train_model() as shipped (v1.5, bf16, lr 0.1, "
          f"Momentum 0.9, weight decay 1e-4); {RS_STEPS} steps of "
          f"Session.run([loss, train_op]) on one synthetic_imagenet("
          f"{RESNET_B}) batch fed as bf16 numpy; the graph window first "
          f"(step 1 eager, step 2 captured), then the eager one",
          flush=True)
    windows, peaks, sizes = {}, {}, None
    for capture in (True, False):
        m, sess = resnet_session(stf, resnet, RESNET_B, stf.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        windows[capture] = session_window(
            K, sess, [m["loss"], m["train_op"]], feeds_of(m), RS_STEPS,
            capture)
        peaks[capture] = torch.cuda.max_memory_allocated() / 2 ** 30
        gs = int(sess.run(m["global_step"]))
        sizes = [t.numel() for t in sess._flat_groups.values()]
        sess.close()
        if gs != windows[capture]["steps"]:
            fail(f"{tag}: global_step {gs} after "
                 f"{windows[capture]['steps']} steps")
        torch.cuda.empty_cache()
    graph, eager = windows[True], windows[False]
    if graph["late"][1] != 1 or graph["captures"] != 1:
        fail(f"{tag}: captures {graph['captures']} (after the first step "
             f"{graph['late'][1]}), expected exactly 1")
    if eager["captures"]:
        fail(f"{tag}: the eager window captured {eager['captures']} times")
    if len(sizes) != 2:
        fail(f"{tag}: Momentum groups {sizes}, expected 2")
    want = {k: v for k, v in resnet_launches(
        {}, RS_STEPS, torch.bfloat16).items() if v}
    flops = 3 * resnet.resnet_flops_per_image(50, RESNET_SIZE)
    out = {}
    for w, name in ((graph, "graph"), (eager, "eager")):
        # the shipped recipe overshoots on one repeated batch after some
        # ten steps (ResNet phase): the loss is held to falling over the
        # window's first half
        p50, dev_ms = report_window(
            f"resnet session {name}[bf16 {RESNET_B} x {RESNET_SIZE}^2]", w,
            want, RESNET_B, "images", first=slice(0, LOSS_MEAN_OF),
            last=slice(LOSS_MEAN_OF, 2 * LOSS_MEAN_OF),
            last_below_first=False)
        ips = RESNET_B / p50
        out[name] = (p50, dev_ms)
        print(f"{tag} {name}: p50 {p50 * 1e3:.4f} ms, {ips:.2f} images/s, "
              f"{ips * flops / 1e12:.2f} TFLOP/s at 3 x "
              f"resnet_flops_per_image, "
              f"{100 * ips * flops / PEAK_OPS_PER_S[torch.bfloat16]:.2f}% of "
              f"the dense bf16 peak; peak device memory "
              f"{peaks[w is graph]:.3f} GiB", flush=True)
    print(f"{tag}: graph vs eager p50 step {out['graph'][0] * 1e3:.4f} vs "
          f"{out['eager'][0] * 1e3:.4f} ms; device ms a step "
          f"{out['graph'][1]} vs {out['eager'][1]} vs "
          f"{notes.get('resnet_device_ms')} (the eager ResNetTrainer, "
          f"ResNet phase, same run); peak memory {peaks[True]:.3f} (graph) "
          f"vs {peaks[False]:.3f} (eager Session) vs "
          f"{notes.get('resnet_peak_gib')} GiB (the eager trainer)",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    print("ResNet Session kernels at the Session's shapes:", flush=True)
    kernel_rows.update(session_momentum_rows(K, gen, dev, sizes))
    kernel_rows.update(xent_case(K, gen, dev, RESNET_B, 1000,
                                 (torch.float32,), (0.0,),
                                 "@resnet_session"))
    return paths + [("resnet session bf16 graph", 0.0, graph["counts"]),
                    ("resnet session bf16 eager", 0.0, eager["counts"])]


# -- BERT phase (phase 10): bert_pretrain_model through stf.Session ----------

BERT_B, BERT_S, BERT_P = 32, 512, 76   # bench.py _measure_bert's setup
BERT_BIG_B = 40                        # its recompute_bigger_batch
BERT_LR = 1e-4                         # bert_pretrain_model's default
BERT_CHECK_B, BERT_CHECK_S, BERT_CHECK_P = 4, 128, 20
BERT_CHECK_LAYERS, BERT_CHECK_STEPS = 2, 2
BERT_GRAPH_STEPS = 5                   # a warm-up, a capture, then 3 replays
BERT_STEPS = 16


def bert_per_step(layers, recompute, adam_groups):
    """Launches a ``bert_pretrain_model`` step with ``layers`` encoder
    layers at dropout 0.1: a flash op, 2 LayerNorms and 2 Dropouts a layer,
    the embeddings' LayerNorm and Dropout, the MLM head's LayerNorm, the
    MLM and the NSP xent, one Adam a group (at bf16 compute two: the bf16
    Dense variables of the layers and the MLM transform, and the f32
    rest; at f32 one). With ``recompute`` the backward runs each layer's
    forward again: its flash forward, 2 LayerNorm forwards and 2 Dropout
    forwards once more."""
    per = {k: layers for k in FLASH_PARTS}
    per.update(layer_norm=2 * layers + 2, layer_norm_bwd=2 * layers + 2,
               dropout=2 * layers + 1, dropout_bwd=2 * layers + 1,
               softmax_xent_fwd=2, softmax_xent_bwd=2,
               adam_update=adam_groups)
    if recompute:
        per["flash_attention_fwd"] += layers
        per["layer_norm"] += 2 * layers
        per["dropout"] += 2 * layers
    return per


def bert_graph_counts(per, steps):
    """The launches of a graph window of ``steps`` steps: step 1 eager
    (the launch-argument entries), the replays through the seed-pointer
    flash entries and the device-key Dropout."""
    want = {k: v * steps for k, v in per.items()}
    for k in FLASH_PARTS:
        want[k] = per[k]
        want[k + "_device_seed"] = per[k] * (steps - 1)
    want["dropout"] = per["dropout"]
    want["dropout_device_key"] = per["dropout"] * (steps - 1)
    return want


def bert_batch(b, s, p, vocab, seed=0):
    """``synthetic_pretrain_batch(b, s, p, seed=seed, input_mask=True)``:
    row lengths from the seed in [3 s / 4, s], so the key bias masks real
    positions."""
    from simple_tensorflow_tpu_torch.models import bert

    return bert.synthetic_pretrain_batch(b, s, p, vocab_size=vocab,
                                         seed=seed, input_mask=True)


def bert_session(stf, bert, cfg, b, s, p, dtype, recompute, same_seed=None):
    """``bert_pretrain_model(b, s, p, cfg, compute_dtype=dtype,
    use_input_mask=True, recompute=recompute)`` in a
    :func:`seeded_session`."""
    return seeded_session(
        stf, lambda: bert.bert_pretrain_model(
            b, s, p, cfg=cfg, learning_rate=BERT_LR, compute_dtype=dtype,
            use_input_mask=True, recompute=recompute),
        same_seed=same_seed)


def bert_feeds(m, batch):
    return {m[k]: v for k, v in batch.items()}


def bert_adam_groups(cfg):
    """The element counts of ``bert_pretrain_model``'s two Adam groups at
    bf16 compute: the Dense kernels and biases the bf16 activations reach
    (each layer's six, the MLM transform), in bf16; and the f32 rest (the
    embeddings, the LayerNorms, the pooler on the f32 first token, the
    MLM output bias, NSP). At f32 compute, one group of their sum."""
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    dense = 4 * (h * h + h) + (h * f + f) + (f * h + h)
    bf16 = L * dense + (h * h + h)
    f32 = (cfg.vocab_size + cfg.max_position + cfg.type_vocab_size) * h \
        + 2 * h + L * 2 * 2 * h + (h * h + h) + 2 * h + cfg.vocab_size \
        + (2 * h + 2)
    return bf16, f32


def bert_kernel_rows(K, gen, dev, cfg, batch):
    """BERT's kernel shapes against their plain versions: the bf16 flash
    kernels at 32 x 12 heads of S = 512, D = 64, with the batch's key bias,
    dropout 0.1, through both entries (:func:`flash_seed_ptr_rows`);
    LayerNorm at n = 768 on its vector path (16384 and 2432 rows, forward
    and backward), beside the general path forced on the same inputs;
    the MLM xent at bf16 2432 x 30522 and the NSP xent at f32 32 x 2;
    Adam over BERT's two groups (bf16 Dense variables and f32 ones, f32
    m and v); the threefry Dropout at bf16 (32, 512,
    768), keep_prob 0.9, with its device-key entry."""
    import torch.nn.functional as F

    kln = importlib.import_module(KMOD + "layer_norm")
    kdo = importlib.import_module(KMOD + "dropout")
    main = {}
    lengths = batch["input_mask"].sum(1).tolist()
    for part, (host_row, ptr_row) in flash_seed_ptr_rows(
            K, gen, dev, BERT_B, BERT_S, False, "bert", H=cfg.num_heads,
            lengths=lengths).items():
        main[f"flash_attention_{part}@bert"] = host_row
        main[f"flash_attention_{part}_device_seed@bert"] = ptr_row

    n, dtype, elem, eps = cfg.hidden_size, torch.bfloat16, 2, \
        cfg.layer_norm_eps
    for rows in (BERT_B * BERT_S, BERT_B * BERT_P):
        copies = [(torch.randn((rows, n), generator=gen, device=dev)
                   .mul(2).add(0.5).to(dtype),
                   torch.randn((rows, n), generator=gen, device=dev)
                   .to(dtype))
                  for _ in range(n_copies(3 * rows * n * elem))]
        gamma = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
        beta = 0.1 * torch.randn(n, generator=gen, device=dev)
        stats = [K.layer_norm_plain(x, gamma, beta, eps=eps,
                                    return_stats=True) for x, _ in copies]
        (x, dy), (ry, mean, rstd) = copies[0], stats[0]
        nv = kln.vectors_per_lane(n, dtype, x, dy, gamma, beta)
        if nv != 3:
            fail(f"layer_norm bf16 n={n}: vectors_per_lane {nv}, expected "
                 "the vector path's 3")
        name = f"layer_norm bfloat16 rows={rows} n={n} eps={eps} (bert)"
        ts, errs = {}, {}
        for path, v in (("vector", nv), ("general", 0)):
            y, mu, rs = kln.launch_fwd(x, gamma, beta, eps, True, v)
            dx, dg, db = kln.launch_bwd(x, gamma, mean, rstd, dy, v)
            again = kln.launch_bwd(x, gamma, mean, rstd, dy, v)
            rdx, rdg, rdb = K.layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((dx, dg, db),
                                                         again)):
                fail(f"{name} {path} path: the backward differs between "
                     "two runs")
            errs[path] = (
                max(check_close(f"{name} {path}", y, ry, dtype),
                    check_close(f"{name} {path} mean", mu, mean,
                                torch.float32),
                    check_close(f"{name} {path} rstd", rs, rstd,
                                torch.float32)),
                max(check_scaled(f"{name} {path} dx", dx, rdx, 2e-2),
                    check_scaled(f"{name} {path} dgamma", dg, rdg, 1e-4),
                    check_scaled(f"{name} {path} dbeta", db, rdb, 1e-4)))
            ts[path] = (
                device_ms([lambda c=c, v=v: kln.launch_fwd(
                    c[0], gamma, beta, eps, True, v) for c in copies]),
                device_ms([lambda c=c, st=st, v=v: kln.launch_bwd(
                    c[0], gamma, st[1], st[2], c[1], v)
                    for c, st in zip(copies, stats)]))
        plain_f = device_ms([lambda c=c: K.layer_norm_plain(
            c[0], gamma, beta, eps=eps, return_stats=True) for c in copies])
        plain_b = device_ms([lambda c=c, st=st: K.layer_norm_bwd_plain(
            c[0], gamma, st[1], st[2], c[1])
            for c, st in zip(copies, stats)])
        g_t, b_t = gamma.to(dtype), beta.to(dtype)
        lib_f = device_ms([lambda c=c: F.layer_norm(c[0], (n,), g_t, b_t,
                                                    eps=eps)
                           for c in copies])
        lib_b = device_ms([
            lambda c=c, st=st: torch.ops.aten.native_layer_norm_backward(
                c[1], c[0], [n], st[1][:, None], st[2][:, None], g_t, b_t,
                [True, True, True]) for c, st in zip(copies, stats)])
        bnd_f = bound_ms(2 * rows * n * elem + 2 * n * 4 + 8 * rows,
                         8 * rows * n, torch.float32)
        bnd_b = bound_ms(3 * rows * n * elem + 12 * n + 8 * rows,
                         12 * rows * n, torch.float32)
        for path in ("vector", "general"):
            report(f"{name} forward ({path} path)", errs[path][0],
                   ts[path][0], plain_f, bnd_f, lib_f)
            report(f"{name} backward ({path} path)", errs[path][1],
                   ts[path][1], plain_b, bnd_b, lib_b)
        print(f"  {name}: vector path {ts['vector'][0]:.5f} / "
              f"{ts['vector'][1]:.5f} ms (forward / backward) vs the general "
              f"path {ts['general'][0]:.5f} / {ts['general'][1]:.5f} ms, "
              f"F.layer_norm {lib_f:.5f} ms, aten backward {lib_b:.5f} ms "
              "(same call)", flush=True)
        if rows == BERT_B * BERT_S:
            main["layer_norm@bert"] = kernel_row(
                errs["vector"][0], ts["vector"][0], plain_f, bnd_f, lib_f,
                f"layer_norm {name}")
            main["layer_norm_bwd@bert"] = kernel_row(
                errs["vector"][1], ts["vector"][1], plain_b, bnd_b, lib_b,
                f"layer_norm_bwd {name}")
        del copies, stats
    torch.cuda.empty_cache()

    main.update(xent_case(K, gen, dev, BERT_B * BERT_P, cfg.vocab_size,
                          (torch.bfloat16,), (0.0,), "@bert"))
    xent_case(K, gen, dev, BERT_B, 2, (torch.float32,), (0.0,), "@bert_nsp")
    torch.cuda.empty_cache()

    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    alpha = torch.tensor(BERT_LR, device=dev)
    for pdt, n in zip((torch.bfloat16, torch.float32), bert_adam_groups(cfg)):
        p = (0.02 * torch.randn(n, generator=gen, device=dev)).to(pdt)
        m = 0.01 * torch.randn(n, generator=gen, device=dev)
        v = 1e-4 * torch.rand(n, generator=gen, device=dev)
        g = (0.01 * torch.randn(n, generator=gen, device=dev)).to(pdt)
        got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
        ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                                  **kw)
        torch.cuda.synchronize()
        name = (f"adam_update {str(pdt)[6:]} params n={n} f32 m/v (bert "
                f"{'Dense' if pdt == torch.bfloat16 else 'f32'} group)")
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{name}: kernel is not bit-exact with its plain version")
        del got, ref
        ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
        plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                          **kw)])
        pt = torch.nn.Parameter(p.clone())
        pt.grad = g.clone()
        opt = torch.optim.Adam([pt], lr=BERT_LR, fused=True)
        lib_ms = event_ms(opt.step)
        # p, g read and p written in their dtype; m, v f32 read and written
        bnd = bound_ms((3 * p.element_size() + 16) * n, 12 * n,
                       torch.float32)
        report(name, 0.0, ms, plain_ms, bnd, lib_ms)
        if pdt == torch.bfloat16:
            main["adam_update@bert"] = kernel_row(0.0, ms, plain_ms, bnd,
                                                  lib_ms, name)
        del p, m, v, g, pt, opt
        torch.cuda.empty_cache()
    print("  (adam library: Adam(fused=True) keeps bf16 m/v for bf16 "
          "parameters, another function; the f32 group's is the same "
          "function)", flush=True)

    kp, key = 1.0 - cfg.hidden_dropout, DROPOUT_KEY
    shape = (BERT_B, BERT_S, cfg.hidden_size)
    numel = math.prod(shape)
    copies = [torch.randn(shape, generator=gen, device=dev).to(dtype)
              for _ in range(n_copies(4 * numel))]
    x = copies[0]
    tag = f"bfloat16 {shape} keep_prob {kp} (bert)"
    if not kdo.vector_path(numel, x):
        fail(f"dropout {tag}: not on the vector path")
    out, bits = K.dropout_fwd(x, kp, key, return_bits=True)
    err_f = check_exact(f"dropout {tag}", out, K.dropout_plain(x, kp, key))
    check_exact(f"dropout {tag} bits", bits, kdo.pack_keep_bits_plain(
        kdo.keep_mask_plain(shape, kp, key, dev)))
    err_b = check_exact(f"dropout_bwd {tag}", K.dropout_bwd(x, kp, bits),
                        K.dropout_plain(x, kp, key))
    kkey = device_key_row(K, kdo, "dropout@bert", tag, copies, kp, dtype,
                          dev, main)
    saved = [K.dropout_fwd(c, kp, key, return_bits=True)[1] for c in copies]
    ms_f = device_ms([lambda c=c: K.dropout_fwd(c, kp, key, return_bits=True)
                      for c in copies])
    plain_f = device_ms([lambda c=c: K.dropout_plain(c, kp, key)
                         for c in copies])
    ms_b = device_ms([lambda c=c, b=b: K.dropout_bwd(c, kp, b)
                      for c, b in zip(copies, saved)])
    plain_b = device_ms([lambda c=c, b=b: kdo.dropout_bwd_bits_plain(
        c, b, kp) for c, b in zip(copies, saved)])
    lib_f = event_ms(lambda: F.dropout(x, 1.0 - kp), reps=20)
    masks = [torch.rand(shape, generator=gen, device=dev) < kp
             for _ in copies]
    lib_b = device_ms([
        lambda c=c, mk=mk: torch.ops.aten.native_dropout_backward(
            c, mk, 1.0 / kp) for c, mk in zip(copies, masks)])
    bits_bytes = -(-numel // 8)
    bnd_f = bound_ms(4 * numel + bits_bytes, 0, torch.float32,
                     THREEFRY_OPS * numel, THREEFRY_ALU_OPS * numel)
    bnd_b = bound_ms(4 * numel + bits_bytes, numel, torch.float32)
    report(f"dropout {tag}", err_f, ms_f, plain_f, bnd_f, lib_f)
    report(f"dropout_bwd {tag} (from the bits)", err_b, ms_b, plain_b, bnd_b,
           lib_b)
    main["dropout@bert"] = kernel_row(err_f, ms_f, plain_f, bnd_f, lib_f,
                                      f"dropout {tag}")
    main["dropout_bwd@bert"] = kernel_row(err_b, ms_b, plain_b, bnd_b,
                                          lib_b, f"dropout_bwd {tag}")
    report_device_key(main, kkey, bnd_f, lib_f)
    del copies, saved, masks
    torch.cuda.empty_cache()
    return main


def bert_check_cfg(bert):
    """``BertConfig.base()`` widths cut to ``BERT_CHECK_LAYERS`` layers."""
    return dataclasses.replace(bert.BertConfig.base(),
                               num_layers=BERT_CHECK_LAYERS)


def check_bert_f32(K, stf, bert):
    """:func:`check_f32_session` over ``BERT_CHECK_STEPS`` f32 steps of
    ``bert_pretrain_model`` at ``BertConfig.base()`` widths cut to
    ``BERT_CHECK_LAYERS`` layers, batch ``BERT_CHECK_B`` x
    ``BERT_CHECK_S`` with padded rows, dropout 0.1; the planted fault
    draws layer 1's flash op with layer 0's seed."""
    cfg = bert_check_cfg(bert)
    batch = bert_batch(BERT_CHECK_B, BERT_CHECK_S, BERT_CHECK_P,
                       cfg.vocab_size)
    at = "bert/encoder/layer_{}/attention/flash_attention"
    return check_f32_session(
        K, f"bert[f32 {BERT_CHECK_LAYERS} layers {BERT_CHECK_B}x"
        f"{BERT_CHECK_S}]",
        lambda fault: bert_session(
            stf, bert, cfg, BERT_CHECK_B, BERT_CHECK_S, BERT_CHECK_P,
            stf.float32, False,
            same_seed=(at.format(1), at.format(0)) if fault else None),
        lambda m: bert_feeds(m, batch), BERT_CHECK_STEPS,
        bert_per_step(BERT_CHECK_LAYERS, False, 1),
        "layer 1's flash op drawn with layer 0's seed")


@contextlib.contextmanager
def fresh_reforward_seeds():
    """A planted fault: a recompute's second run of a body draws each
    dropout seed anew (the seed + 1), not the forward's."""
    from simple_tensorflow_tpu_torch.framework import function, lowering

    cls, ctx_cls = function._Recompute, lowering.LoweringContext
    backward, seed_for = cls.__dict__["backward"], ctx_cls.seed_for
    state = {"on": False}

    def planted_backward(fctx, *grads):
        state["on"] = True
        try:
            return backward.__func__(fctx, *grads)
        finally:
            state["on"] = False

    def planted_seed_for(self, op):
        seed = seed_for(self, op)
        return seed + 1 if state["on"] else seed

    cls.backward = staticmethod(planted_backward)
    ctx_cls.seed_for = planted_seed_for
    try:
        yield
    finally:
        cls.backward = backward
        ctx_cls.seed_for = seed_for


def check_bert_recompute(K, stf, bert):
    """At the f32 check's size, ``recompute=True`` against the same graph
    run under ``function.without_rematerialization()`` (each body once,
    its intermediates kept by autograd: the same ops, names and masks),
    both through the kernels and dispatched eagerly, cuDNN deterministic:
    the losses within ``TF_LOSS_RTOL``, the parameters within
    ``TF_STATE_TOL`` and the Adam slots within the f32 gradient limit
    (:func:`tf_group_errs`); the launches of ``bert_per_step(...,
    recompute=True)`` a step (the second forwards counted). The planted
    fault (:func:`fresh_reforward_seeds`) must fail. Returns the
    rematerializing run's launches."""
    from simple_tensorflow_tpu_torch.framework import function

    cfg = bert_check_cfg(bert)
    batch = bert_batch(BERT_CHECK_B, BERT_CHECK_S, BERT_CHECK_P,
                       cfg.vocab_size)
    tag = (f"bert recompute[f32 {BERT_CHECK_LAYERS} layers "
           f"{BERT_CHECK_B}x{BERT_CHECK_S}]")

    def run(mode):
        m, sess = bert_session(stf, bert, cfg, BERT_CHECK_B, BERT_CHECK_S,
                               BERT_CHECK_P, stf.float32, True)
        sess._capture = False
        with mode:
            outs = [float(sess.run([m["loss"], m["train_op"]],
                                   bert_feeds(m, batch))[0])
                    for _ in range(BERT_CHECK_STEPS)]
        state = session_state(sess)
        sess.close()
        return outs, state

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_state = run(function.without_rematerialization())
        K.reset_launch_counts()
        got, state = run(contextlib.nullcontext())
        counts = K.launch_counts()
        bad, bad_state = run(fresh_reforward_seeds())
    finally:
        torch.backends.cudnn.deterministic = prev
    want = {k: 0 for k in counts}
    want.update({k: v * BERT_CHECK_STEPS for k, v in bert_per_step(
        BERT_CHECK_LAYERS, True, 1).items()})
    if counts != want:
        fail(f"{tag}: launches {counts}, expected {want}")

    def judge(outs, st):
        losses = [(a, b) for a, b in zip(outs, ref)
                  if not abs(a - b) <= TF_LOSS_RTOL * abs(b)]
        errs = tf_group_errs(st, ref_state)
        ok = not losses and all(
            v <= (F32_GRAD_TOL[DROPOUT_RATE] if "/fused_" in k
                  else TF_STATE_TOL) for k, v in errs.items())
        return ok, losses, errs

    def txt(errs):
        return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())

    ok, losses, errs = judge(got, state)
    fok, flosses, ferrs = judge(bad, bad_state)
    print(f"{tag}: {BERT_CHECK_STEPS} steps rematerializing vs the bodies "
          f"kept: losses {got} vs {ref}; bad losses {losses}; relative "
          f"norms: {txt(errs)}", flush=True)
    print(f"{tag}: planted fault (the re-forward draws fresh dropout "
          f"seeds): losses {bad}; bad losses {flosses}; {txt(ferrs)}",
          flush=True)
    if not ok:
        fail(f"{tag}: the rematerializing steps are off the kept bodies'")
    if fok:
        fail(f"{tag}: the check passes the planted fresh-seed fault")
    return counts


def bert_probes(cfg, recompute):
    """Two root-graph tensors that the step's dropout seeds reach (and not
    only its Dropout keys): the first layer's attention (the flash op, or
    the layer's call) and the last layer's output."""
    last = cfg.num_layers - 1
    if recompute:
        return ["bert/encoder/layer_0_rc:0",
                f"bert/encoder/layer_{last}_rc:0"]
    return ["bert/encoder/layer_0/attention/flash_attention:0",
            f"bert/encoder/layer_{last}/ln_ffn/fused_layer_norm:0"]


def bert_window(K, stf, bert, cfg, b, batch, recompute, capture, steps):
    """A :func:`session_window` of ``steps`` shipped-config steps at batch
    ``b`` in a new Session, with its memory peaks, the memory still
    allocated after it and the memory reserved at its end (GiB), each
    counted above what the process held just before the Session was built
    (``base_gib``: allocated, reserved); checks the global step after
    it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated() / GIB
    res0 = torch.cuda.memory_reserved() / GIB
    m, sess = bert_session(stf, bert, cfg, b, BERT_S, BERT_P, stf.bfloat16,
                           recompute)
    w = session_window(K, sess, [m["loss"], m["train_op"]],
                       bert_feeds(m, batch), steps, capture, peaks=True)
    # what stays allocated between steps: weights, the flat gradient and
    # Adam buffers, a captured step's outputs
    w["held_gib"] = torch.cuda.memory_allocated() / GIB - alloc0
    w["peak_first_gib"] -= alloc0
    w["peak_gib"] -= alloc0
    w["reserved_gib"] -= res0
    w["base_gib"] = (alloc0, res0)
    gs = int(sess.run(m["global_step"]))
    sess.close()
    if gs != w["steps"]:
        fail(f"bert: global_step {gs} after {w['steps']} steps")
    torch.cuda.empty_cache()
    return w


def bert_phase(K, dev, kernel_rows):
    """BERT-base pretraining through the TF-1 front end (module docstring,
    phase 10). Returns ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import bert

    cfg = bert.BertConfig.base()
    batch = bert_batch(BERT_B, BERT_S, BERT_P, cfg.vocab_size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    print("BERT kernels at the bert_pretrain_model shapes:", flush=True)
    kernel_rows.update(bert_kernel_rows(K, gen, dev, cfg, batch))
    paths = [("check bert f32", DROPOUT_RATE, check_bert_f32(K, stf, bert))]
    torch.cuda.empty_cache()
    paths.append(("check bert recompute", DROPOUT_RATE,
                  check_bert_recompute(K, stf, bert)))
    torch.cuda.empty_cache()
    lengths = batch["input_mask"].sum(1)
    flops = 3 * bert.bert_flops_per_token(cfg, BERT_S)
    print(f"bert: bert_pretrain_model(BertConfig.base()) as bench.py "
          f"measures it ({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, dropouts "
          f"{cfg.hidden_dropout}/{cfg.attention_dropout}, bf16, "
          f"use_input_mask, Adam lr {BERT_LR}, groups of "
          f"{bert_adam_groups(cfg)} bf16 and f32 parameters); "
          f"synthetic_pretrain_batch({BERT_B}, {BERT_S}, "
          f"{BERT_P}, seed=0) with row lengths {lengths.min()}-"
          f"{lengths.max()} fed as numpy; 3 x bert_flops_per_token = "
          f"{flops / 1e6:.2f} MFLOP a token", flush=True)
    out = {}
    for recompute in (False, True):
        tag = f"bert{' recompute' if recompute else ''}[bf16 {BERT_B}x" \
              f"{BERT_S}]"
        check_graph_replays(
            f"{tag} graph",
            lambda: bert_session(stf, bert, cfg, BERT_B, BERT_S, BERT_P,
                                 stf.bfloat16, recompute),
            lambda m: bert_feeds(m, batch), bert_probes(cfg, recompute),
            BERT_GRAPH_STEPS)
        torch.cuda.empty_cache()
        per = bert_per_step(cfg.num_layers, recompute, 2)
        windows = {c: bert_window(K, stf, bert, cfg, BERT_B, batch,
                                  recompute, c, BERT_STEPS)
                   for c in (True, False)}
        graph, eager = windows[True], windows[False]
        if graph["late"][1] != 1 or graph["captures"] != 1:
            fail(f"{tag}: captures {graph['captures']} (after the first "
                 f"step {graph['late'][1]}), expected exactly 1")
        if eager["captures"]:
            fail(f"{tag}: the eager window captured {eager['captures']} "
                 "times")
        tokens = BERT_B * BERT_S
        half = BERT_STEPS // 2
        res = {}
        for w, name, want in (
                (graph, "graph", bert_graph_counts(per, BERT_STEPS)),
                (eager, "eager", {k: v * BERT_STEPS
                                  for k, v in per.items()})):
            p50, dev_ms = report_window(
                f"{tag} {name}", w, want, tokens, "tokens",
                first=slice(0, half), last=slice(-half, None),
                last_below_first=False)
            if w["by_name"]:
                check_traced(f"{tag} {name}", w["by_name"], (
                    "flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
                    "flash_bwd_dq_mma_kernel", "layer_norm_fwd_vec_kernel",
                    "layer_norm_bwd_vec_kernel", "dropout_vec_kernel"))
            tps = tokens / p50
            res[name] = (p50, dev_ms, w)
            print(f"{tag} {name}: p50 {p50 * 1e3:.4f} ms, {tps:.2f} tokens/s "
                  f"(bench.py's bert_base_tokens_per_sec_per_chip count), "
                  f"{tps * flops / 1e12:.2f} TFLOP/s at 3 x "
                  f"bert_flops_per_token, "
                  f"{100 * tps * flops / PEAK_OPS_PER_S[torch.bfloat16]:.2f}%"
                  f" of the dense bf16 peak; {mem_txt(w)}", flush=True)
        print(f"{tag}: graph vs eager p50 step {res['graph'][0] * 1e3:.4f} "
              f"vs {res['eager'][0] * 1e3:.4f} ms; device ms a step "
              f"{res['graph'][1]} vs {res['eager'][1]}", flush=True)
        out[recompute] = res
        name = "bert recompute" if recompute else "bert"
        paths += [(f"{name} bf16 graph", DROPOUT_RATE, graph["counts"]),
                  (f"{name} bf16 eager", DROPOUT_RATE, eager["counts"])]
    big = bert_batch(BERT_BIG_B, BERT_S, BERT_P, cfg.vocab_size)
    w = bert_window(K, stf, bert, cfg, BERT_BIG_B, big, True, True,
                    BERT_STEPS)
    tag = f"bert recompute[bf16 {BERT_BIG_B}x{BERT_S}]"
    p50, _ = report_window(
        f"{tag} graph", w, bert_graph_counts(
            bert_per_step(cfg.num_layers, True, 2), BERT_STEPS),
        BERT_BIG_B * BERT_S, "tokens", first=slice(0, BERT_STEPS // 2),
        last=slice(-(BERT_STEPS // 2), None), last_below_first=False)
    tps = BERT_BIG_B * BERT_S / p50
    print(f"{tag} graph: p50 {p50 * 1e3:.4f} ms, {tps:.2f} tokens/s, "
          f"{100 * tps * flops / PEAK_OPS_PER_S[torch.bfloat16]:.2f}% of the "
          f"dense bf16 peak; {mem_txt(w)}", flush=True)
    paths.append(("bert recompute bf16 graph b40", DROPOUT_RATE,
                  w["counts"]))
    wins = (out[False]["eager"][2], out[True]["eager"][2],
            out[False]["graph"][2], out[True]["graph"][2], w)
    print(f"bert: a step's peak device memory (eager windows, steps 3-16, "
          f"above what the process held before the Session) batch {BERT_B} "
          f"{wins[0]['peak_gib']:.3f} GiB, with recompute "
          f"{wins[1]['peak_gib']:.3f} GiB; reserved by the Session after "
          f"the graph windows (its variables, Adam slots and the capture's "
          f"pool) {wins[2]['reserved_gib']:.3f} and "
          f"{wins[3]['reserved_gib']:.3f} GiB, batch {BERT_BIG_B} with "
          f"recompute {wins[4]['reserved_gib']:.3f} GiB (its first two "
          f"steps' peak {wins[4]['peak_first_gib']:.3f}); tokens/s "
          f"{BERT_B * BERT_S / out[False]['graph'][0]:.2f}, "
          f"{BERT_B * BERT_S / out[True]['graph'][0]:.2f}, {tps:.2f}",
          flush=True)
    if not wins[1]["peak_gib"] < wins[0]["peak_gib"]:
        fail(f"bert: recompute does not lower a step's peak memory at batch "
             f"{BERT_B}")
    if not wins[3]["reserved_gib"] < wins[2]["reserved_gib"]:
        fail(f"bert: recompute does not lower a captured step's reserved "
             f"memory at batch {BERT_B}")
    return paths


# -- phase 11: the RNN graphs ------------------------------------------------

PTB_B = 20                 # the ptb_word_lm medium recipe's batch
S2S_B = 64                 # the largest examples/train_seq2seq.py allows
RNN_CHECK_STEPS = 2        # f32 runs, kernels vs plain_versions()
RNN_GRAPH_STEPS = 5        # a warm-up, a capture, then 3 replays
RNN_STEPS = 16
S2S_TRAIN_STEPS = 60       # test_rnn_seq2seq_trains_and_decodes' count
RNN_TOL = 1e-5             # losses rtol; variables and states rel norm
PTB_NEW_LR = 0.25
S2S_PER_STEP = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                "adam_update": 1}


def ptb_per_step(cfg):
    """Launches a ``ptb_lm_model`` training run: the embedding's Dropout
    and the two body Dropouts at each of the ``seq_len`` steps, forward
    and backward from the bits (the probe cell's two stay out of the
    plan: ``lowering.shape_only``), the xent forward and backward; the
    SGD update is plain PyTorch (the JAX package has no kernel for it)."""
    n = 1 + cfg.layers * cfg.seq_len
    return {"dropout": n, "dropout_bwd": n, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1}


def rnn_dropout_rows(K, kdo, gen, dev, shape, suffix, main):
    """The threefry Dropout at f32 ``shape``, keep_prob 0.5 (PTB medium's):
    the forward's values and keep bits bit-exact with the plain version,
    0 mismatches on x = ones, the next key (a planted fault) differing in
    values, bits and backward; the device-key entry (:func:`device_key_row`)
    and the backward from the bits; each timed with its plain version and
    ``F.dropout`` / ``native_dropout_backward``."""
    import torch.nn.functional as F

    kp, key = 0.5, DROPOUT_KEY
    other = (key[0], key[1] + 1)
    numel = math.prod(shape)
    copies = [torch.randn(shape, generator=gen, device=dev)
              for _ in range(n_copies(8 * numel))]
    x = copies[0]
    tag = f"float32 {shape} keep_prob {kp} (ptb)"
    if not kdo.vector_path(numel, x):
        fail(f"dropout {tag}: not on the vector path")
    out, bits = K.dropout_fwd(x, kp, key, return_bits=True)
    err_f = check_exact(f"dropout {tag}", out, K.dropout_plain(x, kp, key))
    check_exact(f"dropout {tag} bits", bits, kdo.pack_keep_bits_plain(
        kdo.keep_mask_plain(shape, kp, key, dev)))
    err_b = check_exact(f"dropout_bwd {tag}", K.dropout_bwd(x, kp, bits),
                        K.dropout_plain(x, kp, key))
    ones = torch.ones(shape, device=dev)
    got, got_bits = K.dropout_fwd(ones, kp, key, return_bits=True)
    miss = mismatches(got, K.dropout_plain(ones, kp, key))
    miss_b = mismatches(K.dropout_bwd(ones, kp, got_bits),
                        K.dropout_plain(ones, kp, key))
    bad_bits = kdo.pack_keep_bits_plain(kdo.keep_mask_plain(shape, kp,
                                                            other, dev))
    faults = (mismatches(got, K.dropout_plain(ones, kp, other)),
              mismatches(got_bits, bad_bits),
              mismatches(K.dropout_bwd(ones, kp, got_bits),
                         kdo.dropout_bwd_bits_plain(ones, bad_bits, kp)))
    print(f"  dropout {tag}: x = ones, kernel vs plain mismatches fwd "
          f"{miss} bwd {miss_b}; against the next key: values, mask bytes, "
          f"backward {faults}; kept {(got != 0).float().mean().item():.5f}",
          flush=True)
    if miss or miss_b or not all(faults):
        fail(f"dropout {tag}: mask mismatches {miss}/{miss_b}, next-key "
             f"faults {faults}")
    kkey = device_key_row(K, kdo, "dropout" + suffix, tag, copies, kp,
                          torch.float32, dev, main)
    saved = [K.dropout_fwd(c, kp, key, return_bits=True)[1] for c in copies]
    ms_f = device_ms([lambda c=c: K.dropout_fwd(c, kp, key, return_bits=True)
                      for c in copies])
    plain_f = device_ms([lambda c=c: K.dropout_plain(c, kp, key)
                         for c in copies])
    ms_b = device_ms([lambda c=c, b=b: K.dropout_bwd(c, kp, b)
                      for c, b in zip(copies, saved)])
    plain_b = device_ms([lambda c=c, b=b: kdo.dropout_bwd_bits_plain(
        c, b, kp) for c, b in zip(copies, saved)])
    lib_f = event_ms(lambda: F.dropout(x, 1.0 - kp), reps=20)
    masks = [torch.rand(shape, generator=gen, device=dev) < kp
             for _ in copies]
    lib_b = device_ms([
        lambda c=c, mk=mk: torch.ops.aten.native_dropout_backward(
            c, mk, 1.0 / kp) for c, mk in zip(copies, masks)])
    bits_bytes = -(-numel // 8)
    bnd_f = bound_ms(8 * numel + bits_bytes, 0, torch.float32,
                     THREEFRY_OPS * numel, THREEFRY_ALU_OPS * numel)
    bnd_b = bound_ms(8 * numel + bits_bytes, numel, torch.float32)
    report(f"dropout {tag}", err_f, ms_f, plain_f, bnd_f, lib_f)
    report(f"dropout_bwd {tag} (from the bits)", err_b, ms_b, plain_b, bnd_b,
           lib_b)
    main["dropout" + suffix] = kernel_row(err_f, ms_f, plain_f, bnd_f, lib_f,
                                          f"dropout {tag}")
    main["dropout_bwd" + suffix] = kernel_row(
        err_b, ms_b, plain_b, bnd_b, lib_b, f"dropout_bwd {tag}")
    report_device_key(main, kkey, bnd_f, lib_f)


def rnn_kernel_rows(K, gen, dev, ptb_cfg, s2s_cfg, n):
    """The RNN graphs' kernel shapes against their plain versions: the
    xent at f32 700 x 10000 (PTB's 20 x 35 words) and 768 x 120
    (seq2seq's [64, 12, 120] logits as rows), the Dropout at f32 (20,
    650) (a body Dropout: 70 a run) and (20, 35, 650) (the embedding's),
    Adam over seq2seq's one f32 group of ``n`` (yardstick
    ``Adam(fused=True)``, the same function in f32)."""
    kdo = importlib.import_module(KMOD + "dropout")
    main = {}
    main.update(xent_case(K, gen, dev, PTB_B * ptb_cfg.seq_len,
                          ptb_cfg.vocab_size, (torch.float32,), (0.0,),
                          "@ptb"))
    main.update(xent_case(K, gen, dev, S2S_B * s2s_cfg.tgt_len,
                          s2s_cfg.tgt_vocab, (torch.float32,), (0.0,),
                          "@seq2seq"))
    torch.cuda.empty_cache()
    rnn_dropout_rows(K, kdo, gen, dev, (PTB_B, ptb_cfg.hidden), "@ptb", main)
    rnn_dropout_rows(K, kdo, gen, dev,
                     (PTB_B, ptb_cfg.seq_len, ptb_cfg.hidden),
                     "@ptb_embedding", main)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    lr = s2s_cfg.learning_rate
    alpha = torch.tensor(lr, device=dev)
    p = 0.08 * torch.randn(n, generator=gen, device=dev)
    m = 0.01 * torch.randn(n, generator=gen, device=dev)
    v = 1e-4 * torch.rand(n, generator=gen, device=dev)
    g = 0.01 * torch.randn(n, generator=gen, device=dev)
    got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
    ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                              **kw)
    torch.cuda.synchronize()
    name = f"adam_update float32 params n={n} f32 m/v (seq2seq)"
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        fail(f"{name}: kernel is not bit-exact with its plain version")
    ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
    plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                      **kw)])
    pt = torch.nn.Parameter(p.clone())
    pt.grad = g.clone()
    opt = torch.optim.Adam([pt], lr=lr, fused=True)
    lib_ms = event_ms(opt.step)
    bnd = bound_ms(28 * n, 12 * n, torch.float32)
    report(name, 0.0, ms, plain_ms, bnd, lib_ms)
    main["adam_update@seq2seq"] = kernel_row(0.0, ms, plain_ms, bnd, lib_ms,
                                             name)
    return main


def ptb_batch(cfg):
    from simple_tensorflow_tpu_torch.models import ptb_lstm

    return ptb_lstm.synthetic_ptb_batch(PTB_B, cfg.seq_len, cfg.vocab_size,
                                        seed=0)


def ptb_fetch(m):
    """``[loss, train_op, c0, h0, c1, ...]``: the loss, the update and the
    LSTM state the next run is fed."""
    return [m["loss"], m["train_op"]] + [t for st in m["state_out"]
                                         for t in st]


def ptb_feeds(m, cfg, batch):
    """The feeds of a run given the previous run's fetches (None: the
    zero state), as truncated BPTT carries the state."""
    from simple_tensorflow_tpu_torch.models import ptb_lstm

    def feeds(prev):
        flat = None if prev is None else prev[2:2 + 2 * cfg.layers]
        st = ptb_lstm.zero_state(PTB_B, cfg) if flat is None else \
            list(zip(flat[0::2], flat[1::2]))
        fd = {m["input_ids"]: batch[0], m["target_ids"]: batch[1]}
        fd.update(ptb_lstm.state_feed(m, st))
        return fd

    return feeds


@contextlib.contextmanager
def per_step_body_keys():
    """Planted fault: a Dropout inside a loop body draws a fresh key at
    every step (``fold_in(its run key, step)``) where the reference
    applies one mask to all steps. Eager runs only (a host key)."""
    from simple_tensorflow_tpu_torch.framework import graph as ops_mod
    from simple_tensorflow_tpu_torch.framework import op_registry, prng
    from simple_tensorflow_tpu_torch.ops import nn_ops

    calls = {}

    def wrap(lower):
        def per_step(ctx, op, inputs):
            if not isinstance(op.graph, ops_mod.FuncGraph):
                return lower(ctx, op, inputs)
            n = calls[op] = calls.get(op, -1) + 1
            key = prng.fold_in(ctx.rng_for(op), n)
            return [nn_ops._dropout_impl(inputs[0], op.attrs["keep_prob"],
                                         key)]
        return per_step

    with planted(op_registry.get("Dropout"), "lower", wrap):
        yield


def rnn_state_errs(state, ref):
    """``(worst relative norm over the store, its name)``, 0 for two zero
    tensors."""
    errs = {}
    for k in ref:
        a, b = state[k].double(), ref[k].double()
        d = (a - b).norm().item()
        errs[k] = 0.0 if d == 0 else d / max(b.norm().item(), 1e-30)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def check_ptb_f32(K, stf, ptb, cfg, batch):
    """``RNN_CHECK_STEPS`` f32 ``ptb_lm_model`` runs (the state carried)
    through the kernels against the same runs under ``plain_versions()``,
    eager, from one initializer run (the same run counter, so the same
    masks): each loss within ``RNN_TOL``, the fetched states and every
    variable within ``RNN_TOL`` by relative norm, the embedding Dropout's
    output equal; exactly ``ptb_per_step`` launches a run. Two planted
    faults must fail: a body Dropout drawing a fresh key at every step
    (:func:`per_step_body_keys`) and SGD at lr x 0.5 set through
    ``lr_update``. Returns the kernel runs' launches."""
    from simple_tensorflow_tpu_torch.ops import fused_ops

    fetch_extra = ["dropout:0"]

    def run(plain=False, fault=None):
        m, sess = seeded_session(stf, lambda: ptb.ptb_lm_model(PTB_B, cfg))
        sess._capture = False
        if fault == "lr x 0.5":
            sess.run(m["lr_update"], {m["new_lr"]: cfg.learning_rate * 0.5})
        feeds = ptb_feeds(m, cfg, batch)
        fetch = ptb_fetch(m) + fetch_extra
        outs, prev = [], None
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()), \
                (per_step_body_keys() if fault == "per-step body keys"
                 else contextlib.nullcontext()):
            for _ in range(RNN_CHECK_STEPS):
                prev = sess.run(fetch, feeds(prev))
                outs.append(prev)
        state = session_state(sess)
        sess.close()
        return outs, state

    def compare(got, ref):
        outs, state = got
        routs, rstate = ref
        bad = [(float(a[0]), float(b[0])) for a, b in zip(outs, routs)
               if not abs(a[0] - b[0]) <= RNN_TOL * abs(b[0])]
        st = max(np.linalg.norm(x.astype(np.float64) - y)
                 / max(np.linalg.norm(y.astype(np.float64)), 1e-30)
                 for a, b in zip(outs, routs)
                 for x, y in zip(a[2:-1], b[2:-1]))
        masks = sum(int(((a[-1] == 0) != (b[-1] == 0)).sum())
                    for a, b in zip(outs, routs))
        return bad, st, rnn_state_errs(state, rstate), masks

    ref = run(plain=True)
    K.reset_launch_counts()
    got = compare(run(), ref)
    counts = K.launch_counts()
    faults = {f: compare(run(fault=f), ref)
              for f in ("per-step body keys", "lr x 0.5")}
    want = {k: 0 for k in counts}
    want.update({k: v * RNN_CHECK_STEPS for k, v in ptb_per_step(cfg).items()})
    if counts != want:
        fail(f"ptb f32 check: launches {counts}, expected {want}")

    def ok(r):
        return not r[0] and r[1] <= RNN_TOL and r[2][0] <= RNN_TOL \
            and not r[3]

    tag = f"ptb[f32 {PTB_B}x{cfg.seq_len}]"
    print(f"{tag}: {RNN_CHECK_STEPS} runs (state carried), kernels vs "
          f"plain: losses {[float(o[0]) for o in ref[0]]} (plain); off the "
          f"plain runs: losses {got[0]}, fed-back states {got[1]:.3e}, the "
          f"worst variable {got[2][0]:.3e} ({got[2][1]}), embedding mask "
          f"mismatches {got[3]}; launches {counts}", flush=True)
    for f, r in faults.items():
        print(f"{tag}: planted fault ({f}): bad losses {r[0]}, states "
              f"{r[1]:.3e}, worst variable {r[2][0]:.3e} ({r[2][1]}), "
              f"mask mismatches {r[3]}", flush=True)
        if ok(r):
            fail(f"{tag}: the check passes the planted fault {f}: {r}")
    if not ok(got):
        fail(f"{tag}: the kernels' runs are off the plain runs: {got}")
    return counts


def check_ptb_graph(stf, ptb, cfg, batch):
    """``RNN_GRAPH_STEPS`` runs with the state carried, the step captured
    (run 1 eager, run 2 captured, then replays) against the same runs
    with ``_capture`` off: losses, fetched states, the embedding Dropout's
    output and every variable bit-identical, one capture. The planted
    fault replays without refilling the key buffer (``_refresh_keys``
    off): the replayed runs must differ."""
    def run(capture, refresh=True):
        m, sess = seeded_session(stf, lambda: ptb.ptb_lm_model(PTB_B, cfg))
        sess._capture = capture
        sess._refresh_keys = refresh
        feeds = ptb_feeds(m, cfg, batch)
        outs, prev = [], None
        for _ in range(RNN_GRAPH_STEPS):
            prev = sess.run(ptb_fetch(m) + ["dropout:0"], feeds(prev))
            outs.append(prev)
        state = session_state(sess)
        captures = sess.captures
        sess.close()
        return outs, state, captures

    def diffs(outs, ref):
        return [sum(int(not np.array_equal(x, y)) for i, (x, y) in
                    enumerate(zip(a, b)) if i != 1)
                for a, b in zip(outs, ref)]

    ref, ref_state, _ = run(False)
    got, state, captures = run(True)
    stale, _, _ = run(True, refresh=False)
    d_got, d_stale = diffs(got, ref), diffs(stale, ref)
    bad_vars = [k for k in ref_state
                if not torch.equal(state[k], ref_state[k])]
    tag = f"ptb graph[f32 {PTB_B}x{cfg.seq_len}]"
    print(f"{tag}: {RNN_GRAPH_STEPS} runs (eager warm-up, capture, "
          f"{RNN_GRAPH_STEPS - 2} replays; the state carried) vs eager: "
          f"losses {[float(a[0]) for a in got]}; fetches differing by run "
          f"{d_got}; variables differing {bad_vars[:5]} ({len(bad_vars)} "
          f"of {len(ref_state)}); captures {captures}", flush=True)
    print(f"{tag}: planted fault, the key buffer not refilled before the "
          f"replays: fetches differing by run {d_stale}", flush=True)
    if any(d_got) or bad_vars or captures != 1:
        fail(f"{tag}: the replayed runs are off the eager runs")
    if not all(d_stale[2:]):
        fail(f"{tag}: the check passes replays with stale keys: {d_stale}")


def check_ptb_lr_update(stf, ptb, cfg, batch):
    """``lr_update`` fed ``PTB_NEW_LR``: the next run moves every variable
    by ``PTB_NEW_LR`` / lr of what the same run (the same initializer, run
    counter, masks and clipped gradients) moves it at the shipped lr,
    within 1e-2 by relative norm (the f32 rounding of the subtraction,
    relative to small steps); a run after ``new_lr`` = lr x 0.5, planted,
    must miss it."""
    def delta(lr):
        m, sess = seeded_session(stf, lambda: ptb.ptb_lm_model(PTB_B, cfg))
        if lr is not None:
            sess.run(m["lr_update"], {m["new_lr"]: lr})
        before = session_state(sess)
        sess.run(ptb_fetch(m), ptb_feeds(m, cfg, batch)(None))
        got = float(sess.run(m["lr"]))
        after = session_state(sess)
        sess.close()
        return got, {k: after[k].double() - before[k].double()
                     for k in before if k not in ("lr", "global_step")}

    _, base = delta(None)
    errs = {}
    scale = PTB_NEW_LR / cfg.learning_rate
    for lr in (PTB_NEW_LR, cfg.learning_rate * 0.5):
        got, d = delta(lr)
        errs[lr] = (got, max(
            ((d[k] - scale * base[k]).norm()
             / (scale * base[k]).norm().clamp_min(1e-30)).item()
            for k in base))
    (lr_got, err), (_, fault) = errs[PTB_NEW_LR], \
        errs[cfg.learning_rate * 0.5]
    print(f"ptb lr_update: the run after new_lr {PTB_NEW_LR} against "
          f"{PTB_NEW_LR} / {cfg.learning_rate} of the shipped run's step: "
          f"lr read back {lr_got}, the worst variable {err:.3e}; planted, "
          f"a step at lr {cfg.learning_rate * 0.5} against the same: "
          f"{fault:.3e}", flush=True)
    if lr_got != PTB_NEW_LR or err > 1e-2 or fault <= 1e-2:
        fail(f"ptb lr_update: {errs}")


def rnn_window(K, stf, build, fetch, feeds, steps, capture):
    """A :func:`session_window` of ``steps`` runs of a new seeded Session
    (``build()`` the model dict; ``fetch(m)``, ``feeds(m)`` its fetches
    and feeds), with its memory counted above what the process held before
    the Session (``base_gib``), as :func:`bert_window` does."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated() / GIB
    res0 = torch.cuda.memory_reserved() / GIB
    m, sess = seeded_session(stf, build)
    w = session_window(K, sess, fetch(m), feeds(m), steps, capture,
                       peaks=True)
    w["held_gib"] = torch.cuda.memory_allocated() / GIB - alloc0
    w["peak_first_gib"] -= alloc0
    w["peak_gib"] -= alloc0
    w["reserved_gib"] -= res0
    w["base_gib"] = (alloc0, res0)
    sess.close()
    torch.cuda.empty_cache()
    return w


def rnn_windows(K, stf, tag, build, fetch, feeds, per, items, unit):
    """A graph and an eager :func:`rnn_window` of ``RNN_STEPS`` runs:
    exact launches (``per`` a run), one capture, the mean loss of the
    last 4 runs below that of the first 4, p50, ``items`` ``unit`` a run,
    device and host ms, the busy share, the device operations a run and
    the memory. Returns ``{"graph"|"eager": (p50, device ms, window)}``."""
    res = {}
    for capture, name in ((True, "graph"), (False, "eager")):
        w = rnn_window(K, stf, build, fetch, feeds, RNN_STEPS, capture)
        if capture and (w["late"][1] != 1 or w["captures"] != 1):
            fail(f"{tag}: captures {w['captures']} (after the first run "
                 f"{w['late'][1]}), expected exactly 1")
        if not capture and w["captures"]:
            fail(f"{tag}: the eager window captured {w['captures']} times")
        want = graph_window_counts(per, RNN_STEPS) if capture else \
            {k: v * RNN_STEPS for k, v in per.items()}
        p50, dev_ms = report_window(f"{tag} {name}", w, want, items, unit,
                                    last_below_first=False)
        busy = "not measured" if dev_ms is None else \
            f"{100 * dev_ms / (p50 * 1e3):.1f}%"
        print(f"{tag} {name}: p50 {p50 * 1e3:.4f} ms, {items / p50:.2f} "
              f"{unit}/s; device ops a run {w['device_ops']:.1f}; busy "
              f"{busy}; {mem_txt(w)}", flush=True)
        res[name] = (p50, dev_ms, w)
    print(f"{tag}: graph vs eager p50 {res['graph'][0] * 1e3:.4f} vs "
          f"{res['eager'][0] * 1e3:.4f} ms; device ms a run "
          f"{res['graph'][1]} vs {res['eager'][1]}", flush=True)
    return res


def s2s_feeds(m, cfg):
    from simple_tensorflow_tpu_torch.models import rnn_seq2seq

    src, lens, tin, tout = rnn_seq2seq.synthetic_copy_batch(S2S_B, cfg,
                                                            seed=0)
    return {m["src"]: src, m["src_len"]: lens, m["tgt_in"]: tin,
            m["tgt_out"]: tout}


def check_s2s_f32(K, stf, s2s, cfg):
    """``RNN_CHECK_STEPS`` f32 ``seq2seq_model`` Adam steps through the
    kernels against the same steps under ``plain_versions()``, eager:
    each loss within ``RNN_TOL``, every variable and the flat Adam slots
    within ``RNN_TOL`` by relative norm, ``decoded`` int-exact; exactly
    ``S2S_PER_STEP`` launches a step. Adam's beta1 x (1 + 1e-4), planted,
    must fail. Returns the kernel steps' launches."""
    from simple_tensorflow_tpu_torch.ops import fused_ops

    def run(plain=False, fault=False):
        m, sess = seeded_session(stf, lambda: s2s.seq2seq_model(S2S_B, cfg))
        sess._capture = False
        if fault:
            op = [o for o in sess.graph.get_operations()
                  if o.type == "FusedAdamUpdate"][0]
            op.attrs["beta1"] = op.attrs["beta1"] * (1 + 1e-4)
        feeds = s2s_feeds(m, cfg)
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()):
            outs = [sess.run([m["loss"], m["train_op"], m["decoded"]],
                             feeds) for _ in range(RNN_CHECK_STEPS)]
        state = session_state(sess)
        sess.close()
        return outs, state

    def compare(got, ref):
        bad = [(float(a[0]), float(b[0])) for a, b in zip(got[0], ref[0])
               if not abs(a[0] - b[0]) <= RNN_TOL * abs(b[0])]
        dec = sum(int((a[2] != b[2]).sum()) for a, b in zip(got[0], ref[0]))
        return bad, rnn_state_errs(got[1], ref[1]), dec

    ref = run(plain=True)
    K.reset_launch_counts()
    got = compare(run(), ref)
    counts = K.launch_counts()
    fault = compare(run(fault=True), ref)
    want = {k: 0 for k in counts}
    want.update({k: v * RNN_CHECK_STEPS for k, v in S2S_PER_STEP.items()})
    if counts != want:
        fail(f"seq2seq f32 check: launches {counts}, expected {want}")
    tag = f"seq2seq[f32 {S2S_B}x{cfg.src_len}/{cfg.tgt_len}]"
    print(f"{tag}: {RNN_CHECK_STEPS} Adam steps, kernels vs plain: losses "
          f"{[float(o[0]) for o in ref[0]]} (plain); off the plain steps: "
          f"losses {got[0]}, the worst variable or slot {got[1][0]:.3e} "
          f"({got[1][1]}), decoded ids differing {got[2]}", flush=True)
    print(f"{tag}: planted fault (Adam beta1 x (1 + 1e-4)): bad losses "
          f"{fault[0]}, worst {fault[1][0]:.3e} ({fault[1][1]})", flush=True)
    if got[0] or got[1][0] > RNN_TOL or got[2]:
        fail(f"{tag}: the kernels' steps are off the plain steps: {got}")
    if not fault[0] and fault[1][0] <= RNN_TOL:
        fail(f"{tag}: the check passes the planted Adam fault: {fault}")
    return counts


def check_s2s_graph(stf, s2s, cfg):
    """``RNN_GRAPH_STEPS`` steps captured (step 1 eager, step 2 captured,
    then replays) against the same steps with ``_capture`` off: losses,
    ``decoded`` and every variable and slot bit-identical, one capture
    (no random op: no stale-key fault to plant)."""
    def run(capture):
        m, sess = seeded_session(stf, lambda: s2s.seq2seq_model(S2S_B, cfg))
        sess._capture = capture
        feeds = s2s_feeds(m, cfg)
        outs = [sess.run([m["loss"], m["train_op"], m["decoded"]], feeds)
                for _ in range(RNN_GRAPH_STEPS)]
        state = session_state(sess)
        captures = sess.captures
        sess.close()
        return outs, state, captures

    ref, ref_state, _ = run(False)
    got, state, captures = run(True)
    d = [(int(a[0] != b[0]), int((a[2] != b[2]).sum()))
         for a, b in zip(got, ref)]
    bad_vars = [k for k in ref_state
                if not torch.equal(state[k], ref_state[k])]
    tag = f"seq2seq graph[f32 {S2S_B}x{cfg.src_len}/{cfg.tgt_len}]"
    print(f"{tag}: {RNN_GRAPH_STEPS} steps (eager warm-up, capture, "
          f"{RNN_GRAPH_STEPS - 2} replays) vs eager: losses "
          f"{[float(a[0]) for a in got]}; (loss differs, decoded ids "
          f"differing) by step {d}; variables and slots differing "
          f"{bad_vars[:5]} ({len(bad_vars)} of {len(ref_state)}); captures "
          f"{captures}", flush=True)
    if any(any(x) for x in d) or bad_vars or captures != 1:
        fail(f"{tag}: the replayed steps are off the eager steps")


def s2s_trains(K, stf, s2s, cfg):
    """``S2S_TRAIN_STEPS`` captured Adam steps on one batch, as JAX's
    ``test_rnn_seq2seq_trains_and_decodes`` takes them: the loss below
    half its start, the greedy ``decoded`` ids right on more than half of
    the real (non-pad) target tokens. Returns the launches."""
    m, sess = seeded_session(stf, lambda: s2s.seq2seq_model(S2S_B, cfg))
    feeds = s2s_feeds(m, cfg)
    K.reset_launch_counts()
    l0 = float(sess.run(m["loss"], feeds))
    for _ in range(S2S_TRAIN_STEPS):
        sess.run(m["train_op"], feeds)
    l1 = float(sess.run(m["loss"], feeds))
    dec = sess.run(m["decoded"], feeds)
    counts = K.launch_counts()
    sess.close()
    tout = feeds[m["tgt_out"]]
    real = tout > 0
    acc = float((dec[real] == tout[real]).mean())
    print(f"seq2seq trains: loss {l0:.5f} -> {l1:.5f} after "
          f"{S2S_TRAIN_STEPS} steps; greedy decoded accuracy on the "
          f"{int(real.sum())} real target tokens {acc:.4f}", flush=True)
    if not (l1 < 0.5 * l0 and acc > 0.5):
        fail(f"seq2seq: loss {l0} -> {l1}, decoded accuracy {acc}")
    return counts


def rnn_phase(K, dev, kernel_rows):
    """The reference's two RNN graphs through the TF-1 front end (module
    docstring, phase 11). Returns ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import ptb_lstm, rnn_seq2seq

    t0 = time.perf_counter()
    pcfg = ptb_lstm.PTBConfig.medium()
    scfg = rnn_seq2seq.Seq2SeqConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    # seq2seq's trainable parameters: its one f32 Adam group
    n = sum(int(np.prod(v.shape.as_list())) for v in seeded_graph_vars(
        stf, lambda: rnn_seq2seq.seq2seq_model(S2S_B, scfg)))
    print("RNN kernels at the ptb_lm_model and seq2seq_model shapes:",
          flush=True)
    kernel_rows.update(rnn_kernel_rows(K, gen, dev, pcfg, scfg, n))
    batch = ptb_batch(pcfg)
    print(f"ptb: ptb_lm_model(PTBConfig.medium()) as shipped (vocab "
          f"{pcfg.vocab_size}, hidden {pcfg.hidden}, {pcfg.layers} layers, "
          f"{pcfg.seq_len} steps, keep_prob {pcfg.keep_prob}, clip "
          f"{pcfg.max_grad_norm}, SGD lr {pcfg.learning_rate}, f32), batch "
          f"{PTB_B}, graph seed 1, synthetic_ptb_batch(seed=0), the LSTM "
          f"state fetched and fed back (truncated BPTT)", flush=True)
    paths = [("check ptb f32", 1 - pcfg.keep_prob,
              check_ptb_f32(K, stf, ptb_lstm, pcfg, batch))]
    check_ptb_graph(stf, ptb_lstm, pcfg, batch)
    check_ptb_lr_update(stf, ptb_lstm, pcfg, batch)
    words = PTB_B * pcfg.seq_len
    res = rnn_windows(
        K, stf, f"ptb[f32 {PTB_B}x{pcfg.seq_len}]",
        lambda: ptb_lstm.ptb_lm_model(PTB_B, pcfg), ptb_fetch,
        lambda m: ptb_feeds(m, pcfg, batch), ptb_per_step(pcfg), words,
        "words")
    paths += [("ptb graph", 1 - pcfg.keep_prob, res["graph"][2]["counts"]),
              ("ptb eager", 1 - pcfg.keep_prob, res["eager"][2]["counts"])]
    print(f"seq2seq: seq2seq_model(Seq2SeqConfig()) as shipped (hidden "
          f"{scfg.hidden}, vocab {scfg.src_vocab}/{scfg.tgt_vocab}, lengths "
          f"{scfg.src_len}/{scfg.tgt_len}, Adam {scfg.learning_rate}, clip "
          f"{scfg.max_grad_norm}, f32, one Adam group of {n}), batch "
          f"{S2S_B}, graph seed 1, synthetic_copy_batch(seed=0), fetching "
          f"loss, train_op and the greedy decoded ids", flush=True)
    paths.append(("check seq2seq f32", 0.0,
                  check_s2s_f32(K, stf, rnn_seq2seq, scfg)))
    check_s2s_graph(stf, rnn_seq2seq, scfg)
    res2 = rnn_windows(
        K, stf, f"seq2seq[f32 {S2S_B}x{scfg.src_len}/{scfg.tgt_len}]",
        lambda: rnn_seq2seq.seq2seq_model(S2S_B, scfg),
        lambda m: [m["loss"], m["train_op"], m["decoded"]],
        lambda m: s2s_feeds(m, scfg), S2S_PER_STEP, S2S_B * scfg.tgt_len,
        "target tokens")
    paths += [("seq2seq graph", 0.0, res2["graph"][2]["counts"]),
              ("seq2seq eager", 0.0, res2["eager"][2]["counts"]),
              ("seq2seq trains", 0.0, s2s_trains(K, stf, rnn_seq2seq,
                                                 scfg))]
    print(f"rnn phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# -- phase 12: control flow and the Transformer's beam search ---------------

BEAM_B, BEAM_K, BEAM_SRC = 4, 4, 64      # batch x beam = 16 decode rows
BEAM_PADS = 9                            # the source's last 9 positions pad
BEAM_LEN = 64                            # decode_len of the checks and rows
BEAM_RUNS = 5                            # timed decodes of a window


def beam_src(cfg):
    """The phase's source batch: ``synthetic_wmt_batch(seed=0)`` ids with
    the last ``BEAM_PADS`` positions of every row padded."""
    from simple_tensorflow_tpu_torch.models import transformer as tr

    src = tr.synthetic_wmt_batch(BEAM_B, BEAM_SRC, BEAM_SRC,
                                 vocab_size=cfg.vocab_size,
                                 seed=0)["src_ids"].copy()
    src[:, -BEAM_PADS:] = cfg.pad_id
    return src


def beam_kernel_rows(K, rng, dev):
    """K6 (the single-query DecodeAttention) at the beam shapes, f32 and
    bf16: self-attention at B = 16, L = 64, lengths 1, 32 and 64, and the
    cross-attention at L = 64 over the padded source with its pad bias.
    Each row against its plain version, a planted fault (the reference at
    lengths - 1; the cross row without its bias) that must disagree, its
    bound from the positions the lengths admit, and SDPA's time."""
    import torch.nn.functional as F

    H, D, B, L = 16, 64, BEAM_B * BEAM_K, BEAM_LEN
    main = {}
    pad_bias = torch.zeros(B, L, device=dev)
    pad_bias[:, -BEAM_PADS:] = -1e9
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for n, cross in ((1, False), (32, False), (64, False), (64, True)):
            per_call = (2 * B * L * H * D + 2 * B * H * D) * \
                torch.tensor([], dtype=dtype).element_size()
            copies = []
            for _ in range(n_copies(per_call)):
                copies.append(tuple(
                    torch.from_numpy(rng.standard_normal(s)).to(dev, dtype)
                    for s in ((B, H, D), (B, L, H, D), (B, L, H, D))))
            lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
            bias = pad_bias if cross else None
            q, k, v = copies[0]
            out = K.decode_attention(q, k, v, lengths, bias=bias)
            ref = K.decode_attention_plain(q, k, v, lengths, bias=bias)
            wrong = (K.decode_attention_plain(q, k, v, lengths)
                     if cross else K.decode_attention_plain(
                         q, k, v, lengths - 1))
            torch.cuda.synchronize()
            name = (f"decode_attention@beam {tag} B={B} L={L} "
                    f"{'cross pad bias' if cross else 'self'} length {n}")
            err = check_close(name, out, ref, dtype)
            rtol, atol = TOL[dtype]
            if torch.allclose(out.float(), wrong.float(), rtol=rtol,
                              atol=atol):
                fail(f"{name}: the planted fault (the reference "
                     f"{'without its bias' if cross else 'at lengths - 1'})"
                     " passes the check")
            span = torch.arange(L, device=dev).view(1, 1, L)
            add = torch.where(span < lengths.view(B, 1, 1).long(), 0.0,
                              float("-inf"))
            if bias is not None:
                add = add + bias.view(B, 1, L)
            add = add.view(B, 1, 1, L).to(dtype)

            def kern(c):
                return lambda: K.decode_attention(c[0], c[1], c[2], lengths,
                                                  bias=bias)

            def plain(c):
                return lambda: K.decode_attention_plain(
                    c[0], c[1], c[2], lengths, bias=bias)

            def lib(c):
                return lambda: F.scaled_dot_product_attention(
                    c[0].view(B, 1, H, D).transpose(1, 2),
                    c[1].transpose(1, 2), c[2].transpose(1, 2),
                    attn_mask=add)

            ms = device_ms([kern(c) for c in copies])
            plain_ms = device_ms([plain(c) for c in copies])
            lib_ms = device_ms([lib(c) for c in copies])
            elem = q.element_size()
            # the positions the lengths admit, K and V rows of each read
            # once; q, the output, lengths and the bias
            moved = (B * n * H * D * 2 * elem + 2 * q.numel() * elem
                     + B * 4 + (B * L * 4 if cross else 0))
            bnd = bound_ms(moved, 4 * B * n * H * D, dtype)
            report(name, err, ms, plain_ms, bnd, lib_ms)
            key = f"decode_attention@beam_{tag}_" + (
                "cross" if cross else f"len{n}")
            main[key] = kernel_row(err, ms, plain_ms, bnd, lib_ms, name)
    return main


def cond_set_row(K, dev):
    """The conditional-node setter (``csrc/control_flow.cu``) against its
    plain version, the predicate read on the host: a graph of 64 IF nodes,
    each adding its index to a sum when its predicate holds, replayed for
    two predicate patterns and held to the host loop's sums; its time a
    node, the host read's, and its bound (one byte)."""
    from simple_tensorflow_tpu_torch.ops.kernels import control_flow as cf

    n = 64
    preds = torch.zeros(n, dtype=torch.bool, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    cf.ensure_counters(dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    K.reset_launch_counts()
    with cf.collect_bodies() as (pools, frames), torch.cuda.graph(graph):
        for i in range(n):
            cf.run_if(preds[i], lambda i=i: acc.add_(float(i)))
    if K.launch_counts()["cond_set"] != n:
        fail(f"cond_set: {K.launch_counts()['cond_set']} setter launches "
             f"captured for {n} IF nodes")
    K.reset_launch_counts()
    worst = 0.0
    for pattern in (np.arange(n) % 3 == 0, np.arange(n) % 2 == 1):
        preds.copy_(torch.from_numpy(pattern))
        acc.zero_()
        graph.replay()
        got = acc.item()
        want = 0.0
        for i in range(n):   # the plain version: each predicate on the host
            if bool(preds[i].item()):
                want += float(i)
        worst = max(worst, abs(got - want))
        if got != want:
            fail(f"cond_set: IF nodes summed {got}, the host loop {want}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    ms = statistics.median(times)

    def plain():
        for i in range(n):
            if bool(preds[i].item()):
                acc.add_(float(i))

    plain_ms = event_ms(plain) / n
    bnd = bound_ms(1, 0, torch.float32)
    name = "cond_set (an IF node, its setter and a one-kernel body)"
    report(name, worst, ms, plain_ms, bnd, None)
    torch.cuda.synchronize()
    del graph
    cf.release_pools(dev, pools)
    cf.release_frames(dev, frames)
    return {"cond_set": kernel_row(worst, ms, plain_ms, bnd, None, name)}


def cf_probe(stf, dev):
    """A data-dependent ``while_loop`` (a tanh layer applied until the
    squared sum passes 400), a ``cond`` whose untaken branch is NaN, and
    the gradient of a bounded loop whose body is NaN past its exit, eager
    and captured, for 4 feeds: equal bit for bit, finite, the trip counts
    differing, no host predicate read in a replay."""
    feeds = [np.random.RandomState(5).randn(8).astype(np.float32) * s
             for s in (0.1, 1.0, -3.0, 0.02)]
    outs, reads = {}, {}
    for capture in (False, True):
        g = stf.Graph()
        with g.as_default():
            x = stf.placeholder(stf.float32, [8], name="x")
            w = stf.get_variable("w", [8, 8], initializer=(
                stf.constant_initializer(np.eye(8, dtype=np.float32) * 1.5)))
            i, v = stf.while_loop(
                lambda i, v: stf.less(stf.reduce_sum(v * v), 400.0),
                lambda i, v: (i + 1, stf.reshape(stf.tanh(stf.matmul(
                    stf.reshape(v, [1, 8]), w)), [8]) * 2.0 + v),
                [stf.constant(0), x])
            s = stf.reduce_sum(x)
            c = stf.cond(stf.greater(s, 0.0), lambda: stf.sqrt(s),
                         lambda: stf.sqrt(-s) * 2.0)
            _, a = stf.while_loop(lambda j, a: stf.greater(a, 1.0),
                                  lambda j, a: (j + 1, stf.sqrt(a - 1.0)),
                                  [stf.constant(0), s * s + 1.5],
                                  maximum_iterations=6)
            gx = stf.gradients(a + c, [x])[0]
            fetch = [i, v, c, a, gx]
            sess = stf.Session()
            sess._capture = capture
            sess.run(stf.global_variables_initializer())
            sess.run(fetch, {x: feeds[0]})
            sess.host_predicate_reads = 0
            outs[capture] = [sess.run(fetch, {x: f}) for f in feeds]
            reads[capture] = sess.host_predicate_reads
            if sess.captures != (1 if capture else 0):
                fail(f"control-flow probe: {sess.captures} captures")
            sess.close()
    for e, c in zip(outs[False], outs[True]):
        for a, b in zip(e, c):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                fail("control-flow probe: a captured run differs from the "
                     "eager run")
            if not np.isfinite(np.asarray(b)).all():
                fail("control-flow probe: a non-finite value or gradient "
                     "(a guarded body ran past its exit)")
    trips = [int(o[0]) for o in outs[True]]
    if len(set(trips)) < 2 or reads[True] or not reads[False]:
        fail(f"control-flow probe: trip counts {trips}, host predicate "
             f"reads eager {reads[False]} captured {reads[True]}")
    print(f"control-flow probe: a data-dependent while_loop ({trips} "
          f"iterations), a cond with a NaN untaken branch and the gradient "
          f"of a bounded loop NaN past its exit: captured = eager bit for "
          f"bit over 4 feeds; host predicate reads eager {reads[False]}, "
          f"captured {reads[True]}", flush=True)


def beam_session(stf, tr, cfg, dtype, L, caches=(True,), fault=False):
    """``beam_search_decode`` of the phase's batch in a new graph under
    graph seed 1, for each ``use_cache`` in ``caches``, and a Session on
    the card after its initializer run: ``(src, [(ids, scores)],
    session)``. ``fault``: the cache accessor's lengths ``i`` instead of
    ``i + 1`` (the new position unread)."""
    g = stf.Graph()
    orig = tr._BeamCaches.append_and_gather

    def short(self, layer, k_new, v_new):
        k_all, v_all, _ = orig(self, layer, k_new, v_new)
        return k_all, v_all, stf.fill([self._b], self._i)

    if fault:
        tr._BeamCaches.append_and_gather = short
    try:
        with g.as_default():
            stf.set_random_seed(1)
            src = stf.placeholder(stf.int32, [BEAM_B, BEAM_SRC], "src")
            outs = [tr.beam_search_decode(src, cfg, beam_size=BEAM_K,
                                          decode_len=L, compute_dtype=dtype,
                                          use_cache=c) for c in caches]
            init = stf.global_variables_initializer()
    finally:
        tr._BeamCaches.append_and_gather = orig
    sess = stf.Session(graph=g)
    sess.run(init)
    return src, outs, sess


def beam_agree(ids, scores, ref_ids, ref_scores):
    """``(ok, first differing column or None, max score difference)``."""
    diff = np.argwhere(ids != ref_ids)
    col = int(diff[:, 2].min()) if len(diff) else None
    err = float(np.abs(scores - ref_scores).max())
    return col is None and err <= 1e-4, col, err


def check_beam_f32(K, stf, tr, cfg, src_ids):
    """f32 at ``decode_len`` 64: the cached search against the naive one
    in one graph (shared weights), ids int-exact and scores within 1e-4
    (the JAX suite's bar for the pair); then with the planted cache
    fault, which must fail it. Returns the launches of the checked run."""
    src, (naive, cached), sess = beam_session(
        stf, tr, cfg, stf.float32, BEAM_LEN, caches=(False, True))
    sess._capture = False
    K.reset_launch_counts()
    (n_ids, n_sc), (c_ids, c_sc) = sess.run([naive, cached],
                                            {src: src_ids})
    counts = K.launch_counts()
    sess.close()
    ok, col, err = beam_agree(c_ids, c_sc, n_ids, n_sc)
    if not ok:
        fail(f"beam f32: cached against naive: first differing column "
             f"{col}, max score difference {err:.3e} (limit 1e-4)")
    src, (naive, cached), sess = beam_session(
        stf, tr, cfg, stf.float32, BEAM_LEN, caches=(False, True),
        fault=True)
    sess._capture = False
    (fn_ids, fn_sc), (fc_ids, fc_sc) = sess.run([naive, cached],
                                                {src: src_ids})
    sess.close()
    f_ok, f_col, f_err = beam_agree(fc_ids, fc_sc, fn_ids, fn_sc)
    if f_ok:
        fail("beam f32: the planted fault (lengths i, not i + 1, in the "
             "cache accessor) passes the cached-against-naive check")
    print(f"beam f32 (decode_len {BEAM_LEN}): cached = naive ids over "
          f"{c_ids.size} tokens, max score difference {err:.3e} (limit "
          f"1e-4); the planted fault fails it (first differing column "
          f"{f_col}, max score difference {f_err:.3e})", flush=True)
    return counts


def beam_window(K, sess, fetch, feeds, capture):
    """``BEAM_RUNS`` decodes after a warm-up (and with ``capture`` the
    capture), then a profiler window of 2: ids and scores, host seconds,
    launches a decode (counted from zero around the timed runs), host
    predicate reads a decode, device ms and operations a decode, captures
    and the graph's nodes."""
    from torch.profiler import ProfilerActivity, profile

    sess._capture = capture
    sess.run(fetch, feeds)
    if capture:
        sess.run(fetch, feeds)
    sess.host_predicate_reads = 0
    K.reset_launch_counts()
    outs, times = [], []
    for _ in range(BEAM_RUNS):
        t0 = time.perf_counter()
        outs.append(sess.run(fetch, feeds))
        times.append(time.perf_counter() - t0)
    counts = {k: v / BEAM_RUNS for k, v in K.launch_counts().items() if v}
    reads = sess.host_predicate_reads / BEAM_RUNS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            sess.run(fetch, feeds)
        torch.cuda.synchronize()
    traced = device_times(prof)
    dev_ms = sum(ms for ms, _ in traced.values()) / 2
    ops = sum(k for _, k in traced.values()) / 2
    top = sorted(((ms / 2, k / 2, name) for name, (ms, k) in traced.items()),
                 reverse=True)[:8]
    nodes = None
    if capture:
        plan = [p for p in sess._cache.values() if p.executables][-1]
        nodes = list(plan.executables.values())[0].graph.node_count()
    return dict(outs=outs, times=times, counts=counts, reads=reads,
                dev_ms=dev_ms if ops else None, ops=ops, nodes=nodes, top=top,
                captures=sess.captures, raw_counts={
                    k: int(round(v * BEAM_RUNS)) for k, v in counts.items()})


def beam_phase(K, dev, kernel_rows):
    """Phase 12: control flow on the card and the reference's beam search
    (module docstring). Returns ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import transformer as tr

    t0 = time.perf_counter()
    card = card_line()
    cfg = tr.TransformerConfig.big()
    rng = np.random.RandomState(12)
    print("beam search kernels (K6 at the beam shapes, the node setter):",
          flush=True)
    kernel_rows.update(beam_kernel_rows(K, rng, dev))
    kernel_rows.update(cond_set_row(K, dev))
    cf_probe(stf, dev)
    src_ids = beam_src(cfg)
    print(f"beam: beam_search_decode at TransformerConfig.big() (vocab "
          f"{cfg.vocab_size}, d_model {cfg.d_model}, {cfg.num_heads} heads, "
          f"{cfg.num_layers} + {cfg.num_layers} layers), batch {BEAM_B} x "
          f"beam {BEAM_K}, source {BEAM_SRC} with its last {BEAM_PADS} "
          f"positions padded, weights from the initializers under graph "
          f"seed 1; {card}", flush=True)
    paths = [("beam f32 check", 0.0, check_beam_f32(K, stf, tr, cfg,
                                                     src_ids))]
    src, (cached,), sess = beam_session(stf, tr, cfg, stf.bfloat16,
                                        BEAM_LEN)
    feeds = {src: src_ids}
    res = {}
    for capture, name in ((False, "eager"), (True, "captured")):
        res[name] = beam_window(K, sess, cached, feeds, capture)
    sess.close()
    eager, graph = res["eager"], res["captured"]
    for a, b in zip(eager["outs"], graph["outs"]):
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail("beam bf16: a captured decode differs from the eager one")
    ids, scores = graph["outs"][-1]
    if not (ids[:, :, 0] == cfg.eos_id).all() or \
            not np.isfinite(scores).all():
        fail("beam bf16: column 0 is not EOS everywhere or a score is not "
             "finite")
    steps = BEAM_LEN - 1
    per = 2 * cfg.num_layers * steps
    for tag, w in (("eager", eager), ("captured", graph)):
        got = w["counts"].get("decode_attention", 0)
        if got != per:
            fail(f"beam bf16 {tag}: {got} DecodeAttention launches a "
                 f"decode, expected {per} (2 x {cfg.num_layers} layers x "
                 f"{steps} iterations)")
    if graph["reads"] or eager["reads"] != steps + 1:
        fail(f"beam bf16: host predicate reads a decode eager "
             f"{eager['reads']} (expected {steps + 1}), captured "
             f"{graph['reads']} (expected 0)")
    tokens = BEAM_B * steps
    for tag, w in (("eager", eager), ("captured", graph)):
        p50 = statistics.median(w["times"])
        # the traced kernels' summed time, which CUPTI inflates: a busy
        # share only where it stays under the wall time
        busy = "not measured" if w["dev_ms"] is None or \
            w["dev_ms"] > p50 * 1e3 else \
            f"{100 * w['dev_ms'] / (p50 * 1e3):.1f}%"
        dev_txt = "not measured" if w["dev_ms"] is None else \
            f"{w['dev_ms']:.4f}"
        print(f"beam bf16 {tag} (decode_len {BEAM_LEN}, {steps} "
              f"iterations): p50 {p50 * 1e3:.4f} ms a decode, "
              f"{tokens / p50:.2f} output tokens/s ({BEAM_B} x {steps} a "
              f"decode), device ms a decode {dev_txt} (busy {busy}), "
              f"device operations a decode {w['ops']:.1f}, host predicate "
              f"reads a decode {w['reads']:.0f}, launches a decode "
              f"{w['counts']}, graph nodes {w['nodes']}; {card}",
              flush=True)
    print("beam bf16 captured: the traced device time a decode by kernel "
          "(ms, launches): " + "; ".join(
              f"{name[:60]} {ms:.4f} ({k:.0f})" for ms, k, name in
              graph["top"]), flush=True)
    print(f"beam bf16: captured = eager bit for bit over {BEAM_RUNS} "
          f"decodes; column 0 EOS; scores finite; {card}", flush=True)
    paths += [("beam bf16 eager", 0.0, eager["raw_counts"]),
              ("beam bf16 captured", 0.0, graph["raw_counts"])]
    # the default decode_len, cfg.max_len: 255 iterations
    src, (cached,), sess = beam_session(stf, tr, cfg, stf.bfloat16, None)
    feeds = {src: src_ids}
    sess._capture = False
    ref = sess.run(cached, feeds)
    long = beam_window(K, sess, cached, feeds, True)
    sess.close()
    for got in long["outs"]:
        if not (np.array_equal(got[0], ref[0]) and
                np.array_equal(got[1], ref[1])):
            fail(f"beam bf16 decode_len {cfg.max_len}: a replay differs "
                 "from the eager decode")
    p50 = statistics.median(long["times"])
    steps = cfg.max_len - 1
    print(f"beam bf16 captured (decode_len {cfg.max_len}, {steps} "
          f"iterations, captured and replayed {BEAM_RUNS} times, each "
          f"equal to the eager decode): p50 {p50 * 1e3:.4f} ms, "
          f"{BEAM_B * steps / p50:.2f} output tokens/s, device ms a decode "
          f"{long['dev_ms']}, device operations a decode "
          f"{long['ops']:.1f}, DecodeAttention launches a decode "
          f"{long['counts'].get('decode_attention')}, graph nodes "
          f"{long['nodes']}; {card}", flush=True)
    paths.append(("beam bf16 long", 0.0, long["raw_counts"]))
    print(f"beam phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# -- phase 13: the input pipeline ---------------------------------------------

DATA_SHARDS = 8
DATA_BATCHES = 16           # 512 records of BERT's 32 x 512 batches
DATA_SB = 4                 # superbatches of 4: run_steps windows of 4
DATA_WINDOWS = 12           # three epochs of the stream
DATA_SAVE_AFTER = 4         # the checkpoint the resumed run starts from
DATA_SHUFFLE = (512, 13)    # the training stream's record shuffle
DATA_DELAY_CYCLES = 200_000_000  # GPU sleep (~0.1 s) before each staged copy
DATA_RATE_ROUNDS = 3
MNIST_DATA_B = 32           # the example's batch
MNIST_DATA_STEPS, MNIST_DATA_SPLIT = 40, 20


@contextlib.contextmanager
def data_slot_fault(wait, delay):
    """Within the block, every ``prefetch_to_device`` pool waits for its
    copies or (``wait`` False, a planted fault) reuses a slot at once, and
    with ``delay`` each element's copies queue behind a GPU sleep on the
    pipeline's stream (the host runs ahead of its copies)."""
    from simple_tensorflow_tpu_torch.data import staging

    def pool_init(orig):
        def init(self, *a, **k):
            orig(self, *a, **k)
            self.wait_copies = wait
        return init

    def slow(orig):
        def to_device(x, device, stream):
            if delay and stream is not None:
                with staging._cuda_lock(device), torch.cuda.stream(stream):
                    torch.cuda._sleep(DATA_DELAY_CYCLES)
            return orig(x, device, stream)
        return to_device

    with planted(staging.PinnedPool, "__init__", pool_init), \
            planted(staging, "to_device", slow):
        yield


def data_parse_counts():
    from simple_tensorflow_tpu_torch.platform import monitoring

    m = monitoring.get_metric("/stf/data/parse_example_batches")
    cells = m.snapshot()["cells"] if m is not None else {}
    return cells.get("native", 0), cells.get("python", 0)


def data_superbatches(stream, n):
    """``n`` superbatches of ``stream`` on the host, as numpy."""
    out = []
    for _ in range(n):
        sb = next(stream)
        out.append({k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else v for k, v in sb.items()})
    return out


def data_stream_check(stf, bert, files, batches, tag, dev, wait=True,
                      delay=False):
    """The stream of the module docstring (``bert.pretrain_dataset`` then
    ``prefetch_to_device(2, superbatch=DATA_SB)``) for two epochs against
    the arrays written: the superbatches that differ (0 when right)."""
    ds = bert.pretrain_dataset(files, BERT_B, BERT_S, BERT_P) \
        .prefetch_to_device(2, superbatch=DATA_SB, device=dev)
    n = 2 * DATA_BATCHES // DATA_SB
    with data_slot_fault(wait, delay):
        it = iter(ds)
        # the consumer takes every superbatch before any sync, so the
        # host runs as far ahead of the copies as the rings allow
        got = [next(it) for _ in range(n)]
        data_sync(dev)
        it.close()
    bad = 0
    for i, sb in enumerate(got):
        for j in range(DATA_SB):
            want = bert.to_feed_dtypes(
                batches[(i * DATA_SB + j) % DATA_BATCHES])
            if sorted(sb) != sorted(want) or not all(
                    sb[k].device.type == dev.type
                    and sb[k].dtype == torch.from_numpy(
                        want[k]).dtype and np.array_equal(
                        sb[k][j].cpu().numpy(), want[k]) for k in want):
                bad += 1
                break
    print(f"data {tag}: {n} superbatches of {DATA_SB} x {BERT_B} records "
          f"from {len(files)} shards, {bad} differ from the arrays written",
          flush=True)
    return bad


def data_rates(stf, bert, files):
    """Records/s of the pipeline alone over one epoch, as
    ``bench.py _measure_input_pipeline`` builds its two chains: the
    sequential one (shard after shard, one parse a record, then batch)
    and the parallel one (AUTOTUNE shard reads, batch, one native parse a
    batch, AUTOTUNE prefetch); the medians of ``DATA_RATE_ROUNDS``
    interleaved rounds."""
    spec = bert.pretrain_spec(BERT_S, BERT_P)
    D = stf.data

    def seq():
        return D.TFRecordDataset(files).parse_example(spec).batch(BERT_B)

    def par():
        return (D.TFRecordDataset(files, num_parallel_reads=D.AUTOTUNE)
                .batch(BERT_B).parse_example(spec).prefetch(D.AUTOTUNE))

    def rate(mk):
        n = 0
        t0 = time.perf_counter()
        for b in mk():
            n += len(b["nsp_labels"])
        return n / (time.perf_counter() - t0)

    rates = {"sequential": [], "parallel": []}
    for _ in range(DATA_RATE_ROUNDS):
        rates["sequential"].append(rate(seq))
        rates["parallel"].append(rate(par))
    return {k: statistics.median(v) for k, v in rates.items()}


def data_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()


def data_bert_graph(stf, bert, cfg, files, pipeline, dev):
    """``bert_pretrain_model`` as phase 10 trains it, in a new graph under
    ``set_random_seed(1)``; with ``pipeline``, the shuffled training
    stream's one-shot iterator (``prefetch_to_device(2, superbatch=
    DATA_SB)``) and a ``train.Saver``: ``(model, session, iterator,
    saver)``."""
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(1)
        m = bert.bert_pretrain_model(
            BERT_B, BERT_S, BERT_P, cfg=cfg, learning_rate=BERT_LR,
            compute_dtype=stf.bfloat16, use_input_mask=True)
        it = saver = None
        if pipeline:
            it = bert.pretrain_dataset(
                files, BERT_B, BERT_S, BERT_P, shuffle=DATA_SHUFFLE) \
                .prefetch_to_device(2, superbatch=DATA_SB, device=dev) \
                .make_one_shot_iterator()
            saver = stf.train.Saver(max_to_keep=1)
        init = stf.global_variables_initializer()
    sess = stf.Session(graph=g, config=None if dev.type == "cuda" else
                       stf.ConfigProto(device_count={"GPU": 0}))
    sess.run(init)
    return m, sess, it, saver


def data_windows(K, sess, m, next_sb, windows, after=None,
                 trace_last=True):
    """``windows`` ``run_steps([loss, train_op], DATA_SB, stacked_feeds=
    next_sb(), output_mode="stacked")`` windows: the losses, each window's
    host seconds (the superbatch's pull included), the launches counted
    from zero, and a ``loop_trace`` of the last window (with
    ``trace_last``). ``after(i)`` runs after window i (1-based)."""
    losses, secs, trace = [], [], None
    K.reset_launch_counts()
    for i in range(1, windows + 1):
        def window():
            sb = next_sb()
            out = sess.run_steps(
                [m["loss"], m["train_op"]], DATA_SB,
                stacked_feeds={m[k]: v for k, v in sb.items()},
                output_mode="stacked")
            losses.extend(float(v) for v in out[0])

        if trace_last and i == windows and sess.device.type == "cuda":
            trace = loop_trace(window, DATA_SB)
        else:
            t0 = time.perf_counter()
            window()
            secs.append(time.perf_counter() - t0)
        if after is not None:
            after(i)
    return dict(losses=losses, secs=secs, counts=K.launch_counts(),
                trace=trace, captures=sess.captures,
                fused=sess.fused_steps,
                fallbacks=dict(sess.loop_fusion_fallbacks))


def data_report(tag, w, card):
    """Print a run's step numbers; returns its p50 step (s)."""
    p50 = statistics.median(w["secs"][1:]) / DATA_SB   # window 1 captures
    tps = BERT_B * BERT_S / p50
    tr = w["trace"]
    if tr is None:
        print(f"{card}: data {tag}: p50 step {p50 * 1e3:.4f} ms, {tps:.2f} "
              "tokens/s; the profiler saw no device time: device and host "
              "ms a step, busy share and idle gap not measured", flush=True)
        return p50, None
    print(f"{card}: data {tag}: p50 step {p50 * 1e3:.4f} ms (windows 2-"
          f"{len(w['secs'])}, host clock around the superbatch's pull and "
          f"run_steps), {tps:.2f} tokens/s; traced window: device "
          f"{tr['dev_ms']:.4f} ms a step, host {p50 * 1e3 - tr['dev_ms']:.4f}"
          f" ms a step (p50 minus device), busy {100 * tr['busy']:.2f}% of "
          f"{tr['wall_ms']:.4f} ms a step, longest device idle gap "
          f"{tr['gap_ms']:.4f} ms (at a replay boundary "
          f"{tr['edge_gap_ms']:.4f}, inside a step {tr['inner_gap_ms']:.4f}),"
          f" device-to-device copies {tr['d2d_ms']:.4f} ms a step; "
          f"captures {w['captures']}, fused steps {w['fused']}", flush=True)
    return p50, tr


def data_bert(K, stf, bert, cfg, files, root, card, dev):
    """Phase 13's BERT runs (module docstring): pipeline-fed with a save
    after window ``DATA_SAVE_AFTER``, numpy-fed, resumed, and the two
    planted faults. Returns its paths."""
    paths = []
    per = bert_per_step(cfg.num_layers, False, 2)
    want = bert_graph_counts(per, 1 + DATA_WINDOWS * DATA_SB)
    ckpt = os.path.join(root, "ckpt", "model.ckpt")

    # the stream the numpy-fed runs take: the training chain, sequential,
    # superbatched on the host
    ref = iter(bert.pretrain_dataset(files, BERT_B, BERT_S, BERT_P,
                                     shuffle=DATA_SHUFFLE)
               .superbatch(DATA_SB))
    host_sbs = [next(ref) for _ in range(DATA_WINDOWS + 1)]
    ref.close()

    # -- pipeline-fed, saved after window DATA_SAVE_AFTER --------------------
    m, sess, it, saver = data_bert_graph(stf, bert, cfg, files, True, dev)
    saved = {}

    def save(i):
        if i == DATA_SAVE_AFTER:
            saved["path"] = saver.save(sess, ckpt)
            saved["position"] = it.save_state()["position"]

    fed = data_windows(K, sess, m, lambda: next(it), DATA_WINDOWS, save)
    fed["bits"] = store_bits(sess)
    it.close()
    sess.close()
    del sess, m
    data_sync(dev)
    paths.append(("bert data pipeline-fed", DROPOUT_RATE, fed["counts"]))

    # -- numpy-fed, the same batches -----------------------------------------
    m, sess, _, _ = data_bert_graph(stf, bert, cfg, files, False, dev)
    sbs = iter(host_sbs)
    host = data_windows(K, sess, m, lambda: next(sbs), DATA_WINDOWS)
    host["bits"] = store_bits(sess)
    sess.close()
    del sess, m
    data_sync(dev)
    paths.append(("bert data numpy-fed", DROPOUT_RATE, host["counts"]))

    # -- pipeline-fed, every superbatch taken before the first window: no
    # pipeline thread runs during the windows ------------------------------
    m, sess, it, _ = data_bert_graph(stf, bert, cfg, files, True, dev)
    ahead = [next(it) for _ in range(DATA_WINDOWS)]
    pre = iter(ahead)
    drained = data_windows(K, sess, m, lambda: next(pre), DATA_WINDOWS)
    drained["bits"] = store_bits(sess)
    it.close()
    sess.close()
    del sess, m, ahead, pre
    data_sync(dev)
    paths.append(("bert data drained", DROPOUT_RATE, drained["counts"]))

    bad = []
    for tag, w in (("pipeline-fed", fed), ("numpy-fed", host),
                   ("drained", drained)):
        if w["counts"] != {**{k: 0 for k in w["counts"]}, **want}:
            bad.append(f"{tag} launches {w['counts']}, expected {want}")
        if w["fallbacks"] or w["fused"] != DATA_WINDOWS * DATA_SB:
            bad.append(f"{tag}: fused steps {w['fused']}, fallbacks "
                       f"{w['fallbacks']}")
        if w["captures"] != 1:
            bad.append(f"{tag}: {w['captures']} captures")
        if not all(math.isfinite(v) for v in w["losses"]):
            bad.append(f"{tag}: non-finite losses")
    differ = bits_differ(fed["bits"], host["bits"])
    if fed["losses"] != host["losses"] or differ:
        bad.append(f"pipeline-fed vs numpy-fed: losses {fed['losses']} vs "
                   f"{host['losses']}; {len(differ)} variables and slots "
                   f"differ ({differ[:5]})")
    if drained["losses"] != host["losses"] or bits_differ(drained["bits"],
                                                          host["bits"]):
        bad.append("the drained pipeline's run differs from the numpy-fed")
    half = len(fed["losses"]) // 2
    if not statistics.mean(fed["losses"][half:]) < statistics.mean(
            fed["losses"][:half]):
        bad.append(f"the loss does not fall: {fed['losses']}")
    print(f"data bert: {DATA_WINDOWS} windows of {DATA_SB} steps, "
          f"pipeline-fed vs numpy-fed: {len(fed['losses'])} losses equal "
          f"bit for bit: {fed['losses'] == host['losses']}, "
          f"{len(differ)} of {len(fed['bits'])} variables and Adam slots "
          f"differ; losses {[round(v, 5) for v in fed['losses']]}; "
          f"launches {fed['counts']}", flush=True)
    if bad:
        fail("data bert: " + "; ".join(bad))
    p_fed, _ = data_report("bert pipeline-fed", fed, card)
    p_host, _ = data_report("bert numpy-fed", host, card)
    p_drained, _ = data_report("bert pipeline-fed, drained ahead", drained,
                               card)
    print(f"{card}: data bert: p50 step pipeline-fed {p_fed * 1e3:.4f}, "
          f"numpy-fed {p_host * 1e3:.4f}, pipeline drained ahead "
          f"{p_drained * 1e3:.4f} ms ({p_fed / p_host:.4f}x and "
          f"{p_drained / p_host:.4f}x the numpy-fed)", flush=True)

    # -- resumed from the checkpoint in a new graph and session --------------
    def resumed(reset):
        m, sess, it, saver = data_bert_graph(stf, bert, cfg, files, True,
                                             dev)
        t0 = time.perf_counter()
        saver.restore(sess, saved["path"])
        restore_s = time.perf_counter() - t0
        pos = it.save_state()["position"]
        if reset:   # the planted fault: the stream from its start
            it.restore_state({"position": 0})
        n = 1 if reset else DATA_WINDOWS - DATA_SAVE_AFTER
        w = data_windows(K, sess, m, lambda: next(it), n, trace_last=False)
        w.update(bits=store_bits(sess), position=pos, restore_s=restore_s)
        it.close()
        sess.close()
        del sess, m
        data_sync(dev)
        return w

    res = resumed(False)
    paths.append(("bert data resumed", DROPOUT_RATE, res["counts"]))
    tail = fed["losses"][DATA_SAVE_AFTER * DATA_SB:]
    differ = bits_differ(res["bits"], fed["bits"])
    ok = (res["position"] == saved["position"] == DATA_SAVE_AFTER
          and res["losses"] == tail and not differ)
    print(f"data bert resumed: restored {saved['path']} in "
          f"{res['restore_s']:.4f} s at iterator position {res['position']}"
          f" (saved {saved['position']}); windows "
          f"{DATA_SAVE_AFTER + 1}-{DATA_WINDOWS} losses equal the "
          f"uninterrupted run's bit for bit: {res['losses'] == tail}; "
          f"{len(differ)} variables and slots differ at the end", flush=True)
    if not ok:
        fail(f"data bert resumed: position {res['position']}, losses "
             f"{res['losses']} vs {tail}, differ {differ[:5]}")
    zero = resumed(True)
    head = fed["losses"][DATA_SAVE_AFTER * DATA_SB:][:DATA_SB]
    print(f"data bert planted fault (the restored position reset to 0): "
          f"window {DATA_SAVE_AFTER + 1} losses {zero['losses']} vs "
          f"{head}: the check "
          f"{'fails, as it must' if zero['losses'] != head else 'PASSES'}",
          flush=True)
    if zero["losses"] == head:
        fail("data bert: a restore with its iterator reset to 0 passed the "
             "resume check")

    # -- the batches fed one step shifted ------------------------------------
    m, sess, _, _ = data_bert_graph(stf, bert, cfg, files, False, dev)
    rows = {k: np.concatenate([host_sbs[0][k][1:], host_sbs[1][k][:1]])
            for k in host_sbs[0]}
    shifted = data_windows(K, sess, m, lambda: rows, 1, trace_last=False)
    sess.close()
    del sess, m
    data_sync(dev)
    first = fed["losses"][:DATA_SB]
    print(f"data bert planted fault (the numpy batches one step shifted): "
          f"window 1 losses {shifted['losses']} vs {first}: the check "
          f"{'fails, as it must' if shifted['losses'] != first else 'PASSES'}",
          flush=True)
    if shifted["losses"] == first:
        fail("data bert: batches fed one step shifted passed the check")
    return paths


def data_mnist(K, stf, mnist, root, card, dev):
    """The port's ``examples/train_mnist_end_to_end.py`` steps 1-4 on the
    card (module docstring); returns its path."""
    os.makedirs(os.path.join(root, "mnist"))
    _, _, files = mnist.write_records(os.path.join(root, "mnist",
                                                   "train.tfrecord"))

    def monitored(directory, last_step):
        g = stf.Graph()
        with g.as_default():
            stf.set_random_seed(42)
            m = mnist.records_model(files, MNIST_DATA_B, device=dev)
            losses = []
            with stf.train.MonitoredTrainingSession(
                    checkpoint_dir=directory, save_checkpoint_steps=20,
                    save_summaries_steps=10, config=None
                    if dev.type == "cuda" else stf.ConfigProto(
                        device_count={"GPU": 0}),
                    hooks=[stf.train.StopAtStepHook(last_step=last_step)]) \
                    as ms:
                raw = ms.raw_session
                start = int(raw.variable_value(m["global_step"]).item())
                pos = m["iterator"].save_state()["position"]
                while not ms.should_stop():
                    losses.append(float(ms.run([m["train_op"],
                                                m["loss"]])[1]))
                captures = raw.captures
        m["iterator"].close()
        return dict(start=start, position=pos, losses=losses,
                    captures=captures)

    # cuDNN's deterministic convolutions: the resumed run is held to the
    # uninterrupted one bit for bit
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        full = monitored(os.path.join(root, "mnist", "full"),
                         MNIST_DATA_STEPS)
        full_s = time.perf_counter() - t0
        counts = K.launch_counts()
        split = os.path.join(root, "mnist", "split")
        first = monitored(split, MNIST_DATA_SPLIT)
        res = monitored(split, MNIST_DATA_STEPS)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    n = len(first["losses"])
    print(f"{card}: data mnist journey: {len(full['losses'])} monitored "
          f"steps (get_next in the graph, batch {MNIST_DATA_B}) in "
          f"{full_s:.4f} s with its checkpoints and summaries, captures "
          f"{full['captures']}, losses {full['losses'][0]:.5f} -> "
          f"{full['losses'][-1]:.5f}; resumed at global step "
          f"{res['start']} and position {res['position']} after {n} steps, "
          f"its {len(res['losses'])} losses equal the uninterrupted run's: "
          f"{first['losses'] + res['losses'] == full['losses']}; launches "
          f"{counts}", flush=True)
    bad = []
    if not statistics.mean(full["losses"][-5:]) < statistics.mean(
            full["losses"][:5]):
        bad.append(f"the loss does not fall: {full['losses']}")
    if (res["start"], res["position"]) != (n, n):
        bad.append(f"resumed at step {res['start']}, position "
                   f"{res['position']}, after {n} steps")
    if first["losses"] + res["losses"] != full["losses"]:
        bad.append("the resumed losses differ from the uninterrupted run's")
    # the example's graph has no Dropout: a step's xent forward and
    # backward and one Adam launch (f32, one flat group), replayed or not
    steps = len(full["losses"])
    want = {k: 0 for k in counts}
    want.update(softmax_xent_fwd=steps, softmax_xent_bwd=steps,
                adam_update=steps)
    if full["captures"] < 1 or counts != want:
        bad.append(f"captures {full['captures']}, launches {counts}, "
                   f"expected {want}")
    if bad:
        fail("data mnist journey: " + "; ".join(bad))
    return ("mnist data journey", 0.0, counts)


def data_phase(K, dev):
    """The input pipeline (module docstring, phase 13). Returns
    ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.models import bert, mnist
    from simple_tensorflow_tpu_torch.runtime import native

    t0 = time.perf_counter()
    card = card_line()
    if not native.available():
        fail("data: the native runtime (runtime_cc/libstf_runtime.so) did "
             "not build or load")
    cfg = bert.BertConfig.base()
    root = tempfile.mkdtemp(prefix="stf_data_phase_")
    try:
        t1 = time.perf_counter()
        files, batches = bert.write_pretrain_records(
            os.path.join(root, "bert"), DATA_BATCHES, BERT_B, BERT_S, BERT_P,
            cfg.vocab_size, shards=DATA_SHARDS)
        size = sum(os.path.getsize(f) for f in files)
        print(f"data: {DATA_BATCHES * BERT_B} BERT pretraining Examples "
              f"(synthetic_pretrain_batch({BERT_B}, {BERT_S}, {BERT_P}, "
              f"input_mask=True), seeds 0-{DATA_BATCHES - 1}) in "
              f"{DATA_SHARDS} TFRecord shards, {size} bytes, written in "
              f"{time.perf_counter() - t1:.2f} s; native runtime "
              f"{native.version()}", flush=True)
        before = data_parse_counts()
        bad = data_stream_check(stf, bert, files, batches, "stream", dev)
        parsed = tuple(a - b for a, b in zip(data_parse_counts(), before))
        print(f"data stream: parse_example batches by path: native "
              f"{parsed[0]}, python {parsed[1]}", flush=True)
        if bad or parsed[0] <= 0 or parsed[1] != 0:
            fail(f"data stream: {bad} superbatches differ; parse paths "
                 f"{parsed}")
        slow = data_stream_check(stf, bert, files, batches,
                                 "stream, copies delayed", dev, delay=True)
        fault = data_stream_check(stf, bert, files, batches,
                                  "planted fault: a slot reused without "
                                  "waiting for its copy", dev, wait=False,
                                  delay=True)
        if dev.type == "cuda" and (slow or not fault):
            fail(f"data stream: delayed copies {slow} bad superbatches (0 "
                 f"expected), slots reused without a wait {fault} (some "
                 "expected)")
        rates = data_rates(stf, bert, files)
        print(f"{card}: data: the pipeline alone over {DATA_BATCHES * BERT_B}"
              f" records: sequential chain {rates['sequential']:.2f} "
              f"records/s, parallel chain {rates['parallel']:.2f} records/s "
              f"({rates['parallel'] / rates['sequential']:.2f}x; medians of "
              f"{DATA_RATE_ROUNDS} interleaved rounds, {os.cpu_count()} host "
              f"cores)", flush=True)
        paths = data_bert(K, stf, bert, cfg, files, root, card, dev)
        paths.append(data_mnist(K, stf, mnist, root, card, dev))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"data phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# -- phase 14: async checkpoints, the numerics plane, meta graphs -------------

CK_N = 4                   # run_steps windows of 4 (phase 7b's)
CK_STEPS = 24              # the monitored runs' last step (the loop ends at 25)
CK_SAVE_STEPS = 32         # past CK_STEPS: async checkpoints at 0 and at 25
CK_KEEP = 2
CK_SIGTERM_AT = 12         # run B: SIGTERM after the run that ends at step 12
CK_TIMED = 6               # windows a numerics mode, timed, alternating
# GPU sleep before the planted-fault save (~3 s: longer than the writer
# takes to reach its first copy to the host)
CK_FAULT_CYCLES = 6_000_000_000
CK_L2_RTOL = 1e-6          # l2_norm and zero_fraction: sums in other orders
CK_POISON = (np.array([1.0, 2.0, 0.5, 3.0], np.float32),
             np.array([1.0, 2.0, -1.0, 3.0], np.float32))


def sha256_of(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def summary_check(out, ref):
    """The numeric_summary tolerances: counts and max_abs exact, l2_norm
    and zero_fraction within CK_L2_RTOL, every value finite. Returns
    ``(passes, max abs error, largest relative error of the sums)``."""
    out, ref = out.double().cpu(), ref.double().cpu()
    exact = torch.equal(out[:, :2], ref[:, :2])
    rel = ((out[:, 2:] - ref[:, 2:]).abs()
           / ref[:, 2:].abs().clamp_min(1e-300)).max().item()
    ok = exact and rel <= CK_L2_RTOL and bool(torch.isfinite(out).all())
    return ok, (out - ref).abs().max().item(), rel


def ck_kernel_row(K, taps, kernel_rows):
    """``numeric_summary`` on the tapped tensors of one transformer step
    (their dtypes and shapes as the step made them) and on a copy of one
    with NaN, +-Inf and zeros planted: kernel against plain version; the
    unmasked max_abs (a planted fault) must fail the check; times."""
    kns = importlib.import_module(KMOD + "numeric_summary")
    planted = taps[0].clone().reshape(-1)
    idx = torch.randperm(planted.numel(), device=planted.device,
                         generator=torch.Generator(planted.device).manual_seed(
                             5))
    planted[idx[:7]] = float("nan")
    planted[idx[7:9]] = float("inf")
    planted[idx[9:11]] = -float("inf")
    planted[idx[11:1000]] = 0
    tensors = list(taps) + [planted.reshape(taps[0].shape)]
    out = kns.numeric_summary(tensors)
    again = kns.numeric_summary(tensors)
    ref = kns.numeric_summary_plain(tensors)
    ok, err, rel = summary_check(out, ref)
    if not ok or not torch.equal(out, again):
        fail(f"numeric_summary: kernel vs plain version: counts and max_abs "
             f"exact {torch.equal(out[:, :2].cpu(), ref[:, :2].cpu())}, "
             f"l2/zero-fraction rel {rel:.3e} (limit {CK_L2_RTOL}), "
             f"repeatable {torch.equal(out, again)}")
    if out[-1, 0].item() != 11 or not math.isfinite(out[-1, 1].item()):
        fail(f"numeric_summary: the planted tensor reads {out[-1].tolist()}")

    def unmasked(ts):
        rows = kns.numeric_summary_plain(ts)
        rows[:, 1] = torch.stack([t.float().abs().max() for t in ts])
        return rows

    if summary_check(out, unmasked(tensors))[0]:
        fail("numeric_summary: a max_abs over nonfinite values (planted "
             "fault) passes the check")
    nbytes = sum(t.numel() * t.element_size() for t in taps)
    ms = device_ms([lambda: kns.numeric_summary(taps)])
    plain = device_ms([lambda: kns.numeric_summary_plain(taps)])

    def library():
        for t in taps:
            torch.linalg.vector_norm(t.float())
            t.abs().amax()
            torch.isfinite(t).sum()

    lib = device_ms([library])
    bnd = bound_ms(nbytes + 16 * len(taps), 0, torch.float32)
    dts = sorted({str(t.dtype).replace("torch.", "") for t in taps})
    shape = (f"{len(taps)} taps of one transformer step, {nbytes} bytes "
             f"({'/'.join(dts)})")
    report("numeric_summary", err, ms, plain, bnd, lib)
    print(f"  numeric_summary: the planted tensor {out[-1].tolist()}; the "
          "unmasked max_abs (planted fault) fails the check", flush=True)
    kernel_rows["numeric_summary"] = kernel_row(err, ms, plain, bnd, lib,
                                                shape)


def ck_spy_taps(stf):
    """A context manager recording the inputs of ``NumericSummaries``
    launches (the tapped tensors) while it is open."""
    from simple_tensorflow_tpu_torch.framework import op_registry

    od = op_registry.get("NumericSummaries")
    seen = []

    @contextlib.contextmanager
    def spy():
        orig = od.lower

        def lower(ctx, op, inputs):
            seen.append([x.detach().clone() for x in inputs])
            return orig(ctx, op, inputs)

        od.lower = lower
        try:
            yield seen
        finally:
            od.lower = orig

    return spy()


def ck_overhead(K, stf, tr, cfg, feeds_of, num, kernel_rows, tag, card):
    """Windows of CK_N with the plane off and in ``metrics`` (the process
    default, so one Session holds both plans), alternating; the tapped
    tensors of the first metrics step feed the kernel row. Returns
    ``(session pieces, launches of the metrics windows, p50s, taps)``."""
    g, m, _, init, sv = loop_build(stf, tr, cfg, saver=True)
    sess = stf.Session(graph=g)
    sess.run(init)
    fetch = [m["train_op"], m["loss"]]
    times = {"off": [], "metrics": []}
    counts = {}
    for i in range(CK_TIMED + 1):
        for mode in (("off", "metrics") if i % 2 == 0 else
                     ("metrics", "off")):
            num.set_numerics_mode(mode)
            if i == 0 and mode == "metrics":
                with ck_spy_taps(stf) as seen:
                    sess.run(fetch, feeds_of(m))   # the eager warm-up
                taps = seen[0]
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run_steps(fetch, CK_N, feed_dict=feeds_of(m))
            dt = (time.perf_counter() - t0) / CK_N
            if i > 0:       # the first window of a mode compiles it
                times[mode].append(dt)
                if mode == "metrics":
                    for k, v in K.launch_counts().items():
                        counts[k] = counts.get(k, 0) + v
    num.set_numerics_mode(None)
    table = num.get_plane().info()["taps"]
    if counts.get("numeric_summary") != CK_TIMED * CK_N or \
            len(taps) != len(table):
        fail(f"{tag}: numeric_summary launches {counts.get('numeric_summary')}"
             f" over {CK_TIMED * CK_N} metrics steps; {len(taps)} tapped "
             f"tensors for {len(table)} taps")
    ck_kernel_row(K, taps, kernel_rows)
    p50 = {k: statistics.median(v) for k, v in times.items()}
    print(f"{card}: {tag} p50 ms a step, windows of {CK_N} (host clock, "
          f"synced): numerics off {p50['off'] * 1e3:.4f}, metrics "
          f"{p50['metrics'] * 1e3:.4f} ({100 * (p50['metrics'] / p50['off'] - 1):+.3f}%); "
          f"{len(table)} taps a step ({sorted({t['kind'] for t in table})}),"
          f" {counts['numeric_summary']} numeric_summary launches over "
          f"{CK_TIMED * CK_N} steps", flush=True)
    return (g, m, sess, sv), counts, p50, table


def ck_saves(stf, snapshot, pckpt, g, m, sess, feeds_of, root, tag, card):
    """A blocking save, a planted-fault async save (the writer's copy to
    the host not waiting for the snapshot's event, the snapshot's copies
    held back behind a GPU sleep) and an async save, all of one step: the
    good async data file equals the blocking one (sha256), the faulty one
    must not; the blocking stall against the async save's step-loop cost,
    the writer's seconds, the device memory during the write, and the p50
    step of windows while the writer works against windows before it."""
    with g.as_default():
        blocking = stf.train.Saver(max_to_keep=1)
        asyn = stf.train.Saver(backend="async", max_to_keep=1)
    fetch = [m["train_op"], m["loss"]]
    writer = pckpt.get_writer()
    shas = {}
    t0 = time.perf_counter()
    p = blocking.save(sess, os.path.join(root, "blocking", "m"),
                      global_step=0, write_meta_graph=False)
    stall_blk = time.perf_counter() - t0
    blk = dict(blocking.last_save_stats)
    shas["blocking"] = sha256_of(p + ".stfz")
    snapshot._wait_for_snapshot = False
    try:
        torch.cuda._sleep(CK_FAULT_CYCLES)
        p = asyn.save(sess, os.path.join(root, "fault", "m"), global_step=0,
                      write_meta_graph=False)
        asyn.wait_until_finished()
    finally:
        snapshot._wait_for_snapshot = True
    shas["fault"] = sha256_of(p + ".stfz")
    shutil.rmtree(os.path.join(root, "fault"), ignore_errors=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda._sleep(CK_FAULT_CYCLES // 30)   # copies held back ~0.1 s
    t0 = time.perf_counter()
    p = asyn.save(sess, os.path.join(root, "async", "m"), global_step=0,
                  write_meta_graph=False)
    stall_async = time.perf_counter() - t0
    over = []
    while not writer._idle.is_set() and len(over) < 4 * CK_TIMED:
        t0 = time.perf_counter()
        sess.run_steps(fetch, CK_N, feed_dict=feeds_of(m))
        if not writer._idle.is_set():
            over.append((time.perf_counter() - t0) / CK_N)
    asyn.wait_until_finished()
    peak = torch.cuda.max_memory_allocated() - base
    st = dict(asyn.last_save_stats)
    shas["async"] = sha256_of(p + ".stfz")
    free = []
    for _ in range(CK_TIMED):
        t0 = time.perf_counter()
        sess.run_steps(fetch, CK_N, feed_dict=feeds_of(m))
        free.append((time.perf_counter() - t0) / CK_N)
    for d in ("blocking", "async"):
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    print(f"{tag}: data file sha256: blocking {shas['blocking'][:16]}, async "
          f"{shas['async'][:16]} (copies held behind a GPU sleep), planted "
          f"fault (no wait on the snapshot's event) {shas['fault'][:16]}",
          flush=True)
    if shas["async"] != shas["blocking"]:
        fail(f"{tag}: the async checkpoint's data file differs from the "
             "blocking save's")
    if shas["fault"] == shas["blocking"]:
        fail(f"{tag}: an async save whose host copy does not wait for the "
             "snapshot (planted fault) wrote the right bytes")
    if not over:
        fail(f"{tag}: no window ran while the writer worked")
    p50_over, p50_free = statistics.median(over), statistics.median(free)
    print(f"{card}: {tag} checkpoint of {blk['bytes']} bytes: blocking save "
          f"stalls the step loop {stall_blk * 1e3:.2f} ms (D2H {blk['d2h']:.4f}"
          f" s, npz and sha256 {blk['serialize']:.4f} s, commit "
          f"{blk['commit']:.4f} s); async save's step-loop cost "
          f"{stall_async * 1e3:.4f} ms (snapshot {st['snapshot'] * 1e3:.4f} "
          f"ms, put {st['put'] * 1e3:.4f} ms); the writer thread "
          f"{st['write']:.4f} s to commit (D2H {st['d2h']:.4f} s, npz and "
          f"sha256 {st['serialize']:.4f} s, commit {st['commit']:.4f} s); "
          f"device memory during the write +{peak / GIB:.3f} GiB over "
          f"{base / GIB:.3f} GiB (the snapshot: {st['snapshot_bytes'] / GIB:.3f}"
          f" GiB)", flush=True)
    print(f"{card}: {tag} p50 ms a step, windows of {CK_N}: while the writer "
          f"works {p50_over * 1e3:.4f} ({len(over)} windows, the slowest "
          f"{max(over) * 1e3:.4f}), after it {p50_free * 1e3:.4f} "
          f"({len(free)} windows, the slowest {max(free) * 1e3:.4f}), "
          f"{p50_over / p50_free:.4f}x", flush=True)
    return dict(stall_blocking_ms=stall_blk * 1e3,
                stall_async_ms=stall_async * 1e3, write_s=st["write"],
                peak_gib=peak / GIB, p50_over_ms=p50_over * 1e3,
                p50_free_ms=p50_free * 1e3)


def ck_sigterm_hook(stf, step):
    """A hook that sends this process SIGTERM after the run that ends at
    ``step`` (the global step fetched beside train_op, plus one), its
    windows split there."""

    class SigtermAt(stf.train.SessionRunHook):
        def begin(self):
            self._gs = stf.train.get_global_step()

        def before_run(self, run_context):
            return stf.train.SessionRunArgs(self._gs._ref)

        def after_run(self, run_context, run_values):
            if int(run_values.results) + 1 == step:
                os.kill(os.getpid(), signal.SIGTERM)

        def until_next_trigger(self, global_step):
            return max(1, step - 1 - int(global_step))

    return SigtermAt()


def ck_monitored(stf, pckpt, tr, cfg, feeds_of, directory, preempt):
    """``MonitoredTrainingSession`` (``loop_fusion_steps=CK_N``,
    ``numerics="metrics"``, async ``CheckpointSaverHook`` every
    CK_SAVE_STEPS, ``Saver(max_to_keep=CK_KEEP)``, ``StopAtStepHook(
    last_step=CK_STEPS)``) driven by ``run_steps(.., CK_N)``; with
    ``preempt``, a ``PreemptionHandler(manager=)`` (a
    ``CheckpointManager`` that writes the meta graph) and a SIGTERM after
    step CK_SIGTERM_AT. Returns the window sizes, the saves' statistics,
    the final state and global step, and the handler."""
    g, m, _, _, sv = loop_build(stf, tr, cfg, saver=True)
    stats = []

    class Stats(stf.train.CheckpointSaverListener):
        def after_save(self, session, step):
            stats.append(sv.last_save_stats)

    with g.as_default():
        hooks = [stf.train.StopAtStepHook(last_step=CK_STEPS),
                 stf.train.CheckpointSaverHook(
                     directory, save_steps=CK_SAVE_STEPS, saver=sv,
                     listeners=[Stats()])]
        handler = None
        if preempt:
            mgr = pckpt.CheckpointManager(directory, saver=sv,
                                          write_meta_graph=True)
            handler = pckpt.PreemptionHandler(manager=mgr)
            hooks += [handler, ck_sigterm_hook(stf, CK_SIGTERM_AT)]
        ms = stf.train.MonitoredTrainingSession(
            scaffold=stf.train.Scaffold(saver=sv), hooks=hooks,
            save_summaries_steps=None, log_step_count_steps=None,
            config=stf.ConfigProto(loop_fusion_steps=CK_N,
                                   numerics="metrics"))
        sizes, orig = [], ms._run_once

        def run_once(*a, window=1, **k):
            sizes.append(window)
            return orig(*a, window=window, **k)

        ms._run_once = run_once
        with ms:
            while not ms.should_stop():
                ms.run_steps([m["train_op"], m["loss"]], CK_N,
                             feed_dict=feeds_of(m))
            final = store_bits(ms.raw_session)
            step = int(ms.raw_session.variable_value(m["global_step"]).item())
    return dict(sizes=sizes, stats=stats, final=final, step=step,
                handler=handler)


def ck_resume(stf, pckpt, tr, cfg, batch, directory, until, names=None):
    """A new graph and Session on ``directory``: ``restore_or_initialize``,
    then windows of CK_N up to global step ``until``. Returns ``(restored
    prefix, (losses, state) after the first window, final state, the
    graph's tensor names)``. With ``names`` (those of a built graph), the
    graph is the restored checkpoint's ``.meta`` imported into a fresh
    graph instead, and it runs the first window only."""
    if names is None:
        g, m, _, init, sv = loop_build(stf, tr, cfg, saver=True)
        names = {k: m[k].name for k in ("train_op", "loss", "global_step",
                                        "src_ids", "tgt_in", "tgt_out")}
        meta = False
    else:
        g = stf.Graph()
        with g.as_default():
            stf.set_random_seed(1)
            sv = stf.train.import_meta_graph(
                stf.train.latest_checkpoint(directory) + ".meta")
            init = stf.global_variables_initializer()
        meta = True
    with g.as_default():
        mgr = pckpt.CheckpointManager(directory, saver=sv)
        sess = stf.Session(graph=g,
                           config=stf.ConfigProto(numerics="metrics"))
        restored = mgr.restore_or_initialize(sess, init_op=init)
        fetch = [g.as_graph_element(names["train_op"]),
                 g.as_graph_element(names["loss"])]
        feeds = {g.as_graph_element(names[k]): batch[k]
                 for k in ("src_ids", "tgt_in", "tgt_out")}
        step = int(sess.variable_value(names["global_step"]).item())
        out = sess.run_steps(fetch, CK_N, feed_dict=feeds,
                             output_mode="stacked")
        first = ([float(x) for x in out[1]], store_bits(sess))
        step += CK_N
        final = None
        if not meta:
            while step < until:
                n = min(CK_N, until - step)
                sess.run_steps(fetch, n, feed_dict=feeds)
                step += n
            final = store_bits(sess)
        sess.close()
    return restored, first, final, names


def ckpt_numerics_phase(K, dev, kernel_rows):
    """Async checkpoints, the numerics plane and meta graphs on the
    headline model (module docstring, phase 14). Returns ``[(path,
    dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch import checkpoint as pckpt
    from simple_tensorflow_tpu_torch.checkpoint import snapshot
    from simple_tensorflow_tpu_torch.debug import numerics as num
    from simple_tensorflow_tpu_torch.models import transformer as tr

    t_phase = time.perf_counter()
    card = card_line()
    cfg = tr.TransformerConfig.big()
    batch = tf_batch(TF_B, TF_SRC, TF_TGT, cfg.vocab_size, pads=False)

    def feeds_of(m):
        return tf_feeds(m, batch)

    tag = f"ckpt[bf16 {TF_B}x{TF_SRC}/{TF_TGT}]"
    print(f"{tag}: transformer_train_model(TransformerConfig.big()) as in "
          f"phase 7b (graph seed 1, dropout 0.1, windows of {CK_N}), under "
          "torch.use_deterministic_algorithms(True, warn_only=True)",
          flush=True)
    root = tempfile.mkdtemp(prefix="stf_ckpt_phase_")
    prev_fill = torch.utils.deterministic.fill_uninitialized_memory
    writer = pckpt.get_writer()
    paths = []

    def lap(what):  # where the phase's time goes
        print(f"{tag}: {what} done at {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (g, m, sess, _), counts, p50, table = ck_overhead(
                K, stf, tr, cfg, feeds_of, num, kernel_rows, tag, card)
            paths.append(("ckpt numerics metrics windows", DROPOUT_RATE,
                          counts))
            lap("the numerics windows")
            ck_saves(stf, snapshot, pckpt, g, m, sess, feeds_of, root, tag,
                     card)
            lap("the three saves")
            sess.close()
            del g, m, sess
            gc.collect()
            torch.cuda.empty_cache()
            # run A: uninterrupted
            K.reset_launch_counts()
            a = ck_monitored(stf, pckpt, tr, cfg, feeds_of,
                             os.path.join(root, "A"), False)
            paths.append(("ckpt monitored A", DROPOUT_RATE,
                          K.launch_counts()))
            torch.cuda.empty_cache()
            lap("run A")
            kept = sorted(f for f in os.listdir(os.path.join(root, "A"))
                          if f.endswith(".stfz"))
            print(f"{tag} A: windows {a['sizes']}, ended at global step "
                  f"{a['step']}, checkpoints kept {kept}", flush=True)
            for i, st in enumerate(a["stats"]):
                print(f"{card}: {tag} A async save {i}: step-loop cost "
                      f"{st['stall'] * 1e3:.4f} ms (snapshot "
                      f"{st['snapshot'] * 1e3:.4f} ms, put "
                      f"{st['put'] * 1e3:.4f} ms), writer {st['write']:.4f} s"
                      f" (D2H {st['d2h']:.4f}, npz and sha256 "
                      f"{st['serialize']:.4f}, commit {st['commit']:.4f})",
                      flush=True)
            # run B: preempted by SIGTERM, drained and saved through the
            # manager; C: resumed by restore_or_initialize; D: the meta graph
            outer = signal.signal(signal.SIGTERM, signal.SIG_DFL)
            try:
                b = ck_monitored(stf, pckpt, tr, cfg, feeds_of,
                                 os.path.join(root, "B"), True)
                if not pckpt.preemption_requested():
                    fail(f"{tag} B: the SIGTERM was not seen")
            finally:
                pckpt.reset_preemption_state()
                signal.signal(signal.SIGTERM, outer)
            torch.cuda.empty_cache()
            lap("run B")
            pre = b["handler"].last_saved_prefix
            if pre is None or b["step"] >= CK_STEPS or \
                    stf.train.latest_checkpoint(os.path.join(root, "B")) \
                    != pre or writer._q.unfinished_tasks:
                fail(f"{tag} B: the preempted run did not drain and save "
                     f"(saved {pre}, stopped at {b['step']})")
            print(f"{tag} B: SIGTERM after step {CK_SIGTERM_AT}: drained, "
                  f"saved {os.path.basename(pre)} through the "
                  f"CheckpointManager, stopped at global step {b['step']} "
                  f"(windows {b['sizes']})", flush=True)
            restored, c_first, c_final, names = ck_resume(
                stf, pckpt, tr, cfg, batch, os.path.join(root, "B"),
                a["step"])
            torch.cuda.empty_cache()
            lap("run C")
            off = bits_differ(c_final, a["final"])
            print(f"{tag} C: restore_or_initialize -> "
                  f"{os.path.basename(restored or 'None')}; at global step "
                  f"{a['step']} {len(off)} of {len(c_final)} variables and "
                  "slots differ from run A", flush=True)
            if restored != pre or off:
                fail(f"{tag} C: the resumed run is off the uninterrupted one "
                     f"({off[:5]})")
            _, d_first, _, _ = ck_resume(stf, pckpt, tr, cfg, batch,
                                         os.path.join(root, "B"), None,
                                         names)
            torch.cuda.empty_cache()
            lap("run D")
            off = bits_differ(d_first[1], c_first[1])
            print(f"{tag} D: {os.path.basename(pre)}.meta imported into a "
                  f"fresh graph and restored: window losses {d_first[0]} "
                  f"vs the built graph's {c_first[0]}; {len(off)} variables "
                  "and slots differ after the window", flush=True)
            if d_first[0] != c_first[0] or off:
                fail(f"{tag} D: the re-imported meta graph trains off the "
                     "built graph")
            ck_poison(stf, num, tag)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = prev_fill
        num.set_numerics_mode(None)
        pckpt.wait_until_finished(timeout=120.0)
        pckpt.shutdown_writer(timeout=30.0)
        shutil.rmtree(root, ignore_errors=True)
    print(f"{tag}: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


def ck_poison(stf, num, tag):
    """A step whose loss goes through ``Log``, fed a negative value: in
    ``raise`` the error names the tap and its op (``loss``); in ``dump`` the
    bisector names ``poison_log``, in a captured run and in a window (its
    index 2)."""
    clean, poison = CK_POISON
    found = {}
    for mode in ("raise", "dump"):
        for fused in (False, True):
            g = stf.Graph()
            with g.as_default():
                x = stf.placeholder(stf.float32, [4], name="x")
                w = stf.Variable(np.ones(4, np.float32), name="w")
                loss = stf.reduce_sum(stf.log(x, name="poison_log") * w,
                                      name="loss")
                train = stf.train.AdamOptimizer(0.1).minimize(loss)
                init = stf.global_variables_initializer()
            with g.as_default(), stf.Session(
                    graph=g, config=stf.ConfigProto(numerics=mode)) as sess:
                sess.run(init)
                try:
                    if fused:
                        sess.run_steps([loss, train], 4, stacked_feeds={
                            x: np.stack([clean, clean, poison, clean])})
                    else:
                        for f in (clean, clean, clean, poison):
                            sess.run([loss, train], {x: f})
                except stf.errors.InvalidArgumentError as e:
                    msg = str(e)
                else:
                    fail(f"{tag}: a planted NaN ({mode}, "
                         f"{'window' if fused else 'run'}) did not raise")
                captured = sess.captures
            first = re.search(r"first bad op: (\S+)", msg)
            found[(mode, fused)] = (
                "from op loss (Sum)" in msg,
                "fused window index 2" in msg if fused else True,
                first.group(1) if first else None, captured)
    print(f"{tag}: a planted Log of -1: (tap named, window index, first bad "
          f"op, captures) {found}", flush=True)
    if not all(v[0] and v[1] for v in found.values()) or \
            found[("dump", False)][2] != "poison_log" or \
            found[("dump", True)][2] != "poison_log":
        fail(f"{tag}: the planted NaN was not named: {found}")


# -- phase 15: the cost model and the single-card graphs ---------------------

LC_S = 32768                 # LongContextConfig().max_len, batch 1: the cell
LC_CUT_S, LC_CUT_LAYERS = 2048, 2   # kernels vs plain: the plain attention's
                             # (BH, S, S) f32 scores take 34 GB a layer at
                             # 32768, so that check runs at a cut length
LC_CHECK_STEPS = 2           # f32 and bf16 runs, kernels vs plain_versions()
LC_RAGGED_S = 4000 - 40      # the wgmma kernels' ragged check: no multiple
                             # of their 128-row tiles or 64-query sub-tiles
# kernels vs plain at the cut length: (losses rtol, gradients and, at f32,
# variables and slots by relative norm). bf16 holds its gradients to the
# bf16 kernel rows' 2e-2; its parameters are not held: Adam turns bf16
# roundoff in near-zero gradients into whole +-lr steps (an H100 80GB HBM3
# at 700 W read 1.101e-1 on a LayerNorm beta after 2 steps, f32 3.4e-5)
LC_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 2e-2)}
SC_GRAPH_STEPS = 3           # a warm-up, a capture, one replay
SC_WINDOW_N = 4              # run_steps windows of 4
SC_WINDOWS = 3               # timed windows, after one that warms up
SC_HOOK_STEPS = 8            # the monitored run of the StepCounterHook
DLRM_B = 32                  # dlrm_model's defaults
W2V_B = 128                  # skipgram_model's defaults
SC_TOL = 1e-6                # DLRM: the fused lookup vs a plain gather
BF16_PEAK = 989e12           # H100 SXM dense bf16 (data sheet, utils/perf)
# the flash kernels' FLOP a live (query, key) pair, times D: the forward's
# two products, dK/dV's four, dQ's three
FLASH_FLOP_PER_PAIR = {"fwd": 4, "dkdv": 8, "dq": 6}


def lc_per_step(cfg, groups):
    """Launches a long-context training step: the flash forward, dK/dV and
    dQ a layer (rate 0: the launch-argument entries), two LayerNorms a
    layer and the final one, forward and backward, the xent forward and
    backward, one Adam launch a flat group."""
    n = cfg.num_layers
    return {"flash_attention_fwd": n, "flash_attention_dkdv": n,
            "flash_attention_dq": n, "layer_norm": 2 * n + 1,
            "layer_norm_bwd": 2 * n + 1, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1, "adam_update": groups}


def lc_build(lc, cfg, s, dtype, recompute=False):
    return lambda: lc.lm_train_model(1, s, cfg, compute_dtype=dtype,
                                     recompute=recompute)


def lc_feeds(lc, cfg, m, s):
    ids, tgt = lc.synthetic_lm_batch(1, s, cfg.vocab_size, seed=0)
    return {m["input_ids"]: ids, m["targets"]: tgt}


def lc_groups(stf, lc, cfg, dtype):
    """The flat Adam groups of ``lm_train_model`` at ``dtype``: element
    counts by parameter dtype (the Dense variables take the activations'
    dtype; the embedding and the LayerNorms stay f32)."""
    by = {}
    for v in seeded_graph_vars(stf, lc_build(lc, cfg, 8, dtype)):
        by[v.dtype.base_dtype.name] = by.get(v.dtype.base_dtype.name, 0) \
            + int(np.prod(v.shape.as_list()))
    return by


# Planted faults in the wgmma pipelines at D = 128: copies of their sources
# with one walk cut short in the producer and the consumers alike (so no
# barrier waits forever), each with a C entry appended and its namespace
# renamed, built beside the kernels into a library of their own. The last
# one moves only the last 64 queries' share of each key's dK and dV: off by
# 1.2e-2 at S = 32768, under the limit scaled by max |ref|, so it shows
# that the limit a 128-key block holds the keys whose gradients are small.
# The dQ mutants drop the two key tiles of the diagonal (both consumers'
# last) or shift the walk one tile up (key tile 0 never added).
# (what, source, text, mutated text, occurrences)
SM90_MUTANTS = (
    ("forward without its diagonal key tile", "flash_fwd_sm90.cu",
     "n_kt = min(n_kt, qi + 1);", "n_kt = min(n_kt, qi + 1) - (qi > 0);", 1),
    ("dK/dV without its diagonal query sub-tile", "flash_dkdv_sm90.cu",
     "const int qs0 = kCausal ? k0 / kBM : 0;",
     "const int qs0 = kCausal ? k0 / kBM + 1 : 0;", 1),
    ("dK/dV without its last query sub-tile", "flash_dkdv_sm90.cu",
     "const int n_sub = cdiv(q_len, kBM) - qs0;",
     "const int n_sub = cdiv(q_len, kBM) - qs0 - 1;", 1),
    ("dQ without its diagonal key tiles", "flash_dq_sm90.cu",
     "if (kCausal) n_kt = min(n_kt, cdiv(q0 + kBM, kBN));",
     "if (kCausal) n_kt = min(n_kt, cdiv(q0 + kBM, kBN) - 2 * (qi > 0));",
     1),
    ("dQ without its first key tile", "flash_dq_sm90.cu",
     "const int k0 = i * kBN;", "const int k0 = (i + 1) * kBN;", 2))
# the C entry of mutant i: causal, rate 0, no bias; the forward writes o and
# lse to out0 and out1, dK/dV dk and dv, dQ dq to out0
SM90_ENTRY = r"""
extern "C" int stf_mutant_%(i)d(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* out0, void* out1, int bh,
    int s, float scale, void* stream) {
  return %(call)s;
}
"""
SM90_CALLS = {
    "flash_fwd_sm90.cu":
        "stf::flash_fwd_sm90(q, k, v, nullptr, out0, "
        "static_cast<float*>(out1), bh, s, s, 1, scale, 1, 0, 0u, nullptr, "
        "0u, 1.0f, static_cast<cudaStream_t>(stream))",
    "flash_dkdv_sm90.cu":
        "stf::flash_dkdv_sm90(q, k, v, dout, static_cast<const float*>(lse), "
        "static_cast<const float*>(delta), nullptr, out0, out1, bh, s, s, 1, "
        "scale, 1, 0, 0u, nullptr, 0u, 1.0f, "
        "static_cast<cudaStream_t>(stream))",
    "flash_dq_sm90.cu":
        "stf::flash_dq_sm90(q, k, v, dout, static_cast<const float*>(lse), "
        "static_cast<const float*>(delta), nullptr, out0, bh, s, s, 1, "
        "scale, 1, 0, 0u, nullptr, 0u, 1.0f, "
        "static_cast<cudaStream_t>(stream))"}


# The planted faults of the f32 flash kernels, built as the wgmma ones are:
# the forward's (flash_fwd_f32.cu), checked at the encoder prefill's shape
# (phase 16): the block's last 4-query sub-tile never stored, and the bias
# dropped; the backward's (flash_bwd_f32.cu), checked in the kernel phase
# (phase_flash_f32_bwd): dK/dV without its last query tile, and dQ without
# the bias. (what, source, text, mutated text, occurrences)
F32_MUTANTS = (
    ("forward without its last query sub-tile", "flash_fwd_f32.cu",
     "    if (qg >= q_len) continue;",
     "    if (qg >= q_len || ty == BQ / TM - 1) continue;", 1),
    ("forward without its bias", "flash_fwd_f32.cu",
     "if (bb != nullptr && kg < kv_len) x += bb[kg];",
     "if (false && bb != nullptr && kg < kv_len) x += bb[kg];", 1),
    ("dK/dV without its last query tile", "flash_bwd_f32.cu",
     "int t0 = 0, n_t = cdiv(n_cols, BS);",
     "int t0 = 0, n_t = cdiv(n_cols, BS) - (kDkdv ? 1 : 0);", 1),
    ("dQ without its bias", "flash_bwd_f32.cu",
     "if (!kDkdv && bb != nullptr && col < kv_len) c_bias[j] = __ldg(bb + col);",
     "if (false && bb != nullptr && col < kv_len) c_bias[j] = __ldg(bb + col);",
     1))
# the C entry of a forward mutant: non-causal, rate 0, the (B, S) bias
F32_ENTRY = r"""
extern "C" int stf_mutant_%(i)d(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int bh, int s, int heads, int d, float scale, void* stream) {
  return stf::flash_fwd_f32(q, k, v, static_cast<const float*>(bias), o,
                            static_cast<float*>(lse), bh, s, s, heads, d,
                            scale, 0, 0, 0u, nullptr, 0u, 1.0f,
                            static_cast<cudaStream_t>(stream));
}
"""
# the C entry of a backward mutant: rate 0, the bias or null; dK/dV writes
# dk and dv to out0 and out1, dQ dq to out0
F32_BWD_ENTRY = r"""
extern "C" int stf_mutant_%(i)d(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* out0,
    void* out1, int bh, int s, int heads, int d, float scale, int causal,
    void* stream) {
  return stf::flash_bwd_f32(%(dkdv)d, q, k, v, dout,
                            static_cast<const float*>(lse),
                            static_cast<const float*>(delta),
                            static_cast<const float*>(bias), out0, out0,
                            out1, bh, s, s, heads, d, scale, causal, 0, 0u,
                            nullptr, 0u, 1.0f,
                            static_cast<cudaStream_t>(stream));
}
"""
F32_FWD_TYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p]
F32_BWD_TYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def sm90_mutant_start():
    """Starts the build of the wgmma pipelines' planted faults
    (``SM90_MUTANTS``); ``sm90_mutant_lib`` takes the handle."""
    return mutant_start(SM90_MUTANTS,
                        lambda i, name: SM90_ENTRY % {
                            "i": i, "call": SM90_CALLS[name]})


def f32_mutant_start():
    """Starts the build of the f32 flash kernels' planted faults
    (``F32_MUTANTS``); ``f32_mutant_lib`` takes the handle."""
    def entry(i, name):
        if name == "flash_fwd_f32.cu":
            return F32_ENTRY % {"i": i}
        return F32_BWD_ENTRY % {"i": i, "dkdv": int(
            F32_MUTANTS[i][0].startswith("dK/dV"))}
    return mutant_start(F32_MUTANTS, entry)


_F32_MUTANT_LIBS = {}


def f32_mutant_lib(handle):
    """The f32 planted-fault library of ``f32_mutant_start`` (built once;
    each entry takes its source's arguments)."""
    if handle[0] not in _F32_MUTANT_LIBS:
        _F32_MUTANT_LIBS[handle[0]] = mutant_lib(handle, [
            F32_FWD_TYPES if src == "flash_fwd_f32.cu" else F32_BWD_TYPES
            for _, src, *_ in F32_MUTANTS])
    return _F32_MUTANT_LIBS[handle[0]]


def mutant_start(mutants, entry):
    """Starts the build of a planted-fault library in a temporary
    directory: each mutant a copy of its source with one text replaced and
    the C entry ``entry(i, source)`` appended, one nvcc a mutant, all at
    once. Returns the handle ``mutant_lib`` takes."""
    from simple_tensorflow_tpu_torch.ops.kernels import _build

    tmp = tempfile.mkdtemp(prefix="stf_mutant_")
    for f in os.listdir(_build.SRC_DIR):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(_build.SRC_DIR, f), tmp)
    srcs = []
    for i, (_, name, text, bad, n) in enumerate(mutants):
        src = open(os.path.join(_build.SRC_DIR, name)).read()
        if src.count(text) != n:
            fail(f"planted fault: {name} holds {text!r} "
                 f"{src.count(text)} times, expected {n}")
        with open(os.path.join(tmp, f"mutant{i}.cu"), "w") as fh:
            fh.write(src.replace(text, bad) + entry(i, name))
        srcs.append(f"mutant{i}.cu")
    nvcc = _build._nvcc()
    # each copy in a namespace of its own: two copies of one source link
    procs = [subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, f"-Dstf=stf_mutant{i}", "-c",
         os.path.join(tmp, f), "-o", os.path.join(tmp, f + ".o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, f in enumerate(srcs)]

    def stop():  # at exit, a failed run's builds too
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return tmp, srcs, procs, nvcc


def sm90_mutant_lib(handle):
    """The wgmma planted-fault library of ``sm90_mutant_start``."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return mutant_lib(handle, [P] * 8 + [I, I, F, P])


def mutant_lib(handle, argtypes):
    """The planted-fault library of ``mutant_start``, once built, its
    entries ``stf_mutant_<i>`` taking ``argtypes`` (one list for all, or a
    list of them, one an entry)."""
    tmp, srcs, procs, nvcc = handle
    for f, proc in zip(srcs, procs):
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"planted fault: nvcc failed on {f}:\n{out}")
    so = os.path.join(tmp, "libmutant.so")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         so, *(os.path.join(tmp, f + ".o") for f in srcs)],
        capture_output=True, text=True, timeout=300)
    if link.returncode != 0:
        fail(f"planted fault: link failed:\n{link.stdout}{link.stderr}")
    lib = ctypes.CDLL(so)
    for i in range(len(srcs)):
        fn = getattr(lib, f"stf_mutant_{i}")
        fn.argtypes = (argtypes[i] if isinstance(argtypes[0], list)
                       else argtypes)
        fn.restype = ctypes.c_int
    return lib


def block_ratio(out, ref, tol, rows=128):
    """The largest ||out - ref|| / (tol ||ref||) over blocks of ``rows``
    consecutive rows (queries or keys) of each head of (..., S, D)
    outputs: each block held to ``tol`` of its own size. Above 1 fails."""
    def block_sq(x):
        x = x.float().reshape(-1, x.shape[-2], x.shape[-1]).square().sum(-1)
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % rows))
        return x.view(x.shape[0], -1, rows).sum(-1)

    d2, r2 = block_sq(out.float() - ref.float()), block_sq(ref)
    return ((d2 / r2.clamp_min(torch.finfo(torch.float32).tiny)).sqrt()
            / tol).max().item()


def flash_limits(out, ref, tol):
    """The flash rows' limits on one output: ``(max abs err, within tol x
    max(1, max |ref|), worst block ratio)``. The scaled limit alone misses
    a wrong dK or dV at S = 32768, where the first keys' values (~3.8) set
    it above most keys' own (~1e-2), so each block of 128 queries or keys
    is also held to ``tol`` of its own norm (``block_ratio`` within 1).
    Not element by element: an early query's output cancels to near zero
    while its error scales with its terms (~1)."""
    err = (out.float() - ref.float()).abs().max().item()
    return (err, err <= tol * max(1.0, ref.float().abs().max().item()),
            block_ratio(out, ref, tol))


def check_flash(name, out, ref, tol):
    """Fails unless ``out`` is within both of ``flash_limits``; returns the
    max abs error and the worst block ratio."""
    err, scaled, ratio = flash_limits(out, ref, tol)
    if not (scaled and ratio <= 1.0):
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{err:.3e} against {tol} x max(1, max |ref|); worst 128-row "
             f"block at {ratio:.3e} of its bound)")
    return err, ratio


def lc_sm90_faults(K, lib, q, k, v, do, lse, delta, tag):
    """The planted pipeline faults of ``SM90_MUTANTS`` on head 0 of the
    long-context inputs: each must fail the limits the kernels are held
    to (o, dK, dV, dQ ``check_flash`` at 2e-2; lse 1e-5 scaled)."""
    sl = slice(0, 1)
    h = [t[sl].contiguous() for t in (q, k, v, do)]
    hl, hd = lse[sl].contiguous(), delta[sl].contiguous()
    s, D = q.shape[1], q.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    one = dict(heads=1, sm_scale=D ** -0.5, causal=True)
    refs = {"flash_fwd_sm90.cu": K.flash_attention_fwd_plain(*h[:3], **one),
            "flash_dkdv_sm90.cu": K.flash_attention_dkdv_plain(*h, hl, hd,
                                                               **one),
            "flash_dq_sm90.cu": (K.flash_attention_dq_plain(*h, hl, hd,
                                                            **one),)}
    txt = []
    for i, (what, name, *_) in enumerate(SM90_MUTANTS):
        fwd = name == "flash_fwd_sm90.cu"
        outs = ((torch.empty_like(h[0]), torch.empty_like(hl)) if fwd
                else (torch.empty_like(h[0]),) if name == "flash_dq_sm90.cu"
                else (torch.empty_like(h[1]), torch.empty_like(h[2])))
        ptrs = [t.data_ptr() for t in outs] + [None] * (2 - len(outs))
        rc = getattr(lib, f"stf_mutant_{i}")(
            *(t.data_ptr() for t in h), hl.data_ptr(), hd.data_ptr(),
            *ptrs, 1, s, D ** -0.5, stream)
        torch.cuda.synchronize()
        if rc:
            fail(f"planted sm90 fault ({what}): the launch returned {rc}")
        # (error, within the scaled limit, worst block ratio)
        lims = [flash_limits(out, ref, 2e-2)
                for out, ref in zip(outs, refs[name])]
        if fwd:  # lse: 1e-5 scaled only
            lims[1] = flash_limits(outs[1], refs[name][1], 1e-5)[:2] + (0.0,)
        scaled = all(x[1] for x in lims)
        ratio = max(x[2] for x in lims)
        txt.append(f"{what}: off by "
                   + " and ".join(f"{x[0]:.3e}" for x in lims)
                   + f" (the scaled limit alone "
                   f"{'passes' if scaled else 'fails'} it), worst 128-row "
                   f"block at {ratio:.3e} of its bound")
        if scaled and ratio <= 1.0:
            fail(f"flash {tag}: the check passes the planted fault "
                 f"({what})")
        del outs
    print(f"  planted faults in the wgmma pipelines ({tag}, head 0): "
          + "; ".join(txt), flush=True)


def lc_ragged_check(K, gen, dev):
    """The wgmma forward and dK/dV at a ragged length (S = 4000 - 40, 2 x 4
    heads of D = 128, non-causal with a (batch, key) bias, rate 0 and 0.1)
    against their plain versions: o, dK, dV, dQ ``check_flash`` at 2e-2,
    lse 1e-5 scaled."""
    b, h, s, D = 2, 4, LC_RAGGED_S, 128
    q, k, v, do = (torch.randn((b * h, s, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    bias = torch.randn((b, s), generator=gen, device=dev)
    for rate in (0.0, 0.1):
        args = dict(heads=h, sm_scale=D ** -0.5, causal=False, bias=bias)
        if rate:
            args.update(dropout_rate=rate, dropout_seed=FLASH_SEED)
        tag = (f"bf16 BH={b * h} S={s} D={D} non-causal, key bias, rate "
               f"{rate} (long_context ragged)")
        o, lse = K.flash_attention_fwd(q, k, v, **args)
        ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
        delta = (do.float() * ro.float()).sum(-1)
        dk, dv = K.flash_attention_dkdv(q, k, v, do, rlse, delta, **args)
        dq = K.flash_attention_dq(q, k, v, do, rlse, delta, **args)
        rdk, rdv = K.flash_attention_dkdv_plain(q, k, v, do, rlse, delta,
                                                **args)
        rdq = K.flash_attention_dq_plain(q, k, v, do, rlse, delta, **args)
        torch.cuda.synchronize()
        errs = [check_flash(f"flash fwd o {tag}", o, ro, 2e-2),
                (check_scaled(f"flash fwd lse {tag}", lse, rlse, 1e-5), 0.0),
                check_flash(f"flash dk {tag}", dk, rdk, 2e-2),
                check_flash(f"flash dv {tag}", dv, rdv, 2e-2),
                check_flash(f"flash dq {tag}", dq, rdq, 2e-2)]
        print(f"  flash {tag}: max abs err o {errs[0][0]:.3e}, lse "
              f"{errs[1][0]:.3e}, dk {errs[2][0]:.3e}, dv {errs[3][0]:.3e}, "
              f"dq {errs[4][0]:.3e} against the plain versions; worst "
              f"128-row block at {max(e[1] for e in errs):.3e} of its bound",
              flush=True)
        del o, lse, ro, rlse, dk, dv, dq, rdk, rdv, rdq
        torch.cuda.empty_cache()


def lc_flash_rows(K, gen, dev, B, H, s, D, mutant=None):
    """The bf16 flash kernels at B x H heads of S = ``s``, D = ``D``,
    causal, rate 0 (the long-context LM's attention) against their plain
    versions run a head at a time (the plain score tensor of all heads
    does not fit), timed beside SDPA ``is_causal=True``, which computes
    the same function here (no bias, no dropout); with ``mutant`` (the
    handle of ``sm90_mutant_start``) the planted pipeline faults must fail
    the same limits. Returns ``{part: row}``."""
    import torch.nn.functional as F

    bh, dtype, elem = B * H, torch.bfloat16, 2
    args = dict(heads=H, sm_scale=D ** -0.5, causal=True)
    q, k, v, do = (torch.randn((bh, s, D), generator=gen, device=dev).to(
        dtype) for _ in range(4))
    o, lse = K.flash_attention_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = K.flash_attention_dkdv(q, k, v, do, lse, delta, **args)
    dq = K.flash_attention_dq(q, k, v, do, lse, delta, **args)
    torch.cuda.synchronize()
    one = dict(args, heads=1)
    # (max abs err, worst block ratio) a part, over the heads
    errs = {"fwd": [0.0, 0.0], "dkdv": [0.0, 0.0], "dq": [0.0, 0.0]}
    tag = f"bf16 BH={bh} S={s} D={D} causal rate 0 (long_context)"

    def held(part, *results):
        for err, ratio in results:
            errs[part] = [max(errs[part][0], err), max(errs[part][1], ratio)]

    for h in range(bh):
        sl = slice(h, h + 1)
        ro, rlse = K.flash_attention_fwd_plain(q[sl], k[sl], v[sl], **one)
        held("fwd", check_flash(f"flash fwd o {tag} head {h}", o[sl], ro,
                                2e-2),
             (check_scaled(f"flash fwd lse {tag} head {h}", lse[sl], rlse,
                           1e-5), 0.0))
        rdk, rdv = K.flash_attention_dkdv_plain(
            q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl], **one)
        held("dkdv",
             check_flash(f"flash dk {tag} head {h}", dk[sl], rdk, 2e-2),
             check_flash(f"flash dv {tag} head {h}", dv[sl], rdv, 2e-2))
        rdq = K.flash_attention_dq_plain(q[sl], k[sl], v[sl], do[sl],
                                         lse[sl], delta[sl], **one)
        held("dq", check_flash(f"flash dq {tag} head {h}", dq[sl], rdq,
                               2e-2))
        del ro, rlse, rdk, rdv, rdq
        torch.cuda.empty_cache()
    print(f"  flash {tag}, every head: worst 128-row block at " + ", ".join(
        f"{errs[p][1]:.3e} ({p})" for p in errs) + " of its bound (2e-2 of "
        "its norm)", flush=True)
    # planted fault: the non-causal kernel's output must fail the check
    bad = K.flash_attention_fwd(q[:1], k[:1], v[:1],
                                **dict(args, heads=1, causal=False))[0]
    ro = K.flash_attention_fwd_plain(q[:1], k[:1], v[:1], **one)[0]
    bad_err = (bad.float() - ro.float()).abs().max().item()
    if bad_err <= 2e-2 * max(1.0, ro.float().abs().max().item()):
        fail(f"flash {tag}: the check passes the non-causal kernel "
             f"({bad_err:.3e})")
    del bad, ro
    torch.cuda.empty_cache()
    if mutant is not None:
        lc_sm90_faults(K, sm90_mutant_lib(mutant), q, k, v, do, lse, delta,
                       tag)
        torch.cuda.empty_cache()

    def heads(fn):
        return lambda: [fn(h) for h in range(bh)]

    def pl(h, part):
        sl = slice(h, h + 1)
        if part == "fwd":
            return K.flash_attention_fwd_plain(q[sl], k[sl], v[sl], **one)
        if part == "dkdv":
            return K.flash_attention_dkdv_plain(
                q[sl], k[sl], v[sl], do[sl], lse[sl], delta[sl], **one)
        return K.flash_attention_dq_plain(q[sl], k[sl], v[sl], do[sl],
                                          lse[sl], delta[sl], **one)

    kern = {"fwd": lambda: K.flash_attention_fwd(q, k, v, **args),
            "dkdv": lambda: K.flash_attention_dkdv(q, k, v, do, lse, delta,
                                                   **args),
            "dq": lambda: K.flash_attention_dq(q, k, v, do, lse, delta,
                                               **args)}
    q4, k4, v4, do4 = (t.view(B, H, s, D) for t in (q, k, v, do))
    lib_f = event_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=10)
    lib_b = event_ms(sdpa_bwd((q, k, v, do), B, H, s, D, True), reps=5)
    pairs = bh * (s * (s + 1) // 2)
    io = bh * s * D * elem
    flops = {p: n * D * pairs for p, n in FLASH_FLOP_PER_PAIR.items()}
    bnds = {"fwd": bound_ms(4 * io + bh * s * 4, flops["fwd"], dtype),
            "dkdv": bound_ms(6 * io + 2 * bh * s * 4, flops["dkdv"], dtype),
            "dq": bound_ms(5 * io + 2 * bh * s * 4, flops["dq"], dtype)}
    libs = {"fwd": lib_f, "dkdv": lib_b, "dq": lib_b}
    rows = {}
    for part in ("fwd", "dkdv", "dq"):
        ms = device_ms([kern[part]], min_calls=4)
        plain_ms = event_ms(heads(lambda h, p=part: pl(h, p)), reps=1)
        torch.cuda.empty_cache()
        kname = importlib.import_module(KMOD + "flash_attention").kernel_name(
            part, dtype, D)
        name = f"flash_attention_{part} ({kname}) {tag}"
        report(name, errs[part][0], ms, plain_ms, bnds[part], libs[part])
        rows[part] = kernel_row(
            errs[part][0], ms, plain_ms, bnds[part], libs[part],
            f"{name}; library SDPA is_causal=True, the same function "
            f"({'forward' if part == 'fwd' else 'its flash backward alone'})"
            "; plain a head at a time")
    print("  (flash at the long-context shape: " + ", ".join(
        f"{part} {flops[part] / rows[part]['ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * rows[part]['bound_ms'] / rows[part]['ms']:.1f}% of its "
        "bound" for part in ("fwd", "dkdv", "dq"))
        + f"; kernel / SDPA is_causal forward {rows['fwd']['ms'] / lib_f:.3f}x"
        f", dK/dV + dQ {(rows['dkdv']['ms'] + rows['dq']['ms']) / lib_b:.3f}"
        "x SDPA's flash backward, same call)", flush=True)
    del q, k, v, do, o, lse, delta, dk, dv, dq
    torch.cuda.empty_cache()
    return rows


def lc_ln_rows(K, gen, dev, rows, n, eps):
    """LayerNorm forward and backward at bf16 ``rows x n`` (f32 gamma,
    beta, statistics) against their plain versions and F.layer_norm /
    aten's backward."""
    import torch.nn.functional as F

    dtype, elem = torch.bfloat16, 2
    x = torch.randn((rows, n), generator=gen, device=dev).mul(2).add(
        0.5).to(dtype)
    dy = torch.randn((rows, n), generator=gen, device=dev).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
    beta = 0.1 * torch.randn(n, generator=gen, device=dev)
    ry, mean, rstd = K.layer_norm_plain(x, gamma, beta, eps=eps,
                                        return_stats=True)
    y, mu, rs = K.layer_norm_fwd(x, gamma, beta, eps=eps, return_stats=True)
    dx, dg, db = K.layer_norm_bwd(x, gamma, mean, rstd, dy)
    rdx, rdg, rdb = K.layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    name = f"bfloat16 rows={rows} n={n} eps={eps} (long_context)"
    err_f = max(check_close(f"layer_norm {name}", y, ry, dtype),
                check_close(f"layer_norm {name} mean", mu, mean,
                            torch.float32),
                check_close(f"layer_norm {name} rstd", rs, rstd,
                            torch.float32))
    err_b = max(check_scaled(f"layer_norm_bwd {name} dx", dx, rdx, 2e-2),
                check_scaled(f"layer_norm_bwd {name} dgamma", dg, rdg, 1e-4),
                check_scaled(f"layer_norm_bwd {name} dbeta", db, rdb, 1e-4))
    del y, mu, rs, dx, dg, db, rdx, rdg, rdb, ry
    ms_f = device_ms([lambda: K.layer_norm_fwd(x, gamma, beta, eps=eps,
                                               return_stats=True)])
    ms_b = device_ms([lambda: K.layer_norm_bwd(x, gamma, mean, rstd, dy)])
    plain_f = device_ms([lambda: K.layer_norm_plain(
        x, gamma, beta, eps=eps, return_stats=True)])
    plain_b = device_ms([lambda: K.layer_norm_bwd_plain(x, gamma, mean,
                                                        rstd, dy)])
    g_t, b_t = gamma.to(dtype), beta.to(dtype)
    lib_f = device_ms([lambda: F.layer_norm(x, (n,), g_t, b_t, eps=eps)])
    lib_b = device_ms([lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [n], mean[:, None], rstd[:, None], g_t, b_t,
        [True, True, True])])
    bnd_f = bound_ms(2 * rows * n * elem + 2 * n * 4 + 8 * rows,
                     8 * rows * n, torch.float32)
    bnd_b = bound_ms(3 * rows * n * elem + 12 * n + 8 * rows,
                     12 * rows * n, torch.float32)
    report(f"layer_norm {name}", err_f, ms_f, plain_f, bnd_f, lib_f)
    report(f"layer_norm_bwd {name}", err_b, ms_b, plain_b, bnd_b, lib_b)
    return {"layer_norm@long_context": kernel_row(
                err_f, ms_f, plain_f, bnd_f, lib_f, f"layer_norm {name}"),
            "layer_norm_bwd@long_context": kernel_row(
                err_b, ms_b, plain_b, bnd_b, lib_b,
                f"layer_norm_bwd {name}")}


def lc_adam_rows(K, gen, dev, groups, lr):
    """Adam over the long-context LM's flat groups (bf16 Dense parameters,
    f32 others; f32 m and v), bit-exact with the plain version, timed
    beside ``Adam(fused=True)``; the row is the larger group's."""
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    alpha = torch.tensor(lr, device=dev)
    main = {}
    big = max(groups, key=groups.get)
    for gname, n in sorted(groups.items()):
        pdt = getattr(torch, gname)
        p = (0.02 * torch.randn(n, generator=gen, device=dev)).to(pdt)
        m = 0.01 * torch.randn(n, generator=gen, device=dev)
        v = 1e-4 * torch.rand(n, generator=gen, device=dev)
        g = (0.01 * torch.randn(n, generator=gen, device=dev)).to(pdt)
        got = K.adam_update(p.clone(), m.clone(), v.clone(), g, alpha, **kw)
        ref = K.adam_update_plain(p.clone(), m.clone(), v.clone(), g, alpha,
                                  **kw)
        torch.cuda.synchronize()
        name = (f"adam_update {gname} params n={n} f32 m/v (long_context "
                f"{gname} group)")
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{name}: kernel is not bit-exact with its plain version")
        del got, ref
        ms = device_ms([lambda: K.adam_update(p, m, v, g, alpha, **kw)])
        plain_ms = device_ms([lambda: K.adam_update_plain(p, m, v, g, alpha,
                                                          **kw)])
        pt = torch.nn.Parameter(p.clone())
        pt.grad = g.clone()
        opt = torch.optim.Adam([pt], lr=lr, fused=True)
        lib_ms = event_ms(opt.step)
        bnd = bound_ms((3 * p.element_size() + 16) * n, 12 * n,
                       torch.float32)
        report(name, 0.0, ms, plain_ms, bnd, lib_ms)
        if gname == big:
            main["adam_update@long_context"] = kernel_row(
                0.0, ms, plain_ms, bnd, lib_ms, name)
        del p, m, v, g, pt, opt
        torch.cuda.empty_cache()
    return main


def lc_kernel_rows(K, gen, dev, cfg, groups, lr, mutant=None):
    """The long-context LM's kernel shapes against their plain versions
    (module docstring, phase 15)."""
    main = {}
    hd = cfg.d_model // cfg.num_heads
    for part, row in lc_flash_rows(K, gen, dev, 1, cfg.num_heads, LC_S,
                                   hd, mutant).items():
        main[f"flash_attention_{part}@long_context"] = row
    lc_ragged_check(K, gen, dev)
    torch.cuda.empty_cache()
    main.update(lc_ln_rows(K, gen, dev, LC_S, cfg.d_model,
                           cfg.layer_norm_eps))
    torch.cuda.empty_cache()
    main.update(xent_case(K, gen, dev, LC_S, cfg.vocab_size,
                          (torch.bfloat16,), (0.0,), "@long_context"))
    torch.cuda.empty_cache()
    main.update(lc_adam_rows(K, gen, dev, groups, lr))
    return main


@contextlib.contextmanager
def ring_not_causal():
    """Planted fault: the ``RingAttention`` lowering drops the causal
    flag."""
    from simple_tensorflow_tpu_torch.framework import op_registry
    from simple_tensorflow_tpu_torch.ops import fused_ops

    def wrap(lower):
        def no_causal(ctx, op, inputs):
            return [fused_ops.fused_attention(
                *inputs, causal=False, sm_scale=op.attrs["sm_scale"])]
        return no_causal

    with planted(op_registry.get("RingAttention"), "lower", wrap):
        yield


@contextlib.contextmanager
def ring_plain_flash():
    """The ``RingAttention`` lowering on the flash kernels' plain versions
    (forward and backward), every other kernel launched as it is."""
    from simple_tensorflow_tpu_torch.framework import op_registry
    from simple_tensorflow_tpu_torch.ops import fused_ops

    def wrap(lower):
        def plain_flash(ctx, op, inputs):
            with fused_ops.plain_versions():
                return lower(ctx, op, inputs)
        return plain_flash

    with planted(op_registry.get("RingAttention"), "lower", wrap):
        yield


def check_lc_plain(K, stf, lc, dtype, attribution=False):
    """``lm_train_model`` at the full width cut to ``LC_CUT_LAYERS`` layers
    and seq ``LC_CUT_S``, through the kernels against the same runs under
    ``plain_versions()``, eager, from one initializer: the gradients of
    every variable (one run before any update), then ``LC_CHECK_STEPS``
    Adam steps, each loss, each gradient and (f32) every variable and Adam
    slot within ``LC_TOL``; exactly ``lc_per_step`` launches a step. The
    causal flag dropped in the ``RingAttention`` lowering, planted, must
    fail. With ``attribution`` (``--lc-attribution``), the same run with
    the flash path alone on its plain versions says how much of the gaps
    the flash kernels own. Returns the kernel steps' launches."""
    from simple_tensorflow_tpu_torch.ops import fused_ops

    cfg = dataclasses.replace(lc.LongContextConfig(),
                              num_layers=LC_CUT_LAYERS)
    groups = len(lc_groups(stf, lc, cfg, dtype))
    loss_tol, rel_tol = LC_TOL[dtype.name]

    def build():
        m = lc_build(lc, cfg, LC_CUT_S, dtype)()
        tvars = stf.trainable_variables()
        m["grad_names"] = [v.var_name for v in tvars]
        m["grads"] = stf.gradients(m["loss"], tvars)
        return m

    def run(plain=False, fault=False, counts=None, plain_flash=False):
        m, sess = seeded_session(stf, build)
        sess._capture = False
        feeds = lc_feeds(lc, cfg, m, LC_CUT_S)
        with (fused_ops.plain_versions() if plain
              else contextlib.nullcontext()), \
                (ring_not_causal() if fault else contextlib.nullcontext()), \
                (ring_plain_flash() if plain_flash
                 else contextlib.nullcontext()):
            grads = dict(zip(m["grad_names"], sess.run(m["grads"], feeds)))
            if counts is not None:
                K.reset_launch_counts()
            losses = [float(sess.run([m["loss"], m["train_op"]], feeds)[0])
                      for _ in range(LC_CHECK_STEPS)]
            if counts is not None:
                counts.update(K.launch_counts())
        state = session_state(sess)
        sess.close()
        return losses, grads, state

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.linalg.norm(a - b)
        return 0.0 if d == 0 else d / max(np.linalg.norm(b), 1e-30)

    def compare(got, ref):
        bad = [(a, b) for a, b in zip(got[0], ref[0])
               if not abs(a - b) <= loss_tol * abs(b)]
        g = {k: rel(got[1][k], ref[1][k]) for k in ref[1]}
        worst = max(g, key=g.get)
        return bad, (g[worst], worst), session_errs(got[2], ref[2])

    def gaps(got, ref, var):
        """The largest relative loss gap, and ``var``'s relative-norm
        gap after the steps."""
        loss = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
        a, b = got[2][var].double(), ref[2][var].double()
        return loss, ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    ref = run(plain=True)
    counts = {}
    got_run = run(counts=counts)
    got = compare(got_run, ref)
    fault = compare(run(fault=True), ref)
    want = {k: 0 for k in counts}
    want.update({k: v * LC_CHECK_STEPS
                 for k, v in lc_per_step(cfg, groups).items()})
    if counts != want:
        fail(f"long_context check: launches {counts}, expected {want}")
    tag = f"long_context[{dtype.name} 1x{LC_CUT_S}, {LC_CUT_LAYERS} layers]"

    def txt(r):
        return (f"bad losses {r[0]}, the worst gradient {r[1][0]:.3e} "
                f"({r[1][1]}), the worst variable or slot {r[2][0]:.3e} "
                f"({r[2][1]})")

    print(f"{tag}: gradients, then {LC_CHECK_STEPS} Adam steps, kernels vs "
          f"plain (losses rtol {loss_tol}, gradients{' and variables' if dtype.name == 'float32' else ''} "
          f"rel norm {rel_tol}): losses {ref[0]} (plain); off the plain "
          f"runs: {txt(got)}; launches of the steps {counts}", flush=True)
    print(f"{tag}: planted fault (RingAttention not causal): {txt(fault)}",
          flush=True)
    if attribution:
        # which share of the gaps the flash kernels own: the kernel run,
        # and the kernel run with the flash path on its plain versions,
        # each off the plain run
        fp = run(plain_flash=True)
        var = got[2][1]
        (l_all, v_all), (l_fp, v_fp) = (gaps(r, ref, var)
                                        for r in (got_run, fp))
        print(f"{tag}: the flash path alone on its plain versions: "
              f"{txt(compare(fp, ref))}; largest relative loss gap "
              f"{l_all:.3e} (all kernels) vs {l_fp:.3e} (flash plain), "
              f"{var} after {LC_CHECK_STEPS} steps {v_all:.3e} vs "
              f"{v_fp:.3e}; the gradients before Adam, worst "
              f"{got[1][0]:.3e} ({got[1][1]}) vs "
              f"{compare(fp, ref)[1][0]:.3e} ({compare(fp, ref)[1][1]})",
              flush=True)

    def ok(r):
        return not r[0] and r[1][0] <= rel_tol and (
            dtype.name != "float32" or r[2][0] <= rel_tol)

    if not ok(got):
        fail(f"{tag}: the kernels' runs are off the plain runs: {got}")
    if ok(fault):
        fail(f"{tag}: the check passes the planted causal fault: {fault}")
    return counts


def graph_vs_eager(K, stf, tag, build, fetch, feeds_at, steps, fault=None):
    """``steps`` runs of a new seeded Session, the step captured (run 1
    eager, run 2 captured, then replays) against the same runs with
    ``_capture`` off: every fetch (but the train op) and every variable
    and slot bit-identical, one capture. ``feeds_at(m, i)``: run i's
    feeds. ``fault``: a context manager planted in a third, captured run,
    whose fetches must then differ. Returns ``(fetches, launches)`` of
    the captured run."""
    def run(capture, planted_fault=False):
        m, sess = seeded_session(stf, build)
        sess._capture = capture
        K.reset_launch_counts()
        with (fault[1]() if planted_fault else contextlib.nullcontext()):
            outs = [sess.run(fetch(m), feeds_at(m, i)) for i in range(steps)]
        counts = K.launch_counts()
        state = session_state(sess)
        captures = sess.captures
        sess.close()
        torch.cuda.empty_cache()
        return outs, state, captures, counts

    def diffs(outs, ref):
        return [sum(int(not np.array_equal(x, y)) for i, (x, y) in
                    enumerate(zip(a, b)) if i != 1)
                for a, b in zip(outs, ref)]

    ref, ref_state, _, ref_counts = run(False)
    got, state, captures, counts = run(True)
    d_got = diffs(got, ref)
    bad_vars = [k for k in ref_state
                if not torch.equal(state[k], ref_state[k])]
    print(f"{tag}: {steps} runs (eager warm-up, capture, {steps - 2} "
          f"replays) vs eager: losses {[float(a[0]) for a in got]}; fetches "
          f"differing by run {d_got}; variables and slots differing "
          f"{bad_vars[:5]} ({len(bad_vars)} of {len(ref_state)}); captures "
          f"{captures}; launches {counts} (eager {ref_counts})", flush=True)
    if any(d_got) or bad_vars or captures != 1 or counts != ref_counts:
        fail(f"{tag}: the captured runs are off the eager runs")
    if fault is not None:
        stale, _, _, _ = run(True, planted_fault=True)
        d_stale = diffs(stale, ref)
        print(f"{tag}: planted fault ({fault[0]}): fetches differing by "
              f"run {d_stale}", flush=True)
        if not all(d_stale[1:]):
            fail(f"{tag}: the check passes the planted fault: {d_stale}")
    return got, counts


def sc_windows(K, stf, tag, build, fetch, feeds, items, unit, fwd_fetch=None,
               attn_flops=0.0, want_kernels=()):
    """A new seeded Session trained by ``run_steps`` windows of
    ``SC_WINDOW_N`` (one that warms up and captures, then ``SC_WINDOWS``
    timed ones) and one window traced: p50 a step, ``items`` ``unit`` a
    second, device and host ms a step, the busy share, peak allocated
    memory over the first window and over the rest (above what the
    process held before), the launches of the timed windows; with
    ``fwd_fetch`` the share of the dense bf16 peak at 3 x the cost
    model's forward FLOPs, and beside it with ``attn_flops`` (the
    attention FLOPs a step counted from the shapes, which the cost model
    does not price) added; each of ``want_kernels`` (kernel names) must
    show in the traced window, and its device ms a step is printed.
    Returns ``(p50 s, launches, fetches, sess, m)`` with the Session still
    open."""
    from simple_tensorflow_tpu_torch.framework import cost_model

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / GIB
    torch.cuda.reset_peak_memory_stats()
    m, sess = seeded_session(stf, build)
    fd = feeds(m)
    f = fetch(m)
    sess.run_steps(f, SC_WINDOW_N, feed_dict=fd)
    torch.cuda.synchronize()
    peak_first = torch.cuda.max_memory_allocated() / GIB - base
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    times, losses = [], []
    for _ in range(SC_WINDOWS):
        t0 = time.perf_counter()
        out = sess.run_steps(f, SC_WINDOW_N, feed_dict=fd,
                             output_mode="stacked")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / SC_WINDOW_N)
        losses += [float(x) for x in out[0]]
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / GIB - base
    tr = loop_trace(lambda: sess.run_steps(f, SC_WINDOW_N, feed_dict=fd),
                    SC_WINDOW_N)
    p50 = statistics.median(times)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: non-finite loss in the windows: {losses}")
    dev_txt = "device ms a step not measured (no device time traced)" \
        if tr is None else (
            f"device {tr['dev_ms']:.4f} ms a step, host {p50 * 1e3 - tr['dev_ms']:.4f} "
            f"ms (p50 minus device), busy {100 * tr['busy']:.1f}% of the "
            f"traced window")
    print(f"{tag}: run_steps windows of {SC_WINDOW_N}: losses "
          f"{[round(x, 5) for x in losses]}; p50 {p50 * 1e3:.4f} ms a step "
          f"(min {min(times) * 1e3:.4f}, max {max(times) * 1e3:.4f}), "
          f"{items / p50:.2f} {unit}/s; {dev_txt}; peak allocated "
          f"{peak_first:.3f} GiB over the first window (warm-up, capture), "
          f"{peak:.3f} GiB over the timed ones (above {base:.3f} GiB held "
          f"before); launches {counts}", flush=True)
    if want_kernels:
        names = {} if tr is None else tr["kernels"]
        got = {w: sum(v for k, v in names.items() if w + "<" in k)
               for w in want_kernels}
        missing = [w for w, v in got.items() if not v]
        if missing:
            fail(f"{tag}: the traced window shows no {missing}")
        print(f"{tag}: the traced window's device ms a step by kernel: "
              + ", ".join(f"{w} {v:.4f}" for w, v in got.items())
              + f" ({100 * sum(got.values()) / tr['dev_ms']:.1f}% of the "
              "device time)", flush=True)
    if fwd_fetch is not None:
        est = cost_model.estimate(fwd_fetch(m), feeds=list(fd))
        share = 3 * est.flops / p50 / BF16_PEAK
        print(f"{tag}: the cost model's forward {est.flops / 1e12:.4f} TFLOP "
              f"a step; 3 x that at the p50: {3 * est.flops / p50 / 1e12:.2f} "
              f"TFLOP/s, {100 * share:.2f}% of the dense bf16 peak "
              f"({BF16_PEAK / 1e12:.0f} TFLOP/s, data sheet)", flush=True)
        if attn_flops:
            total = 3 * est.flops + attn_flops
            print(f"{tag}: the attention FLOPs counted from the shapes "
                  f"(forward 4 x D, backward 10 x D a live causal pair, "
                  f"every layer) {attn_flops / 1e12:.4f} TFLOP a step; "
                  f"with them {total / p50 / 1e12:.2f} TFLOP/s, "
                  f"{100 * total / p50 / BF16_PEAK:.2f}% of the dense bf16 "
                  "peak", flush=True)
    return p50, counts, out, sess, m


def lc_hook_check(stf, lc, cfg, card):
    """A ``MonitoredTrainingSession`` of ``SC_HOOK_STEPS`` long-context
    steps with a ``StepCounterHook(every_n_steps=4)``: its ``last_perf``
    (the MFU report) must equal ``cost_model.predicted_vs_measured`` of the
    same fetches at the hook's measured seconds a step, and carry ``mfu``
    on the card."""
    from simple_tensorflow_tpu_torch.framework import cost_model

    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(1)
        m = lc_build(lc, cfg, LC_S, stf.bfloat16)()
        hook = stf.train.StepCounterHook(every_n_steps=4)
        fetch = [m["train_op"], m["loss"]]
        with stf.train.MonitoredTrainingSession(
                hooks=[hook], save_summaries_steps=None) as ms:
            fd = lc_feeds(lc, cfg, m, LC_S)
            for _ in range(SC_HOOK_STEPS):
                ms.run(fetch, fd)
        perf = hook.last_perf
        if not perf or "mfu" not in perf:
            fail(f"long_context StepCounterHook: last_perf {perf}")
        ref = cost_model.predicted_vs_measured(
            fetch, measured_seconds=perf["measured_sec_per_step"])
    # the hook's measured figures come from its unrounded seconds, ref's
    # from the 4 significant digits the hook reports
    measured = ("mfu", "measured_over_predicted")
    off = {k: (perf.get(k), v) for k, v in ref.items()
           if k not in measured and perf.get(k) != v}
    rel = max(abs(perf[k] - ref[k]) / max(abs(ref[k]), 1e-12)
              for k in measured)
    print(f"{card}: long_context StepCounterHook.last_perf {perf}; "
          f"predicted_vs_measured at its measured s a step {ref}; steps/s "
          f"{hook.last_steps_per_sec:.4f}", flush=True)
    if off or rel > 1e-3:
        fail(f"long_context StepCounterHook: last_perf off "
             f"predicted_vs_measured: {off}, measured figures rel {rel:.3e}")
    return perf


def recompute_auto_report(stf, card):
    """What ``recompute="auto"`` resolves to on this card for the five
    graph entry points at the smoke's cells, read off the graphs built
    (a ``RecomputeGradCall`` op a layer when it resolves to True)."""
    from simple_tensorflow_tpu_torch.models import bert, long_context, resnet
    from simple_tensorflow_tpu_torch.models import transformer as tr
    from simple_tensorflow_tpu_torch.utils import perf

    cells = {
        "transformer_train_model big 64x64/64 bf16": lambda:
            tr.transformer_train_model(64, 64, 64, recompute="auto"),
        "bert_pretrain_model base 32x512 bf16": lambda:
            bert.bert_pretrain_model(BERT_B, BERT_S, BERT_P,
                                     recompute="auto"),
        "bert_encoder base 32x512 bf16": lambda: bert.bert_encoder(
            stf.placeholder(stf.int32, [BERT_B, BERT_S]),
            stf.placeholder(stf.int32, [BERT_B, BERT_S]), None,
            bert.BertConfig.base(), recompute="auto"),
        "resnet50_train_model 256x224 bf16": lambda:
            resnet.resnet50_train_model(256, 224, recompute="auto"),
        "lm_train_model LongContextConfig() 1x32768 bf16": lambda:
            long_context.lm_train_model(1, LC_S, recompute="auto"),
    }
    out = {}
    for name, build in cells.items():
        g = stf.Graph()
        with g.as_default():
            build()
        out[name] = any(op.type == "RecomputeGradCall"
                        for op in g.get_operations())
    flops, bw = perf.chip_spec()
    print(f"{card}: recompute=\"auto\" resolves (cost model against "
          f"{torch.cuda.get_device_name(0)}: {flops / 1e12:.0f} TFLOP/s, "
          f"{bw / 1e12:.2f} TB/s, HBM {perf.chip_hbm_bytes() / GIB:.2f} GiB) "
          f"to {out}", flush=True)
    if out["lm_train_model LongContextConfig() 1x32768 bf16"]:
        fail("long_context: recompute=\"auto\" resolves to True on this "
             "card; the cost model expects False")
    return out


@contextlib.contextmanager
def sampler_host_key_once():
    """Planted fault: the sampler draws from a host key taken once, at its
    first run, so every captured replay draws the same ids."""
    from simple_tensorflow_tpu_torch.framework import op_registry

    first = {}

    class Fixed:
        def __init__(self, ctx, key):
            self._ctx, self._key = ctx, key

        def rng_key(self, op):
            return self._key

        def __getattr__(self, name):
            return getattr(self._ctx, name)

    def wrap(lower):
        def once(ctx, op, inputs):
            if op not in first:
                first[op] = ctx.rng_for(op)
            return lower(Fixed(ctx, first[op]), op, inputs)
        return once

    with planted(op_registry.get("LogUniformCandidateSampler"), "lower",
                 wrap):
        yield


@contextlib.contextmanager
def dlrm_plain_lookup():
    """The reference of the DLRM check: ``EmbeddingLookupFused`` as a plain
    clipped gather, differentiated by PyTorch's indexing backward."""
    from simple_tensorflow_tpu_torch.framework import dtypes as dtypes_mod
    from simple_tensorflow_tpu_torch.framework import op_registry

    def wrap(lower):
        def plain(ctx, op, inputs):
            table, ids = inputs
            dt = dtypes_mod.as_dtype(op.attrs["compute_dtype"]).torch_dtype
            return [table[ids.long().clamp(0, table.shape[0] - 1)].to(dt)]
        return plain

    with planted(op_registry.get("EmbeddingLookupFused"), "lower", wrap):
        yield


@contextlib.contextmanager
def dlrm_drop_duplicates():
    """Planted fault: the scatter-add without the inverse segment sum: a
    duplicate id's cotangents are written, not added, so all but one
    drop."""
    from simple_tensorflow_tpu_torch.ops import embedding_ops

    def wrap(_):
        def first_only(gm, inv, n):
            out = torch.zeros((n,) + tuple(gm.shape[1:]), dtype=gm.dtype,
                              device=gm.device)
            return out.index_put_((inv,), gm)
        return first_only

    with planted(embedding_ops, "_segment_sum", wrap):
        yield


def dlrm_feeds(dlrm, m, i):
    return dlrm.feed_dict_for(m, dlrm.synthetic_dlrm_batch(DLRM_B, seed=i))


def check_dlrm_reference(stf, dlrm):
    """2 eager DLRM steps on Zipf batches (duplicate ids: the dedup merges
    them) through the fused lookup against the same steps with the lookup
    a plain gather (:func:`dlrm_plain_lookup`): losses within ``SC_TOL``,
    the tables and MLPs within ``SC_TOL`` by relative norm. The scatter-add
    that drops duplicates (:func:`dlrm_drop_duplicates`), planted, must
    fail."""
    def run(ctx):
        m, sess = seeded_session(stf, dlrm.dlrm_model)
        sess._capture = False
        with ctx():
            losses = [float(sess.run([m["loss"], m["train_op"]],
                                     dlrm_feeds(dlrm, m, i))[0])
                      for i in range(2)]
        state = session_state(sess)
        sess.close()
        return losses, state

    def compare(got, ref):
        bad = [(a, b) for a, b in zip(got[0], ref[0])
               if not abs(a - b) <= SC_TOL * abs(b)]
        return bad, session_errs(got[1], ref[1])

    ref = run(dlrm_plain_lookup)
    got = compare(run(contextlib.nullcontext), ref)
    fault = compare(run(dlrm_drop_duplicates), ref)
    batch = dlrm.synthetic_dlrm_batch(DLRM_B, seed=0)
    dup = [(int((ids >= 0).sum()), len(np.unique(np.maximum(ids, 0))))
           for ids in batch["cat_ids"]]
    tag = f"dlrm[f32 {DLRM_B}]"
    print(f"{tag}: 2 SGD steps, the fused lookup vs a plain gather: losses "
          f"{ref[0]} (plain); off them: losses {got[0]}, the worst variable "
          f"{got[1][0]:.3e} ({got[1][1]}); batch 0's (ids, distinct after "
          f"the -1 clip) a table {dup}", flush=True)
    print(f"{tag}: planted fault (duplicates dropped in the scatter-add): "
          f"bad losses {fault[0]}, worst {fault[1][0]:.3e} "
          f"({fault[1][1]})", flush=True)
    if got[0] or got[1][0] > SC_TOL:
        fail(f"{tag}: the fused lookup's steps are off the plain ones: {got}")
    if fault[1][0] <= SC_TOL:
        fail(f"{tag}: the check passes the planted duplicate drop: {fault}")


def single_card_phase(K, dev, kernel_rows):
    """The static cost model and the three single-card graphs (module
    docstring, phase 15). Returns ``[(path, dropout, launches)]``."""
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch.framework import cost_model
    from simple_tensorflow_tpu_torch.models import dlrm, long_context as lc
    from simple_tensorflow_tpu_torch.models import word2vec

    t0 = time.perf_counter()
    mutant = sm90_mutant_start()  # built while the phase runs
    card = card_line()
    recompute_auto_report(stf, card)
    cfg = lc.LongContextConfig()
    groups = lc_groups(stf, lc, cfg, stf.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    print(f"long-context kernels at LongContextConfig() (d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.d_model // cfg.num_heads}, "
          f"vocab {cfg.vocab_size}), seq {LC_S}, bf16; Adam groups "
          f"{groups}:", flush=True)
    try:
        kernel_rows.update(lc_kernel_rows(K, gen, dev, cfg, groups, 3e-4,
                                          mutant))
    finally:
        for proc in mutant[2]:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(mutant[0], ignore_errors=True)
    torch.cuda.empty_cache()
    paths = []
    for dtype in (stf.float32, stf.bfloat16):
        paths.append((f"long_context check {dtype.name}", 0.0,
                      check_lc_plain(K, stf, lc, dtype)))
        torch.cuda.empty_cache()
    # the full cell: LongContextConfig(), batch 1, seq 32768, bf16
    g = stf.Graph()
    with g.as_default():
        m = lc_build(lc, cfg, LC_S, stf.bfloat16)()
        est = cost_model.estimate([m["loss"], m["train_op"]],
                                  feeds=[m["input_ids"], m["targets"]])
    print(f"{card}: long_context[bf16 1x{LC_S}] the cost model: "
          f"{est.summary()}, resident {est.resident_bytes / GIB:.3f} GiB, "
          f"peak {est.peak_bytes / GIB:.3f} GiB (its liveness sweep of the "
          f"op list; autograd keeps what the backward needs, not counted "
          "there)", flush=True)
    del g, m
    tag = f"long_context[bf16 1x{LC_S}]"
    per = lc_per_step(cfg, len(groups))
    _, counts = graph_vs_eager(
        K, stf, f"{tag} graph", lc_build(lc, cfg, LC_S, stf.bfloat16),
        lambda m: [m["loss"], m["train_op"]],
        lambda m, i: lc_feeds(lc, cfg, m, LC_S), SC_GRAPH_STEPS)
    want = {k: 0 for k in counts}
    want.update({k: v * SC_GRAPH_STEPS for k, v in per.items()})
    if counts != want:
        fail(f"{tag} graph: launches {counts}, expected {want}")
    paths.append(("long_context graph", 0.0, counts))
    hd = cfg.d_model // cfg.num_heads
    attn = cfg.num_layers * cfg.num_heads * (LC_S * (LC_S + 1) // 2) * \
        (4 + 10) * hd
    p50, counts, _, sess, _ = sc_windows(
        K, stf, tag, lc_build(lc, cfg, LC_S, stf.bfloat16),
        lambda m: [m["loss"], m["train_op"]],
        lambda m: lc_feeds(lc, cfg, m, LC_S), LC_S, "tokens",
        fwd_fetch=lambda m: m["loss"], attn_flops=attn,
        want_kernels=[importlib.import_module(
            KMOD + "flash_attention").kernel_name(part, torch.bfloat16, hd)
            for part in ("fwd", "dkdv", "dq")])
    sess.close()
    torch.cuda.empty_cache()
    if any(counts.get(k, 0) < v * SC_WINDOWS * SC_WINDOW_N
           for k, v in per.items()):
        fail(f"{tag} windows: launches {counts} below {per} a step")
    paths.append(("long_context windows", 0.0, counts))
    lc_hook_check(stf, lc, cfg, card)
    torch.cuda.empty_cache()

    # word2vec at skipgram_model()'s defaults: no kernel on this path
    wtag = f"word2vec[f32 {W2V_B}, vocab 50000, 64 sampled]"
    wx, wy = word2vec.synthetic_skipgram_batch(W2V_B, seed=0)

    def w2v_feeds(m, i=0):
        return {m["train_inputs"]: wx, m["train_labels"]: wy}

    got, _ = graph_vs_eager(
        K, stf, f"{wtag} graph", word2vec.skipgram_model,
        lambda m: [m["loss"], m["train_op"], "LogUniformCandidateSampler:0"],
        w2v_feeds, SC_GRAPH_STEPS,
        fault=("the sampler's host key taken once", sampler_host_key_once))
    ids = [np.asarray(o[2]) for o in got]
    if any(np.array_equal(ids[i], ids[i + 1]) for i in range(len(ids) - 1)) \
            or any(len(np.unique(x)) != 64 for x in ids):
        fail(f"{wtag}: the sampled ids repeat across runs or within one")
    _, counts, _, sess, _ = sc_windows(
        K, stf, wtag, word2vec.skipgram_model,
        lambda m: [m["loss"], m["train_op"]], w2v_feeds, W2V_B, "examples")
    sess.close()
    paths.append(("word2vec windows", 0.0, counts))

    # DLRM at dlrm_model()'s defaults on Zipf batches
    check_dlrm_reference(stf, dlrm)
    dtag = f"dlrm[f32 {DLRM_B}, tables (1000, 1000, 500, 200) x 16]"
    graph_vs_eager(K, stf, f"{dtag} graph", dlrm.dlrm_model,
                   lambda m: [m["loss"], m["train_op"], m["prediction"]],
                   lambda m, i: dlrm_feeds(dlrm, m, i), SC_GRAPH_STEPS)
    _, counts, _, sess, _ = sc_windows(
        K, stf, dtag, dlrm.dlrm_model, lambda m: [m["loss"], m["train_op"]],
        lambda m: dlrm_feeds(dlrm, m, 0), DLRM_B, "examples")
    sess.close()
    paths.append(("dlrm windows", 0.0, counts))
    torch.cuda.empty_cache()
    print(f"single-card phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def seeded_graph_vars(stf, build):
    """The trainable variables of ``build()`` in a new graph."""
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(1)
        build()
        return stf.trainable_variables()


def mem_txt(w):
    """A window's memory (:func:`bert_window`) as text."""
    return (f"peak device memory {w['peak_first_gib']:.3f} GiB over the "
            f"first two steps (warm-up, capture), {w['peak_gib']:.3f} GiB "
            f"over the rest, {w['held_gib']:.3f} GiB held between steps, "
            f"{w['reserved_gib']:.3f} GiB reserved (above the "
            f"{w['base_gib'][0]:.3f} GiB allocated and "
            f"{w['base_gib'][1]:.3f} GiB reserved before the Session)")


def demangled_kernel(sym, prefix):
    """``kernel<template args>`` of a mangled kernel symbol whose name
    starts with ``prefix``, else None."""
    # the kernel's name follows its length in the mangled symbol
    k = re.search(r"\d(" + prefix + r"(?:\w*?kernel)?)I(\w*?)EE", sym)
    if not k:
        return None
    targs = re.findall(r"L[ib](\d+)", k.group(2))
    if "__nv_bfloat16" in k.group(2):
        targs.insert(0, "bf16")
    elif k.group(2).startswith("f"):
        targs.insert(0, "f32")
    return f"{k.group(1)}<{', '.join(targs)}>"


def kernel_props(log, prefix):
    """``[(kernel<template args>, "N registers, M bytes static shared
    memory; spill stores/loads")]`` of the kernels whose name starts with
    ``prefix``, from ``ptxas -v``."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = demangled_kernel(m.group(1), prefix)
            spill = None
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append((name, f"{regs} registers, "
                              f"{smem.group(1) if smem else 0} bytes static "
                              f"shared memory; {spill}"))
            name = None
    return out


def f32_fwd_smem_lines():
    """The dynamic shared memory of the f32 flash forward at the shapes its
    paths run (csrc/flash_fwd_f32.cu ``f32_smem_floats``: q, then K and V
    in one or two stages, then p, rows padded by 4 floats), which ``ptxas
    -v`` does not see."""
    fa = importlib.import_module(KMOD + "flash_attention")
    out = []
    for what, bh, s, d, causal in (
            ("prefill batch 1", 16, 64, 64, False),
            ("prefill batch 4", 64, 64, 64, False),
            ("prefill batch 16", 256, 64, 64, False),
            ("the f32 checks", 256, 256, 64, True),
            ("the long-context f32 check", 8, 2048, 128, True)):
        bq, tm = fa.fwd_tile_f32(bh, s, causal)
        bk = 32 if d == 128 else 64
        stages = 2 if s > bk else 1
        floats = bq * (d + 4) + 2 * stages * bk * (d + 4) + bq * (bk + 4)
        out.append(f"flash_fwd_kernel<{d}, {bq}, {tm}> at {what} (BH {bh}, "
                   f"S {s}): {4 * floats} bytes of dynamic shared memory, "
                   f"{stages} K/V stage{'s' if stages > 1 else ''}")
    return out


def f32_bwd_smem_lines():
    """The f32 dK/dV's and dQ's tile and dynamic shared memory at the
    shapes their paths run (csrc/flash_bwd_f32.cu ``bwd_smem_floats``: the
    block's two row tiles, the streamed pair in one or two stages, dS and,
    in dK/dV, p'; rows padded by 4 or 8 floats)."""
    fa = importlib.import_module(KMOD + "flash_attention")
    out = []
    for what, bh, s, d in (("the f32 checks", 256, 256, 64),
                           ("the long-context f32 check", 8, 2048, 128),
                           ("the transformer f32 check", 128, 64, 64)):
        for part in ("dkdv", "dq"):
            rows, cols = fa.bwd_tile_f32(part, bh, s, d)
            stages = 2 if s > cols else 1
            floats = (2 * rows * (d + 4) + 2 * stages * cols * (d + 4)
                      + (2 if part == "dkdv" else 1) * rows * (cols + 8))
            out.append(f"flash_{part}_f32_kernel<{d}, {rows // 16}> at "
                       f"{what} (BH {bh}, S {s}): {rows} rows a block, "
                       f"{4 * floats} bytes of dynamic shared memory, "
                       f"{stages} stage{'s' if stages > 1 else ''}")
    return out


# kernels the serving traces must show: the Kq = 1 DecodeAttention and the
# LayerNorm forward on its vector path
SERVING_KERNELS = ("decode_one_kernel", "layer_norm_fwd_vec_kernel")


# -- encoder-decoder serving phase (phase 16) ------------------------------------

S2S_SRC, S2S_SLOTS, S2S_DECODE_LEN = 64, 16, 128
S2S_REQUESTS = 24
S2S_ONE_SLOT_REQUESTS = 8       # the 1-slot runs serve the first 8
S2S_SPEC_K, S2S_DRAFT_STEPS = 4, 3
S2S_FAULT_REQUESTS, S2S_FAULT_NEW = 4, 16
# the f32 plain arm at 16 slots before the f32 flash forward's redesign:
# this phase's p50 prefill and time to first token on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §5)
EARLIER_S2S_MS = {"prefill": 0.6579, "ttft": 11.7897}


class Lent:
    """A model lent to one engine, whose ``close`` (the engine's, as it
    closes) leaves the model to the phase; ``admitted`` holds the rows of
    each prefill the engine asked of it."""

    def __init__(self, model):
        self._model = model
        self.admitted = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, src_rows, slots):
        self.admitted.append(len(slots))
        return self._model.prefill(src_rows, slots)

    def close(self):
        pass


class ProposalTap(Lent):
    """A draft that keeps its last proposals (for ``BonusFromDraft``)."""

    def decode_k(self, tokens, positions, slots):
        props, bucket = self._model.decode_k(tokens, positions, slots)
        self.last = props
        return props, bucket


class BonusFromDraft(Lent):
    """A planted fault: the target's pick at the first rejected position
    (the bonus token) replaced by the draft's proposal there."""

    def __init__(self, model, tap):
        super().__init__(model)
        self._tap = tap

    def verify(self, tok_blocks, positions, slots):
        toks, lps, bucket = self._model.verify(tok_blocks, positions, slots)
        toks, props = toks.copy(), self._tap.last
        for i in range(len(toks)):
            a = 0
            while a < props.shape[1] and props[i, a] == toks[i, a]:
                a += 1
            if a < props.shape[1]:
                toks[i, a] = props[i, a]
        return toks, lps, bucket


def s2s_requests(vocab, seed=11):
    """24 sources of 8-64 real tokens (the engine pads each to 64) and
    budgets staggered from 8 to 120 new tokens, so slots retire and
    refill."""
    rng = np.random.RandomState(seed)
    lens = np.linspace(8, S2S_SRC, S2S_REQUESTS).astype(int)
    rng.shuffle(lens)
    sources = [list(rng.randint(2, vocab, n)) for n in lens]
    budgets = [int(x) for x in np.linspace(8, 120, S2S_REQUESTS)]
    return sources, budgets


def s2s_errors(model, sources, results, int8):
    """``stream_errors`` of every request against the encoder-decoder's
    plain re-forward on the card, teacher-forced on the engine's stream
    (decoder inputs: EOS, then the emitted tokens). Returns ``(requests
    that break the rule, max log-prob error)``."""
    from simple_tensorflow_tpu_torch.models import transformer as tr

    cfg = model.cfg
    bad, worst = [], 0.0
    for i, (src, r) in enumerate(zip(sources, results)):
        toks = [int(t) for t in r["tokens"]]
        row = torch.full((1, S2S_SRC), cfg.pad_id, dtype=torch.long,
                         device=model.device)
        row[0, :len(src)] = torch.tensor(src)
        tgt_in = torch.tensor([[cfg.eos_id] + toks[:-1]], dtype=torch.long,
                              device=model.device)
        h = tr.seq2seq_hidden_plain(model.stack, row, tgt_in)[0]
        bad_arg, bad_lp, err = stream_errors(h, model, r, int8)
        worst = max(worst, err)
        if bad_arg or bad_lp:
            bad.append((i, bad_arg[:4], bad_lp[:4]))
    return bad, worst


def s2s_launch_check(tag, counts, steps, prefills, draft_layers, int8,
                     layers):
    """The launches of one run of ``steps`` engine steps and ``prefills``
    prefill bucket runs, exactly: a decode step 2L one-query
    DecodeAttention (self and cross) and 3L LayerNorms (+ 1 QuantMatMul
    with int8); a verify 2L query-block DecodeAttention and 3L LayerNorms
    (+ 1); a draft call ``draft_steps`` decode steps of the draft's
    layers; a prefill L flash forwards and 2L LayerNorms for the target
    (and the draft's layers for the draft)."""
    da, blk = counts["decode_attention"], counts["decode_attention_block"]
    ln, fl = counts["layer_norm"], counts["flash_attention_fwd"]
    qmm = counts["quant_matmul"]
    per_prefill = layers + (draft_layers or 0)
    if draft_layers is None:
        want = {"decode_attention": 2 * layers * steps,
                "decode_attention_block": 0,
                "layer_norm": 3 * layers * steps + 2 * layers * prefills,
                "quant_matmul": steps if int8 else 0}
    else:
        kd = S2S_DRAFT_STEPS
        want = {"decode_attention": 2 * draft_layers * kd * steps,
                "decode_attention_block": 2 * layers * steps,
                "layer_norm": (3 * layers + 3 * draft_layers * kd) * steps
                + 2 * per_prefill * prefills,
                "quant_matmul": (1 + kd) * steps if int8 else 0}
    want["flash_attention_fwd"] = per_prefill * prefills
    got = {"decode_attention": da, "decode_attention_block": blk,
           "layer_norm": ln, "quant_matmul": qmm, "flash_attention_fwd": fl}
    if not prefills or got != want:
        fail(f"{tag}: launches {got} do not match {steps} steps and "
             f"{prefills} prefill runs: expected {want}")


def s2s_serve(K, tag, target, sources, budgets, slots, draft=None,
              draft_layers=None, trace=False, check=True):
    """Serve ``sources`` with ``budgets`` through ``GenerativeEngine`` at
    ``slots`` slots (``draft``: speculative). Launch counters are zeroed
    just before the requests and read just after. Returns ``(results,
    launches, numbers)``; with ``check``, the launches are held to the
    run's steps and every token to the plain re-forward."""
    from simple_tensorflow_tpu_torch import serving

    buckets = [b for b in (1, 4, 16) if b <= slots]
    policy = serving.DecodePolicy(num_slots=slots,
                                  max_decode_len=S2S_DECODE_LEN,
                                  bucket_sizes=buckets, max_new_tokens=120)
    first = [None] * len(sources)

    def on_token(i):
        def cb(tok, lp):
            if first[i] is None:
                first[i] = time.perf_counter()
        return cb

    lent = None if draft is None else (
        draft if isinstance(draft, Lent) else Lent(draft))
    tgt = target if isinstance(target, Lent) else Lent(target)
    with serving.GenerativeEngine(f"s2s_{tag}", tgt, policy,
                                  draft=lent) as eng:
        # warm-up: one unrelated request
        eng.generate(list(range(2, 12)), max_new_tokens=4).result(600)
        torch.cuda.synchronize()
        met = eng.metrics
        steps0, n0, p0 = met.steps, len(met.step_seconds), \
            len(met.prefill_seconds)
        a0 = len(tgt.admitted)
        spec0 = (met.spec_proposed, met.spec_accepted)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [eng.generate(s, max_new_tokens=b, on_token=on_token(i))
                for i, (s, b) in enumerate(zip(sources, budgets))]
        results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        steps = met.steps - steps0
        step_s = list(met.step_seconds)[n0:]
        prefill_s = list(met.prefill_seconds)[p0:]
        admitted = tgt.admitted[a0:]
        proposed = met.spec_proposed - spec0[0]
        accepted = met.spec_accepted - spec0[1]
        traced = (trace_decode(eng, target.cfg.vocab_size, f"s2s {tag}",
                               SERVING_KERNELS) if trace else None)
    emitted = sum(len(r["tokens"]) for r in results)
    stats = {"tokens_s": emitted / wall, "tokens": emitted, "steps": steps,
             "p50_ms": statistics.median(step_s) * 1e3,
             "ttft_ms": statistics.median(f - t0 for f in first
                                          if f is not None) * 1e3,
             "prefill_ms": statistics.median(prefill_s) * 1e3,
             "acceptance": accepted / proposed if proposed else None,
             "traced": traced}
    if not check:
        return results, counts, stats
    # the prefill runs the engine made: each of its admissions (one
    # prefill time each) covers its rows with the model's prefill buckets,
    # the largest first; the draft prefills what the target does
    if len(admitted) != len(prefill_s) or (
            lent is not None and lent.admitted[-len(admitted):] != admitted):
        fail(f"s2s {tag}: {len(prefill_s)} admissions timed, prefills of "
             f"{admitted} rows asked of the target and "
             f"{None if lent is None else lent.admitted} of the draft")
    largest = target.prefill_buckets[-1]
    prefills = sum(-(-n // largest) for n in admitted)
    s2s_launch_check(tag, counts, steps, prefills, draft_layers, target.int8,
                     target.cfg.num_layers)
    for r in results:
        if r["outcome"] not in ("eos", "length") or not len(r["tokens"]) \
                or not np.all(np.isfinite(r["logprobs"])):
            fail(f"s2s {tag}: bad result {r}")
    bad, worst = s2s_errors(target, sources, results, target.int8)
    if bad:
        fail(f"s2s {tag}: token streams off the plain re-forward "
             f"(request, steps not argmax, steps logp off): {bad[:4]}")
    acc = ("" if stats["acceptance"] is None else
           f", acceptance {stats['acceptance']:.4f} ({accepted} of "
           f"{proposed} proposals)")
    print(f"s2s[{tag}]: {len(results)} requests at {slots} slots, {emitted} "
          f"tokens in {wall:.4f} s = {stats['tokens_s']:.2f} tokens/s, "
          f"{steps} engine steps (p50 {stats['p50_ms']:.4f} ms), p50 time to"
          f" first token {stats['ttft_ms']:.4f} ms, p50 prefill "
          f"{stats['prefill_ms']:.4f} ms ({prefills} prefill runs){acc}; "
          f"every token within the rule (max logp err {worst:.3e}); "
          f"launches {dict((k, v) for k, v in counts.items() if v)}",
          flush=True)
    return results, counts, stats


def equal_tokens(a, b):
    """Tokens of streams ``a`` equal to ``b``'s, request by request, up
    to their first difference; and the tokens of ``a``."""
    same = total = 0
    for x, y in zip(a, b):
        total += len(x["tokens"])
        for p, q in zip(x["tokens"], y["tokens"]):
            if p != q:
                break
            same += 1
    return same, total


def s2s_kernel_rows(K, rng, dev, mutant):
    """The kernels at this path's shapes (f32, 16 heads of 64,
    ``S2S_DECODE_LEN`` self positions, ``S2S_SRC`` source positions with
    a pad bias), each against its plain version with its bound and one
    SDPA call with the same mask: the one-query kernel on the slot cache
    at B = 1, 4, 16; cross-attention with the bias at B = 1, 4, 16; the
    query block of ``S2S_SPEC_K`` with ``causal_offset`` and with the bias
    and no offset at B = 1, 4, 16; the f32 flash forward at the encoder's
    (B x 16, 64, 64), B = 1, 4, 16, and the bf16 one at B = 4, with the pad
    bias, non-causal, where the planted faults of the f32 forward (the
    handle of ``f32_mutant_start``) must fail at B = 4."""
    import torch.nn.functional as F

    H, D = 16, 64
    main = {}
    for kq in (1, S2S_SPEC_K):
        for role, L in (("self", S2S_DECODE_LEN), ("cross", S2S_SRC)):
            for b in (1, 4, 16):
                causal = role == "self" and kq > 1
                qshape = (b, H, D) if kq == 1 else (b, kq, H, D)
                if role == "self":
                    lens = rng.randint(1, L - kq + 1, size=b)
                    lens[0] = L - kq
                    bias = None
                else:
                    lens = np.full(b, L)
                    real = rng.randint(8, L + 1, size=b)
                    real[0] = 8
                    bias = torch.from_numpy(
                        (np.arange(L)[None, :] >= real[:, None]).astype(
                            np.float32) * -1e9).to(dev)
                lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
                per_call = (2 * b * L * H * D + 2 * int(np.prod(qshape))) * 4
                copies = [tuple(torch.from_numpy(rng.standard_normal(
                    shape).astype(np.float32)).to(dev)
                    for shape in (qshape, (b, L, H, D), (b, L, H, D)))
                    for _ in range(n_copies(per_call))]
                kw = dict(bias=bias, causal_offset=causal)
                q, k, v = copies[0]
                err = check_close(f"s2s decode {role} B={b} Kq={kq}",
                                  K.decode_attention(q, k, v, lengths, **kw),
                                  K.decode_attention_plain(q, k, v, lengths,
                                                           **kw),
                                  torch.float32)
                span = torch.arange(L, device=dev).view(1, 1, L)
                allowed = lengths.view(b, 1, 1).long()
                if causal:
                    allowed = allowed + 1 + torch.arange(
                        kq, device=dev).view(1, kq, 1)
                add = torch.where(span < allowed, 0.0, float("-inf"))
                if bias is not None:
                    add = add + bias.view(b, 1, L)
                add = add.expand(b, kq, L).reshape(b, 1, kq, L)

                def lib(c):
                    qv = (c[0].view(b, 1, H, D) if kq == 1
                          else c[0]).transpose(1, 2)
                    return lambda: F.scaled_dot_product_attention(
                        qv, c[1].transpose(1, 2), c[2].transpose(1, 2),
                        attn_mask=add)

                ms = device_ms([lambda c=c: K.decode_attention(
                    *c, lengths, **kw) for c in copies])
                plain_ms = device_ms([lambda c=c: K.decode_attention_plain(
                    *c, lengths, **kw) for c in copies])
                lib_ms = device_ms([lib(c) for c in copies])
                # this run's lengths: each query reads its allowed positions
                reach = np.minimum(lens + (kq if causal else 0), L)
                allowed_pos = sum(min(int(n) + (j + 1 if causal else 0), L)
                                  for n in lens for j in range(kq))
                moved = (int(reach.sum()) * H * D * 2 * 4
                         + 2 * int(np.prod(qshape)) * 4 + b * 4
                         + (b * L * 4 if bias is not None else 0))
                bnd = bound_ms(moved, 4 * allowed_pos * H * D, torch.float32)
                kind = "decode_attention" + ("" if kq == 1 else "_block")
                name = (f"{kind} f32 B={b} Kq={kq} L={L} {role}"
                        f"{' causal' if causal else ''}"
                        f"{' bias' if bias is not None else ''} (s2s)")
                report(name, err, ms, plain_ms, bnd, lib_ms)
                if b == 16:
                    main[f"{kind}@s2s_{role}"] = kernel_row(
                        err, ms, plain_ms, bnd, lib_ms, name)
    s = S2S_SRC
    # the encoder's flash forward at the prefill buckets' head counts: f32
    # at batch 1, 4 and 16 (16, 64 and 256 heads: 16, 32 and 64 query rows
    # a block, 2, 2 and 4 a thread), bf16 at 4
    for dtype, B in ((torch.float32, 1), (torch.float32, 4),
                     (torch.float32, 16), (torch.bfloat16, 4)):
        bh = B * H
        elem = elem_size(dtype)
        copies = [tuple(torch.from_numpy(rng.standard_normal(
            (bh, s, D)).astype(np.float32)).to(dev, dtype) for _ in range(3))
            for _ in range(n_copies(3 * bh * s * D * elem))]
        pads = np.zeros((B, s), np.float32)
        # real lengths 64, 40, 8, 0 (the last row all padding) in turn
        for i, n in enumerate((40,) if B == 1 else (64, 40, 8, 0) * (B // 4)):
            pads[i, n:] = 1.0
        bias = torch.from_numpy(pads * -1e9).to(dev)
        args = dict(heads=H, sm_scale=D ** -0.5, causal=False, bias=bias)
        q, k, v = copies[0]
        o, lse = K.flash_attention_fwd(q, k, v, **args)
        ro, rlse = K.flash_attention_fwd_plain(q, k, v, **args)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        tag = (f"flash_attention_fwd {str(dtype)[6:]} BH={bh} S={s} D={D} "
               f"pad bias{', one row all padding' if B > 1 else ''} "
               "(s2s encoder)")
        if not torch.isfinite(o).all():
            fail(f"{tag}: non-finite output")
        tol = 1e-5 if f32 else 2e-2
        err = max(check_scaled(f"{tag} o", o, ro, tol),
                  check_scaled(f"{tag} lse", lse, rlse, 1e-5))
        if f32 and B == 4:
            s2s_f32_faults(K, mutant, q, k, v, bias, ro, rlse, tag)
        ms = device_ms([lambda c=c: K.flash_attention_fwd(*c, **args)
                        for c in copies])
        plain_ms = device_ms([lambda c=c: K.flash_attention_fwd_plain(
            *c, **args) for c in copies])
        mask = bias.view(B, 1, 1, s).to(dtype)
        lib_ms = device_ms([lambda c=c: F.scaled_dot_product_attention(
            *(t.view(B, H, s, D) for t in c), attn_mask=mask)
            for c in copies])
        io = bh * s * D * elem
        bnd = bound_ms(4 * io + bh * s * 4 + B * s * 4, 4 * D * bh * s * s,
                       dtype)
        report(tag, err, ms, plain_ms, bnd, lib_ms)
        if f32:
            print(f"  {tag}: {ms / lib_ms:.3f}x SDPA f32 with the same mask",
                  flush=True)
            key = "flash_attention_fwd@s2s_encoder" + (
                "" if B == 4 else f"_bh{bh}")
            main[key] = kernel_row(err, ms, plain_ms, bnd, lib_ms, tag)
        del copies, o, lse, ro, rlse
    return main


def s2s_f32_faults(K, handle, q, k, v, bias, ro, rlse, tag):
    """The planted faults of ``F32_MUTANTS`` (the f32 forward built from a
    copy of its source with the block's last 4-query sub-tile left
    unstored, or the bias dropped) at the encoder prefill's inputs: each
    must fail the limits the kernel is held to (o and lse 1e-5 scaled)."""
    lib = f32_mutant_lib(handle)
    bh, s, D = q.shape
    txt = []
    for i, (what, src, *_) in enumerate(F32_MUTANTS):
        if src != "flash_fwd_f32.cu":
            continue
        o, lse = torch.zeros_like(q), torch.zeros_like(rlse)
        rc = getattr(lib, f"stf_mutant_{i}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, s, bh // bias.shape[0], D,
            D ** -0.5, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if rc:
            fail(f"planted f32 fault ({what}): the launch returned {rc}")
        err_o = (o - ro).abs().max().item()
        err_l = (lse - rlse).abs().max().item()
        passes = (err_o <= 1e-5 * max(1.0, ro.abs().max().item()) and
                  err_l <= 1e-5 * max(1.0, rlse.abs().max().item()))
        if passes:
            fail(f"{tag}: the check passes the planted fault ({what})")
        txt.append(f"{what}: o off by {err_o:.3e}, lse by {err_l:.3e}")
    print(f"  planted faults in the f32 forward ({tag}): " + "; ".join(txt),
          flush=True)


def s2s_faults(K, tr, cfg, params, target, self_draft, small, sources,
               dev):
    """The three planted faults, each of which the token check must fail:
    verify's self-attention without ``causal_offset`` and the cross bias
    dropped (a target dispatched eagerly, so the planted function runs),
    and the bonus token taken from the one-layer draft's proposal."""
    src = sources[:S2S_FAULT_REQUESTS]
    bud = [S2S_FAULT_NEW] * len(src)
    eager = tr.TransformerGenerativeModel(
        cfg, S2S_SRC, num_slots=S2S_SLOTS, max_decode_len=S2S_DECODE_LEN,
        decode_bucket_sizes=[1, 4, 16], prefill_bucket_sizes=[1, 4],
        params=params, speculative_k=S2S_SPEC_K, aot_warmup=False,
        device=dev)

    def no_offset(f):
        return lambda q, k, v, lengths, **kw: f(
            q, k, v, lengths, **{**kw, "causal_offset": False})

    def no_bias(f):
        return lambda q, k, v, lengths, bias=None, **kw: f(q, k, v, lengths,
                                                            **kw)

    runs = []
    with planted(tr, "decode_attention", no_offset):
        out, _, _ = s2s_serve(K, "fault no causal_offset", eager, src, bud,
                              S2S_SLOTS, draft=self_draft, check=False)
    runs.append(("verify without causal_offset", out))
    with planted(tr, "decode_attention", no_bias):
        out, _, _ = s2s_serve(K, "fault no cross bias", eager, src, bud,
                              S2S_SLOTS, check=False)
    runs.append(("cross bias dropped", out))
    tap = ProposalTap(small)
    out, _, _ = s2s_serve(K, "fault bonus from draft",
                          BonusFromDraft(target, tap), src, bud, S2S_SLOTS,
                          draft=tap, check=False)
    runs.append(("bonus token from the draft", out))
    eager.close()
    for what, out in runs:
        bad, _ = s2s_errors(target, src, out, False)
        print(f"s2s fault ({what}): {len(bad)} of {len(out)} requests "
              f"break the rule {bad[:2]}", flush=True)
        if not bad:
            fail(f"s2s: the planted fault ({what}) passes the token check")


def s2s_phase(K, dev, kernel_rows, f32_mutant=None):
    """Encoder-decoder serving (module docstring, phase 16). Returns
    ``[(path, dropout, launches)]``. ``f32_mutant``: the handle of
    ``f32_mutant_start`` (started here if not given)."""
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import transformer as tr

    t_phase = time.perf_counter()
    card = card_line()
    cfg = tr.TransformerConfig.big()
    small_cfg = dataclasses.replace(cfg, num_layers=1)
    if f32_mutant is None:
        f32_mutant = f32_mutant_start()
    kernel_rows.update(s2s_kernel_rows(K, np.random.RandomState(16), dev,
                                       f32_mutant))
    params = convert.init_seq2seq_params(cfg, seed=0)
    sources, budgets = s2s_requests(cfg.vocab_size)
    geo = dict(num_slots=S2S_SLOTS, max_decode_len=S2S_DECODE_LEN,
               decode_bucket_sizes=[1, 4, 16], prefill_bucket_sizes=[1, 4],
               device=dev)
    print(f"s2s: TransformerGenerativeModel(TransformerConfig.big(), src_len "
          f"{S2S_SRC}, {S2S_SLOTS} slots, max_decode_len {S2S_DECODE_LEN}, "
          f"decode buckets [1, 4, 16], prefill [1, 4], speculative_k "
          f"{S2S_SPEC_K}), random f32 weights (seed 0); drafts with "
          f"draft_steps {S2S_DRAFT_STEPS}: the target's weights, and one "
          f"layer from seed 1 (its table 1000x smaller); {S2S_REQUESTS} "
          f"sources of 8-64 tokens, "
          f"budgets 8-120 (1 slot: the first {S2S_ONE_SLOT_REQUESTS})",
          flush=True)
    t0 = time.perf_counter()
    target = tr.TransformerGenerativeModel(
        cfg, S2S_SRC, params=params, speculative_k=S2S_SPEC_K, **geo)
    self_draft = tr.TransformerGenerativeModel(
        cfg, S2S_SRC, params=params, draft_steps=S2S_DRAFT_STEPS, **geo)
    # random tied-embedding models echo their input token (the target
    # does): a one-layer draft drawn as the init draws it proposes what the
    # target picks (acceptance 0.94 on an H100). Its table drawn 1000x
    # smaller leaves the position in its residual stream, not the token:
    # it proposes a token of the position, which the target rejects
    small_params = convert.init_seq2seq_params(small_cfg, 1)
    small_params["shared_embedding"] *= 1e-3
    small = tr.TransformerGenerativeModel(
        small_cfg, S2S_SRC, params=small_params,
        draft_steps=S2S_DRAFT_STEPS, **geo)
    torch.cuda.synchronize()
    print(f"s2s: the target and the two drafts built, every bucket "
          f"captured, in {time.perf_counter() - t0:.3f} s", flush=True)
    paths, res, stats = [], {}, {}
    arms = (("plain", None, None), ("self-draft", self_draft, cfg.num_layers),
            ("one-layer draft", small, 1))
    for slots in (S2S_SLOTS, 1):
        n = len(sources) if slots > 1 else S2S_ONE_SLOT_REQUESTS
        for arm, draft, layers in arms:
            tag = f"f32 {arm}, {slots} slot{'s' if slots > 1 else ''}"
            res[arm, slots], counts, stats[arm, slots] = s2s_serve(
                K, tag, target, sources[:n], budgets[:n], slots,
                draft=draft, draft_layers=layers,
                trace=slots > 1 and draft is None)
            paths.append((f"s2s {tag}", 0.0, counts))
        plain = stats["plain", slots]
        for arm, _, _ in arms[1:]:
            same, total = equal_tokens(res[arm, slots], res["plain", slots])
            st = stats[arm, slots]
            print(f"{card}: s2s {arm} at {slots} slot(s): acceptance "
                  f"{st['acceptance']:.4f}, {st['tokens_s']:.2f} tokens/s "
                  f"against plain {plain['tokens_s']:.2f} "
                  f"({st['tokens_s'] / plain['tokens_s']:.3f}x); {same} of "
                  f"{total} tokens equal to the plain stream", flush=True)
    st = stats["plain", S2S_SLOTS]
    traced = ("not measured" if st["traced"] is None else
              f"device {st['traced'][0]:.4f} ms a decode step at bucket 16 "
              f"(host p50 {st['traced'][1]:.4f} ms in the traced window)")
    print(f"{card}: s2s f32 plain, {S2S_SLOTS} slots: {st['tokens_s']:.2f} "
          f"tokens/s over the mix, p50 decode step {st['p50_ms']:.4f} ms, "
          f"p50 time to first token {st['ttft_ms']:.4f} ms, p50 prefill "
          f"{st['prefill_ms']:.4f} ms; {traced}", flush=True)
    print(f"{card}: s2s f32 plain, {S2S_SLOTS} slots, before the f32 "
          f"forward's redesign: p50 prefill {EARLIER_S2S_MS['prefill']:.4f} "
          f"ms, now {st['prefill_ms']:.4f} "
          f"({st['prefill_ms'] / EARLIER_S2S_MS['prefill']:.3f}x); p50 time "
          f"to first token {EARLIER_S2S_MS['ttft']:.4f} ms, now "
          f"{st['ttft_ms']:.4f} "
          f"({st['ttft_ms'] / EARLIER_S2S_MS['ttft']:.3f}x)", flush=True)
    s2s_faults(K, tr, cfg, params, target, self_draft, small, sources, dev)
    for m in (self_draft, small):
        m.close()
    target.close()
    del target, self_draft, small
    torch.cuda.empty_cache()
    # the int8 head, plain and with its self-draft (verify's QuantMatMul at
    # m = bucket x speculative_k, up to 64)
    target = tr.TransformerGenerativeModel(
        cfg, S2S_SRC, params=params, speculative_k=S2S_SPEC_K, int8=True,
        **geo)
    draft = tr.TransformerGenerativeModel(
        cfg, S2S_SRC, params=params, draft_steps=S2S_DRAFT_STEPS, int8=True,
        **geo)
    for arm, d, layers in (("plain", None, None),
                           ("self-draft", draft, cfg.num_layers)):
        tag = f"int8 {arm}, {S2S_SLOTS} slots"
        _, counts, _ = s2s_serve(K, tag, target, sources, budgets,
                                 S2S_SLOTS, draft=d, draft_layers=layers)
        paths.append((f"s2s {tag}", 0.0, counts))
    target.close()
    draft.close()
    del target, draft
    torch.cuda.empty_cache()
    print(f"s2s: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


# a hang (a kernel or a capture that never returns) dumps every thread's
# stack and exits non-zero this long after the start, inside the 1200 s
# the run is given
HANG_DUMP_S = 1140


def main():
    smoke_t0 = time.perf_counter()
    faulthandler.dump_traceback_later(HANG_DUMP_S, exit=True)
    serving_only = sys.argv[1:] == ["--serving"]
    lc_only = sys.argv[1:] == ["--lc-attribution"]
    s2s_only = sys.argv[1:] == ["--seq2seq"]
    if sys.argv[1:] and not (serving_only or lc_only or s2s_only):
        fail(f"usage: {sys.argv[0]} [--serving | --lc-attribution | "
             "--seq2seq]")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures "
             "the port on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from simple_tensorflow_tpu_torch import convert
    from simple_tensorflow_tpu_torch.models import transformer as tr
    from simple_tensorflow_tpu_torch.models.common import resolve_device
    from simple_tensorflow_tpu_torch.ops import kernels as K
    from simple_tensorflow_tpu_torch.ops.kernels import _build

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built from {SRC} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # the nvcc log of this build, or of the one that made the library
    build_log = _build.build_log or (_build.BUILD_DIR / "build.log"
                                     ).read_text()
    spills, entry = [], ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill" \
                not in ln:
            spills.append(f"{entry}: {ln.strip()}")
    print(f"  ptxas: {len(spills)} kernels spill registers {spills}",
          flush=True)
    for prefix in ("flash_fwd_mma", "flash_bwd_", "flash_fwd_sm90",
                   "flash_dkdv_sm90", "flash_dq_sm90", "flash_fwd_kernel",
                   "flash_dkdv_f32", "flash_dq_f32", "xent_fwd", "qmm_",
                   "layer_norm_", "decode_one", "dropout"):
        for name, props in kernel_props(build_log, prefix):
            print(f"  ptxas {name}: {props}", flush=True)
    for line in f32_fwd_smem_lines() + f32_bwd_smem_lines():
        print(f"  {line}", flush=True)

    cfg = tr.TransformerConfig.big()
    if serving_only:
        # the serving phase alone, of whichever tree's package sits beside
        # this script: its traces ask for no kernel by name
        params = convert.init_params(cfg, seed=0)
        for int8 in (False, True):
            serve(params, cfg, int8, make_prompts(cfg.vocab_size), dev, ())[0]
        print("chip_smoke: the serving phase passed (--serving)", flush=True)
        return
    if lc_only:
        import simple_tensorflow_tpu_torch as stf
        from simple_tensorflow_tpu_torch.models import long_context as lc
        check_lc_plain(K, stf, lc, stf.bfloat16, attribution=True)
        print("chip_smoke: the long-context bf16 check passed "
              "(--lc-attribution)", flush=True)
        return
    if s2s_only:
        print(f"chip_smoke: phase 16 launches "
              f"{s2s_phase(K, dev, {})}", flush=True)
        print("chip_smoke: the encoder-decoder serving phase passed "
              "(--seq2seq)", flush=True)
        return
    def mark(what):  # where the smoke's time goes, phase by phase
        print(f"chip_smoke: {what} ended at "
              f"{time.perf_counter() - smoke_t0:.1f} s", flush=True)

    mark("the build")
    # the f32 forward's planted faults (phase 16), built while phases run
    f32_mutant = f32_mutant_start()
    rng = np.random.RandomState(0)
    print("kernel phases (times are per call, on the card):", flush=True)
    main_rows = {}
    main_rows.update(phase_decode_attention(K, rng, dev))
    main_rows.update(phase_layer_norm(K, rng, dev))
    main_rows.update(phase_quant_matmul(K, rng, dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    main_rows.update(phase_flash_attention(K, gen, dev))
    main_rows.update(phase_flash_f32_bwd(K, gen, dev, f32_mutant))
    main_rows.update(phase_dropout_residual(K, gen, dev))
    main_rows.update(phase_dropout(K, gen, dev))
    main_rows.update(phase_layer_norm_bwd(K, gen, dev))
    main_rows.update(phase_softmax_xent(K, gen, dev))
    main_rows.update(phase_adam(K, gen, dev, cfg))
    main_rows.update(phase_momentum(K, gen, dev))
    torch.cuda.empty_cache()
    mark("the kernel phases")

    params = convert.init_params(cfg, seed=0)
    prompts = make_prompts(cfg.vocab_size)
    # (path, dropout rate, launches counted from zero around it)
    paths, stats = [], {}
    for int8 in (False, True):
        counts, stats[int8] = serve(params, cfg, int8, prompts, dev,
                                    SERVING_KERNELS)
        paths.append((f"serve {'int8' if int8 else 'f32'}", 0.0, counts))
    check_serving_graphs(params, cfg, dev)
    counts, eager = serve(params, cfg, False, prompts, dev, SERVING_KERNELS,
                          aot=False)
    paths.append(("serve f32 eager", 0.0, counts))
    g = stats[False]
    print(f"serving[f32] graph vs eager: tokens/s {g['tokens_s']:.2f} vs "
          f"{eager['tokens_s']:.2f}, p50 decode step {g['p50_ms']:.4f} vs "
          f"{eager['p50_ms']:.4f} ms, p50 time to first token "
          f"{g['ttft_ms']:.4f} vs {eager['ttft_ms']:.4f} ms; bucket-16 "
          f"traced (device ms, host p50 ms) a decode step {g['traced']} vs "
          f"{eager['traced']}", flush=True)
    torch.cuda.empty_cache()
    mark("serving")
    notes = {}
    paths += train_phase(K, cfg, params, dev, main_rows, notes)
    del params
    torch.cuda.empty_cache()
    mark("training")
    paths += resnet_phase(K, dev, notes)
    torch.cuda.empty_cache()
    mark("resnet")
    paths += session_phase(K, dev, main_rows)
    torch.cuda.empty_cache()
    mark("session")
    paths += transformer_session_phase(K, dev, main_rows)
    torch.cuda.empty_cache()
    mark("transformer session")
    paths += loop_phase(K, dev)
    torch.cuda.empty_cache()
    mark("loop")
    paths += lm_session_phase(K, dev, main_rows, notes)
    torch.cuda.empty_cache()
    mark("causal-lm session")
    paths += resnet_session_phase(K, dev, main_rows, notes)
    torch.cuda.empty_cache()
    mark("resnet session")
    paths += bert_phase(K, dev, main_rows)
    torch.cuda.empty_cache()
    mark("bert")
    paths += rnn_phase(K, dev, main_rows)
    torch.cuda.empty_cache()
    mark("rnn")
    paths += beam_phase(K, dev, main_rows)
    torch.cuda.empty_cache()
    mark("beam")
    paths += data_phase(K, dev)
    torch.cuda.empty_cache()
    mark("data")
    paths += ckpt_numerics_phase(K, dev, main_rows)
    torch.cuda.empty_cache()
    mark("checkpoint")
    paths += single_card_phase(K, dev, main_rows)
    mark("single-card")
    paths += s2s_phase(K, dev, main_rows, f32_mutant)
    mark("seq2seq serving")
    # rows of a kernel at a Session path's own shape: (source, TPU kernel,
    # the row's counter, the general row's counter, the paths whose
    # launches the row takes from the general row)
    session_where = {
        f"flash_attention_{part}_device_seed@causal_lm": (
            src, tpu, f"flash_attention_{part}_device_seed",
            f"flash_attention_{part}_device_seed", "lm session bf16")
        for part, src, tpu in (
            ("fwd", "flash_fwd_mma.cu", "flash_attention.py:141"),
            ("dkdv", "flash_bwd_mma.cu", "flash_attention.py:244"),
            ("dq", "flash_bwd_mma.cu", "flash_attention.py:297"))}
    session_where.update({
        # each of the two groups counted under its own dtype's counter
        f"momentum_update@session_{g}": (
            "fused_update.cu", "fused_update.py:135",
            f"momentum_update_{g}", "momentum_update", "resnet session bf16")
        for g in RESNET_GROUPS[torch.bfloat16]})
    session_where.update({
        "softmax_xent_fwd@resnet_session": (
            "softmax_xent.cu", "softmax_xent.py:32", "softmax_xent_fwd",
            "softmax_xent_fwd", "resnet session bf16"),
        "softmax_xent_bwd@resnet_session": (
            "softmax_xent.cu", "softmax_xent.py:78", "softmax_xent_bwd",
            "softmax_xent_bwd", "resnet session bf16")})
    # BERT's rows: its shipped-config paths (those named "bert ...")
    session_where.update({
        f"{name}@bert": (src, tpu, name, name, "bert")
        for name, src, tpu in (
            ("flash_attention_fwd", "flash_fwd_mma.cu",
             "flash_attention.py:141"),
            ("flash_attention_dkdv", "flash_bwd_mma.cu",
             "flash_attention.py:244"),
            ("flash_attention_dq", "flash_bwd_mma.cu",
             "flash_attention.py:297"),
            ("flash_attention_fwd_device_seed", "flash_fwd_mma.cu",
             "flash_attention.py:141"),
            ("flash_attention_dkdv_device_seed", "flash_bwd_mma.cu",
             "flash_attention.py:244"),
            ("flash_attention_dq_device_seed", "flash_bwd_mma.cu",
             "flash_attention.py:297"),
            ("layer_norm", "layer_norm.cu", "layer_norm.py:29"),
            ("layer_norm_bwd", "layer_norm.cu", "layer_norm.py:42"),
            ("softmax_xent_fwd", "softmax_xent.cu", "softmax_xent.py:32"),
            ("softmax_xent_bwd", "softmax_xent.cu", "softmax_xent.py:78"),
            ("adam_update", "fused_update.cu", "fused_update.py:59"),
            ("dropout", "dropout.cu", "../nn_ops.py:388"),
            ("dropout_device_key", "dropout.cu", "../nn_ops.py:388"),
            ("dropout_bwd", "dropout.cu", "../nn_ops.py:388"))})
    # the RNN graphs' rows: their windows and seq2seq's 60 steps (paths
    # "ptb ..." and "seq2seq ..."; the f32 checks fall in the general rows)
    rnn_src = {"softmax_xent_fwd": ("softmax_xent.cu", "softmax_xent.py:32"),
               "softmax_xent_bwd": ("softmax_xent.cu", "softmax_xent.py:78"),
               "dropout": ("dropout.cu", "../nn_ops.py:388"),
               "dropout_device_key": ("dropout.cu", "../nn_ops.py:388"),
               "dropout_bwd": ("dropout.cu", "../nn_ops.py:388"),
               "adam_update": ("fused_update.cu", "fused_update.py:59")}
    session_where.update({
        f"{name}@{model}": (*rnn_src[name], name, name, model)
        for model, names in (
            ("ptb", ("softmax_xent_fwd", "softmax_xent_bwd", "dropout",
                     "dropout_device_key", "dropout_bwd")),
            ("seq2seq", ("softmax_xent_fwd", "softmax_xent_bwd",
                         "adam_update")))
        for name in names})
    # K6 at the beam shapes: the f32 check's and the bf16 decodes' launches
    session_where.update({
        f"decode_attention@beam_{t}_{s}": (
            "decode_attention.cu", "decode_attention.py:57",
            "decode_attention", "decode_attention",
            "beam f32" if t == "float32" else "beam bf16")
        for t in ("float32", "bfloat16")
        for s in ("len1", "len32", "len64", "cross")})
    # the long-context LM's rows: its checks, captured runs and windows
    # (the three flash kernels at D = 128 on the wgmma kernels)
    session_where.update({
        f"{name}@long_context": (src, tpu, name, name, "long_context")
        for name, src, tpu in (
            ("flash_attention_fwd", "flash_fwd_sm90.cu",
             "flash_attention.py:102"),
            ("flash_attention_dkdv", "flash_dkdv_sm90.cu",
             "flash_attention.py:210"),
            ("flash_attention_dq", "flash_dq_sm90.cu",
             "flash_attention.py:264"),
            ("layer_norm", "layer_norm.cu", "layer_norm.py:29"),
            ("layer_norm_bwd", "layer_norm.cu", "layer_norm.py:42"),
            ("softmax_xent_fwd", "softmax_xent.cu", "softmax_xent.py:32"),
            ("softmax_xent_bwd", "softmax_xent.cu", "softmax_xent.py:78"),
            ("adam_update", "fused_update.cu", "fused_update.py:59"))})
    # phase 16's rows: the slot path's DecodeAttention timed at each
    # role's shape (each row counts all of the path's launches of its
    # kernel, as the beam rows do), the f32 encoder flash forward, the int8
    # runs' QuantMatMul timed at verify's m = 64
    session_where.update({
        f"{kind}@s2s_{role}": ("decode_attention.cu", tpu, kind, kind,
                               "s2s")
        for kind, tpu in (("decode_attention", "decode_attention.py:57"),
                          ("decode_attention_block",
                           "decode_attention.py:108"))
        for role in ("self", "cross")})
    session_where.update({
        "flash_attention_fwd@s2s_encoder": (
            "flash_fwd_f32.cu", "flash_attention.py:102",
            "flash_attention_fwd", "flash_attention_fwd", "s2s"),
        "quant_matmul@s2s": (
            "quant_matmul.cu", "quant_matmul.py:45", "quant_matmul",
            "quant_matmul", "s2s int8")})
    # the f32 dK/dV and dQ (csrc/flash_bwd_f32.cu) at their paths' shapes:
    # each row counts both entries' launches on its paths (F32_BWD_PATHS),
    # which the general and Session rows then leave out
    f32_where = {
        f"flash_attention_{part}@{tag}": (
            "flash_bwd_f32.cu", tpu, (f"flash_attention_{part}",
                                      f"flash_attention_{part}_device_seed"),
            F32_BWD_PATHS[tag])
        for tag in F32_BWD_PATHS
        for part, tpu in (
            ("dkdv", "flash_attention.py:244" if tag == "f32_s64"
             else "flash_attention.py:210"),
            ("dq", "flash_attention.py:297" if tag == "f32_s64"
             else "flash_attention.py:264"))}
    f32_paths = tuple(F32_BWD_PATHS.values())
    # (the general row's counter, the path) pairs a Session row takes over
    claimed = {(c, p) for _, _, _, c, p in session_where.values()}
    claimed |= {(c, p) for _, _, cs, p in f32_where.values() for c in cs}
    # a kernel's launches over every path; the flash rows split by the
    # path's dropout (the dropout branch runs only at rate > 0; the
    # seed-pointer entries only with dropout)
    launches = {}
    for path, rate, counts in paths:
        for k, v in counts.items():
            if any(k == c and path.startswith(p) for c, p in claimed):
                continue
            if k.startswith("flash_attention") and rate > 0 and \
                    not k.endswith("_device_seed"):
                k += "_dropout"
            launches[k] = launches.get(k, 0) + v
    print(f"launches over the paths {[p for p, _, _ in paths]}: {launches}",
          flush=True)

    where = {
        "decode_attention": ("decode_attention.cu",
                             "decode_attention.py:57"),
        "decode_attention_block": ("decode_attention.cu",
                                   "decode_attention.py:108"),
        "layer_norm": ("layer_norm.cu", "layer_norm.py:29"),
        "quant_matmul": ("quant_matmul.cu", "quant_matmul.py:45"),
        "flash_attention_fwd": ("flash_fwd_mma.cu",
                                "flash_attention.py:102"),
        "flash_attention_dkdv": ("flash_bwd_mma.cu",
                                 "flash_attention.py:210"),
        "flash_attention_dq": ("flash_bwd_mma.cu",
                               "flash_attention.py:264"),
        "layer_norm_bwd": ("layer_norm.cu", "layer_norm.py:42"),
        "softmax_xent_fwd": ("softmax_xent.cu", "softmax_xent.py:32"),
        "softmax_xent_bwd": ("softmax_xent.cu", "softmax_xent.py:78"),
        "adam_update": ("fused_update.cu", "fused_update.py:59"),
        "momentum_update": ("fused_update.cu", "fused_update.py:135"),
        "flash_attention_fwd_dropout": ("flash_fwd_mma.cu",
                                        "flash_attention.py:141"),
        "flash_attention_dkdv_dropout": ("flash_bwd_mma.cu",
                                         "flash_attention.py:244"),
        "flash_attention_dq_dropout": ("flash_bwd_mma.cu",
                                       "flash_attention.py:297"),
        "dropout_residual": ("dropout_residual.cu",
                             "dropout_residual.py:41"),
        "dropout_residual_bwd": ("dropout_residual.cu",
                                 "dropout_residual.py:99"),
        "flash_attention_fwd_device_seed": ("flash_fwd_mma.cu",
                                            "flash_attention.py:141"),
        "flash_attention_dkdv_device_seed": ("flash_bwd_mma.cu",
                                             "flash_attention.py:244"),
        "flash_attention_dq_device_seed": ("flash_bwd_mma.cu",
                                           "flash_attention.py:297"),
        "dropout_residual_device_seed": ("dropout_residual.cu",
                                         "dropout_residual.py:41"),
        "dropout_residual_bwd_device_seed": ("dropout_residual.cu",
                                             "dropout_residual.py:99"),
        "dropout": ("dropout.cu", "../nn_ops.py:388"),
        "dropout_device_key": ("dropout.cu", "../nn_ops.py:388"),
        "dropout_bwd": ("dropout.cu", "../nn_ops.py:388"),
        # not a Pallas kernel: the setter of the conditional nodes that
        # take the place of lax.while_loop's and lax.cond's predicates
        "cond_set": ("control_flow.cu", "../control_flow_ops.py:337"),
        # not a Pallas kernel: the numerics plane's NumericSummary, which
        # XLA fuses in the JAX package (ops/numerics.py:23)
        "numeric_summary": ("numeric_summary.cu", "../numerics.py:23"),
    }
    missing = [k for k in where if not launches.get(k)]
    if missing:
        fail(f"kernels {missing} were not launched on any path")
    rows = []
    for name, (src, tpu) in where.items():
        r = main_rows[name]
        rows.append({"name": name, "route": "cuda", "source": SRC + src,
                     "replaces": os.path.normpath(TPU + tpu),
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    for name, (src, tpu, counter, _, prefix) in session_where.items():
        n = sum(counts.get(counter, 0) for path, _, counts in paths
                if path.startswith(prefix)
                and not path.startswith(f32_paths))
        if not n:
            fail(f"{name}: the kernel was not launched on the "
                 f"{prefix} paths")
        r = main_rows[name]
        rows.append({"name": name, "route": "cuda", "source": SRC + src,
                     "replaces": os.path.normpath(TPU + tpu),
                     "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    for name, (src, tpu, counters, prefix) in f32_where.items():
        n = sum(counts.get(c, 0) for path, _, counts in paths
                if path.startswith(prefix) for c in counters)
        if not n:
            fail(f"{name}: the kernel was not launched on the "
                 f"{prefix} paths")
        r = main_rows[name]
        rows.append({"name": name, "route": "cuda", "source": SRC + src,
                     "replaces": os.path.normpath(TPU + tpu),
                     "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
        print(f"{name}: {n} launches on the {prefix} paths", flush=True)
    for name, (old, what) in EARLIER_MS.items():
        r = main_rows[name]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        ratio = "" if old is None else f" ({r['ms'] / old:.3f}x)"
        if old is not None and r["ms"] > 1.05 * old:
            ratio += " OUTSIDE 5%"
        before = "n/a" if old is None else f"{old:.5f} ms"
        print(f"{what} {name} ({r['shape']}): before {before}, now "
              f"{r['ms']:.5f} ms{ratio}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), library {lib} ms", flush=True)
    print(f"chip_smoke: {time.perf_counter() - smoke_t0:.1f} s in all",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
