#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Drives the port's main paths and holds their hand-written CUDA
kernels against the plain PyTorch versions:

- stateful decode serving of ``DecoderBlockLM`` at GPT-2-small widths
  through ``InferenceSession``, ``SessionStateStore`` and
  ``DynamicBatcher``, with the decode-attention kernel K2;
- training ``TransformerLM`` at GPT-2 small's published widths and
  depth (``autograd.record``, softmax cross-entropy, ``backward``,
  Adam ``Trainer``), with the flash-attention forward kernel K1;
- serving an exported symbol graph, wav2vec2-large-lv60 CTC at its
  published widths and depth, through ``InferenceSession.load`` under
  ``MXNET_GRAPH_OPT=1``: the fusion pass lowers its seven
  LayerNorm→GELU pairs onto the fused LayerNorm→activation kernel K3 and
  its 24 attentions onto K1;
- training ``resnet50_v1`` at its published widths and depth
  (``autograd.record``, SGD-momentum ``Trainer``) with a custom-op loss
  head, ``rtc_softmax``, whose forward and backward are CUDA C kernels
  that the runtime-kernel launcher K4 (``rtc.CudaModule``) compiles with
  NVRTC and launches;
- decode serving as the JAX package serves it: the paged KV store, one
  captured CUDA graph per occupancy bucket (K2 inside each), SLO
  classes through the batcher, and a ``ModelServer`` over a
  ``ModelRepository`` on a local port, with a canary promote that
  migrates live streams;
- training ResNet-50 v1 (with K4's head) and the GPT-2-small LM (with
  K1's bf16 kernel for Hopper, ``csrc/flash_attention_sm90.cu``: wgmma
  fed by TMA from a producer warp) in bf16 AMP: ``amp.init("bfloat16")``,
  ``amp.init_trainer`` (a dynamic loss scaler), ``amp.scale_loss`` and
  the Trainer's fused step, captured as one CUDA graph;
- both training paths hybridized (``HybridBlock.hybridize``: the
  network's forward and backward captured as CUDA graphs, one pair per
  signature, with K1 inside the LM's captured forward and K4's head
  eager), held bitwise against their eager runs, and ResNet-50 fed by
  ``gluon.data`` (``ArrayDataset``, a ``DataLoader`` of thread workers
  into pinned memory) through ``pipeline.DeviceFeed``;
- symbolic training: ``sym`` → ``simple_bind`` → the Executor, whose
  forward and backward are captured CUDA graphs, under ``Module.fit``
  (the MNIST MLP), the LSTM word-LM through ``Module`` and the fused
  ``sym.RNN`` (cuDNN), ``BucketingModule`` over ``rnn.LSTMCell.unroll``,
  and the same word-LM as a hybridized ``gluon.rnn.LSTM``;
- the NDArray and op surface: ResNet-50 trained through a hand-written
  SGD loop on the in-place operators (no ``Trainer``), and every op of
  the surface on the card against the CPU port, in one CUDA graph, with
  the random ops drawing under a registered generator;
- the Gluon surface: nine vision-zoo models at their published widths,
  VGG-16 trained hybridized at Simonyan and Zisserman's settings, LAMB
  on ResNet-50 v2, every new optimizer against the CPU port, and the
  GAN and matrix-factorization examples' twins;
- detection: the ``nd.contrib`` detection ops on the card against the
  CPU port, SSD300-VGG16 (``tools/profile_ssd.py``) trained hybridized
  at its published widths, and its detection batch through
  ``MultiBoxDetection``, whose ``box_nms`` sweep is the hand-written CUDA
  kernels N1 (``csrc/box_nms.cu``; not a TPU kernel: they replace the
  JAX op's ``lax.fori_loop``): an IoU bitmask and a sequential OR-reduce
  over it, in two kernels (the mask across the card, the reduce a block
  an image) at SSD300's sweeps and in one fused launch for short sweeps
  such as the toy detector twin's;
- int8 quantization: every ``ops_quant`` op on the card against the CPU
  port, ``resnet50_v1`` at its published widths quantized by
  ``contrib.quantization.quantize_net_graph`` and served in int8 through
  ``InferenceSession.predict`` beside float32, its convolutions on the
  hand-written int8 kernel N2 (not a TPU kernel: it replaces the
  int32-accumulating ``lax.conv_general_dilated`` of the JAX op's native
  lowering): 52 of 53 on its Hopper kernel (``csrc/int8_conv_sm90.cu``:
  wgmma s8 on NHWC/OHWI tiles fed by TMA through an mbarrier ring, after
  the layout copy ``int8_to_nhwc`` of the same file), the stem on the
  ``mma.sync`` kernel (``csrc/int8_conv.cu``); its classifier on
  ``torch._int_mm``; the block-swap ``quantize_net``; and GPT-2-small
  decode on int8 KV pages;
- the deployment chain: autotune sweeps of ``quantize.lowering`` and
  ``fusion.attn_compute_bound_seq``, three model versions (wav2vec2,
  int8 ResNet-50, GPT-2-small decode) exported as bundles by a
  ``ModelRepository`` and served by a process with no ``nvcc`` that
  builds nothing, and a ``FleetRouter`` over two replica processes on
  the one card, drained mid-stream;
- the host runtime and the record pipeline: the dependency engine on the
  card, the JPEG decoder the machine has (libjpeg on the host, or nvJPEG
  and the crop kernels ``jpeg_crop`` and ``jpeg_crop_scaled`` of
  ``csrc/jpeg_decode.cu``, not TPU kernels: they replace the resize,
  crop and mirror of the JAX package's host decode), ``ImageRecordIter``
  alone and with a resize, and ResNet-50 v1
  trained from a ``.rec`` through ``DeviceFeed``
  (``tools/profile_records.py``);
- the linear-algebra, image and contrib ops of ``nd.linalg``,
  ``nd.image`` and ``nd.contrib`` on the card against the CPU port, the
  two-stage detector ops (``Proposal``, ``PSROIPooling``,
  ``DeformableConvolution``, ...) at Faster R-CNN's, R-FCN's and
  Deformable ConvNets' published shapes, and SSD300-VGG16 trained from
  ``ImageDetIter``;
- the sparse storage types: sparse logistic regression and the
  embedding-bag layer of a wide-and-deep model at avazu-app's 1,000,000
  features, batch 8,192, through ``LibSVMIter`` over the native text
  parser, ``nd.sparse.dot``, the store's sparse push and
  ``row_sparse_pull`` and the lazy SGD and Adam rows
  (``tools/profile_sparse.py``; no kernel: plain tensor code), and the
  DGL graph ops on a graph of ogbn-arxiv's size;
- interchange: ResNet-50 v1 at its published widths trained by
  ``gluon.contrib.estimator.Estimator.fit`` with its handlers and an
  ``mx.Monitor``, exported to ONNX by ``contrib.onnx.export_model``
  through the package's own protobuf codec, imported back by
  ``import_to_gluon`` and ``import_model`` and served, and loaded
  through the model store by ``pretrained=True``
  (``tools/profile_onnx.py``; no kernel).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result). Every kernel
time is the median of 25 launches timed alone with CUDA events, each
after a write that evicts the L2 and a ~200 us spin that keeps the
stream busy until the launch is enqueued, so it is the device's time:

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls (torch's default too); cuDNN's global
   flags stay at torch's defaults: the port scopes its own convolutions
   to float32;
2. build: compile every ``mxnet_tpu_torch/csrc/*.cu`` with nvcc, one
   process per source, all started together;
3. K2 check: K2 against ``_decode_flash_ref`` on the card, within
   rtol = atol = 1e-5, at the serving shapes, at other head dims, and
   where the key sweep is split: B = 1 at lengths 0, 1, 63, 64, 65, 1000
   and S, the seven in one batch of 7, a length past S; each case prints
   its ``(splits, chunk)``;
4. K2 times: K2, its plain version and ``scaled_dot_product_attention``
   (a yardstick only; the port never calls it) at B in {1, 8, 32},
   S = 1024, beside the bound (the bytes of the visible K and V, q and
   out at 3.35 TB/s) and the splits;
5. serving: 8 greedy-decode streams of 8-48 tokens through the batcher
   (row-slot store, buckets 1-8, one graph per bucket); every future
   resolves, K2 launches = layers x decode steps (counted through graph
   replays), and the three longest streams' final logits match the
   session's own explicit-state step loop within rtol = atol = 1e-4;
6. K1 check: K1 against ``_flash_ref`` on the card within rtol = atol =
   1e-5 in float32 at the training shape (8, 12, 1024, 1024, 64,
   causal), the JAX tests' shapes, D in {128, 256}, a strided view and
   the fusion route's (128, 1, 499, 499, 64); within two bfloat16 ulps
   in bfloat16; rows that are not 16-byte aligned (bf16 rows of 40 and
   42 bytes, fp32 rows of 12 bytes, an odd s-stride in fp32 and bf16),
   each case printing the bytes per K/V copy its load path took;
   dq/dk/dv through the ``autograd.Function`` against autograd of
   ``_flash_ref`` within 1e-4;
7. K1 times: K1, ``_flash_ref`` and ``scaled_dot_product_attention(
   is_causal=True)`` (a yardstick only) at the training shape, L2
   flushed before each launch, beside two bounds: its flops at the fp32
   rate of 67 TFLOP/s, and three times its flops at the TF32 rate of
   495 TFLOP/s (K1's 3xTF32 products);
8. training: ``TransformerLM`` at GPT-2 small's widths and depth, tied
   embedding, Xavier weights from a seed, one fixed batch of 8 x 1024
   tokens, Adam at 3e-4: 2 warm-up and 10 timed steps; every loss
   finite and the last below the first, every gradient finite after
   step 1, K1 launches = 12 layers x 10 timed steps, the fused step one
   captured graph replayed every step; tokens/s, step ms,
   forward/backward/optimizer ms and peak memory; then 5 steps of the
   eager loop (``MXNET_FUSED_STEP=0``), whose step and optimizer ms
   print beside;
9. training against the CPU: one record/backward at 1 x 128 tokens,
   full width, on the card (through K1) and on the CPU (the plain path)
   from the same weights; the loss and three gradients agree within
   rtol 1e-3;
10. K3 check: K3 against ``_norm_act_ref`` on the card within rtol =
    atol = 1e-5 in float32 at the seven LayerNorm→GELU shapes of a
    bucket-8 forward of 10 s clips, a ragged row count, C in {100, 768,
    1024, 1030, 4096}, every activation code, and within one bfloat16
    ulp in bfloat16;
11. K3 times: K3, its plain version and ``F.layer_norm`` then
    ``F.gelu`` (two PyTorch calls, a yardstick only) at the seven path
    shapes, L2 flushed before each launch, beside the bound (input read
    and output written once at 3.35 TB/s);
12. K1 on the fusion route: K1 against ``_flash_ref`` at (128, 1, 499,
    64), not causal, within 1e-5, and its times and bounds as in phase 7;
13. symbolic serving: wav2vec2-large-lv60 CTC exported with ``sym.save``
    and ``nd.save``, loaded by ``InferenceSession.load`` with buckets 1,
    2, 4, 8; every bucket's optimized graph holds 7 ``_fused_norm_act``
    and 24 ``_fused_attention`` nodes at ``impl="cuda"``; requests of 1,
    3, 8, 5 and 2 clips of 10 s; K3 launches = 7 and K1 launches = 24
    per bucket execution; one bucket's logits within 1e-4 (of the
    largest logit) of the same export served under ``MXNET_FUSION=0``,
    and a 1 s clip within rtol 1e-3 of the CPU port;
14. K4 check: ``rtc.CudaModule`` compiles (NVRTC, ``sm_90a``) the
    ``double`` kernel of ``tests/test_quant_custom.py`` and an ``axpy``
    with a scalar argument, which equal torch's ``x * 2`` and ``y + a *
    x`` exactly on 2^26 elements; the ``rtc_softmax`` forward and
    backward match their plain versions within rtol = atol = 1e-6 at
    (128, 1000), (128, 1001) and (64, 4097); a compile error raises with
    NVRTC's log, a dtype mismatch and a CPU context raise;
15. K4 times: the softmax forward (against ``torch.softmax``, a
    yardstick only) and backward (against
    ``torch._softmax_backward_data``) at (128, 1000) and ``double`` at 2^26
    (against ``x * 2``), L2 flushed before each launch, beside the bound
    (bytes at 3.35 TB/s); the host microseconds per ``launch`` call;
16. ResNet-50 training: ``resnet50_v1`` (25.6 M parameters), batch 128
    of 224 x 224 fp32 images and labels from a seed, Xavier weights from
    a seed, SGD lr 0.1, momentum 0.9, wd 1e-4, the ``rtc_softmax`` head:
    2 warm-up and 10 timed steps, then 28 more on the same batch; every
    loss finite and the 40th below the first, every gradient finite,
    every running statistic moved, K4 launches = 2 x 10 timed steps, the
    fused step one graph replayed every step; img/s, step ms (forward,
    backward, optimizer), peak memory, the eval forward's img/s at batch
    128, and the eager loop's step and optimizer ms beside;
17. ResNet-50 against the CPU: one record/backward at batch 2 on the
    card (K4) and on the CPU (the plain head) from the same fresh
    weights: the loss and three gradients within rtol 1e-3 in eval mode
    (the stem, a mid-network convolution, the classifier), and the loss
    and the classifier's gradients in training mode, whose deeper
    gradients at batch 2 are float32-ill-conditioned (see the phase);
    and head against head on the card at
    batch 128 with the trained weights: ``rtc_softmax``'s gradients
    against ``SoftmaxCrossEntropyLoss``'s within 1e-4 of the largest
    entry;
18. paged decode serving: GPT-2 small on a paged store (16-token pages),
    buckets 1-32 captured as graphs; 32 greedy streams of 16-256 tokens
    arriving open-loop (seeded exponential gaps) through the stateful
    batcher as SLO class ``standard``: tokens/s, mean step ms, p50/p99
    per-token latency from the serving histograms, pages at the peak
    against the row-slot bytes of the same sessions, captures and
    replays per bucket, K2 launches = layers x steps; then 8 of the
    streams rerun on a row-slot store, step for step at the buckets
    they ran at, give bitwise-equal logits;
19. graph against eager at 8 rows: one step from the same random
    states through a captured graph and eagerly, bitwise or within
    1e-5; each mode's host ms per step, device busy ms, idle share and
    launches per step (``tools/profile_decode.py``'s measure, 10
    profiled steps);
20. HTTP: a ``ModelServer`` over a ``ModelRepository`` serves the
    decoder on a local port; 4 streams with ``X-Session-Id``; v2 (the
    same weights) deployed and promoted while a round is in flight; the
    streams' logits bitwise equal to a run with no promote,
    ``resumed_sessions`` = 4; under ``faults.inject("serving_admission",
    every=1)`` best_effort gets 503 with ``Retry-After`` and critical
    200; ``/metrics`` carries the ``slo_class`` families;
21. convolution at torch's default flags: phase 17's eval- and
    training-mode comparison rerun with ``cudnn.allow_tf32`` and
    ``cudnn.benchmark`` at torch's defaults, each deviation logged
    against rtol 1e-3;
22. K4's launch floor: an empty kernel through ``rtc.CudaModule``,
    timed as every kernel here (median of 25 launches, CUDA events, the
    stream kept busy);
23. K1 in bfloat16 at the LM's shape (8, 12, 1024, 1024, 64, causal):
    the rule (``_flash_route``) sends it to the sm90 kernel, on
    contiguous inputs, on the LM's strided qkv views, at a ragged S, at
    S_q < S_k and not causal, each within two bf16 ulps of the plain
    version in float32 rounded once; its time on both layouts beside
    the mma.sync kernel's (``route="mma"``, the route of earlier slices)
    at the same shape, the plain version's,
    ``scaled_dot_product_attention`` in bf16 (a yardstick only) and two
    bounds: the function's (bytes at 3.35 TB/s, flops at 989 TFLOP/s)
    and the design's two-pass arithmetic (P.V twice);
24. ResNet-50 in bf16 AMP, as phase 16 (batch 128, SGD, the
    ``rtc_softmax`` head on the logits cast to float32, with the loss
    scale as its ``grad_scale``), in NCHW and in NHWC: 2 warm-up, 10
    timed and 28 more steps; the loss finite and the 40th below the
    first, K4 launches = 2 x 10, one graph capture and a replay per
    step; img/s, step ms, peak memory, skipped steps; the faster layout
    is the headline;
25. the GPT-2-small LM in bf16 AMP, as phase 8 (Adam, ``scale_loss``):
    the loss falls, the logits are bf16, K1 launches = 12 x 10 (on bf16
    q, k, v), every one on the sm90 kernel, one graph and a replay per
    step; tokens/s, step ms, peak memory;
26. AMP on the card against the CPU port: ResNet-50 at batch 2 (eval
    mode, fresh weights) and the LM at 1 x 128 tokens, one
    record/backward each in bf16 and in float32 on both: the card's bf16
    deviation from its float32 (L2 of the logits and of the gradients)
    within 1.5 x the CPU's plus 1e-3, and the bf16 losses within rtol
    2e-2 (``tests/test_torch_amp_training.py``'s bounds); the LM also
    at torch's default cuBLAS flags (the port's fp32-accumulation scope
    replaced by a no-op), whose deviations are reported;
27. a poisoned bf16 step: an inf in one gradient; ``Trainer.step``
    under ``torch.cuda.set_sync_debug_mode("error")`` (any host sync
    raises) skips it on the device: weights and momenta bitwise
    unchanged, the scale halved, one more skipped step;
28. ResNet-50 hybridized against eager: phase 24's NHWC setup, the net
    hybridized; 2 warm-up and 10 timed steps in each mode from the same
    weights and batch. With cuDNN held to deterministic algorithms, the
    12 steps' logits and every final weight, gradient and running
    statistic are bitwise equal; then, at torch's flags, each mode's
    step ms, img/s, peak memory, K4 launches (2 x 10) and the cache's
    counters (one capture, a replay per step);
29. the LM hybridized against eager: phase 25's setup, 2 + 10 steps in
    each mode; the last position's logits of every step and every final
    weight and gradient bitwise equal; K1 launches = 12 x 10 counted per
    replay, all on sm90; step ms, tokens/s, peak memory;
30. ResNet-50 fed by ``gluon.data``: 768 uint8 NHWC images and labels
    made from a seed and held in host memory, ``ArrayDataset``,
    ``DataLoader(batch_size=128, num_workers=4, pin_memory=True,
    last_batch="discard")``, ``DeviceFeed``, normalized and cast on the
    card, the hybridized net; two passes (2 + 10 steps): step ms, img/s
    and ``prefetch_stall_s`` per step;
31. a capture that must fail: a block whose forward calls ``asnumpy()``
    raises ``MXNetError`` naming the block and the signature when
    hybridized, and the card computes correctly afterwards;
32. the MNIST MLP through ``Module`` (784-128-64-10, ``SoftmaxOutput``,
    SGD lr 0.3, momentum 0.9, batch 128, ``examples/train_mnist_mlp.py``
    on its synthetic data from a seed): one pass of 14 steps on the card
    and on the CPU port from the same weights and batches, per-step
    losses and final weights within rtol 1e-3; then ``Module.fit`` for 8
    epochs, with the accuracy metric and without: step ms, validation
    accuracy before and after (it must rise by 0.2), the captured
    training signature replayed every step;
33. the LSTM word-LM through ``Module`` and the fused ``sym.RNN`` at
    Zaremba et al.'s medium widths (vocabulary 10,000, 650 wide, 2
    layers, dropout 0.5, tied decoder, BPTT 35, batch 20; SGD lr 0.25,
    each gradient element clipped at 0.1; token ids from a seeded Markov
    chain): cuDNN's LSTM against the
    op's plain version on the card within 2e-5 of the largest value
    (float32, not TF32); the captured executor against the eager one,
    bitwise, for 3 steps at p = 0; 3 steps against the CPU port within
    rtol 1e-3; each mode timed (2 + 20 steps, Perplexity metric) and
    profiled (5 steps: idle share, device time by kind), peak memory,
    5 steps without the metric; the perplexity of 10 batches
    falls over 30 more steps; the device time of the rnn op's forward
    and backward on views against ``torch.nn.LSTM``'s flattened weights
    (cuDNN's repack), in turns;
34. ``BucketingModule`` over ``rnn.LSTMCell.unroll`` at the same widths
    (one layer), buckets 10, 20, 30 and 35, ``BucketSentenceIter`` over
    200 Markov sentences, one epoch of ``fit``: one captured signature
    per bucket, replayed (forward and backward) once per batch of it;
35. the word-LM in Gluon: ``gluon.rnn.LSTM`` under an ``Embedding``
    whose weight the decoder shares, hybridized (``CachedOp`` with the
    states as inputs), SGD through the Trainer's fused step: 2 + 20
    steps, step ms beside the Module's;
36. K3 and K1 on a training bind: ``layer_norm → gelu`` and an
    attention at ``MXNET_GRAPH_OPT=2`` against 0, one training step on
    the card: the gradients within 1e-4, K3 not launched in the
    training step (``replay_needs_grad``), launched in an inference
    forward, K1 launched under its ``autograd.Function``;
37. ResNet-50 through a hand-written SGD loop: ``resnet50_v1`` at
    phase 16's configuration, the batch drawn on the card by
    ``nd.random.uniform`` and the labels by ``nd.random.randint``, the
    loss ``-nd.pick(nd.log_softmax(out), y).mean()``, per parameter
    ``m *= 0.9; m -= lr * (g + wd * w); w += m`` on ``p.data()``; one
    hand update against the Trainer's fused sgd step from the same
    weights and gradients within 1e-6 of each parameter's largest value;
    after a hand update the hybridized net's captured forward bitwise
    equal to its eager forward and different from before; 20 logged
    steps (loss, top-1 from ``argmax``, top-5 from ``nd.topk``, the
    global gradient norm from ``nd.norm`` read with ``float()``), the
    loss at step 40 below the first; the hand loop's step ms beside the
    Trainer loop's on the same loss;
38. the op sweep (``tools/op_sweep.py``): every case of the surface's
    ops on the card against the CPU port, forward and backward (exact
    outputs bitwise, the rest within rtol 1e-5 and atol 1e-6, CTC rtol
    1e-4); every deterministic case but ``boolean_mask`` (a
    data-dependent shape) captured in one CUDA graph, whose replay
    equals the eager calls bitwise; the random ops captured with the
    device's generator registered, drawing anew per replay and repeating
    after ``mx.random.seed``; the JAX opperf suite's times
    (``benchmark/opperf.py``);
39. the vision zoo at published widths (1000 classes, 224 x 224,
    Inception v3 at 299 x 299): ``alexnet``, ``vgg16``, ``vgg16_bn``,
    ``squeezenet1_1``, ``mobilenet1_0``, ``mobilenet_v2_1_0``,
    ``densenet121``, ``inception_v3`` and ``resnet50_v2``, Xavier
    weights from a seed: each one's trainable parameter count; eval-mode
    logits and every gradient at batch 2 against the CPU port with the
    same weights, within 1e-3 of each tensor's largest magnitude (a
    gradient behind a max-pool near-tie within 1e-2 in relative L2, and
    named); one training-mode forward and backward at batch 32, eager
    and then hybridized, with dropout at 0 and cuDNN deterministic:
    logits and every gradient bitwise equal; then 2 + 5 hybridized SGD
    steps at the published dropout: step ms, img/s, peak memory;
40. VGG-16 training: ``vgg16`` (13 convolutions and 3 FC layers at
    Simonyan and Zisserman's widths, 138,357,544 parameters, as the JAX
    model counts them; dropout 0.5), one synthetic batch of 64 images
    from a seed, hybridized, SGD momentum 0.9, lr 0.01, wd 5e-4 (their
    §3.1), ``SoftmaxCELoss``: 20 steps; the batch's eval-mode loss (no
    dropout noise) falls; step ms, img/s, peak memory, one training and
    one eval capture and a backward replay per step, and 3
    profiled steps (``tools/profile_zoo.py``): the device's idle share
    and device time by kind;
41. LAMB on ResNet-50 v2: ``resnet50_v2`` at batch 128, hybridized,
    LAMB (lr 0.01, wd 1e-4) through the Trainer's eager per-parameter
    loop for 10 steps (the loss falls), then the fused SGD step on the
    same net: each optimizer's ms per step;
42. the new optimizers (Adamax, Nadam, FTML, LAMB, LARS, LBSGD, DCASGD,
    SGLD without its noise, GroupAdaGrad): 3 Trainer steps on a small
    MLP on the card against the CPU port within 1e-5 of each
    parameter's largest value; ``ftml_update``, ``lamb_update_phase1``,
    ``lamb_update_phase2`` and ``multi_lars`` against the CPU within
    1e-6;
43. the twins of ``examples/train_gan_toy.py`` (``SigmoidBCELoss``, two
    Adam Trainers, both nets hybridized: the discriminator, called twice
    under one ``record()``, takes two captured slots) and
    ``examples/train_recommender_mf.py`` (``L2Loss``, ``Embedding``) at
    their default arguments; the MF loss falls below its start;
44. the detection ops on the card against the CPU port: each of
    ``multibox_prior``, ``box_iou``, ``bipartite_matching``,
    ``multibox_target`` (with hard-negative mining),
    ``multibox_detection``, ``box_nms`` (class-aware with ``topk`` 400,
    ``force_suppress`` with 200) and ``roi_align`` (and its
    gradient) at SSD300's shapes (8732 anchors, 21 classes, batch 32,
    16 boxes) and at the JAX package's test inputs: class ids, matches,
    masks and -1 rows equal, values within 1e-5 of max(1, largest), the
    gradient within 1e-5 of its largest; then N1 against its plain
    version (the Python loop over the rows) on the card at (32, 8732)
    from random class scores, ``nms_topk`` 400 and -1, class-aware and
    ``force_suppress``: keep masks equal on every route that takes the
    limit (mask_reduce, the rule's, and fused at 400; mask_reduce at -1),
    and the mask kernel's words equal the plain mask's; both routes'
    times at 400, their launches, workspace and shared memory, the plain
    loop's time at 400,
    N1's bound (the bytes of the swept rows and the mask; the IoU tests
    the data needs) and its dependent steps (one per kept row); no
    PyTorch call computes greedy NMS, so no library time;
45. the twin of ``examples/train_ssd_toy.py`` (MultiBoxPrior,
    MultiBoxTarget, softmax cross-entropy and smooth L1, Adam, 120
    steps, then MultiBoxDetection): the loss ends below 2.0, and its
    detection (4 x 192 rows, a short sweep) launches N1's fused kernel
    once;
46. SSD300-VGG16 training: example/ssd's 300 x 300 ``vgg16_reduced``
    network (26,285,486 trainable parameters, 8732 anchors, 21
    classes) at batch 2 against the CPU port with the same weights
    (class and location outputs within 1e-3 of their largest value, the
    loss within rtol 1e-4); one recorded forward, ``MultiBoxTarget``,
    loss and backward at batch 8, eager and then hybridized with cuDNN
    deterministic: outputs, loss and every gradient bitwise equal; then
    2 + 20 hybridized SGD steps at batch 32 on one synthetic batch (lr
    0.001, momentum 0.9, wd 5e-4): the loss falls; step ms, img/s, peak
    memory, the ms of ``MultiBoxTarget`` and of the loss within a step
    (CUDA events), and 3 profiled steps: idle share, device time by
    kind;
47. SSD300 detection: ``softmax`` and ``MultiBoxDetection`` (NMS 0.45,
    ``nms_topk`` 400, threshold 0.01) on the trained body's batch of
    32, and again uncapped (``nms_topk`` -1, the op's default), each
    with the launch counts reset just before: the route rule's N1
    kernels launched once each (the mask and the reduce kernel, capped
    and uncapped), the capped rows equal to those the CPU
    port's ``MultiBoxDetection`` gives on the card's class
    probabilities (ids and -1 rows exactly, values within 1e-5; the two
    devices' softmax, within 1e-5 of each other, can order scores tied
    to a float32 ulp differently, so each side gets the same
    probabilities), the uncapped rows' first 400 equal to the capped
    ones; the head's and the forward-plus-head's ms at both caps; N1 on
    the rows this batch swept, on both routes at 400 (the plain loop
    timed beside), at the toy's (4, 192) on the fused route and
    uncapped (keep mask equal to the plain loop's), and its mask and
    reduce kernels alone beside their plain versions;
48. the quantization ops and N2: every case of
    ``tools/profile_quant.op_cases`` (all 14 ``ops_quant`` ops, int8 and
    uint8 inputs) on the card against the CPU port under both lowerings,
    integers equal and floats within 1e-5; N2 bitwise equal to its plain
    version (float64) at every ``resnet50_v1`` convolution at batch 32
    and 1 on both routes where the route rule gives sm90, a grouped, a
    dilated, an odd-stride and a 7 x 7 C = 3 case; the sm90 kernel at its
    edges (M not a multiple of 128, O not one of the tile width, C = 16
    and 48, a stride-2 1 x 1, a padded 3 x 3 at 7 x 7, dilated,
    anisotropic, a wide image) at each tile width, a K split at batch 1
    run twice, bitwise; the layout copy against its plain version;
    ``int8_mm`` (``torch._int_mm`` on padded operands) at M = 1, 32 and
    an odd K and N; ``dequant`` (cuDNN float32, no TF32) bitwise equal to
    ``native`` at K = 576 and its largest accumulator gap at K = 4608;
    the batched product by N2 as a grouped 1 x 1 convolution against
    ``_int_mm`` per batch entry; N2's time at every distinct ResNet-50
    shape at batch 32, both routes in turns (mma, sm90, sm90, mma; the
    stem forced onto sm90 with its channels padded), beside its plain
    version's, its bound (int8 operations at 1,979 TOPS or bytes at 3.35
    TB/s), the layout copy's time and bound, and two library routes that
    compute the same function: cuDNN's float32 convolution of the codes
    and ``_int_mm`` on an explicit im2col (yardsticks only); the route of
    each of the 53 convolutions and the per-forward sums;
49. ResNet-50 v1 served in int8: ``resnet50_v1`` (25,575,912
    parameters), Xavier weights from a seed, quantized by
    ``quantize_net_graph`` with naive calibration over 10 synthetic
    batches of 32 and with entropy calibration over 2 batches of 4 (the
    calibration's host sampling costs ~70 ns per activation element);
    sessions at batch 1 and 32 under ``native`` beside the float32
    session: ms per predict, img/s, weight bytes, ``accuracy_delta``,
    peak memory, N2 and ``_int_mm`` launches per predict equal to the
    quantized convolutions and FCs, and N2's sm90 launches to the
    convolutions the route rule gives it; once under ``dequant`` (no
    int8 launch); the card's int8 logits within 1e-5 of the CPU port's;
    the block hybridized, captured and replayed bitwise equal to eager,
    a replay launching the sm90 kernel at each of those convolutions;
50. ``quantize_net`` (the block-swap form) on the same network at batch
    32: its calibration, ms per predict and ``accuracy_delta``;
51. GPT-2-small decode on int8 KV pages: phase 18's open-loop traffic
    (the same arrivals and token sequences) on a paged store with
    ``kv_int8=True``: tokens/s and p50/p99 per token beside phase 18's
    float32 pages, the full-length sessions one byte budget holds, and
    every step of phase 18's eight rerun streams within 0.1 of their
    float32-page logits (the JAX bound);
52. ``dist_sync`` data parallelism: ``tools/profile_dist.py`` under
    ``python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local``,
    two ranks on the one card over gloo (the launcher's rule: ranks that
    share a card take gloo): ``resnet50_v1`` at its published widths,
    batch 128 a rank, the fp32 step of phase 16 with
    ``Trainer(kvstore="dist_sync")`` and K4's head; 2 warm-up and 5
    timed steps, each holding the reduced gradient bitwise to the sum of
    the ranks' gradients saved before the reduction and the ranks'
    parameters bitwise equal; steps to 40, the loss at 40 below the
    first; buckets dispatched during backward; a step with
    ``MXNET_ASYNC_GRAD_SYNC=1`` and one with ``=0`` from the same
    weights at deterministic cuDNN (the trainer hooks its reducer when
    it is made, so the first step's buckets leave during backward),
    bitwise equal parameters; ``dist.all_reduce`` and the
    kvstore's push and pull at 1e6, 1e7 and 2.56e7 float32; per rank the
    step ms, img/s, the all-reduce's ms left after backward, the bytes
    reduced, peak memory and K4's launches (2 x 5);
53. one rank over NCCL (one rank, one card): the same step under
    ``dist_device_sync``, 3 timed, then a step bitwise equal to one
    under ``kvstore="device"`` from the same weights; 3 steps with 2-bit
    compression, every parameter's packed codes and residual made on the
    card equal to the CPU port's for the same gradient and residual;
    NCCL's ``all_reduce`` and the kvstore at the same sizes;
54. decode serving traced: on one batcher at GPT-2-small widths, a
    warm-up, then phase 18's own paged open-loop traffic (32 streams of
    16-256 tokens) once to warm up, then in six windows of one pass
    each at ``MXNET_TELEMETRY`` 0, 1, 1, 0, 0 and 1,
    then a shorter traffic (16 streams of 16-48 tokens) at 1 with the
    profiler's device trace (``profiler.start``/``stop``,
    ``torch.profiler`` with the CUDA activity). Level 0 records no span;
    in every level-1 run every request has its ``serving.admission`` and
    ``serving.queue_wait`` spans under one trace id of its own, the
    ``serving.decode_step`` spans equal the steps served and no span is
    dropped; the device trace names K2's kernel 12 times a step (or,
    where kineto does not name kernels inside a replayed graph, holds
    one graph launch a step). Prints tokens/s, decode steps and the mean
    step of each run, whether the levels' gap in tokens/s exceeds the
    spread of the runs at one level, the span and trace event counts,
    and ``trace_top``'s first ten rows;
55. ResNet-50 v1 training traced: phase 30's setup (bf16 AMP, NHWC,
    hybridized, batch 128, fed by ``DeviceFeed``), after the warm-up
    captures 5 steps at level 0, 5 at level 1 and 5 at level 1 with the
    device trace: each traced step's span names on the step loop's
    thread are ``fused_step.execute`` and ``pipeline.feed_wait``, the
    feed's thread stages 5 ``pipeline.prefetch_stage`` spans, and the
    device trace holds K4's ``rtc_softmax_fwd`` and ``_bwd`` once each a
    step; step ms of each run and ``trace_top``'s first ten rows;
56. autotune: under ``MXNET_AUTOTUNE=tune``, ``autotune.tune`` sweeps
    ``quantize.lowering`` on the int8 ResNet-50 at batch 32 (``native``
    runs N2, ``dequant`` cuDNN on float codes) and
    ``fusion.attn_compute_bound_seq`` on wav2vec2's bucket-8 graph, each
    candidate priced by the paired-median harness (3 pairs of windows of
    10 predicts, each window ending in a synchronize) against the
    heuristic; prints each candidate's ratio and the stored winner;
57. artifacts and bundles: a ``ModelRepository`` deploys wav2vec2 at
    bucket 8 (phase 13's export), ResNet-50 in int8 at batch 32 (its
    calibrated graph a program) and GPT-2-small decode, from an empty
    program cache, answers one request each (K1, K3, N2 and K2 launched
    on that path), and exports a bundle of each; a child process
    (``tools/deploy_chain.py serve``) with ``nvcc`` off its ``PATH``,
    ``CUDA_HOME`` pointing nowhere and an empty
    ``MXNET_COMPILE_CACHE_DIR`` imports the bundles, consults the tuned
    records and serves: 0 ``nvcc`` builds, 0 graph-optimizer runs, 0
    calibrations, 0 measurements, ``disk_hits`` equal to the bundles'
    programs, every answer bitwise the exporter's, and the forced
    winners (the lowering's knob, the threshold's trial) bitwise the
    consulted answers; prints the bundles' bytes and the seconds to a
    first response, cold (the exporter) against bundle-warm;
58. the replica fleet: two replica processes of GPT-2-small decode
    share the card behind a ``FleetRouter`` (the second joins from
    phase 57's bundle, building nothing); 16 greedy streams of 24 steps
    through the router's HTTP surface, ``drain("a")`` after step 12:
    every stream pinned to one replica until the drain and to b after
    it, ``drained_sessions`` equal to a's live sessions, K2 launched in
    b, every stream's tokens equal to one in-process session's and its
    logits within 1e-5; prints tokens/s through the router beside phase
    18's and the drain's seconds;
59. the dependency engine on the card: 200 pushes on each lane in push
    order with their var versions, a poisoned var and its reader raised
    again at ``wait_for_var``, an op pushed with ``device=`` whose
    matmuls are finished when ``nd.waitall()`` returns; the host µs a
    push for the native engine and ``NaiveEngine``;
60. record decode: the decoder the machine has (jpeglib.h, nvJPEG, PIL,
    cores) on the example twin's synthetic .rec (512 records of 64
    seeded 252 x 252 JPEGs); on the nvJPEG route the crop kernels
    bitwise against their plain version and their first design
    (``csrc/jpeg_crop_pixel.cu``): ``jpeg_crop`` on the batch of 128,
    ``jpeg_crop_scaled`` on a resize shape (128 seeded 500 x 375 images
    made on the card, resize_short 256, random crops of 224 and
    mirrors), each timed in turns with the first design (pixel, band,
    band, pixel) beside its bound; a ``copy_`` of the output's bytes and
    ``torch.take`` of the crops on an index made outside its timing; and
    the batch of 128 against the Python twin (PIL) within the bounds
    ``tools/profile_records.py`` states: the IDCT's rounding alone on
    4:4:4 JPEGs (a mean of 1.5 levels of 255), the chroma upsampling of
    the .rec's 4:2:0 JPEGs (a luma mean of 3, an RGB mean of 20);
61. ``ImageRecordIter`` alone at 224 x 224, batch 128,
    ``preprocess_threads`` = the machine's cores: images/s; then with
    ``resize=256`` (nvJPEG route), counts reset just before: two batches
    launch ``jpeg_crop_scaled`` and no ``jpeg_crop``;
62. ResNet-50 v1 (bf16 NHWC hybridized under AMP, SGD 0.05) trained 20
    steps from the .rec through ``DeviceFeed``, counts reset just before:
    K4 launched twice a step, ``jpeg_crop`` launched and
    ``jpeg_crop_scaled`` not (nvJPEG route: no resize), the mean loss of
    the last five steps below the first five's; ms a step, images/s and
    the device's idle share beside the same step fed from a batch
    already on the card;
63. the slice's ops (``ops_linalg``, ``ops_image``, ``ops_contrib2``,
    ``ops_contrib3``): every case of ``tools/op_sweep.py``'s ``LINALG``,
    ``IMAGE``, ``CONTRIB2`` and ``CONTRIB3`` tables on the card against
    the CPU port, forward and backward, at the sweep's tolerances, every
    output on the card; every deterministic case but ``linalg_syevd``
    (``torch.linalg.eigh`` reads the solver's error code on the host)
    in one CUDA graph whose replay equals the eager calls bitwise; the
    random image ops captured with the device's generator registered;
64. the two-stage detector ops at published shapes against the CPU port:
    ``Proposal`` at Faster R-CNN's RPN test settings (a 600 x 1000 image,
    a 38 x 63 stride-16 map, 12 anchors, pre 6000, post 300, NMS 0.7)
    with the kept indices equal and the boxes within 1e-5, and
    ``MultiProposal`` at batch 2; ``PSROIPooling`` at R-FCN's VOC head
    (1029 channels, 300 rois, output_dim 21, 7 x 7, scale 1/16) and
    ``DeformablePSROIPooling`` at the same shapes (trans (300, 2, 7, 7),
    part 7, 4 samples a part, trans_std 0.1), forward and backward
    within 1e-5 of max(1, |value|); ``DeformableConvolution`` at
    Deformable ConvNets v1's res5a_branch2b ((1, 512, 38, 63), 3 x 3,
    dilation 2, 512 filters, 4 deformable groups) within 1e-4 of each
    tensor's largest magnitude; each op's card ms (CUDA events) beside
    its CPU ms;
65. SSD300-VGG16 trained from ``ImageDetIter``
    (``tools/profile_detiter.py``): a synthetic detection .rec of 256
    seeded images with 1-5 boxes each (``pack_det`` labels), read with
    ``CreateDetAugmenter(data_shape=(3, 300, 300), rand_crop=0.5,
    rand_pad=0.5, rand_mirror=True, mean=True, std=True)`` through
    ``DeviceFeed``; 10 steps of phase 46's network, loss and optimizer at
    batch 32: every loss finite, every label in [0, 1] or padding, the
    first batch's labels equal to the same iterator and seed run on the
    host; ms a step, images/s and the device's idle share beside the
    step fed from a batch already on the card;
66. ``LibSVMIter``'s parse: a LibSVM file of 40 batches (327,680 rows)
    written from the seed (``profile_sparse.write_libsvm``: 15 one-hot
    features a row, one per field, Zipf 1.1 ranks hashed into 1,000,000
    columns) parsed by ``csrc/textio.cc``; seconds and rows a second;
67. both legs of ``tools/profile_sparse.py`` at 1,000,000 features, batch
    8,192 (the embedding width 64: 256 MB of weights, 512 MB of Adam
    state), 20 steps with lazy SGD and 20 with lazy Adam each on the
    card, each against the CPU port on the same file over the first 3
    steps: the pushed row ids equal at every step, the logits within
    1e-5 relative in L2, the weights after 3 steps within 1e-4; ms a
    step split into its stages (batch assembly and copy, forward
    ``dot``, transposed ``dot``, ``tostype``, push and update, pulls;
    a sync at each boundary), rows a second, unique rows a batch, the
    device's idle share over 5 more steps without the syncs
    (``torch.profiler``) and the peak device memory;
68. the DGL graph ops on a seeded graph of ogbn-arxiv's size (169,343
    nodes, 1,166,243 edges) resident on the card: neighbor sampling of
    1,024 seeds over 2 hops (fan-out 10), the subgraph with its mapping
    on the sampled vertices, ``edge_id`` of 1,024 pairs; every output
    bitwise equal to the CPU port's on the same graph, and each op's
    seconds;
69. ``resnet50_v1`` (1000 classes, 224 x 224, float32; weights from a
    numpy seed, explicit prefix) hybridized, trained by ``Estimator.fit``
    for 2 epochs of 4 seeded batches of 32 on the card (SGD 0.1, momentum
    0.9, wd 1e-4; ``LoggingHandler``, ``CheckpointHandler``,
    ``EarlyStoppingHandler``, an ``mx.Monitor`` collecting every 4th
    step, on which the net runs eagerly) and its twin by a loop written
    by hand with the same Trainer settings, loss, batches and monitor,
    both under cuDNN's deterministic algorithms: every parameter and
    running statistic bitwise equal, the loss finite, the monitor's
    steps and the checkpoint names as expected; the step times (a
    device sync at each end) of both;
70. ``export`` then ``contrib.onnx.export_model`` at (32, 3, 224, 224):
    the file's bytes, nodes, initializers and seconds; the package's
    codec reads it back and every initializer is its parameter, bitwise;
71. ``import_to_gluon(ctx=gpu)``, hybridized, and ``import_model``
    bound through the Executor predict a seeded batch of 32: both within
    rtol = atol = 1e-5 of the exported block's logits; the imported
    block's hybridized predict timed in turns beside the zoo block's;
72. the exported ``.params`` file staged as ``resnet50_v1-<hash>.params``
    under ``$MXNET_HOME/models`` with a run-local checksum entry, loaded
    by ``resnet50_v1(pretrained=True, ctx=gpu, root=...)``: its logits
    bitwise the exported block's;
73. report: one JSON line of kernels, then the device line last.

``python3 chip_smoke.py --chain`` runs phases 1-2, phase 13's export and
56-58 alone; ``--records`` runs phases 1-2 and 59-62 alone; ``--tail``
runs phases 1-2 and 63-65 alone; ``--sparse`` runs phases 1 and 66-68
alone and ``--onnx`` phases 1 and 69-72 (they build no kernel).

Each phase prints the seconds it took.

Needs no network; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import FIRST_COMPLETED, wait

import numpy as onp
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, convert, gluon, nd, rtc, serving  # noqa: E402
from mxnet_tpu_torch.contrib import amp  # noqa: E402
from mxnet_tpu_torch.gluon import fused_step  # noqa: E402
from mxnet_tpu_torch.kernels import _build, _nvrtc  # noqa: E402
from mxnet_tpu_torch.kernels.flash_attention import (  # noqa: E402
    FLASH_KERNEL, FLASH_SM90_KERNEL, KERNEL, _decode_flash, _decode_flash_ref,
    _decode_splits, _flash_fwd_cuda, _flash_load_width, _flash_ref,
    _flash_route, flash_attention)
from mxnet_tpu_torch.ndarray import ops_nn  # noqa: E402
from mxnet_tpu_torch.kernels.norm_act import (  # noqa: E402
    KERNEL as NORM_ACT_KERNEL, _norm_act_cuda, _norm_act_ref)
from mxnet_tpu_torch.kernels import box_nms as n1k  # noqa: E402
from mxnet_tpu_torch.kernels.int8_conv import (  # noqa: E402
    KERNEL as N2_KERNEL, NHWC_KERNEL)
from mxnet_tpu_torch.models import DecoderBlockLM, TransformerLM  # noqa: E402
from mxnet_tpu_torch.tools.profile_predict import (  # noqa: E402
    SAMPLE_RATE, WAV2VEC2_LARGE_LV60, export_wav2vec2, frames)
from mxnet_tpu_torch.benchmark import opperf  # noqa: E402
from mxnet_tpu_torch.tools import op_sweep  # noqa: E402
from mxnet_tpu_torch.tools import profile_module as pm  # noqa: E402
from mxnet_tpu_torch.tools import profile_quant as pq  # noqa: E402
from mxnet_tpu_torch.tools import profile_resnet as pr  # noqa: E402
from mxnet_tpu_torch.tools import profile_ssd as ps  # noqa: E402
from mxnet_tpu_torch.tools import profile_zoo as pz  # noqa: E402
from mxnet_tpu_torch.tools.profile_decode import (  # noqa: E402
    build as decode_stack, profile_steps)
from mxnet_tpu_torch.gluon.model_zoo import vision  # noqa: E402
from mxnet_tpu_torch.resilience import faults  # noqa: E402
from mxnet_tpu_torch.tools import launch  # noqa: E402
from mxnet_tpu_torch.tools import profile_records as prec  # noqa: E402
from mxnet_tpu_torch.kernels import jpeg_decode as jpk  # noqa: E402
from mxnet_tpu_torch.tools import profile_sparse as psp  # noqa: E402
from mxnet_tpu_torch.tools import profile_onnx as po  # noqa: E402

SEED = 20240917
# GPT-2 small (n_embd 768, n_head 12, n_layer 12, n_positions 1024,
# vocab_size 50257, FFN 4 x 768) in the block's own architecture
GPT2_SMALL = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                  num_heads=12, ffn_dim=3072, max_len=1024)
# TransformerLM at the same published widths and depth, with GPT-2's tied
# embedding; dropout 0.0 (the JAX default) instead of GPT-2's 0.1, so the
# run is deterministic: the one cut
GPT2_SMALL_LM = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                     num_heads=12, ffn_dim=3072, max_len=1024,
                     tie_weights=True, dropout=0.0)
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 1024, 3e-4
WARMUP_STEPS, TIMED_STEPS = 2, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bfloat16 on the tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense
# ~200 us at the H100's 1.98 GHz boost clock: longer than a kernel
# wrapper's host cost, so every kernel time below is the device's alone
BUSY_CYCLES = 400_000
KERNEL_RTOL = KERNEL_ATOL = 1e-5
SERVE_RTOL = SERVE_ATOL = 1e-4
# K1 in bfloat16 against the plain version in float32 from the same
# bfloat16 inputs: the kernel rounds once, at the output; two ulps
BF16_RTOL = 2.0 ** -6
# dq/dk/dv: the recompute backward against autograd through the plain
# version, two different fp32 computations over up to 1024 keys
GRAD_TOL = 1e-4
# float32 through different summation orders over 12 layers and a
# 50257-way softmax: the card's cuBLAS and K1 against the CPU's BLAS and
# plain attention
CPU_RTOL = 1e-3
REPS = 25
# the eager per-parameter loop (MXNET_FUSED_STEP=0) timed beside the
# fused step in the same call: this many steps after one warm-up step
EAGER_STEPS = 5
# bf16 AMP on the card against the CPU port, as tests/
# test_torch_amp_training.py holds the port against the JAX package: the
# card's bf16 deviation from its own float32 run within 1.5 x the CPU's
# plus 1e-3 (L2 over the logits and over every gradient), and the bf16
# losses within rtol 2e-2 of each other
AMP_DEV_FACTOR, AMP_DEV_FLOOR, AMP_LOSS_RTOL = 1.5, 1e-3, 2e-2


_PHASE = {"name": None, "t": None}
# the run's scratch directory (the program cache and autotune records
# under MXNET_HOME, phase 13's export, the bundles), removed at exit
WORK = {"dir": None, "home": None, "w2v_prefix": None}


def phase(name):
    """Print the phase's heading, and the seconds the previous phase
    took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"   ({_PHASE['name']}: {now - _PHASE['t']:.1f} s)", flush=True)
    _PHASE["name"], _PHASE["t"] = name, now
    print(f"== {name}", flush=True)


def device_phase():
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    print("float32 matmuls in full float32: "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}; cuDNN's global flags "
          f"at torch's defaults: torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32} (the port scopes its "
          "convolutions to float32)")
    return smi


def build_phase():
    phase("2 build")
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"built {sorted(report) or 'nothing (up to date)'} from "
          f"{_build.CSRC_DIR} in {time.perf_counter() - t0:.2f} s")
    for name, rec in report.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def attention_inputs(gen, B, H, S, D, lengths):
    dev = torch.device("cuda")
    q = torch.randn(B, H, D, device=dev, generator=gen)
    k = torch.randn(B, S, H, D, device=dev, generator=gen)
    v = torch.randn(B, S, H, D, device=dev, generator=gen)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, n


def kernel_check_phase(gen):
    phase("3 K2 check")
    S, H, D = GPT2_SMALL["max_len"], GPT2_SMALL["num_heads"], 64
    cases = [
        (8, H, S, D, [1, 7, S, 333, 512, 2, S - 1, 64]),
        (1, H, S, D, [S]),
        (2, H, S, D, [49, 1]),
        (4, H, S, D, [8, 48, 17, 30]),
        (32, H, S, D, [S] * 32),
        (2, 3, 40, 8, [1, 40]),
        (3, 2, 100, 24, [5, 100, 61]),
        (2, 4, 77, 128, [77, 3]),
        (2, 2, 50, 256, [50, 17]),
    ]
    # the split sweep's edges: an empty row, one key, a chunk's edges, a
    # long and a full cache, alone and all in one batch; a length past S
    edges = [0, 1, 63, 64, 65, 1000, S]
    cases += [(1, H, S, D, [n]) for n in edges]
    cases += [(7, H, S, D, edges), (2, H, S, D, [S + 500, 700])]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for B, H_, S_, D_, lengths in cases:
        q, k, v, n = attention_inputs(gen, B, H_, S_, D_, lengths)
        scale = D_ ** -0.5
        got = _decode_flash(q, k, v, n, scale)
        want = _decode_flash_ref(q, k, v, n, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        splits, chunk = _decode_splits(B, H_, S_, n_sm)
        print(f"  B={B} H={H_} S={S_} D={D_} lengths={lengths[:4]}"
              f"{'...' if len(lengths) > 4 else ''} splits={splits} "
              f"chunk={chunk}: max_abs_err={err:.3e}")
        if not ok:
            raise RuntimeError(f"K2 disagrees with its plain version at "
                               f"B={B} H={H_} S={S_} D={D_}: {err}")
        worst = max(worst, err)
    print(f"K2 matches _decode_flash_ref within rtol=atol={KERNEL_RTOL}; "
          f"worst max_abs_err {worst:.3e}")
    return worst


def time_ms(fn, flush, reps=REPS):
    """Median device ms of ``fn`` over ``reps`` launches, each timed alone
    with CUDA events after ``flush`` evicts the 50 MB L2 — a decode step
    reaches attention with its caches cold. The stream is then kept busy
    for BUSY_CYCLES (``torch.cuda._sleep``), so the host has enqueued
    ``fn`` before the start event runs and a launch's host cost is not
    counted as device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(BUSY_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(B, H, D, lengths):
    """Least ms for one decode-attention call: the larger of the bytes it
    must move (visible K and V, q, lengths in; out) over the memory rate
    and its flops (q.k and p.v, 2 each per element) over the fp32 rate."""
    visible = sum(int(n) for n in lengths)
    nbytes = visible * H * D * 4 * 2 + 2 * B * H * D * 4 + B * 4
    flops = 4 * visible * H * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_times_phase(gen):
    phase("4 K2 times")
    S, H, D = GPT2_SMALL["max_len"], GPT2_SMALL["num_heads"], 64
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for B in (1, 8, 32):
        q, k, v, n = attention_inputs(gen, B, H, S, D, [S] * B)
        scale = D ** -0.5
        mask = (torch.arange(S, device="cuda")[None, :]
                < n[:, None])[:, None, None, :]  # (B, 1, 1, S)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale)[:, :, 0, :]

        lib_err = (library() - _decode_flash_ref(q, k, v, n, scale)) \
            .abs().max().item()
        row = {"B": B, "H": H, "S": S, "D": D, "visible": S,
               "splits": _decode_splits(B, H, S, n_sm)[0],
               "ms": time_ms(lambda: _decode_flash(q, k, v, n, scale),
                             flush),
               "plain_ms": time_ms(
                   lambda: _decode_flash_ref(q, k, v, n, scale), flush),
               "library_ms": time_ms(library, flush),
               "library_max_abs_err": lib_err}
        row["bound_ms"], row["bound_by"] = attention_bound(B, H, D, [S] * B)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("  " + json.dumps(row))
        rows.append(row)
    del flush
    return rows


def serving_phase():
    phase("5 serving")
    cfg = GPT2_SMALL
    ctx = mx.gpu(0)
    mx.random.seed(SEED)
    net = DecoderBlockLM(**cfg)
    net.initialize(ctx=ctx)
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=8,
        byte_budget=0, ttl_s=0, ctx=ctx)
    t0 = time.perf_counter()
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=[1, 2, 4, 8], ctx=ctx)
    n_params = sum(p.data().size for p in net.collect_params().values())
    print(f"DecoderBlockLM {cfg}: {n_params} parameters, "
          f"{store.bytes_per_session} state bytes per session; session "
          f"built and warmed in {time.perf_counter() - t0:.2f} s")
    bat = serving.DynamicBatcher(sess, max_batch_size=8, max_latency_ms=2.0,
                                 timeout_ms=120000, admission=False)
    rs = onp.random.RandomState(SEED)
    lengths = [8, 48] + [int(x) for x in rs.randint(9, 48, size=6)]
    sids = [f"stream{i}" for i in range(len(lengths))]
    toks = {sid: [int(rs.randint(cfg["vocab_size"]))] for sid in sids}
    final = {}
    try:
        _build.reset_launch_counts()
        serving.METRICS.reset()
        t0 = time.perf_counter()
        pending = {bat.submit(onp.array([[toks[sid][0]]], "int32"),
                              session_id=sid): sid for sid in sids}
        while pending:
            done, _ = wait(pending, timeout=600, return_when=FIRST_COMPLETED)
            if not done:
                raise RuntimeError("serving stalled: no step resolved in "
                                   "600 s")
            for fut in done:
                sid = pending.pop(fut)
                logits = onp.asarray(fut.result())
                final[sid] = logits
                if len(toks[sid]) < lengths[sids.index(sid)]:
                    nxt = int(logits.argmax())  # greedy decode
                    toks[sid].append(nxt)
                    pending[bat.submit(onp.array([[nxt]], "int32"),
                                       session_id=sid)] = sid
        wall = time.perf_counter() - t0
        launches = _build.launch_counts().get(KERNEL, 0)
        snap = serving.METRICS.snapshot()
    finally:
        bat.close()
    print(f"graphs per bucket: {sess.graph_stats()}")
    n_tokens = sum(lengths)
    steps = snap["decode_steps"]
    print(f"{len(sids)} streams, lengths {lengths}: {n_tokens} tokens in "
          f"{steps} decode steps, {wall:.3f} s")
    if snap["responses"] != n_tokens or snap["failures"]:
        raise RuntimeError(f"not every request resolved: {snap}")
    if launches != cfg["num_layers"] * steps:
        raise RuntimeError(f"K2 launched {launches} times in {steps} decode "
                           f"steps of {cfg['num_layers']} layers")
    print(f"K2 launches {launches} = {cfg['num_layers']} layers x {steps} "
          "decode steps")
    for sid, logits in final.items():
        if logits.shape != (1, cfg["vocab_size"]) or \
                not onp.isfinite(logits).all():
            raise RuntimeError(f"{sid}: bad logits {logits.shape}")
    # the oracle: the session's own explicit-state loop, one stream at a
    # time (batch 1, so cuBLAS may sum in another order: tolerance)
    worst = 0.0
    for sid in sorted(sids, key=lambda s: -len(toks[s]))[:3]:
        states = [onp.zeros((1,) + s, dt) for s, dt in
                  zip(net.state_row_shapes(), net.state_row_dtypes())]
        for tok in toks[sid]:
            out, states = sess.step(onp.array([[tok]], "int32"),
                                    states=states)
        ref = out.asnumpy()
        err = float(onp.abs(ref - final[sid]).max())
        worst = max(worst, err)
        if not onp.allclose(final[sid], ref, rtol=SERVE_RTOL,
                            atol=SERVE_ATOL):
            raise RuntimeError(f"{sid}: batcher logits differ from the "
                               f"explicit step loop by {err}")
    print(f"three longest streams match the explicit step loop within "
          f"rtol=atol={SERVE_RTOL}; worst max_abs_err {worst:.3e}")
    # the state copies each batched step pays: gather + scatter of 8 slots
    recs = [store.acquire(sid) for sid in sids]
    times = []
    try:
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            store.scatter(recs, store.gather(recs, pad_to=8))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        for rec in recs:
            store.release(rec, stepped=False)
    copy_ms = statistics.median(times)
    copy_bytes = 2 * len(recs) * store.bytes_per_session
    result = {"tokens_per_s": n_tokens / wall,
              "decode_steps": steps,
              "mean_step_ms": mean_step_ms(),
              "mean_rows_per_step": snap["true_rows"] / max(steps, 1),
              "padded_rows": snap["padded_rows"],
              "gather_scatter_ms_at_8": copy_ms,
              "gather_scatter_bytes_at_8": copy_bytes,
              "gather_scatter_bound_ms_at_8":
                  copy_bytes * 2 / HBM_BYTES_PER_S * 1e3,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("serving " + json.dumps(result))
    sess.close()
    store.close()
    return launches, result


def mean_step_ms():
    """Mean host-timed step of the serving registry's execution
    histogram, ms."""
    hist = serving.METRICS.exec_latency
    return hist.sum / max(hist.total, 1) * 1e3


def flash_inputs(gen, B, H, S_q, S_k, D, dtype=torch.float32):
    dev = torch.device("cuda")
    q = torch.randn(B, H, S_q, D, device=dev, generator=gen)
    k = torch.randn(B, H, S_k, D, device=dev, generator=gen)
    v = torch.randn(B, H, S_k, D, device=dev, generator=gen)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def k1_check_phase(gen):
    phase("6 K1 check")
    H, S = GPT2_SMALL_LM["num_heads"], TRAIN_S
    # (B, H, S_q, S_k, D, causal): the training shape; the JAX tests'
    # (tests/test_attention.py:26-78); causal S_q < S_k; D 128 and 256
    cases = [
        (TRAIN_B, H, S, S, 64, True),
        (2, 3, 64, 64, 16, False),
        (2, 3, 64, 64, 16, True),
        (1, 2, 100, 70, 24, False),
        (1, 2, 1, 40, 8, True),
        (2, 4, 100, 300, 64, True),
        (2, 4, 333, 333, 128, True),
        (2, 4, 200, 200, 256, True),
        (128, 1, 499, 499, 64, False),  # the fusion route's shape
        (1, 1, 5, 9, 3, False),  # 12-byte rows: 4-byte copies
    ]
    worst = 0.0
    for B, H_, S_q, S_k, D, causal in cases:
        q, k, v = flash_inputs(gen, B, H_, S_q, S_k, D)
        got = _flash_fwd_cuda(q, k, v, D ** -0.5, causal)
        want = _flash_ref(q, k, v, D ** -0.5, causal)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"  B={B} H={H_} S_q={S_q} S_k={S_k} D={D} causal={causal} "
              f"copies={_flash_load_width(k, v)} B: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1 disagrees with its plain version at "
                               f"{(B, H_, S_q, S_k, D, causal)}: {err}")
        worst = max(worst, err)
    # the model's own layout: q, k, v strided views of one projection
    qkv = torch.randn(2, S, 3, H, 64, device="cuda", generator=gen)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    got = _flash_fwd_cuda(q, k, v, 0.125, True)
    want = _flash_ref(q.contiguous(), k.contiguous(), v.contiguous(), 0.125,
                      True)
    err = (got - want).abs().max().item()
    print(f"  strided views of (2, {S}, 3, {H}, 64) copies="
          f"{_flash_load_width(k, v)} B: max_abs_err={err:.3e}")
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"K1 disagrees on strided views: {err}")
    worst = max(worst, err)
    # an odd s-stride (65 elements): 4-byte copies in float32, element
    # loads in bfloat16
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.randn(3, 2, 3, 90, 65, device="cuda",
                           generator=gen).to(dtype)
        q, k, v = (base[i, ..., :64] for i in range(3))
        got = _flash_fwd_cuda(q, k, v, 0.125, True).float()
        want = _flash_ref(q.float(), k.float(), v.float(), 0.125, True)
        tol = KERNEL_RTOL if dtype == torch.float32 else BF16_RTOL
        want = want.to(dtype).float()
        err = (got - want).abs().max().item()
        print(f"  {str(dtype)[6:]} s-stride {k.stride(2)} (2, 3, 90, 90, 64) "
              f"causal copies={_flash_load_width(k, v)} B: "
              f"max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=tol, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1 disagrees at an odd s-stride in {dtype}: "
                               f"{err}")
        if dtype == torch.float32:
            worst = max(worst, err)
    q, k, v = flash_inputs(gen, 2, H, 512, 512, 64, torch.bfloat16)
    got = _flash_fwd_cuda(q, k, v, 0.125, True).float()
    want = _flash_ref(q.float(), k.float(), v.float(), 0.125, True)
    bf_err = (got - want.to(torch.bfloat16).float()).abs().max().item()
    print(f"  bfloat16 (2, {H}, 512, 512, 64): max_abs_err={bf_err:.3e} "
          f"against the float32 plain version rounded to bfloat16")
    if not torch.allclose(got, want.to(torch.bfloat16).float(),
                          rtol=BF16_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"K1 in bfloat16 is off by {bf_err}")
    # bfloat16 rows that are not 16-byte aligned: 40 bytes (4-byte
    # copies) and 42 bytes (element loads)
    for B, H_, S_q, S_k, D, causal in ((1, 2, 77, 77, 20, False),
                                       (1, 2, 33, 50, 21, True)):
        q, k, v = flash_inputs(gen, B, H_, S_q, S_k, D, torch.bfloat16)
        got = _flash_fwd_cuda(q, k, v, D ** -0.5, causal).float()
        want = _flash_ref(q.float(), k.float(), v.float(), D ** -0.5,
                          causal).to(torch.bfloat16).float()
        err = (got - want).abs().max().item()
        print(f"  bfloat16 B={B} H={H_} S_q={S_q} S_k={S_k} D={D} "
              f"causal={causal} copies={_flash_load_width(k, v)} B: "
              f"max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=BF16_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1 in bfloat16 is off by {err} at "
                               f"{(B, H_, S_q, S_k, D, causal)}")
    q, k, v = flash_inputs(gen, 2, H, S, S, 64)
    do = torch.randn(q.shape, device="cuda", generator=gen)
    grads = []
    for fn in (lambda a, b, c: flash_attention(a, b, c, causal=True),
               lambda a, b, c: _flash_ref(a, b, c, 0.125, True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(do)
        grads.append([t.grad for t in leaves])
    gerr = max((a - b).abs().max().item() for a, b in zip(*grads))
    print(f"  dq/dk/dv at (2, {H}, {S}, {S}, 64) causal: max_abs_err="
          f"{gerr:.3e} against autograd of _flash_ref")
    if not all(torch.allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
               for a, b in zip(*grads)):
        raise RuntimeError(f"K1's gradients are off by {gerr}")
    print(f"K1 matches _flash_ref within rtol=atol={KERNEL_RTOL} in float32; "
          f"worst max_abs_err {worst:.3e}")
    return worst


def flash_bound(B, H, S_q, S_k, D, causal, itemsize=4):
    """Least ms for one K1 call: the larger of its bytes (q, k, v read,
    out written) over the memory rate and its flops (2*D for q.k and
    2*D for p.v per visible query-key pair) over the fp32 rate."""
    if causal:  # row i sees keys 0 .. i + S_k - S_q
        pairs = S_q * (S_q + 1) // 2 + S_q * (S_k - S_q)
    else:
        pairs = S_q * S_k
    flops = 4 * D * B * H * pairs
    nbytes = (2 * B * H * S_q * D + 2 * B * H * S_k * D) * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def add_k1_rates(row):
    """The 3xTF32 bound (three TF32 products per fp32 product, at 495
    TFLOP/s, or the bytes if larger), both bounds' shares and the
    achieved fp32-equivalent TFLOP/s of a phase-7 or -12 row."""
    row["bound_3xtf32_ms"] = max(row["bytes"] / HBM_BYTES_PER_S,
                                 3 * row["flops"] / TF32_FLOPS) * 1e3
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["bound_3xtf32_share"] = row["bound_3xtf32_ms"] / row["ms"]
    row["achieved_tflops"] = row["flops"] / row["ms"] / 1e9


def k1_times_phase(gen):
    phase("7 K1 times")
    B, H, S, D = TRAIN_B, GPT2_SMALL_LM["num_heads"], TRAIN_S, 64
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    q, k, v = flash_inputs(gen, B, H, S, S, D)
    scale = D ** -0.5

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)

    lib_err = (library() - _flash_ref(q, k, v, scale, True)).abs().max()
    row = {"B": B, "H": H, "S_q": S, "S_k": S, "D": D, "causal": True,
           "ms": time_ms(lambda: _flash_fwd_cuda(q, k, v, scale, True),
                         flush),
           "plain_ms": time_ms(lambda: _flash_ref(q, k, v, scale, True),
                               flush),
           "library_ms": time_ms(library, flush),
           "library_max_abs_err": lib_err.item()}
    row["bound_ms"], row["bound_by"], row["flops"], row["bytes"] = \
        flash_bound(B, H, S, S, D, True)
    add_k1_rates(row)
    print("  " + json.dumps(row))
    del flush
    return row


def eager_step_ms(step):
    """The eager per-parameter loop (``MXNET_FUSED_STEP=0``) timed beside
    the fused step in the same call: ``step(events)`` runs one training
    step recording four CUDA events (forward, backward, optimizer); one
    warm-up, then EAGER_STEPS host-timed steps. Returns the mean step ms
    and the mean optimizer ms."""
    os.environ["MXNET_FUSED_STEP"] = "0"
    try:
        step(None)
        torch.cuda.synchronize()
        step_ms, opt_ms = [], []
        for _ in range(EAGER_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t0 = time.perf_counter()
            step(ev)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            opt_ms.append(ev[2].elapsed_time(ev[3]))
    finally:
        os.environ.pop("MXNET_FUSED_STEP", None)
    return statistics.mean(step_ms), statistics.mean(opt_ms)


def check_fused(trainer, steps):
    """The fused step ran as one captured CUDA graph replayed every step."""
    st = fused_step.fused_step_stats()
    if trainer._fused is None or trainer._fused["graph"] is None or \
            st["captures"] != 1 or st["replays"] != steps:
        raise RuntimeError(f"the fused step did not run as one graph "
                           f"replayed {steps} times: {st}")
    return st


def training_phase():
    phase("8 training")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    mx.random.seed(SEED)
    net = TransformerLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    toks = nd.array(onp.random.RandomState(SEED).randint(
        0, vocab, (TRAIN_B, TRAIN_S)).astype("int32"), ctx=ctx)
    labels = toks[:, 1:].reshape(-1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})

    def step(ev=None):
        ev = ev or [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with autograd.record():
            logits = net(toks)
            # next-token loss, as tests/test_attention.py's training test
            loss = loss_fn(logits[:, :-1].reshape(-1, vocab), labels).mean()
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.step(TRAIN_B)
        ev[3].record()
        return loss, ev

    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_STEPS):
        loss, _ = step()
        losses.append(loss.asscalar())
        if i == 0:
            bad = [name for name, p in net.collect_params().items()
                   if not torch.isfinite(p.grad().data).all()]
            if bad:
                raise RuntimeError(f"non-finite gradients after step 1: "
                                   f"{bad[:5]}")
    torch.cuda.synchronize()
    n_params = sum(p.data().size for p in net.collect_params().values())
    print(f"TransformerLM {cfg}: {n_params} parameters; batch {TRAIN_B} x "
          f"{TRAIN_S} tokens, Adam lr {TRAIN_LR}; {WARMUP_STEPS} warm-up "
          f"steps done")
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss, ev = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    launches = counts.get(FLASH_KERNEL, 0)
    sm90 = counts.get(FLASH_SM90_KERNEL, 0)
    print(f"losses {[round(x, 4) for x in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not go down: {losses}")
    want = cfg["num_layers"] * TIMED_STEPS
    if launches != want:
        raise RuntimeError(f"K1 launched {launches} times in {TIMED_STEPS} "
                           f"steps of {cfg['num_layers']} layers")
    print(f"K1 launches {launches} = {cfg['num_layers']} layers x "
          f"{TIMED_STEPS} timed steps")
    stats = check_fused(trainer, WARMUP_STEPS + TIMED_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    peak = torch.cuda.max_memory_allocated() / 1e9
    eager_ms, eager_opt = eager_step_ms(step)
    result = {"tokens_per_s": TRAIN_B * TRAIN_S * TIMED_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0], "last_loss": losses[-1],
              "peak_memory_gb": peak, "fused_step": stats,
              "eager_loop_mean_step_ms": eager_ms,
              "eager_loop_optimizer_ms": eager_opt}
    print("training " + json.dumps(result))
    return net, launches, result


def training_vs_cpu_phase(net):
    phase("9 training against the CPU")
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    arrays = {name: p.data().asnumpy()
              for name, p in net._collect_params_with_prefix().items()}
    cpu_net = convert.params_from_numpy(TransformerLM(**cfg), arrays,
                                        ctx=mx.cpu())
    toks = onp.random.RandomState(SEED + 1).randint(0, vocab, (1, 128))
    watched = ["embed.weight",
               f"blocks.{cfg['num_layers'] // 2}.attn.qkv.weight",
               "ln_f.gamma"]
    results = []
    for model, ctx in ((net, mx.gpu(0)), (cpu_net, mx.cpu())):
        t = nd.array(toks.astype("int32"), ctx=ctx)
        _build.reset_launch_counts()
        with autograd.record():
            logits = model(t)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                logits[:, :-1].reshape(-1, vocab),
                t[:, 1:].reshape(-1)).mean()
        loss.backward()
        params = model._collect_params_with_prefix()
        results.append((loss.asscalar(),
                        {n: params[n].grad().asnumpy() for n in watched},
                        _build.launch_counts().get(FLASH_KERNEL, 0)))
    (gl, gg, glaunch), (cl, cg, claunch) = results
    if glaunch != cfg["num_layers"] or claunch != 0:
        raise RuntimeError(f"K1 launches: card {glaunch}, CPU {claunch}")
    print(f"loss card {gl:.6f} cpu {cl:.6f}")
    if not onp.isclose(gl, cl, rtol=CPU_RTOL, atol=0):
        raise RuntimeError(f"loss differs: card {gl}, CPU {cl}")
    worst = {}
    for n in watched:
        # rtol against the gradient's own scale: entries near zero keep
        # no relative precision through the reordered sums
        scale = float(onp.abs(cg[n]).max())
        err = float(onp.abs(gg[n] - cg[n]).max())
        worst[n] = err / scale
        print(f"  grad {n}: max_abs_err {err:.3e}, {err / scale:.3e} of its "
              f"largest entry {scale:.3e}")
        if not onp.allclose(gg[n], cg[n], rtol=CPU_RTOL,
                            atol=CPU_RTOL * scale):
            raise RuntimeError(f"gradient of {n} differs from the CPU's")
    print(f"card matches CPU within rtol {CPU_RTOL}")
    return {"loss_card": gl, "loss_cpu": cl, "grad_rel_err": worst}


# -- the symbolic-serving path: K3 and K1 behind the fusion pass ----------

W2V_CFG = WAV2VEC2_LARGE_LV60
W2V_SECONDS = 10
W2V_BUCKETS = (1, 2, 4, 8)
W2V_REQUESTS = (1, 3, 8, 5, 2)  # clips per request
# activation codes of csrc/norm_act.cu and the slope each takes
K3_ACTS = {"relu": (0, 0.0), "sigmoid": (1, 0.0), "tanh": (2, 0.0),
           "softrelu": (3, 0.0), "softsign": (4, 0.0), "leaky": (5, 0.25),
           "elu": (6, 1.0), "selu": (7, 0.0), "gelu": (8, 0.0),
           "rrelu": (9, (0.125 + 0.334) / 2)}
GELU = K3_ACTS["gelu"]
LN_EPS = W2V_CFG["layer_norm_eps"]
# one bfloat16 ulp (8 significant bits) at the output's scale
BF16_ULP = 2.0 ** -7
# float32 logits through ~700 reordered ops: the fused graph (K3's and
# K1's sums) against the unfused one on the card, scaled by the largest
# logit
FUSION_TOL = 1e-4


def k3_path_shapes():
    """(rows, C) of the seven K3 launches of one bucket-8 forward."""
    b = W2V_BUCKETS[-1]
    return [(b * t, c) for t, c in zip(frames(W2V_CFG, W2V_SECONDS *
                                              SAMPLE_RATE),
                                       W2V_CFG["conv_dim"])]


def k3_inputs(gen, rows, C, dtype=torch.float32):
    dev = torch.device("cuda")
    x = torch.randn(rows, C, device=dev, generator=gen) * 2 + 0.5
    g = 1 + 0.1 * torch.randn(C, device=dev, generator=gen)
    b = 0.1 * torch.randn(C, device=dev, generator=gen)
    return x.to(dtype), g.to(dtype), b.to(dtype)


def k3_check_phase(gen):
    phase("10 K3 check")
    cases = [(rows, C, "gelu") for rows, C in k3_path_shapes()]
    cases += [(1001, 512, "gelu"), (3, 100, "gelu"), (517, 768, "gelu"),
              (64, 1024, "gelu"), (33, 1030, "gelu"), (250, 4096, "gelu")]
    cases += [(999, C, act) for act in K3_ACTS for C in (512, 100, 4096)]
    worst = 0.0
    for rows, C, act in cases:
        code, slope = K3_ACTS[act]
        x, g, b = k3_inputs(gen, rows, C)
        got = _norm_act_cuda(x, g, b, LN_EPS, code, slope)
        want = _norm_act_ref(x, g, b, LN_EPS, code, slope)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if act == "gelu" or C == 512:
            print(f"  rows={rows} C={C} {act}: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K3 disagrees with its plain version at "
                               f"rows={rows} C={C} {act}: {err}")
        worst = max(worst, err)
    for rows, C in ((8 * 499, 512), (999, 100), (77, 4096)):
        x, g, b = k3_inputs(gen, rows, C, torch.bfloat16)
        got = _norm_act_cuda(x, g, b, LN_EPS, *GELU).float()
        want = _norm_act_ref(x, g, b, LN_EPS, *GELU).float()
        err = (got - want).abs().max().item()
        print(f"  bfloat16 rows={rows} C={C} gelu: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=BF16_ULP, atol=KERNEL_ATOL):
            raise RuntimeError(f"K3 in bfloat16 is off by {err} at "
                               f"rows={rows} C={C}")
    print(f"K3 matches _norm_act_ref within rtol=atol={KERNEL_RTOL} in "
          f"float32 over {len(cases)} cases; worst max_abs_err {worst:.3e}")
    return worst


def k3_bound(rows, C, itemsize=4):
    """Least ms for one K3 call: x read and out written once, gamma and
    beta once (bytes at 3.35 TB/s), against ~12 fp32 operations per
    element at 67 TFLOP/s."""
    nbytes = 2 * rows * C * itemsize + 2 * C * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 12 * rows * C / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def k3_times_phase(gen):
    phase("11 K3 times")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    F = torch.nn.functional
    rows_out = []
    for rows, C in k3_path_shapes():
        x, g, b = k3_inputs(gen, rows, C)

        def library():
            return F.gelu(F.layer_norm(x, (C,), g, b, LN_EPS))

        row = {"rows": rows, "C": C,
               "ms": time_ms(lambda: _norm_act_cuda(x, g, b, LN_EPS, *GELU),
                             flush),
               "plain_ms": time_ms(
                   lambda: _norm_act_ref(x, g, b, LN_EPS, *GELU), flush),
               "library_ms": time_ms(library, flush)}
        row["bound_ms"], row["bound_by"], row["bytes"] = k3_bound(rows, C)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("  " + json.dumps(row))
        rows_out.append(row)
        del x, g, b
    total = {k: sum(r[k] for r in rows_out)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes")}
    print("  seven launches of one bucket-8 forward: " + json.dumps(total))
    del flush
    return rows_out, total


def k1_route_phase(gen):
    phase("12 K1 on the fusion route")
    B, S = W2V_BUCKETS[-1] * W2V_CFG["num_attention_heads"], \
        frames(W2V_CFG, W2V_SECONDS * SAMPLE_RATE)[-1]
    D = W2V_CFG["hidden_size"] // W2V_CFG["num_attention_heads"]
    q, k, v = flash_inputs(gen, B, 1, S, S, D)
    scale = D ** -0.5
    got = _flash_fwd_cuda(q, k, v, scale, False)
    want = _flash_ref(q, k, v, scale, False)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"  B={B} H=1 S={S} D={D} not causal: max_abs_err={err:.3e}")
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"K1 disagrees with its plain version on the "
                           f"fusion route: {err}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale)

    lib_err = (library() - want).abs().max().item()
    row = {"B": B, "H": 1, "S_q": S, "S_k": S, "D": D, "causal": False,
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "ms": time_ms(lambda: _flash_fwd_cuda(q, k, v, scale, False),
                         flush),
           "plain_ms": time_ms(lambda: _flash_ref(q, k, v, scale, False),
                               flush),
           "library_ms": time_ms(library, flush)}
    row["bound_ms"], row["bound_by"], row["flops"], row["bytes"] = \
        flash_bound(B, 1, S, S, D, False)
    add_k1_rates(row)
    print("  " + json.dumps(row))
    del flush
    return row


def _fused_nodes(block, batch):
    g = block._optimized_outputs(nd.zeros(
        (batch, W2V_SECONDS * SAMPLE_RATE, 1), ctx=mx.gpu(0)))
    out = {}
    for s in g._walk():
        if s._op in ("_fused_norm_act", "_fused_attention"):
            out.setdefault(s._op, []).append(s._kwargs["impl"])
    return out


def symbolic_phase():
    phase("13 symbolic serving")
    os.environ["MXNET_GRAPH_OPT"] = "1"
    cfg = W2V_CFG
    samples = W2V_SECONDS * SAMPLE_RATE
    n_layers = cfg["num_hidden_layers"]
    n_ln_act = len(cfg["conv_dim"])
    print(f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    # exported into the run's scratch directory: phases 56-57 serve it
    with contextlib.nullcontext(WORK["dir"]) as tmp:
        prefix = os.path.join(tmp, "wav2vec2-large-lv60")
        WORK["w2v_prefix"] = prefix
        t0 = time.perf_counter()
        n_params = export_wav2vec2(prefix, mx.sym, nd, cfg, SEED)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess = serving.InferenceSession.load(
            prefix, input_shapes=[(1, samples, 1)], buckets=list(W2V_BUCKETS),
            ctx=mx.gpu(0))
        t_load = time.perf_counter() - t0
        print(f"wav2vec2-large-lv60 CTC {cfg}: {n_params} parameters "
              f"({n_params * 4 / 1e9:.3f} GB fp32); exported in "
              f"{t_export:.2f} s, loaded and warmed at buckets "
              f"{list(W2V_BUCKETS)} in {t_load:.2f} s")
        for b in W2V_BUCKETS:
            fused = _fused_nodes(sess._block, b)
            na = fused.get("_fused_norm_act", [])
            att = fused.get("_fused_attention", [])
            if len(na) != n_ln_act or len(att) != n_layers or \
                    set(na + att) != {"cuda"}:
                raise RuntimeError(f"bucket {b}: optimized graph holds "
                                   f"norm_act {na}, attention {att}")
        print(f"every bucket's optimized graph: {n_ln_act} _fused_norm_act "
              f"and {n_layers} _fused_attention, all impl='cuda'")
        rng = onp.random.default_rng(SEED)
        reqs = [rng.standard_normal((n, samples, 1), dtype=onp.float32)
                for n in W2V_REQUESTS]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        serving.METRICS.reset()
        torch.cuda.reset_peak_memory_stats()
        outs, req_ms = [], []
        t_all = time.perf_counter()
        for x in reqs:
            t0 = time.perf_counter()
            outs.append(sess.predict(x).asnumpy())
            req_ms.append((time.perf_counter() - t0) * 1e3)
        wall = time.perf_counter() - t_all
        counts = _build.launch_counts()
        snap = serving.METRICS.snapshot()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        execs = snap["bucket_execs"]
        k3 = counts.get(NORM_ACT_KERNEL, 0)
        k1 = counts.get(FLASH_KERNEL, 0)
        if k3 != n_ln_act * execs or k1 != n_layers * execs:
            raise RuntimeError(f"K3 launched {k3}, K1 {k1} times in {execs} "
                               "bucket executions")
        print(f"K3 launches {k3} = {n_ln_act} x {execs} bucket executions; "
              f"K1 launches {k1} = {n_layers} x {execs}")
        T = frames(cfg, samples)[-1]
        for n, o in zip(W2V_REQUESTS, outs):
            if o.shape != (n, T, cfg["vocab_size"]) or \
                    not onp.isfinite(o).all():
                raise RuntimeError(f"bad logits {o.shape} for {n} clips")
        buckets = [min(b for b in W2V_BUCKETS if b >= n)
                   for n in W2V_REQUESTS]
        clips = sum(W2V_REQUESTS)
        result = {"clips_per_s": clips / wall,
                  "audio_seconds_per_s": clips * W2V_SECONDS / wall,
                  "mean_request_ms": statistics.mean(req_ms),
                  "request_ms": dict(zip(
                      [f"{n} clips (bucket {b})"
                       for n, b in zip(W2V_REQUESTS, buckets)], req_ms)),
                  "bucket_execs": execs, "padded_rows": snap["padded_rows"],
                  "true_rows": snap["true_rows"],
                  "peak_memory_gb": peak_gb}
        print("symbolic serving " + json.dumps(result))
        # the same export with the fusion pass off: every node 1:1
        big = W2V_REQUESTS.index(W2V_BUCKETS[-1])
        os.environ["MXNET_FUSION"] = "0"
        try:
            plain = sess.predict(reqs[big]).asnumpy()
        finally:
            del os.environ["MXNET_FUSION"]
        scale = float(onp.abs(plain).max())
        ferr = float(onp.abs(outs[big] - plain).max())
        print(f"fused against MXNET_FUSION=0 at bucket {W2V_BUCKETS[-1]}: "
              f"max_abs_err {ferr:.3e}, {ferr / scale:.3e} of the largest "
              f"logit {scale:.3e}")
        if ferr > FUSION_TOL * scale:
            raise RuntimeError(f"fused logits differ from the unfused graph "
                               f"by {ferr}")
        # one 1 s clip on the card and on the CPU port, same export
        short = SAMPLE_RATE
        clip = rng.standard_normal((1, short, 1), dtype=onp.float32)
        card = serving.InferenceSession(
            sess._block, input_shapes=[(1, short, 1)], buckets=[1],
            ctx=mx.gpu(0)).predict(clip).asnumpy()
        cpu = serving.InferenceSession.load(
            prefix, input_shapes=[(1, short, 1)], buckets=[1],
            ctx=mx.cpu()).predict(clip).asnumpy()
    cscale = float(onp.abs(cpu).max())
    cerr = float(onp.abs(card - cpu).max())
    print(f"1 s clip, card against the CPU port: max_abs_err {cerr:.3e}, "
          f"{cerr / cscale:.3e} of the largest logit {cscale:.3e}")
    if not onp.allclose(card, cpu, rtol=CPU_RTOL, atol=CPU_RTOL * cscale):
        raise RuntimeError(f"card logits differ from the CPU's by {cerr}")
    result.update(n_params=n_params, fused_rel_err=ferr / scale,
                  cpu_rel_err=cerr / cscale, k3_launches=k3, k1_launches=k1)
    return result


# -- K4: rtc.CudaModule, and the ResNet-50 training path it serves -------

# the double kernel of tests/test_quant_custom.py:162-172 in CUDA C, and an
# axpy with a scalar argument; compiled with --fmad=false so y + a * x
# rounds twice, as torch's two ops do
K4_SRC = r"""
extern "C" __global__ void double_kernel(const float* x, float* y,
                                         long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}
extern "C" __global__ void axpy(const float* x, float* y, float a,
                                long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += a * x[i];
}
"""
K4_N = 2 ** 26
# the softmax kernels against their plain versions: the same fp32
# arithmetic, the row sums in another order
SOFTMAX_TOL = 1e-6
SOFTMAX_SHAPE = (128, 1000)  # the ResNet-50 head's (batch, classes)
RESNET_B, RESNET_WARMUP, RESNET_STEPS = 128, 2, 10
# SGD at lr 0.1 with momentum 0.9 and no warm-up overshoots on the fixed
# batch for about its first 20 steps: at step 12 the loss stands above
# its start in about half the runs on an H100, since cuDNN's algorithms
# sum in an order that varies from run to run and the overshoot
# amplifies it. From about step 20 it falls steadily in every run. So
# the falling-loss check reads the loss after this many steps in all;
# those after the timed ones are not timed
RESNET_FALL_STEPS = 40
# the rtc_softmax head's gradient against SoftmaxCrossEntropyLoss's, both
# p - onehot, through the same network on the card, relative to the
# largest gradient entry of the model
HEAD_TOL = 1e-4


def _launch_1d(kernel, args, n):
    kernel.launch(args, mx.gpu(0), ((n + 255) // 256, 1, 1), (256, 1, 1))


def k4_check_phase(gen):
    phase("14 K4 check")
    print(f"NVRTC {'.'.join(map(str, _nvrtc.nvrtc_version()))} from "
          f"{_nvrtc.nvrtc_path()}; modules compiled for {rtc.ARCH}")
    t0 = time.perf_counter()
    mod = rtc.CudaModule(K4_SRC, options=["--fmad=false"])
    print(f"double/axpy module compiled in {time.perf_counter() - t0:.3f} s")
    double = mod.get_kernel("double_kernel",
                            "const float* x, float* y, int64_t n")
    axpy = mod.get_kernel("axpy", "const float* x, float* y, float a, "
                                  "int64_t n")
    x = torch.randn(K4_N, device="cuda", generator=gen)
    y = torch.empty_like(x)
    _launch_1d(double, [x, y, K4_N], K4_N)
    if not torch.equal(y, x * 2):
        raise RuntimeError("K4 double_kernel differs from x * 2")
    y0 = torch.randn(K4_N, device="cuda", generator=gen)
    y = y0.clone()
    _launch_1d(axpy, [nd.NDArray(x), nd.NDArray(y), 0.75, K4_N], K4_N)
    if not torch.equal(y, y0 + 0.75 * x):
        raise RuntimeError("K4 axpy differs from y + 0.75 * x")
    print(f"double and axpy on {K4_N} fp32 elements equal torch's x * 2 and "
          "y + 0.75 * x exactly")
    worst = 0.0
    for B, C in (SOFTMAX_SHAPE, (128, 1001), (64, 4097)):
        x = torch.randn(B, C, device="cuda", generator=gen) * 4
        label = torch.randint(0, C, (B,), device="cuda",
                              generator=gen).float()
        p = torch.zeros_like(x)
        pr.softmax_fwd(x, p)
        dx = torch.zeros_like(x)
        pr.softmax_bwd(label, p, dx)
        torch.cuda.synchronize()
        for what, got, want in (("forward", p, pr.softmax_fwd_plain(x)),
                                ("backward", dx,
                                 pr.softmax_bwd_plain(label, p))):
            err = (got - want).abs().max().item()
            print(f"  rtc_softmax {what} B={B} C={C}: max_abs_err={err:.3e}")
            if not torch.allclose(got, want, rtol=SOFTMAX_TOL,
                                  atol=SOFTMAX_TOL):
                raise RuntimeError(f"rtc_softmax {what} disagrees with its "
                                   f"plain version at B={B} C={C}: {err}")
            worst = max(worst, err)
    try:
        rtc.CudaModule('extern "C" __global__ void f(float* x) '
                       '{ x[0] = undefined_name; }')
        raise RuntimeError("a source that does not compile was accepted")
    except mx.MXNetError as e:
        if "undefined_name" not in str(e):
            raise RuntimeError(f"the compile error lacks NVRTC's log: {e}")
    refusals = (
        ("dtype", lambda: _launch_1d(double, [x.double(), y, 8], 8),
         "float64"),
        ("cpu ctx", lambda: double.launch([x, y, 8], mx.cpu(), (1, 1, 1),
                                          (32, 1, 1)), "GPU context"))
    for what, fn, msg in refusals:
        try:
            fn()
            raise RuntimeError(f"K4 launch with a wrong {what} was accepted")
        except mx.MXNetError as e:
            if msg not in str(e):
                raise
    print("a compile error raises with NVRTC's log; a dtype mismatch and a "
          "CPU context raise MXNetError")
    print(f"rtc_softmax matches its plain versions within rtol=atol="
          f"{SOFTMAX_TOL}; worst max_abs_err {worst:.3e}")
    return worst, double


def k4_bound(nbytes):
    """Least ms for a memory-bound launch moving ``nbytes`` (each input
    read once, each output written once) at 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def k4_times_phase(gen, double):
    phase("15 K4 times")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    B, C = SOFTMAX_SHAPE
    x = torch.randn(B, C, device="cuda", generator=gen) * 4
    label = torch.randint(0, C, (B,), device="cuda", generator=gen).float()
    p, dx = torch.zeros_like(x), torch.zeros_like(x)
    pr.softmax_fwd(x, p)

    def t(fn):
        return time_ms(fn, flush)

    fwd = {"B": B, "C": C, "ms": t(lambda: pr.softmax_fwd(x, p)),
           "plain_ms": t(lambda: pr.softmax_fwd_plain(x)),
           "library_ms": t(lambda: torch.softmax(x, -1)),
           "bound_ms": k4_bound(2 * B * C * 4), "bound_by": "bytes"}
    # the library call: softmax's backward, torch._softmax_backward_data,
    # which gives p * (g - sum(g * p)) = p - onehot(label) for the head
    # gradient g = 1 - onehot / p (made outside the timing)
    onehot = (torch.arange(C, device="cuda")
              == label.to(torch.int64)[:, None]).float()
    g_head = 1.0 - onehot / p
    lib = torch._softmax_backward_data(g_head, p, -1, torch.float32)
    lib_dev = float((lib - pr.softmax_bwd_plain(label, p)).abs().max())
    bwd = {"B": B, "C": C, "ms": t(lambda: pr.softmax_bwd(label, p, dx)),
           "plain_ms": t(lambda: pr.softmax_bwd_plain(label, p)),
           "library_ms": t(lambda: torch._softmax_backward_data(
               g_head, p, -1, torch.float32)),
           "library_call": "torch._softmax_backward_data",
           "library_max_abs_dev": lib_dev,
           "bound_ms": k4_bound(2 * B * C * 4 + B * 4), "bound_by": "bytes"}
    xd = torch.randn(K4_N, device="cuda", generator=gen)
    yd = torch.empty_like(xd)
    dbl = {"n": K4_N,
           "ms": t(lambda: _launch_1d(double, [xd, yd, K4_N], K4_N)),
           "plain_ms": t(lambda: xd * 2),
           "bound_ms": k4_bound(2 * K4_N * 4), "bound_by": "bytes"}
    for row in (fwd, bwd, dbl):
        row["bound_share"] = row["bound_ms"] / row["ms"]
    dbl["achieved_tb_per_s"] = 2 * K4_N * 4 / dbl["ms"] / 1e9
    # host cost of one launch call: argument checks, context, stream and
    # cuLaunchKernel, for a one-block kernel
    small = torch.zeros(256, device="cuda")
    for _ in range(100):
        _launch_1d(double, [small, small, 256], 256)
    torch.cuda.synchronize()
    n_calls = 2000
    t0 = time.perf_counter()
    for _ in range(n_calls):
        _launch_1d(double, [small, small, 256], 256)
    host_us = (time.perf_counter() - t0) / n_calls * 1e6
    torch.cuda.synchronize()
    dbl["host_us_per_launch"] = host_us
    for name, row in (("rtc_softmax_fwd", fwd), ("rtc_softmax_bwd", bwd),
                      ("double_kernel", dbl)):
        print(f"  {name} " + json.dumps(row))
    del flush, xd, yd
    return fwd, bwd, dbl


def _grads(net):
    return {n: p.grad().asnumpy()
            for n, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def resnet_phase():
    phase("16 ResNet-50 training")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    # cuDNN times its convolution algorithms at first use of a shape, as
    # MXNet does by default (MXNET_CUDNN_AUTOTUNE_DEFAULT=1); TF32 stays off
    torch.backends.cudnn.benchmark = True
    print(f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cudnn."
          f"benchmark = {torch.backends.cudnn.benchmark}")
    t0 = time.perf_counter()
    net = pr.build_resnet50(ctx, seed=SEED)
    params = net._collect_params_with_prefix()
    n_params = sum(p.data().size for p in params.values()
                   if p.grad_req != "null")
    trainer = pr.make_trainer(net)
    x, y = pr.synthetic_batch(RESNET_B, ctx, seed=SEED)
    print(f"resnet50_v1: {n_params} trainable parameters; batch {RESNET_B} "
          f"x 3 x {pr.IMAGE} x {pr.IMAGE} fp32, {pr.CLASSES} classes, SGD "
          f"lr {pr.LR} momentum {pr.MOMENTUM} wd {pr.WD}; built in "
          f"{time.perf_counter() - t0:.2f} s")
    stats0 = {n: p.data().asnumpy() for n, p in params.items()
              if n.endswith(("running_mean", "running_var"))}
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(RESNET_WARMUP):
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
        if i == 0:
            bad = [n for n, g in _grads(net).items()
                   if not onp.isfinite(g).all()]
            if bad:
                raise RuntimeError(f"non-finite gradients after step 1: "
                                   f"{bad[:5]}")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(RESNET_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        loss = pr.train_step(net, trainer, x, y, events=ev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    while len(losses) < RESNET_FALL_STEPS:
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
    print(f"losses {[round(v, 4) for v in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"ResNet-50 training did not go down in "
                           f"{len(losses)} steps: {losses}")
    bad = [n for n, g in _grads(net).items() if not onp.isfinite(g).all()]
    if bad:
        raise RuntimeError(f"non-finite gradients: {bad[:5]}")
    moved = [n for n, v in stats0.items()
             if not onp.array_equal(params[n].data().asnumpy(), v)]
    if len(moved) != len(stats0):
        raise RuntimeError(f"running statistics that never moved: "
                           f"{sorted(set(stats0) - set(moved))[:5]}")
    fwd_n, bwd_n = counts.get(pr.FWD_KERNEL, 0), counts.get(pr.BWD_KERNEL, 0)
    if fwd_n != RESNET_STEPS or bwd_n != RESNET_STEPS:
        raise RuntimeError(f"K4 launched forward {fwd_n}, backward {bwd_n} "
                           f"times in {RESNET_STEPS} steps")
    print(f"K4 launches {fwd_n + bwd_n} = 2 x {RESNET_STEPS} steps "
          f"({pr.FWD_KERNEL} {fwd_n}, {pr.BWD_KERNEL} {bwd_n}); all "
          f"{len(stats0)} running statistics moved; every gradient finite")
    stats = check_fused(trainer, RESNET_FALL_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    eager_ms, eager_opt = eager_step_ms(
        lambda ev: pr.train_step(net, trainer, x, y, events=ev))
    # scoring: the eval forward at the same batch (BASELINE's other fp32
    # configuration)
    for _ in range(2):
        net(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        out = net(x)
    torch.cuda.synchronize()
    score_s = (time.perf_counter() - t0) / RESNET_STEPS
    if out.shape != (RESNET_B, pr.CLASSES) or \
            not torch.isfinite(out.data).all():
        raise RuntimeError(f"bad scoring output {out.shape}")
    result = {"img_per_s": RESNET_B * RESNET_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0],
              "timed_last_loss": losses[RESNET_WARMUP + RESNET_STEPS - 1],
              "last_loss": losses[-1], "steps": len(losses),
              "peak_memory_gb": peak_gb,
              "scoring_img_per_s": RESNET_B / score_s,
              "scoring_ms": score_s * 1e3, "n_params": n_params,
              "fused_step": stats, "eager_loop_mean_step_ms": eager_ms,
              "eager_loop_optimizer_ms": eager_opt}
    print("resnet training " + json.dumps(result))
    return net, (fwd_n, bwd_n), result


def resnet_cpu_compare():
    """One record/backward of ResNet-50 at batch 2 on the card (K4) and
    on the CPU (the plain head) from the same fresh weights, in eval and
    training mode: the loss and the watched gradients within rtol 1e-3.
    Returns each watched value's deviation relative to its largest
    entry."""
    # fresh weights from the seed (running statistics at their initial
    # values), on the card and, carried across, on the CPU
    fresh = pr.build_resnet50(mx.gpu(0), seed=SEED + 1)
    arrays = {n: p.data().asnumpy()
              for n, p in fresh._collect_params_with_prefix().items()}
    cpu_net = convert.params_from_numpy(vision.resnet50_v1(), arrays,
                                        ctx=mx.cpu())
    rs = onp.random.RandomState(SEED + 1)
    xb = rs.standard_normal((2, 3, pr.IMAGE, pr.IMAGE)).astype("float32")
    yb = rs.randint(0, pr.CLASSES, 2).astype("float32")
    # eval mode first, where batch norm is linear: the loss and the
    # gradients of the stem, a mid-network convolution and the
    # classifier. Then training mode: the loss and the classifier's
    # gradients. The other training-mode gradients at batch 2 carry the
    # float32 rounding of batch statistics taken over few, nearly equal
    # values, which batch norm multiplies by 1/sigma (the card sums them
    # in float32, torch's CPU kernels in float64): on these weights the
    # last BatchNorm's gamma already differs by 3.5%, and the JAX
    # package's own eager and compiled runs differ by up to 26% on such
    # inputs
    cases = (("eval", False, ["features.0.weight",
                              "features.5.0.body.3.weight",
                              "output.weight"]),
             ("train", True, ["output.weight", "output.bias"]))
    report = {}
    for mode, train, watched in cases:
        runs = []
        for model, ctx in ((fresh, mx.gpu(0)), (cpu_net, mx.cpu())):
            xs, ys = nd.array(xb, ctx=ctx), nd.array(yb, ctx=ctx)
            _build.reset_launch_counts()
            with autograd.record(train_mode=train):
                logits = model(xs)
                p = pr.rtc_softmax(logits, ys)
            p.backward()
            params = model._collect_params_with_prefix()
            runs.append((pr.cross_entropy(logits, ys).asscalar(),
                         {n: params[n].grad().asnumpy() for n in watched},
                         sum(_build.launch_counts().values())))
        (gl, gg, gk), (cl, cg, ck) = runs
        if gk != 2 or ck != 0:
            raise RuntimeError(f"K4 launches: card {gk}, CPU {ck}")
        print(f"  {mode} mode: loss card {gl:.6f} cpu {cl:.6f}")
        if not onp.isclose(gl, cl, rtol=CPU_RTOL, atol=0):
            raise RuntimeError(f"{mode} loss differs: card {gl}, CPU {cl}")
        for n in watched:
            scale = float(onp.abs(cg[n]).max())
            err = float(onp.abs(gg[n] - cg[n]).max())
            report[f"{mode}:{n}"] = err / scale
            print(f"    grad {n}: max_abs_err {err:.3e}, {err / scale:.3e} "
                  f"of its largest entry {scale:.3e}")
            if not onp.allclose(gg[n], cg[n], rtol=CPU_RTOL,
                                atol=CPU_RTOL * scale):
                raise RuntimeError(f"{mode} gradient of {n} differs from the "
                                   "CPU's")
        report[f"{mode}:loss"] = (gl, cl)
    del fresh, cpu_net
    print(f"card matches CPU within rtol {CPU_RTOL}")
    return report


def resnet_vs_cpu_phase(net):
    phase("17 ResNet-50 against the CPU, and head against head")
    report = resnet_cpu_compare()
    # head against head on the card, at the training batch
    x, y = pr.synthetic_batch(RESNET_B, mx.gpu(0), seed=SEED + 2)
    heads = []
    for head in ("rtc_softmax", "SoftmaxCrossEntropyLoss"):
        with autograd.record():
            out = net(x)
            h = pr.rtc_softmax(out, y) if head == "rtc_softmax" else \
                gluon.loss.SoftmaxCrossEntropyLoss()(out, y)
        h.backward()
        heads.append(_grads(net))
    scale = max(float(onp.abs(g).max()) for g in heads[1].values())
    herr = max(float(onp.abs(heads[0][n] - g).max())
               for n, g in heads[1].items())
    print(f"rtc_softmax head against SoftmaxCrossEntropyLoss at batch "
          f"{RESNET_B}: worst gradient difference {herr:.3e}, "
          f"{herr / scale:.3e} of the largest gradient entry {scale:.3e}")
    if herr > HEAD_TOL * scale:
        raise RuntimeError(f"the two heads' gradients differ by {herr}")
    report["head_rel_err"] = herr / scale
    return report


# -- slice 5: decode serving as the JAX package serves it -------------------

PAGE_TOKENS = 16
PAGED_BUCKETS = [1, 2, 4, 8, 16, 32]
PAGED_STREAMS, PAGED_MIN, PAGED_MAX = 32, 16, 256
PAGED_GAP_S = 0.025  # mean gap between stream arrivals (open loop)
PAGED_BUDGET = 2 ** 30  # KV page pool, bytes: 910 pages of 16 tokens
RERUN_STREAMS = 8
# one eager step against one replayed step of the same states: the same
# kernels, so bitwise unless cuBLAS picks another algorithm under capture
GRAPH_TOL = 1e-5
HTTP_STREAMS, HTTP_STEPS, HTTP_PROMOTE_AT = 4, 12, 6


def decode_net():
    mx.random.seed(SEED)
    net = DecoderBlockLM(**GPT2_SMALL)
    net.initialize(ctx=mx.gpu(0))
    return net


def paged_serving_phase(net):
    phase("18 paged decode serving")
    cfg = GPT2_SMALL
    t0 = time.perf_counter()
    store, sess = decode_stack(net, PAGED_STREAMS, PAGE_TOKENS,
                               PAGED_BUCKETS, budget=PAGED_BUDGET)
    capture_s = time.perf_counter() - t0
    print(f"paged store: {store.num_pages} pages of {PAGE_TOKENS} tokens, "
          f"{store.stats()['page_bytes']} bytes each; {len(PAGED_BUCKETS)} "
          f"buckets captured in {capture_s:.2f} s")
    rs = onp.random.RandomState(SEED + 18)
    lengths = [int(n) for n in rs.randint(PAGED_MIN, PAGED_MAX + 1,
                                          PAGED_STREAMS)]
    arrivals = onp.cumsum(rs.exponential(PAGED_GAP_S, PAGED_STREAMS))
    sids = [f"p{i}" for i in range(PAGED_STREAMS)]
    first = {sid: int(rs.randint(cfg["vocab_size"])) for sid in sids}
    rerun = set(sids[:RERUN_STREAMS])
    # the step log, for the row-slot rerun: per step its sessions, its
    # bucket, its tokens and the rerun streams' logits
    log = []
    run_store_step = sess._run_store_step

    def logged(arrs, recs, bucket=None):
        host = run_store_step(arrs, recs, bucket)
        ids = [r.sid for r in recs]
        log.append((ids, sess._bucket_for(len(recs)), arrs[0].copy(),
                    {i: host[0][i].copy() for i, sid in enumerate(ids)
                     if sid in rerun}))
        return host

    sess._run_store_step = logged
    bat = serving.DynamicBatcher(sess, max_batch_size=PAGED_BUCKETS[-1],
                                 max_latency_ms=2.0, timeout_ms=600000,
                                 admission=False)
    toks = {sid: [first[sid]] for sid in sids}
    try:
        _build.reset_launch_counts()
        serving.METRICS.reset()
        pending, started = {}, 0
        t0 = time.perf_counter()
        while pending or started < PAGED_STREAMS:
            now = time.perf_counter() - t0
            while started < PAGED_STREAMS and arrivals[started] <= now:
                sid = sids[started]
                pending[bat.submit(onp.array([[first[sid]]], "int32"),
                                   session_id=sid,
                                   slo_class="standard")] = sid
                started += 1
            wait_s = (arrivals[started] - now if started < PAGED_STREAMS
                      else 600)
            done, _ = wait(pending, timeout=max(wait_s, 0.0),
                           return_when=FIRST_COMPLETED)
            if not done and started == PAGED_STREAMS:
                raise RuntimeError("paged serving stalled: no step "
                                   "resolved in 600 s")
            for fut in done:
                sid = pending.pop(fut)
                logits = onp.asarray(fut.result())
                if logits.shape != (1, cfg["vocab_size"]) or \
                        not onp.isfinite(logits).all():
                    raise RuntimeError(f"{sid}: bad logits {logits.shape}")
                if len(toks[sid]) < lengths[sids.index(sid)]:
                    nxt = int(logits.argmax())
                    toks[sid].append(nxt)
                    pending[bat.submit(onp.array([[nxt]], "int32"),
                                       session_id=sid,
                                       slo_class="standard")] = sid
        wall = time.perf_counter() - t0
        launches = _build.launch_counts().get(KERNEL, 0)
        snap = serving.METRICS.snapshot()
        stats = store.stats()
        graphs = sess.graph_stats()
        step_ms = mean_step_ms()
    finally:
        bat.close()
        sess._run_store_step = run_store_step
    n_tokens = sum(lengths)
    steps = snap["decode_steps"]
    if snap["responses:standard"] != n_tokens or snap["failures"] or \
            snap["evictions"]:
        raise RuntimeError(f"not every step resolved cleanly: {snap}")
    if launches != cfg["num_layers"] * steps:
        raise RuntimeError(f"K2 launched {launches} times in {steps} decode "
                           f"steps of {cfg['num_layers']} layers")
    replays = sum(g["replays"] for g in graphs.values())
    if not all(g["graph"] for g in graphs.values()) or replays != steps:
        raise RuntimeError(f"steps did not all replay graphs: {graphs}, "
                           f"{steps} steps")
    result = {
        "streams": PAGED_STREAMS, "tokens": n_tokens, "wall_s": wall,
        "tokens_per_s": n_tokens / wall, "decode_steps": steps,
        "mean_rows_per_step": snap["true_rows"] / max(steps, 1),
        "mean_step_ms": step_ms,
        "token_latency_p50_ms": snap["latency_p50_ms"],
        "token_latency_p99_ms": snap["latency_p99_ms"],
        "pages_used_peak": stats["pages_used"],
        "pages_total": store.num_pages,
        "kv_bytes_peak": stats["pages_used"] * stats["page_bytes"],
        "row_slot_bytes": PAGED_STREAMS * store.bytes_per_session,
        "graphs": {str(b): g for b, g in graphs.items()},
        "capture_s": capture_s, "k2_launches": launches}
    result["kv_bytes_share"] = result["kv_bytes_peak"] / \
        result["row_slot_bytes"]
    print("paged serving " + json.dumps(result))
    print(f"K2 launches {launches} = {cfg['num_layers']} layers x {steps} "
          f"graph replays")
    sess.close()
    store.close()
    del sess, store
    torch.cuda.empty_cache()
    # the rerun: the first 8 streams on a row-slot store, each logged step
    # restricted to them and run at the bucket it ran at
    rstore, rsess = decode_stack(net, RERUN_STREAMS, 0, PAGED_BUCKETS)
    worst, compared = 0.0, 0
    for ids, bucket, tok, want in log:
        rows = [i for i, sid in enumerate(ids) if sid in rerun]
        if not rows:
            continue
        recs = []
        for i in rows:
            if not rstore.has(ids[i]):
                rstore.open(ids[i])
            recs.append(rstore.acquire(ids[i]))
        try:
            got = rsess._run_store_step([tok[rows]], recs, bucket)[0]
        finally:
            for rec in recs:
                rstore.release(rec)
        for k, i in enumerate(rows):
            err = float(onp.abs(got[k] - want[i]).max())
            worst = max(worst, err)
            compared += 1
            if not onp.array_equal(got[k], want[i]):
                raise RuntimeError(
                    f"{ids[i]}: the row-slot rerun differs from the paged "
                    f"run at bucket {bucket} by {err}")
    print(f"{RERUN_STREAMS} streams rerun on a row-slot store: {compared} "
          f"steps' logits bitwise equal (max_abs_err {worst})")
    rsess.close()
    rstore.close()
    torch.cuda.empty_cache()
    result["rerun_bitwise_steps"] = compared
    # the traffic and the rerun streams' logits per step, which phase 51
    # replays on int8 pages
    traffic = {"lengths": lengths, "arrivals": arrivals, "toks": toks,
               "logits": _stream_logits(log, rerun)}
    return launches, result, traffic


def _stream_logits(log, sids):
    """``{sid: [logits of its step 0, 1, ...]}`` of the streams ``sids``
    from a step log of (ids, bucket, tokens, {row: logits})."""
    out = {sid: [] for sid in sids}
    for ids, _, _, got in log:
        for i, logits in got.items():
            out[ids[i]].append(logits)
    return out


def graph_vs_eager_phase(net):
    phase("19 graph against eager")
    rows = 8
    rs = onp.random.RandomState(SEED + 19)
    states = []
    for s, dt in zip(net.state_row_shapes(), net.state_row_dtypes()):
        if dt == "int32":  # positions inside the cache
            states.append(rs.randint(0, GPT2_SMALL["max_len"] - 1,
                                     (rows,) + s).astype(dt))
        else:
            states.append(rs.standard_normal((rows,) + s).astype(dt))
    tok = rs.randint(GPT2_SMALL["vocab_size"], size=(rows, 1)).astype("int32")
    out, numbers = {}, {}
    for graphs in (False, True):
        store, sess = decode_stack(net, rows, PAGE_TOKENS, [1, 2, 4, 8],
                                   graphs=graphs)
        logits, news = sess.step(tok, states=states)
        out[graphs] = [logits.asnumpy()] + [n.asnumpy() for n in news]
        sids = [f"g{i}" for i in range(rows)]
        for sid in sids:
            store.open(sid)
        numbers["graphs" if graphs else "eager"] = profile_steps(
            store, sess, sids, 10, SEED)
        sess.close()
        store.close()
        del sess, store
        torch.cuda.empty_cache()
    errs = [float(onp.abs(a.astype("float64") - b).max())
            for a, b in zip(out[False], out[True])]
    bitwise = all(onp.array_equal(a, b) for a, b in zip(out[False],
                                                          out[True]))
    print(f"one step at {rows} rows, eager against replayed graph: "
          f"{'bitwise equal' if bitwise else 'not bitwise'}; max_abs_err "
          f"logits {errs[0]:.3e}, states {max(errs[1:]):.3e}")
    if not all(onp.isfinite(a).all() for a in out[True]) or \
            not max(errs) <= GRAPH_TOL:
        raise RuntimeError(f"graph replay differs from the eager step by "
                           f"{max(errs)} (> {GRAPH_TOL})")
    for mode, row in numbers.items():
        print(f"  {mode} " + json.dumps({
            k: row[k] for k in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "device_ops_per_step",
                "host_launches_per_step")}))
    return {"bitwise": bitwise, "max_abs_err": max(errs), **numbers}


def _http(port, method, path, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _http_step(port, sid, tok, slo_class="standard"):
    code, hdr, body = _http(
        port, "POST", "/models/lm/predict",
        json.dumps({"data": [[int(tok)]]}).encode(),
        {"Content-Type": "application/json", "X-Session-Id": sid,
         "X-SLO-Class": slo_class, "X-Request-Id": f"{sid}-{tok}"})
    return code, hdr, body


def _http_round(port, streams, k):
    """Step k of every stream, concurrently over HTTP; returns
    {sid: logits}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(streams)) as ex:
        futs = {sid: ex.submit(_http_step, port, sid, toks[k])
                for sid, toks in streams.items()}
        out = {}
        for sid, f in futs.items():
            code, hdr, body = f.result()
            if code != 200:
                raise RuntimeError(f"{sid} step {k}: HTTP {code} {body!r}")
            out[sid] = onp.asarray(json.loads(body)["outputs"][0],
                                   "float32")
    return out


def http_phase(net):
    phase("20 HTTP")
    rs = onp.random.RandomState(SEED + 20)
    streams = {f"h{i}": [int(t) for t in rs.randint(
        GPT2_SMALL["vocab_size"], size=HTTP_STEPS)]
        for i in range(HTTP_STREAMS)}

    def version():
        # one bucket: every step runs the same shapes whichever streams
        # share it, so the two runs are comparable bit for bit
        return decode_stack(net, HTTP_STREAMS, PAGE_TOKENS,
                            [HTTP_STREAMS])[1]

    # the admission controllers' latency signal reads each version's p99
    # against this SLO; the shed checked here is the forced one
    os.environ["MXNET_SERVING_SLO_MS"] = "10000"
    runs = {}
    for promote in (False, True):
        repo = serving.ModelRepository(max_latency_ms=2.0,
                                       timeout_ms=300000,
                                       canary_min_requests=10 ** 9)
        repo.deploy("lm", version())
        srv = serving.ModelServer(repository=repo, port=0).start()
        try:
            got = {sid: [] for sid in streams}
            for k in range(HTTP_STEPS):
                if promote and k == HTTP_PROMOTE_AT:
                    repo.deploy("lm", version())
                    serving.METRICS.reset()
                    # promote while this round is in flight: it waits
                    # for the incumbent's accepted steps, then migrates
                    import threading

                    t = threading.Thread(target=repo.promote, args=("lm",))
                    t.start()
                    step = _http_round(srv.port, streams, k)
                    t.join(300)
                    resumed = serving.METRICS.snapshot()["resumed_sessions"]
                else:
                    step = _http_round(srv.port, streams, k)
                for sid, v in step.items():
                    got[sid].append(v)
            if promote:
                with faults.inject("serving_admission", every=1):
                    shed = _http_step(srv.port, "shed-me", 1, "best_effort")
                    kept = _http_step(srv.port, "keep-me", 1, "critical")
                code, _, body = _http(srv.port, "GET", "/metrics")
                metrics = body.decode()
                _, _, health = _http(srv.port, "GET", "/healthz")
                states = repo.model_states()["lm"]
        finally:
            srv.stop()
        runs[promote] = got
    del os.environ["MXNET_SERVING_SLO_MS"]
    for sid in streams:
        for k, (a, b) in enumerate(zip(runs[False][sid], runs[True][sid])):
            if not onp.array_equal(a, b):
                raise RuntimeError(
                    f"{sid} step {k}: logits after the promote differ from "
                    f"the run without one by {onp.abs(a - b).max()}")
    if resumed != HTTP_STREAMS or states["active_version"] != 2:
        raise RuntimeError(f"promote migrated {resumed} sessions, active "
                           f"v{states['active_version']}")
    print(f"{HTTP_STREAMS} streams x {HTTP_STEPS} steps over HTTP; v2 "
          f"promoted at step {HTTP_PROMOTE_AT} with a round in flight: "
          f"resumed_sessions {resumed}, every logit bitwise equal to the "
          "run without a promote")
    code, hdr, body = shed
    if code != 503 or float(hdr.get("Retry-After", 0)) <= 0:
        raise RuntimeError(f"best_effort under an admission fault: HTTP "
                           f"{code} {hdr}")
    if kept[0] != 200:
        raise RuntimeError(f"critical under an admission fault: HTTP "
                           f"{kept[0]} {kept[2]!r}")
    print(f"under faults.inject('serving_admission', every=1): best_effort "
          f"HTTP {code}, Retry-After {hdr['Retry-After']}; critical HTTP "
          f"{kept[0]}")
    fams = sorted({line.split("{")[0] for line in metrics.splitlines()
                   if 'slo_class="' in line})
    if not fams:
        raise RuntimeError("/metrics carries no slo_class family")
    print(f"/metrics slo_class families: {fams}")
    print(f"/healthz: {json.loads(health)['status']}")
    torch.cuda.empty_cache()
    return {"resumed_sessions": resumed, "shed_status": code,
            "critical_status": kept[0], "slo_class_families": len(fams)}


def conv_default_flags_phase():
    phase("21 convolution at torch's default flags")
    # torch's defaults, whatever an earlier phase set: the port must hold
    # float32 convolutions to float32 on its own
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    print(f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cudnn."
          f"benchmark = {torch.backends.cudnn.benchmark}")
    report = resnet_cpu_compare()
    worst = max(v for k, v in report.items() if not k.endswith(":loss"))
    print(f"worst gradient deviation {worst:.3e} of its largest entry "
          f"(allowed rtol {CPU_RTOL})")
    return report


def k4_floor_phase():
    phase("22 K4 launch floor")
    mod = rtc.CudaModule('extern "C" __global__ void mxtt_empty() {}')
    kernel = mod.get_kernel("mxtt_empty", "")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def launch():
        kernel.launch([], mx.gpu(0), (1, 1, 1), (32, 1, 1))

    ms = time_ms(launch, flush)
    del flush
    row = {"ms": ms, "bound_ms": 0.0, "bound_by": "bytes",
           "note": "an empty kernel: the device time of one launch"}
    print("  empty rtc kernel " + json.dumps(row))
    return row


# -- slice 6: bf16 AMP and the fused step ------------------------------------

def k1_bf16_phase(gen):
    phase("23 K1 in bfloat16 at the LM's shape")
    B, H, S, D = TRAIN_B, GPT2_SMALL_LM["num_heads"], TRAIN_S, 64
    scale = D ** -0.5
    q, k, v = flash_inputs(gen, B, H, S, S, D, torch.bfloat16)
    # the LM's own layout: q, k, v strided views of one fused projection
    qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=gen).to(
        torch.bfloat16)
    vq, vk, vv = qkv.permute(2, 0, 3, 1, 4)
    cases = [("training shape, contiguous", q, k, v, True),
             ("training shape, the LM's qkv views", vq, vk, vv, True)]
    # a ragged S (not a multiple of the 128-row tiles) and a causal
    # offset (S_q < S_k), not causal beside it
    for B_, H_, S_q, S_k, causal in ((2, H, 1000, 1000, True),
                                     (3, 4, 300, 777, True),
                                     (2, 5, 333, 555, False)):
        cases.append((f"B={B_} H={H_} S_q={S_q} S_k={S_k} causal={causal}",
                      *flash_inputs(gen, B_, H_, S_q, S_k, D,
                                    torch.bfloat16), causal))
    worst = 0.0
    for name, q_, k_, v_, causal in cases:
        route = _flash_route(q_, k_, v_)
        if route != "sm90":
            raise RuntimeError(f"K1's rule sends {name} to {route!r}")
        got = _flash_fwd_cuda(q_, k_, v_, scale, causal).float()
        # the plain version in float32 from the same bf16 inputs, rounded
        # to bf16 once: the kernel rounds once too, at its output
        want = _flash_ref(q_.float(), k_.float(), v_.float(), scale,
                          causal).to(torch.bfloat16).float()
        err = (got - want).abs().max().item()
        print(f"  sm90 route, {name}: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=BF16_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1's sm90 kernel is off by {err} at {name}")
        worst = max(worst, err)
    want = _flash_ref(q.float(), k.float(), v.float(), scale, True).to(
        torch.bfloat16).float()
    mma_err = (_flash_fwd_cuda(q, k, v, scale, True, route="mma").float()
               - want).abs().max().item()

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)

    lib_err = (library().float() - want).abs().max().item()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    pairs = S * (S + 1) // 2
    flops = 4 * D * B * H * pairs
    nbytes = 4 * B * H * S * D * 2  # q, k, v read and out written, bf16
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    row = {"B": B, "H": H, "S_q": S, "S_k": S, "D": D, "causal": True,
           "dtype": "bfloat16", "max_abs_err": worst,
           "ms": time_ms(lambda: _flash_fwd_cuda(q, k, v, scale, True),
                         flush),
           "views_ms": time_ms(
               lambda: _flash_fwd_cuda(vq, vk, vv, scale, True), flush),
           "mma_route_ms": time_ms(
               lambda: _flash_fwd_cuda(q, k, v, scale, True, route="mma"),
               flush),
           "mma_route_max_abs_err": mma_err,
           "plain_ms": time_ms(lambda: _flash_ref(q, k, v, scale, True),
                               flush),
           "library_ms": time_ms(library, flush),
           "library_max_abs_err": lib_err,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           # the design's own arithmetic: P.V twice (P_hi and P_lo)
           "bound_two_pass_ms": max(t_bytes, 1.5 * t_ops) * 1e3,
           "flops": flops, "bytes": nbytes}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["bound_two_pass_share"] = row["bound_two_pass_ms"] / row["ms"]
    row["speedup_over_mma_route"] = row["mma_route_ms"] / row["ms"]
    del flush
    print(f"  K1 bf16 (sm90 route) within two bf16 ulps of the plain "
          f"version: worst max_abs_err={worst:.3e}; the mma route's "
          f"{mma_err:.3e}; SDPA's {lib_err:.3e}")
    print("  " + json.dumps(row))
    return row


def _amp_grads_finite(net):
    bad = [n for n, p in net._collect_params_with_prefix().items()
           if p.grad_req != "null" and
           not torch.isfinite(p.grad().data).all()]
    if bad:
        raise RuntimeError(f"non-finite gradients after step 1: {bad[:5]}")


def resnet_amp_run(layout):
    """ResNet-50 v1 in bf16 AMP at one layout, as phase 16 in fp32: 2
    warm-up and 10 timed steps, then 28 more; the fused step with a loss
    scaler. Returns (net, trainer, x, y, result)."""
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    net = pr.build_resnet50(ctx, seed=SEED, layout=layout)
    trainer = pr.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    x, y = pr.synthetic_batch(RESNET_B, ctx, seed=SEED, layout=layout)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    for i in range(RESNET_WARMUP):
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
        if i == 0:
            _amp_grads_finite(net)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_build
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(RESNET_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        loss = pr.train_step(net, trainer, x, y, events=ev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    while len(losses) < RESNET_FALL_STEPS:
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
    print(f"  {layout} losses {[round(v, 4) for v in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"bf16 ResNet-50 ({layout}) did not go down in "
                           f"{len(losses)} steps: {losses}")
    fwd_n, bwd_n = counts.get(pr.FWD_KERNEL, 0), counts.get(pr.BWD_KERNEL, 0)
    if fwd_n != RESNET_STEPS or bwd_n != RESNET_STEPS:
        raise RuntimeError(f"K4 launched forward {fwd_n}, backward {bwd_n} "
                           f"times in {RESNET_STEPS} bf16 steps")
    stats = check_fused(trainer, RESNET_FALL_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    result = {"layout": layout, "img_per_s": RESNET_B * RESNET_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0], "last_loss": losses[-1],
              "steps": len(losses), "peak_memory_gb": peak_gb,
              "warmup_s": warm_s, "k4_launches": fwd_n + bwd_n,
              "skipped_steps": trainer._fused_skipped_steps(),
              "loss_scale": trainer._amp_loss_scaler.loss_scale,
              "fused_step": stats}
    print(f"  resnet bf16 {layout} " + json.dumps(result))
    amp.disable()
    return net, trainer, x, y, result


def resnet_amp_phase():
    phase("24 ResNet-50 in bf16 AMP")
    torch.backends.cudnn.benchmark = True
    runs = {}
    for layout in ("NCHW", "NHWC"):
        runs[layout] = resnet_amp_run(layout)
        if layout == "NCHW":  # the NHWC run keeps its net for phase 27
            runs[layout] = runs[layout][4:]
            torch.cuda.empty_cache()
    head = min(("NCHW", "NHWC"), key=lambda k: runs[k][-1]["mean_step_ms"])
    print(f"headline layout {head}: "
          f"{runs[head][-1]['img_per_s']:.1f} img/s against "
          f"{runs['NCHW' if head == 'NHWC' else 'NHWC'][-1]['img_per_s']:.1f}")
    net, trainer, x, y, _ = runs["NHWC"]
    return (net, trainer, x, y), {k: v[-1] for k, v in runs.items()}, head


def lm_amp_phase():
    phase("25 LM in bf16 AMP")
    ctx = mx.gpu(0)
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    fused_step.reset_fused_step_cache()
    mx.random.seed(SEED)
    net = TransformerLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    toks = nd.array(onp.random.RandomState(SEED).randint(
        0, vocab, (TRAIN_B, TRAIN_S)).astype("int32"), ctx=ctx)
    labels = toks[:, 1:].reshape(-1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    dtypes = set()

    def step(ev=None):
        ev = ev or [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with autograd.record():
            logits = net(toks)
            loss = loss_fn(logits[:, :-1].reshape(-1, vocab), labels).mean()
            ev[1].record()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        ev[2].record()
        trainer.step(TRAIN_B)
        ev[3].record()
        dtypes.add(str(logits.dtype))
        return loss, ev

    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_STEPS):
        losses.append(step()[0].asscalar())
        if i == 0:
            _amp_grads_finite(net)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss, ev = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    launches = counts.get(FLASH_KERNEL, 0)
    sm90 = counts.get(FLASH_SM90_KERNEL, 0)
    print(f"losses {[round(x, 4) for x in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"bf16 LM training did not go down: {losses}")
    if dtypes != {"bfloat16"}:
        raise RuntimeError(f"the LM's logits came out {dtypes} under AMP")
    want = cfg["num_layers"] * TIMED_STEPS
    if launches != want or sm90 != want:
        raise RuntimeError(f"K1 launched {launches} times, {sm90} of them "
                           f"on its sm90 kernel, in {TIMED_STEPS} bf16 "
                           f"steps of {cfg['num_layers']} layers")
    print(f"K1 (bf16) launches {launches} = {cfg['num_layers']} layers x "
          f"{TIMED_STEPS} timed steps, all {sm90} on the sm90 kernel")
    stats = check_fused(trainer, WARMUP_STEPS + TIMED_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    result = {"tokens_per_s": TRAIN_B * TRAIN_S * TIMED_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0], "last_loss": losses[-1],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "skipped_steps": trainer._fused_skipped_steps(),
              "loss_scale": trainer._amp_loss_scaler.loss_scale,
              "fused_step": stats}
    print("bf16 LM training " + json.dumps(result))
    amp.disable()
    del net, trainer
    torch.cuda.empty_cache()
    return launches, sm90, result


def _l2(parts):
    return float(onp.sqrt(sum(float((p.astype("float64") ** 2).sum())
                              for p in parts)))


def _amp_record(model, ctx, x, y, loss_of, use_amp, train):
    """One record/backward of ``model`` on ``ctx``: (loss, logits,
    {name: grad}) as float32 host arrays."""
    if use_amp:
        amp.init("bfloat16")
    try:
        with autograd.record(train_mode=train):
            logits, loss = loss_of(model, nd.array(x, ctx=ctx),
                                   nd.array(y, ctx=ctx))
        loss.backward()
    finally:
        amp.disable()
    grads = {n: p.grad().asnumpy().astype("float32")
             for n, p in model._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return (float(loss.asnumpy().astype("float32").reshape(-1)[0]),
            logits.asnumpy().astype("float32"), grads)


def _amp_dev(amp_run, fp32_run):
    (_, oa, ga), (_, of, gf) = amp_run, fp32_run
    return {"logits": _l2([oa - of]) / _l2([of]),
            "grads": _l2([ga[k] - gf[k] for k in gf]) /
            _l2([gf[k] for k in gf])}


def _amp_compare(name, make, x, y, loss_of, train):
    """bf16 against float32 on the card and on the CPU port, from the
    same weights: each side's deviation, and the card's held to the
    CPU's as the CPU test holds the port to the JAX package."""
    runs = {}
    for side, ctx in (("gpu", mx.gpu(0)), ("cpu", mx.cpu())):
        model = make(ctx)
        for use_amp in (True, False):
            runs[side, use_amp] = _amp_record(model, ctx, x, y, loss_of,
                                              use_amp, train)
        del model
    dev = {side: _amp_dev(runs[side, True], runs[side, False])
           for side in ("gpu", "cpu")}
    losses = {side: runs[side, True][0] for side in ("gpu", "cpu")}
    print(f"  {name}: bf16 deviation from float32 card {dev['gpu']}, "
          f"cpu {dev['cpu']}; bf16 loss card {losses['gpu']:.6f} cpu "
          f"{losses['cpu']:.6f}")
    return dev, losses


def _check_amp_compare(name, dev, losses):
    for what in ("logits", "grads"):
        if dev["gpu"][what] > AMP_DEV_FACTOR * dev["cpu"][what] + \
                AMP_DEV_FLOOR:
            raise RuntimeError(f"{name}: the card's bf16 {what} deviate "
                               f"{dev['gpu'][what]} from float32, the "
                               f"CPU's {dev['cpu'][what]}")
    if not onp.isclose(losses["gpu"], losses["cpu"], rtol=AMP_LOSS_RTOL,
                       atol=0):
        raise RuntimeError(f"{name}: bf16 loss card {losses['gpu']}, CPU "
                           f"{losses['cpu']}")


def amp_vs_cpu_phase():
    phase("26 AMP on the card against the CPU port")
    report = {}
    # ResNet-50 at batch 2, 224 x 224, eval mode with fresh weights (batch
    # norm linear, its statistics the initial ones: phase 17's
    # well-conditioned case)
    src = pr.build_resnet50(mx.cpu(), seed=SEED + 3)
    arrays = {n: p.data().asnumpy()
              for n, p in src._collect_params_with_prefix().items()}
    del src
    rs = onp.random.RandomState(SEED + 3)
    xb = rs.standard_normal((2, 3, pr.IMAGE, pr.IMAGE)).astype("float32")
    yb = rs.randint(0, pr.CLASSES, 2).astype("float32")

    def resnet(ctx):
        return convert.params_from_numpy(vision.resnet50_v1(), arrays,
                                         ctx=ctx)

    def resnet_loss(model, xs, ys):
        out = model(xs)
        return out, gluon.loss.SoftmaxCrossEntropyLoss()(out, ys).mean()

    dev, losses = _amp_compare("resnet50 eval", resnet, xb, yb, resnet_loss,
                               False)
    _check_amp_compare("resnet50", dev, losses)
    report["resnet50"] = {"dev": dev, "bf16_loss": losses}
    # the LM at 1 x 128 tokens, full width, at both cuBLAS settings: the
    # port's scope (bf16 products summed in float32) and torch's default
    # (split-K partial sums in bf16)
    cfg = GPT2_SMALL_LM
    mx.random.seed(SEED + 4)
    src = TransformerLM(**cfg)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    toks = onp.random.RandomState(SEED + 4).randint(
        0, cfg["vocab_size"], (1, 128)).astype("float32")
    with autograd.pause():
        src(nd.array(toks, ctx=mx.cpu()))
    lm_arrays = {n: p.data().asnumpy()
                 for n, p in src._collect_params_with_prefix().items()}
    del src

    def lm(ctx):
        return convert.params_from_numpy(TransformerLM(**cfg), lm_arrays,
                                         ctx=ctx)

    def lm_loss(model, t, _):
        logits = model(t)
        V = cfg["vocab_size"]
        return logits, gluon.loss.SoftmaxCrossEntropyLoss()(
            logits[:, :-1].reshape(-1, V), t[:, 1:].reshape(-1)).mean()

    dev, losses = _amp_compare("LM 1 x 128", lm, toks, toks, lm_loss, True)
    _check_amp_compare("LM", dev, losses)
    report["lm"] = {"dev": dev, "bf16_loss": losses}
    # the same at torch's default cuBLAS flags (split-K partial sums of
    # bf16 products reduced in bf16): the port's scope replaced by a
    # no-op for this measurement, whose deviations are reported
    scope = ops_nn.cublas_fp32_accumulate
    ops_nn.cublas_fp32_accumulate = \
        lambda dtype=None: contextlib.nullcontext()
    try:
        dev, losses = _amp_compare("LM 1 x 128, torch's default cuBLAS "
                                   "flags", lm, toks, toks, lm_loss, True)
    finally:
        ops_nn.cublas_fp32_accumulate = scope
    report["lm_torch_default_cublas_flags"] = {"dev": dev,
                                               "bf16_loss": losses}
    print("amp against cpu " + json.dumps(report))
    return report


def poisoned_step_phase(net, trainer, x, y):
    phase("27 a poisoned bf16 step on the card")
    amp.init("bfloat16")
    try:
        with amp.scale_loss(nd.ones((1,), ctx=x.context), trainer) as scale:
            pass
        with autograd.record():
            logits = net(x)
            p = pr.rtc_softmax(logits.astype("float32"), y, grad_scale=scale)
        p.backward()
    finally:
        amp.disable()
    params = [q for q in net.collect_params().values()
              if q.grad_req != "null"]
    params[0].grad().data.fill_(float("inf"))
    weights = [q.data().data.clone() for q in params]
    states = [s.data.clone() for s in trainer._states if s is not None]
    scale0 = trainer._amp_loss_scaler.loss_scale
    skipped0 = trainer._fused_skipped_steps()
    replays0 = fused_step.fused_step_stats()["replays"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in step raises
    try:
        trainer.step(x.shape[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = all(torch.equal(a, q.data().data) for a, q in zip(weights, params))
    same_states = all(torch.equal(a, s.data) for a, s in
                      zip(states, [s for s in trainer._states
                                   if s is not None]))
    scale1 = trainer._amp_loss_scaler.loss_scale
    skipped1 = trainer._fused_skipped_steps()
    replays1 = fused_step.fused_step_stats()["replays"]
    result = {"weights_bitwise_unchanged": same,
              "states_bitwise_unchanged": same_states,
              "loss_scale_before": scale0, "loss_scale_after": scale1,
              "skipped_before": skipped0, "skipped_after": skipped1,
              "replays": replays1 - replays0, "host_syncs_in_step": 0}
    print("poisoned step " + json.dumps(result))
    if not (same and same_states and scale1 == scale0 / 2
            and skipped1 == skipped0 + 1 and replays1 == replays0 + 1):
        raise RuntimeError(f"the poisoned step was not skipped on the "
                           f"device: {result}")
    return result


# -- slice 7: hybridize as captured CUDA graphs, and the data pipeline --------

HYB_WARMUP, HYB_STEPS = 2, 10
# images held in host memory for the DataLoader-fed run: 6 batches of 128,
# two passes
FEED_BATCHES, FEED_EPOCHS, FEED_WORKERS = 6, 2, 4


def _fresh_peak():
    """Free what earlier runs left (blocks and parameters hold each other
    in cycles that only the collector breaks) and restart the peak
    count; returns the GB still allocated."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def _state_to_host(net):
    """Weights, gradients and running statistics as host tensors."""
    state = {}
    for k, p in net._collect_params_with_prefix().items():
        state[k] = p.data().data.detach().cpu()
        if p.grad_req != "null":
            state[k + ".grad"] = p.grad().data.detach().cpu()
    return state


def _compare_runs(what, eager, hyb):
    """Bitwise comparison of two runs' per-step outputs and final state;
    returns the count of tensors compared. Raises on any difference,
    naming the worst ones."""
    (lo_e, st_e), (lo_h, st_h) = eager, hyb
    bad = []
    for i, (a, b) in enumerate(zip(lo_e, lo_h)):
        if not torch.equal(a, b):
            bad.append((f"outputs of step {i + 1}",
                        float((a.float() - b.float()).abs().max())))
    for k in st_e:
        if not torch.equal(st_e[k], st_h[k]):
            bad.append((k, float((st_e[k].float() - st_h[k].float())
                                 .abs().max())))
    if bad:
        raise RuntimeError(f"{what}: hybridized differs from eager in "
                           f"{len(bad)} tensors: {bad[:8]}")
    return len(lo_e) + len(st_e)


def _hyb_resnet_run(hybridize, record_state, x=None, y=None):
    """ResNet-50 v1 in bf16 AMP, NHWC, batch 128, as phase 24, eager or
    hybridized: 2 warm-up and 10 timed steps. Returns (result, per-step
    logits, final state or None)."""
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    net = pr.build_resnet50(ctx, seed=SEED, layout="NHWC")
    trainer = pr.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    if hybridize:
        net.hybridize()
    if x is None:
        x, y = pr.synthetic_batch(RESNET_B, ctx, seed=SEED, layout="NHWC")
    logits, losses, step_ms = [], [], []
    resident = _fresh_peak()
    for _ in range(HYB_WARMUP):
        out = []
        losses.append(pr.train_step(net, trainer, x, y, outputs=out))
        logits.append(out[0].data.detach().cpu())
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_all = time.perf_counter()
    for _ in range(HYB_STEPS):
        out = []
        t0 = time.perf_counter()
        losses.append(pr.train_step(net, trainer, x, y, outputs=out))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out[0].data.detach().cpu())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    losses = [v.asscalar() for v in losses]
    if not all(onp.isfinite(losses)):
        raise RuntimeError(f"ResNet-50 (hybridize={hybridize}) losses "
                           f"{losses}")
    cached = gluon.cached_op_stats()
    k4 = counts.get(pr.FWD_KERNEL, 0) + counts.get(pr.BWD_KERNEL, 0)
    if k4 != 2 * HYB_STEPS:
        raise RuntimeError(f"K4 launched {counts} in {HYB_STEPS} steps")
    steps = HYB_WARMUP + HYB_STEPS
    if hybridize and (cached["captures"] != 1 or cached["replays"] != steps
                      or cached["backward_replays"] != steps):
        raise RuntimeError(f"hybridized ResNet-50: {cached} in {steps} "
                           "steps (want one capture, a replay per step)")
    result = {"hybridize": hybridize, "img_per_s":
              RESNET_B * HYB_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "resident_before_gb": resident,
              "k4_launches": k4, "cached_op": cached,
              "first_loss": losses[0], "last_loss": losses[-1]}
    state = _state_to_host(net) if record_state else None
    amp.disable()
    del net, trainer
    torch.cuda.empty_cache()
    return result, logits, state


def resnet_hybrid_phase():
    phase("28 ResNet-50 hybridized against eager")
    torch.backends.cudnn.benchmark = True
    # equality: the same weights and batch through 12 steps in each mode,
    # with cuDNN held to deterministic algorithms, so that two eager runs
    # would agree bitwise too (cudnn.benchmark may pick algorithms that
    # sum with atomics, whose order varies from run to run)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=True):
        _, lo_e, st_e = _hyb_resnet_run(False, True)
        _, lo_h, st_h = _hyb_resnet_run(True, True)
    n = _compare_runs("ResNet-50 bf16 NHWC", (lo_e, st_e), (lo_h, st_h))
    print(f"  bitwise equal: {n} tensors (12 steps' logits, every weight, "
          "gradient and running statistic), cuDNN deterministic")
    del lo_e, st_e, lo_h, st_h
    # timing at torch's flags (cuDNN may pick any algorithm), as phase 24
    runs = {}
    for hyb in (False, True):
        runs[hyb] = _hyb_resnet_run(hyb, False)[0]
        print("  resnet bf16 NHWC " + json.dumps(runs[hyb]))
    print(f"  step ms eager {runs[False]['mean_step_ms']:.2f}, hybridized "
          f"{runs[True]['mean_step_ms']:.2f}; img/s "
          f"{runs[False]['img_per_s']:.1f} -> {runs[True]['img_per_s']:.1f}; "
          f"peak GB {runs[False]['peak_memory_gb']:.2f} -> "
          f"{runs[True]['peak_memory_gb']:.2f}")
    return runs


def _hyb_lm_run(hybridize):
    """The GPT-2-small LM in bf16 AMP, 8 x 1024 tokens, as phase 25, eager
    or hybridized: 2 warm-up and 10 timed steps. Returns (result,
    per-step logits, final state)."""
    ctx = mx.gpu(0)
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    mx.random.seed(SEED)
    net = TransformerLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    toks = nd.array(onp.random.RandomState(SEED).randint(
        0, vocab, (TRAIN_B, TRAIN_S)).astype("int32"), ctx=ctx)
    labels = toks[:, 1:].reshape(-1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    if hybridize:
        net.hybridize()
    logits_seen, losses, step_ms = [], [], []

    def step():
        with autograd.record():
            logits = net(toks)
            loss = loss_fn(logits[:, :-1].reshape(-1, vocab), labels).mean()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        trainer.step(TRAIN_B)
        # a digest of the logits (all 8 x 1024 x 50257 would be 823 MB a
        # step): the last position of every row, bitwise
        logits_seen.append(logits.data[:, -1].detach().cpu())
        return loss

    resident = _fresh_peak()
    for _ in range(WARMUP_STEPS):
        losses.append(step())
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    losses = [v.asscalar() for v in losses]
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"LM (hybridize={hybridize}) losses {losses}")
    k1, sm90 = counts.get(FLASH_KERNEL, 0), counts.get(FLASH_SM90_KERNEL, 0)
    want = cfg["num_layers"] * TIMED_STEPS
    if k1 != want or sm90 != want:
        raise RuntimeError(f"K1 launched {k1} times, {sm90} on sm90, in "
                           f"{TIMED_STEPS} steps (hybridize={hybridize})")
    cached = gluon.cached_op_stats()
    steps = WARMUP_STEPS + TIMED_STEPS
    if hybridize and (cached["captures"] != 1 or cached["replays"] != steps):
        raise RuntimeError(f"hybridized LM: {cached} in {steps} steps")
    result = {"hybridize": hybridize,
              "tokens_per_s": TRAIN_B * TRAIN_S * TIMED_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "resident_before_gb": resident,
              "k1_launches": k1, "k1_sm90_launches": sm90,
              "cached_op": cached, "first_loss": losses[0],
              "last_loss": losses[-1]}
    if hybridize:
        ent = next(iter(net._cached_op.entries.values()))
        result["k1_launches_per_replay"] = dict(ent.fwd_launches)
    state = _state_to_host(net)
    amp.disable()
    del net, trainer
    torch.cuda.empty_cache()
    return result, logits_seen, state


def lm_hybrid_phase():
    phase("29 LM hybridized against eager")
    runs, seen = {}, {}
    for hyb in (False, True):
        runs[hyb], lo, st = _hyb_lm_run(hyb)
        seen[hyb] = (lo, st)
        print("  LM bf16 " + json.dumps(runs[hyb]))
    n = _compare_runs("the LM bf16", seen[False], seen[True])
    print(f"  bitwise equal: {n} tensors (12 steps' last-position logits, "
          "every weight and gradient)")
    print(f"  K1 launches {runs[True]['k1_launches']} = "
          f"{GPT2_SMALL_LM['num_layers']} x {TIMED_STEPS} counted per replay, "
          f"all {runs[True]['k1_sm90_launches']} on sm90; step ms eager "
          f"{runs[False]['mean_step_ms']:.2f}, hybridized "
          f"{runs[True]['mean_step_ms']:.2f}; tokens/s "
          f"{runs[False]['tokens_per_s']:.0f} -> "
          f"{runs[True]['tokens_per_s']:.0f}; peak GB "
          f"{runs[False]['peak_memory_gb']:.2f} -> "
          f"{runs[True]['peak_memory_gb']:.2f}")
    return runs


def fed_resnet_phase():
    phase("30 ResNet-50 fed by gluon.data")
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.pipeline import (DeviceFeed, pipeline_counters,
                                          reset_pipeline_counters)

    ctx = mx.gpu(0)
    n = FEED_BATCHES * RESNET_B
    rs = onp.random.RandomState(SEED)
    images = rs.randint(0, 256, (n, pr.IMAGE, pr.IMAGE, 3), dtype=onp.uint8)
    labels = rs.randint(0, pr.CLASSES, n).astype("float32")
    loader = DataLoader(ArrayDataset(images, labels), batch_size=RESNET_B,
                        num_workers=FEED_WORKERS, pin_memory=True,
                        last_batch="discard")
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    net = pr.build_resnet50(ctx, seed=SEED, layout="NHWC")
    trainer = pr.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    net.hybridize()
    # ImageNet's channel statistics, in 0-255 units, on the card
    mean = nd.array(onp.array([123.68, 116.78, 103.94], "f"), ctx=ctx)
    std = nd.array(onp.array([58.40, 57.12, 57.38], "f"), ctx=ctx)
    reset_pipeline_counters()
    resident = _fresh_peak()
    feed = DeviceFeed(loader)
    step_ms, stall_s, losses, k4 = [], [], [], 0
    steps = 0
    t_all = None
    stalled = 0.0  # the counter after the last step
    for _ in range(FEED_EPOCHS):
        for xb, yb in feed:
            # the wait for this batch: the stall since the last step ended
            waited = pipeline_counters()["prefetch_stall_s"] - stalled
            if steps == HYB_WARMUP:
                _build.reset_launch_counts()
                t_all = time.perf_counter() - waited
            t0 = time.perf_counter()
            x = (xb.astype("float32") - mean) / std  # normalize on the card
            losses.append(pr.train_step(net, trainer, x, yb))
            torch.cuda.synchronize()
            if steps >= HYB_WARMUP:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                stall_s.append(waited)
            stalled = pipeline_counters()["prefetch_stall_s"]
            steps += 1
    wall = time.perf_counter() - t_all
    feed.close()
    counts = _build.launch_counts()
    k4 = counts.get(pr.FWD_KERNEL, 0) + counts.get(pr.BWD_KERNEL, 0)
    timed = steps - HYB_WARMUP
    losses = [v.asscalar() for v in losses]
    cached = gluon.cached_op_stats()
    if steps != FEED_BATCHES * FEED_EPOCHS or not all(onp.isfinite(losses)):
        raise RuntimeError(f"fed run: {steps} steps, losses {losses}")
    if k4 != 2 * timed or cached["captures"] != 1 or \
            cached["replays"] != steps:
        raise RuntimeError(f"fed run: K4 {counts}, {cached}")
    pc = pipeline_counters()
    result = {"steps_timed": timed, "img_per_s": RESNET_B * timed / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "prefetch_stall_s_per_step": statistics.mean(stall_s),
              "prefetch_stall_s_by_step": stall_s,
              "prefetch_stall_s_max": max(stall_s),
              "prefetch_hits": pc["prefetch_hits"],
              "prefetch_stalls": pc["prefetch_stalls"],
              "workers": FEED_WORKERS, "k4_launches": k4,
              "cached_op": cached, "peak_memory_gb":
              torch.cuda.max_memory_allocated() / 1e9,
              "resident_before_gb": resident,
              "first_loss": losses[0], "last_loss": losses[-1]}
    print("  fed resnet bf16 NHWC " + json.dumps(result))
    amp.disable()
    del net, trainer, feed, loader, images
    torch.cuda.empty_cache()
    return result


class _HostSync(gluon.HybridBlock):
    """A forward that reads a value back to the host: not capturable."""

    def hybrid_forward(self, F, x):
        return x * float(x.asnumpy().sum() > 0)


def failing_capture_phase():
    phase("31 a capture that must fail")
    blk = _HostSync()
    blk.hybridize()
    try:
        blk(nd.ones((4,), ctx=mx.gpu(0)))
    except mx.MXNetError as e:
        msg = str(e)
        if "_HostSync" not in msg or "signature" not in msg:
            raise RuntimeError(f"the capture error does not name the block "
                               f"and the signature: {msg}") from e
        print(f"  raised as expected: {msg[:200]}...")
    else:
        raise RuntimeError("a forward that calls asnumpy() was captured")
    if (nd.ones((3,), ctx=mx.gpu(0)) * 2).asnumpy().tolist() != [2.0] * 3:
        raise RuntimeError("the card computes wrongly after a failed capture")


# -- slice 7 of ROADMAP A: symbolic training and the LSTM word-LM ------------

# the MLP against the CPU port: one pass over the 14 training batches from
# the same weights; per-step losses and final weights relative to their
# largest value (float32 sums in another order, through 14 SGD steps)
MLP_CPU_RTOL = 1e-3
MLP_EPOCHS = 8
# the word-LM: steps timed per mode, steps that check the falling
# perplexity, steps against the CPU port and the captured-vs-eager steps
WLM_WARMUP, WLM_STEPS, WLM_FALL, WLM_CPU, WLM_BITWISE = 2, 20, 40, 3, 3
WLM_PROFILED = 5
# cuDNN's LSTM against the op's plain version (the JAX step arithmetic,
# one time step at a time) in float32 on the card, relative to the largest
# value: two float32 computations in different orders over 35 steps and
# 650-wide products; TF32 would miss it by two orders of magnitude
RNN_FP32_RTOL = 2e-5
# the word-LM on the card against the CPU port, three steps from the same
# weights and batches at p = 0, relative to the largest value
WLM_CPU_RTOL = 1e-3
BUCKETS = (10, 20, 30, 35)
BUCKET_SENTENCES = 200


def _ce(probs, labels):
    """Mean cross-entropy of host ``labels`` under host ``probs``."""
    p = probs[onp.arange(len(labels)), labels.astype(int)]
    return float(-onp.log(onp.maximum(p, 1e-30)).mean())


def _rel(a, b):
    """max |a - b| over max |a| (numpy or tensors)."""
    a = onp.asarray(a, dtype=onp.float64)
    b = onp.asarray(b, dtype=onp.float64)
    return float(onp.abs(a - b).max() / max(onp.abs(a).max(), 1e-30))


def _params_host(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _mlp_module(ctx, arg_params=None):
    mod = mx.mod.Module(pm.mlp_symbol(mx.sym, **pm.MLP), context=ctx)
    mod.bind([("data", (pm.MLP["batch"], pm.MLP["features"]))],
             [("softmax_label", (pm.MLP["batch"],))])
    mx.random.seed(SEED)
    if arg_params is None:
        mod.init_params(mx.init.Xavier())
    else:
        mod.init_params(arg_params={k: nd.array(v, ctx=ctx)
                                    for k, v in arg_params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(pm.MLP_OPT))
    return mod


def mlp_phase():
    phase("32 MNIST MLP through Module.fit")
    ctx = mx.gpu(0)
    B = pm.MLP["batch"]
    X, y = pm.mlp_data(2048, seed=SEED)
    Xt, yt, Xv, yv = X[:1792], y[:1792], X[1792:], y[1792:]

    def train_iter(shuffle=False):
        return mx.io.NDArrayIter(Xt, yt, batch_size=B, shuffle=shuffle,
                                 label_name="softmax_label")

    val = mx.io.NDArrayIter(Xv, yv, batch_size=B, label_name="softmax_label")
    # against the CPU port: one pass, the same weights and batches
    gpu_mod = _mlp_module(ctx)
    w0 = _params_host(gpu_mod)
    before = dict(gpu_mod.score(val, "acc"))["accuracy"]
    cpu_mod = _mlp_module(mx.cpu(), w0)
    worst_loss = 0.0
    for batch in train_iter():
        losses = []
        for mod in (gpu_mod, cpu_mod):
            mod.forward_backward(batch)
            mod.update()
            losses.append(_ce(mod.get_outputs()[0].asnumpy(),
                              batch.label[0].asnumpy()))
        worst_loss = max(worst_loss, abs(losses[0] - losses[1])
                         / max(abs(losses[1]), 1e-30))
    wg, wc = _params_host(gpu_mod), _params_host(cpu_mod)
    worst_w = max(_rel(wc[k], wg[k]) for k in wc)
    print(f"  14 steps against the CPU port: per-step loss within "
          f"{worst_loss:.3e}, final weights within {worst_w:.3e} "
          f"(allowed {MLP_CPU_RTOL})")
    if worst_loss > MLP_CPU_RTOL or worst_w > MLP_CPU_RTOL:
        raise RuntimeError("the MLP on the card departs from the CPU port")
    # fit: accuracy before and after, step ms with and without the metric
    res = {}
    for metric in ("acc", None):
        mod = mx.mod.Module(pm.mlp_symbol(mx.sym, **pm.MLP), context=ctx)
        onp.random.seed(SEED)
        it = train_iter(shuffle=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, eval_data=val if metric else None, eval_metric=metric,
                optimizer="sgd", optimizer_params=dict(pm.MLP_OPT),
                num_epoch=MLP_EPOCHS,
                arg_params={k: nd.array(v, ctx=ctx) for k, v in w0.items()})
        torch.cuda.synchronize()
        steps = MLP_EPOCHS * (len(Xt) // B)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        after = dict(mod.score(val, "acc"))["accuracy"]
        res["metric" if metric else "no_metric"] = {
            "step_ms": step_ms, "val_acc_before": float(before),
            "val_acc_after": float(after),
            "graphs": mod._exec.graph_info()}
        print(f"  fit ({'acc metric' if metric else 'no metric'}): "
              f"{step_ms:.3f} ms per step over {steps} steps (binding, "
              f"the graphs' capture and the evaluation passes included), "
              f"validation accuracy {before:.3f} -> {after:.3f}")
        if after <= before + 0.2:
            raise RuntimeError("the MLP's validation accuracy did not rise")
    g = res["metric"]["graphs"]
    print(f"  captured signatures: {[(s['is_train'], s['replays'], s['backward_replays']) for s in g]}")
    if not any(s["is_train"] and s["replays"] >= steps for s in g):
        raise RuntimeError("the MLP's training step was not replayed")
    return res


def rnn_fp32_phase(gen):
    """cuDNN's LSTM inside cudnn_fp32() against the op's plain version on
    the card, at the word-LM's shapes, forward and gradients."""
    cfg = pm.WORD_LM
    T, N, H, L, E = (cfg["bptt"], cfg["batch"], cfg["hidden"],
                     cfg["layers"], cfg["embed"])
    size = ops_nn.rnn_param_size(L, E, H, False, "lstm")
    x = torch.randn(T, N, E, device="cuda", generator=gen)
    w = (torch.rand(size, device="cuda", generator=gen) - 0.5) * 0.2
    h = torch.randn(L, N, H, device="cuda", generator=gen) * 0.5
    c = torch.randn(L, N, H, device="cuda", generator=gen) * 0.5
    cot = [torch.randn(T, N, H, device="cuda", generator=gen),
           torch.randn(L, N, H, device="cuda", generator=gen),
           torch.randn(L, N, H, device="cuda", generator=gen)]
    def run(fn, scope):
        ins = [t.clone().requires_grad_(True) for t in (x, w, h, c)]
        outs = fn(*ins, state_size=H, num_layers=L, mode="lstm")
        # the backward in the scope the port's backward runs in
        # (autograd.backward, the executor's, CachedOp's), or at torch's
        # default cuDNN flags (allow_tf32 True)
        with scope:
            grads = torch.autograd.grad(outs, ins, cot)
        return [o.detach() for o in outs] + list(grads)

    plain = run(ops_nn.rnn_plain, ops_nn.cudnn_fp32())
    names = ["out", "h", "c", "dx", "dw", "dh", "dc"]
    res = {}
    for label, scope in (("cudnn_fp32", ops_nn.cudnn_fp32()),
                         ("torch_default_flags", contextlib.nullcontext())):
        got = run(ops_nn.rnn, scope)
        res[label] = {n: _rel(b.cpu(), a.cpu())
                      for n, a, b in zip(names, plain, got)}
    worst = max(res["cudnn_fp32"].values())
    print(f"  cuDNN LSTM (T={T}, N={N}, {E}->{H}, {L} layers) against the "
          f"plain version on the card, the backward in the port's scope: "
          f"{res['cudnn_fp32']}; worst {worst:.3e} (allowed "
          f"{RNN_FP32_RTOL}: float32, not TF32)")
    print(f"  the same backward at torch's default cuDNN flags (TF32): "
          f"{res['torch_default_flags']}")
    if worst > RNN_FP32_RTOL:
        raise RuntimeError("cuDNN's LSTM is not float32-accurate")
    return worst, res


def _wlm_batches(n, seed=SEED):
    cfg = pm.WORD_LM
    toks = pm.markov_tokens(cfg["bptt"] * cfg["batch"] * n + 1,
                            cfg["vocab"], seed)
    return pm.bptt_batches(toks, cfg["bptt"], cfg["batch"])


def _check_mode(mod, graphs, steps, eager_before):
    """``mod``'s executor captured one training signature replayed
    ``steps`` times (``graphs``), or captured nothing and ran ``steps``
    eager forwards since ``executor_stats()`` read ``eager_before``."""
    info = mod._exec.graph_info()
    eager = mx.executor.executor_stats()["eager_forwards"] - eager_before
    if graphs:
        ok = len(info) == 1 and info[0]["replays"] == steps == \
            info[0]["backward_replays"]
    else:
        ok = info == [] and eager == steps
    if not ok:
        raise RuntimeError(f"the {'captured' if graphs else 'eager'} "
                           f"word-LM ran in the wrong mode: signatures "
                           f"{info}, {eager} eager forwards in {steps} steps")


def _wlm_run(cfg, batches, graphs, arg_params=None, ctx=None, metric=None):
    ctx = ctx or mx.gpu(0)
    with pm.bind_mode(mx, graphs):
        mod = pm.word_lm_module(mx, cfg, ctx, arg_params=arg_params)
    eager_before = mx.executor.executor_stats()["eager_forwards"]
    outs = []
    states = None
    for b in batches:
        _, states = pm.word_lm_train(mx, mod, [b], cfg, ctx, metric=metric,
                                     states=states)
        outs.append(mod.get_outputs()[0].asnumpy())
    if ctx.device_type == "gpu":
        _check_mode(mod, graphs, len(batches), eager_before)
    return mod, outs


def word_lm_phase(gen):
    phase("33 LSTM word-LM through Module and the fused sym.RNN")
    ctx = mx.gpu(0)
    cfg = pm.WORD_LM
    tokens = cfg["bptt"] * cfg["batch"]
    worst, devs = rnn_fp32_phase(gen)
    res = {"config": cfg, "rnn_fp32_worst": worst, "rnn_devs": devs}
    batches = _wlm_batches(2 * (WLM_WARMUP + WLM_STEPS + 2 * WLM_PROFILED)
                           + WLM_FALL + WLM_BITWISE)
    det = dict(cfg, dropout=0.0)
    # captured against eager, bitwise, at p = 0 (deterministic cuDNN)
    w0 = _params_host(pm.word_lm_module(mx, det, ctx))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        eager, e_out = _wlm_run(det, batches[:WLM_BITWISE], False, w0)
        capt, c_out = _wlm_run(det, batches[:WLM_BITWISE], True, w0)
    bad = [i for i, (a, b) in enumerate(zip(e_out, c_out))
           if not onp.array_equal(a, b)]
    we, wc = _params_host(eager), _params_host(capt)
    bad += [k for k in we if not onp.array_equal(we[k], wc[k])]
    print(f"  captured against eager, {WLM_BITWISE} steps at p = 0: "
          f"{'bitwise equal' if not bad else bad} ({len(e_out)} outputs, "
          f"{len(we)} parameters)")
    if bad:
        raise RuntimeError(f"the captured executor departs from eager: {bad}")
    # three steps against the CPU port at p = 0
    cpu, p_out = _wlm_run(det, batches[:WLM_CPU], False, w0, ctx=mx.cpu())
    worst_out = max(_rel(a, b) for a, b in zip(p_out, c_out))
    wp = _params_host(cpu)
    worst_w = max(_rel(wp[k], wc[k]) for k in wp)
    print(f"  {WLM_CPU} steps against the CPU port: softmax outputs within "
          f"{worst_out:.3e}, weights within {worst_w:.3e} (allowed "
          f"{WLM_CPU_RTOL})")
    if max(worst_out, worst_w) > WLM_CPU_RTOL:
        raise RuntimeError("the word-LM on the card departs from the CPU")
    del eager, capt, cpu
    # timed: eager and captured in this call, p = 0.5, Perplexity metric
    _build.reset_launch_counts()
    rest = batches[WLM_BITWISE:]
    for graphs in (False, True):
        _fresh_peak()
        with pm.bind_mode(mx, graphs):
            mod = pm.word_lm_module(mx, cfg, ctx)
        eager_before = mx.executor.executor_stats()["eager_forwards"]
        metric = mx.metric.Perplexity()
        _, states = pm.word_lm_train(mx, mod, rest[:WLM_WARMUP], cfg, ctx,
                                     metric=metric)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, states = pm.word_lm_train(
            mx, mod, rest[WLM_WARMUP:WLM_WARMUP + WLM_STEPS], cfg, ctx,
            metric=metric, states=states)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / WLM_STEPS
        it = iter(rest[WLM_WARMUP + WLM_STEPS:])
        box = {"states": states}

        def step(metric=metric):
            _, box["states"] = pm.word_lm_train(
                mx, mod, [next(it)], cfg, ctx, metric=metric,
                states=box["states"])

        prof = pm.profile_steps(step, WLM_PROFILED)
        key = "captured" if graphs else "eager"
        # the metric's copy to the host: the same steps without it
        t0 = time.perf_counter()
        _, box["states"] = pm.word_lm_train(
            mx, mod, [next(it) for _ in range(WLM_PROFILED)], cfg, ctx,
            states=box["states"])
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t0) * 1e3 / WLM_PROFILED
        _check_mode(mod, graphs, WLM_WARMUP + WLM_STEPS + 2 * WLM_PROFILED,
                    eager_before)
        res[key] = {"step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "profile": prof, "no_metric_step_ms": bare}
        print(f"  {key}: {ms:.3f} ms per step, {tokens / ms * 1e3:,.0f} "
              f"tokens/s, peak {res[key]['peak_gb']:.2f} GB; profiled "
              f"{prof['wall_ms_per_step']:.3f} ms, device busy "
              f"{prof['device_busy_ms_per_step']:.3f} ms, idle "
              f"{prof['device_idle_share']:.1%}, "
              f"{prof['device_ops_per_step']:.0f} device operations")
        print(f"    by kind: " + json.dumps(
            {k: round(v["ms"], 4) for k, v in
             prof["device_ms_per_step_by_kind"].items()}))
        print(f"    without the metric: {bare:.3f} ms per step (the "
              f"Perplexity update copies "
              f"{tokens * cfg['vocab'] * 4 / 1e6:.0f} MB of softmax to the "
              "host each step)")
    # the perplexity falls
    first, last = mx.metric.Perplexity(), mx.metric.Perplexity()
    fall = [next(it) for _ in range(WLM_FALL)]
    _, box["states"] = pm.word_lm_train(mx, mod, fall[:10], cfg, ctx,
                                        metric=first, states=box["states"])
    _, box["states"] = pm.word_lm_train(mx, mod, fall[10:-10], cfg, ctx,
                                        states=box["states"])
    pm.word_lm_train(mx, mod, fall[-10:], cfg, ctx, metric=last,
                     states=box["states"])
    p0, p1 = first.get()[1], last.get()[1]
    print(f"  perplexity over 10 batches: {p0:.1f} -> {p1:.1f} after "
          f"{WLM_FALL - 10} more steps")
    if not (onp.isfinite(p1) and p1 < p0 and p1 < cfg["vocab"]):
        raise RuntimeError("the word-LM's perplexity did not fall below "
                           "the vocabulary's size")
    counts = _build.launch_counts()
    res["k1_k3_launches"] = {"k1": counts.get(FLASH_KERNEL, 0)
                             + counts.get(FLASH_SM90_KERNEL, 0),
                             "k3": counts.get(NORM_ACT_KERNEL, 0)}
    info = mod._exec.graph_info()
    print(f"  captured signatures: {[(s['is_train'], s['replays'], s['backward_replays'], s['launches_per_replay']) for s in info]}; "
          f"K1/K3 launches on this path: {res['k1_k3_launches']}")
    port_ms, flat_ms = pm.repack_ms(cfg, torch.device("cuda", 0))
    res["rnn_fwd_bwd_ms"] = {"port_views": port_ms,
                             "torch_flat_weights": flat_ms}
    print(f"  cuDNN weight repack: the rnn op's forward+backward takes "
          f"{port_ms:.3f} ms of device time on views of the packed vector "
          f"against {flat_ms:.3f} ms for torch.nn.LSTM with flattened "
          f"weights (medians of turns port, flat, flat, port)")
    res["perplexity"] = [p0, p1]
    return res


def bucketing_phase():
    phase("34 BucketingModule over rnn.LSTMCell.unroll")
    ctx = mx.gpu(0)
    cfg = pm.WORD_LM
    B = cfg["batch"]
    sents = pm.sentences(BUCKET_SENTENCES, cfg["vocab"], 5, max(BUCKETS),
                         SEED)
    it = mx.rnn.BucketSentenceIter(sents, B, buckets=list(BUCKETS),
                                   invalid_label=0)
    mod = mx.mod.BucketingModule(
        pm.bucketing_sym_gen(mx, cfg["vocab"], cfg["hidden"], B),
        default_bucket_key=it.default_bucket_key, context=ctx)
    mx.random.seed(SEED)
    metric = mx.metric.Perplexity()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the example's optimizer: Adam at 0.01
    mod.fit(it, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": 0.01}, num_epoch=1,
            initializer=mx.init.Uniform(0.1))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    info = mod.graph_info()
    per_bucket = {k: [(s["is_train"], s["replays"], s["backward_replays"])
                      for s in v] for k, v in sorted(info.items())}
    print(f"  {len(it.idx)} batches over buckets {sorted(info)} in "
          f"{secs:.1f} s (captures included); perplexity "
          f"{metric.get()[1]:.1f}")
    print(f"  per bucket (is_train, replays, backward replays): "
          f"{per_bucket}")
    counts = {it.buckets[i]: 0 for i in range(len(it.buckets))}
    for i, _ in it.idx:
        counts[it.buckets[i]] += 1
    for k, n in counts.items():
        if n == 0:
            continue
        sigs = per_bucket.get(k, [])
        if len(sigs) != 1 or sigs[0][1] != n or sigs[0][2] != n:
            raise RuntimeError(f"bucket {k}: expected one captured "
                               f"signature replayed {n} times, got {sigs}")
    if not onp.isfinite(metric.get()[1]):
        raise RuntimeError("the bucketed LM's perplexity is not finite")
    return {"batches_per_bucket": counts, "graphs": per_bucket,
            "seconds": secs}


def gluon_word_lm_phase(module_ms):
    phase("35 the word-LM in Gluon, hybridized")
    ctx = mx.gpu(0)
    cfg = pm.WORD_LM
    T, N = cfg["bptt"], cfg["batch"]
    GluonWordLM = pm.gluon_word_lm(mx)
    # against the CPU port: WLM_CPU steps from the same weights at p = 0
    det = dict(cfg, dropout=0.0)
    runs = []
    for c in (ctx, mx.cpu()):
        net = GluonWordLM(**det)
        mx.random.seed(SEED)
        net.initialize(mx.init.Uniform(pm.WORD_LM_INIT), ctx=c)
        net.hybridize()
        if runs:
            for p, q in zip(net.collect_params().values(), runs[0][0]):
                p.set_data(nd.array(q, ctx=c))
        w0 = [p.data().asnumpy() for p in net.collect_params().values()]
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(pm.WORD_LM_OPT))
        losses, _ = pm.gluon_word_lm_train(
            mx, net, trainer, _wlm_batches(WLM_CPU, seed=SEED + 1), det, c)
        runs.append((w0, [float(v.asscalar()) for v in losses],
                     [p.data().asnumpy()
                      for p in net.collect_params().values()]))
    (_, g_loss, g_w), (_, c_loss, c_w) = runs
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    worst_w = max(_rel(b, a) for a, b in zip(g_w, c_w))
    print(f"  {WLM_CPU} steps against the CPU port at p = 0: losses within "
          f"{worst_loss:.3e}, weights within {worst_w:.3e} (allowed "
          f"{WLM_CPU_RTOL})")
    if max(worst_loss, worst_w) > WLM_CPU_RTOL:
        raise RuntimeError("the Gluon word-LM on the card departs from the "
                           "CPU port")
    # timed, p = 0.5
    net = GluonWordLM(**cfg)
    mx.random.seed(SEED)
    net.initialize(mx.init.Uniform(pm.WORD_LM_INIT), ctx=ctx)
    net.hybridize()
    gluon.reset_cached_op_stats()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            dict(pm.WORD_LM_OPT))
    batches = _wlm_batches(WLM_WARMUP + WLM_STEPS + WLM_FALL, seed=SEED + 1)
    warm, states = pm.gluon_word_lm_train(mx, net, trainer,
                                          batches[:WLM_WARMUP], cfg, ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, states = pm.gluon_word_lm_train(
        mx, net, trainer, batches[WLM_WARMUP:WLM_WARMUP + WLM_STEPS], cfg,
        ctx, states=states)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / WLM_STEPS
    # the loss falls: WLM_FALL more steps
    more, _ = pm.gluon_word_lm_train(
        mx, net, trainer, batches[WLM_WARMUP + WLM_STEPS:], cfg, ctx,
        states=states)
    vals = [float(v.asscalar()) / (T * N) for v in warm + timed + more]
    first, last = float(onp.mean(vals[:5])), float(onp.mean(vals[-5:]))
    stats = gluon.cached_op_stats()
    print(f"  hybridized: {ms:.3f} ms per step, "
          f"{T * N / ms * 1e3:,.0f} tokens/s (the Module's captured step: "
          f"{module_ms:.3f} ms); mean loss over the first 5 of "
          f"{len(vals)} steps {first:.3f}, over the last 5 {last:.3f} (ln V = "
          f"{onp.log(cfg['vocab']):.3f}); cached op {stats}")
    if not all(onp.isfinite(vals)) or stats["captures"] < 1 or \
            stats["replays"] < WLM_STEPS:
        raise RuntimeError("the Gluon word-LM did not train through its "
                           "captured graphs")
    if not last < min(first, onp.log(cfg["vocab"])):
        raise RuntimeError("the Gluon word-LM's loss did not fall below "
                           "its start and ln(vocabulary)")
    return {"step_ms": ms, "tokens_per_s": T * N / ms * 1e3,
            "losses": [first, last], "cpu_rel": [worst_loss, worst_w],
            "cached_op": stats}


def training_bind_fusion_phase():
    phase("36 K3 and K1 on a training bind")
    ctx = mx.gpu(0)
    sym = mx.sym
    x = sym.Variable("data")
    y = sym.LayerNorm(x, sym.Variable("ln_gamma"), sym.Variable("ln_beta"),
                      name="ln")
    y = sym.LeakyReLU(y, act_type="gelu", name="act")
    q = sym.FullyConnected(y, num_hidden=64, flatten=False, name="q")
    s = sym.softmax(sym.batch_dot(q, q, transpose_b=True), axis=-1)
    out = sym.make_loss(sym.sum(sym.batch_dot(s, q)), name="loss")
    rs = onp.random.RandomState(SEED)
    feed = {"data": rs.randn(4, 128, 64).astype("f"),
            "ln_gamma": 1 + 0.1 * rs.randn(64).astype("f"),
            "ln_beta": 0.1 * rs.randn(64).astype("f"),
            "q_weight": 0.1 * rs.randn(64, 64).astype("f"),
            "q_bias": 0.1 * rs.randn(64).astype("f")}
    grads, counts = {}, {}
    old = os.environ.get("MXNET_GRAPH_OPT")
    try:
        for level in ("0", "2"):
            os.environ["MXNET_GRAPH_OPT"] = level
            ex = out.simple_bind(ctx=ctx, data=(4, 128, 64))
            ex.copy_params_from({k: nd.array(v, ctx=ctx) for k, v in
                                 feed.items() if k != "data"})
            mx.kernels.reset_counters()
            _build.reset_launch_counts()
            ex.forward(is_train=True, data=nd.array(feed["data"], ctx=ctx))
            ex.backward()
            train = _build.launch_counts()
            grads[level] = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
            ex.forward(is_train=False)
            infer = _build.launch_counts()
            counts[level] = {"train": train, "after_inference": infer,
                             "fusion": mx.kernels.counters()}
    finally:
        if old is None:
            os.environ.pop("MXNET_GRAPH_OPT", None)
        else:
            os.environ["MXNET_GRAPH_OPT"] = old
    worst = max(_rel(grads["0"][k], grads["2"][k]) for k in grads["0"])
    c2 = counts["2"]
    print(f"  gradients at MXNET_GRAPH_OPT=2 against 0: within {worst:.3e}; "
          f"K3 launches in the training step "
          f"{c2['train'].get(NORM_ACT_KERNEL, 0)}, after an inference "
          f"forward {c2['after_inference'].get(NORM_ACT_KERNEL, 0)}; "
          f"K1 in the training step {c2['train'].get(FLASH_KERNEL, 0)}; "
          f"fusion counters {c2['fusion']}")
    if worst > 1e-4 or c2["train"].get(NORM_ACT_KERNEL, 0) != 0 or \
            c2["after_inference"].get(NORM_ACT_KERNEL, 0) < 1 or \
            c2["fusion"].get("replay_needs_grad", 0) < 1:
        raise RuntimeError("a training bind lost gradients or ran K3 on a "
                           "graph that needs one")
    return {"worst": worst, "counts": c2}


# -- ROADMAP A1: the NDArray and op surface ------------------------------------

# the hand update against the Trainer's fused SGD step from the same weights
# and gradients: two fp32 orderings of one formula, relative to each
# parameter's largest magnitude
HAND_VS_TRAINER = 1e-6
# the hand loop's logged and timed steps; the falling-loss check reads step
# RESNET_FALL_STEPS, as phase 16's does (the loss overshoots early)
HAND_STEPS = 20
# the loss is the batch mean, so its gradients are scaled already: the
# Trainer's rescale_grad, 1 / step's batch_size, is 1
HAND_RESCALE = 1.0


def _hand_backward(net, x, y):
    """The tutorials' loss, -mean log softmax at the label, recorded and
    differentiated; returns the logits and the loss."""
    with autograd.record():
        out = net(x)
        loss = -nd.pick(nd.log_softmax(out), y).mean()
    loss.backward()
    return out, loss


def _hand_update(params, moms):
    """SGD with momentum as the from-scratch tutorials write it, through
    the in-place operators on each Parameter's data (its registered
    leaf): m *= 0.9; m -= lr * (g + wd * w); w += m."""
    for p, m in zip(params, moms):
        w = p.data()
        g = p.grad() * HAND_RESCALE
        m *= pr.MOMENTUM
        m -= pr.LR * (g + pr.WD * w)
        w += m


def _hand_log(out, y, loss, params):
    """The step's loss, top-1 and top-5 accuracy, and the global gradient
    norm from ``nd.norm``, each read with ``float()``."""
    top1 = float((out.argmax(axis=1) == y).mean())
    top5 = float((nd.topk(out, k=5) == y.reshape((-1, 1))).sum(axis=1)
                 .mean())
    norms = [nd.norm(p.grad()) for p in params]
    gnorm = float(nd.add_n(*[n * n for n in norms]) ** 0.5)
    return {"loss": float(loss), "top1": top1, "top5": top5,
            "grad_norm": gnorm}


def _restore(params, weights, moms):
    with torch.no_grad():
        for p, w in zip(params, weights):
            p.data().data.copy_(w)
        for m in moms:
            m.data.zero_()


def hand_loop_phase():
    phase("37 ResNet-50 through a hand-written SGD loop")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    torch.backends.cudnn.benchmark = True
    net = pr.build_resnet50(ctx, seed=SEED)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    mx.random.seed(SEED)
    x = nd.random.uniform(-1, 1, shape=(RESNET_B, 3, pr.IMAGE, pr.IMAGE),
                          ctx=ctx)
    y = nd.random.randint(0, pr.CLASSES, shape=(RESNET_B,),
                          ctx=ctx).astype("float32")
    moms = [nd.zeros(p.shape, ctx=ctx) for p in params]
    leaves = [p.data().data for p in params]
    w0 = [t.detach().clone() for t in leaves]
    # 1. the same update as the Trainer's fused step, from the same
    # weights and gradients
    _hand_backward(net, x, y)
    _hand_update(params, moms)
    kept = all(p.data().data is t for p, t in zip(params, leaves))
    hand = [t.detach().clone() for t in leaves]
    moved = sum(not torch.equal(a, b) for a, b in zip(hand, w0))
    _restore(params, w0, moms)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": pr.LR, "momentum": pr.MOMENTUM,
                             "wd": pr.WD})
    trainer.step(1)
    worst = max(float((t.detach() - h).abs().max()
                      / h.abs().max().clamp_min(1e-30))
                for t, h in zip(leaves, hand))
    print(f"  hand update: every parameter kept its leaf: {kept}; "
          f"{moved}/{len(params)} parameters moved; against the Trainer's "
          f"fused sgd step: {worst:.3g} of each parameter's largest "
          f"magnitude (bound {HAND_VS_TRAINER})")
    if not kept or moved != len(params) or not worst <= HAND_VS_TRAINER:
        raise RuntimeError("the hand-written SGD update did not reach the "
                           "parameters, or differs from the Trainer's")
    # 2. the in-place writes reach the captured forward: same gradients,
    # fresh momenta, the forward captured before the update
    _restore(params, w0, moms)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=True):
        net.hybridize()
        before = net(x).data.detach().clone()
        _hand_update(params, moms)
        captured = net(x).data.detach().clone()
        cached = gluon.cached_op_stats()
        net.hybridize(False)
        eager = net(x).data.detach().clone()
    same = torch.equal(captured, eager)
    changed = not torch.equal(captured, before)
    print(f"  after a hand update: captured forward bitwise equal to eager: "
          f"{same}; differs from before the update: {changed}; cached op "
          f"{cached}")
    if not same or not changed or cached["captures"] != 1 or \
            cached["replays"] != 2:
        raise RuntimeError("the in-place update did not reach the captured "
                           "graph")
    # 3. training: the hand loop timed and logged, then untimed to the
    # falling-loss step; the Trainer loop on the same loss timed beside
    _restore(params, w0, moms)
    logs, step_ms = [], []
    for i in range(RESNET_FALL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, loss = _hand_backward(net, x, y)
        _hand_update(params, moms)
        if i < HAND_STEPS:
            logs.append(_hand_log(out, y, loss, params))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        elif i == RESNET_FALL_STEPS - 1:
            logs.append(_hand_log(out, y, loss, params))
    for i, row in enumerate(logs[:HAND_STEPS]):
        print(f"  step {i + 1}: " + json.dumps(row))
    print(f"  step {RESNET_FALL_STEPS}: " + json.dumps(logs[-1]))
    losses = [r["loss"] for r in logs]
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the hand-written loop did not train: {losses}")
    _restore(params, w0, moms)
    trainer_ms = []
    for i in range(RESNET_WARMUP + RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, loss = _hand_backward(net, x, y)
        trainer.step(1)
        _hand_log(out, y, loss, params)
        torch.cuda.synchronize()
        if i >= RESNET_WARMUP:
            trainer_ms.append((time.perf_counter() - t0) * 1e3)
    result = {"hand_step_ms": statistics.mean(step_ms[RESNET_WARMUP:]),
              "hand_first_step_ms": step_ms[0],
              "trainer_step_ms": statistics.mean(trainer_ms),
              "hand_vs_trainer": worst,
              "first_loss": losses[0], "last_loss": losses[-1]}
    print("hand loop " + json.dumps(result))
    del net, trainer
    torch.cuda.empty_cache()
    return result


def op_sweep_phase():
    phase("38 the op sweep")
    dev = torch.device("cuda", 0)
    rows = op_sweep.card_sweep(dev, op_sweep.SURFACE)
    exact = sum(r["exact_outputs"] for r in rows)
    worst = max(rows, key=lambda r: r["worst"])
    print(f"  {len(rows)} cases on the card against the CPU port, forward "
          f"and backward: {exact} outputs bitwise, the worst float "
          f"deviation {worst['worst']:.3g} of its bound ({worst['case']})")
    n_captured = op_sweep.capture_check(dev, op_sweep.SURFACE)
    skipped = sorted({c.op for c in op_sweep.SURFACE
                      if c.op in op_sweep.DATA_DEPENDENT})
    print(f"  {n_captured} cases in one CUDA graph, the replay bitwise equal "
          f"to the eager calls; not captured (output shapes that depend on "
          f"the data): {skipped}")
    n_random = op_sweep.random_capture_check(dev, op_sweep.RANDOM_SURFACE)
    print(f"  {n_random} random draws in one CUDA graph under the registered "
          "generator: each replay draws anew, and repeats after "
          "mx.random.seed")
    suite = opperf.run_op_suite(ctx=mx.gpu(0))
    for r in suite:
        print("  opperf " + json.dumps(r))
    return {"cases": len(rows), "bitwise_outputs": exact,
            "captured": n_captured, "random_captured": n_random,
            "opperf": suite}


# -- ROADMAP A3: the Gluon surface, the vision zoo, VGG-16 -------------------

# the zoo at published widths (1000 classes, 224 x 224, Inception v3 at
# 299 x 299): eager against hybridized at batch 32, against the CPU port
# at batch 2, timed over 5 steps after 2
ZOO_MODELS = ("alexnet", "vgg16", "vgg16_bn", "squeezenet1_1",
              "mobilenet1_0", "mobilenet_v2_1_0", "densenet121",
              "inception_v3", "resnet50_v2")
ZOO_B, ZOO_CPU_B, ZOO_WARMUP, ZOO_STEPS = 32, 2, 2, 5
# the card against the CPU port, eval mode: within this fraction of each
# tensor's largest magnitude; a gradient behind a max-pool near-tie (two
# values of a window within float32 rounding, which each device's
# rounding resolves its own way) within this relative L2 distance
ZOO_CPU_TOL, ZOO_NEAR_TIE_L2 = 1e-3, 1e-2
# Simonyan and Zisserman's 13 convolutions and 3 FC layers at 1000
# classes, as the JAX package's vgg16 counts them
VGG16_PARAMS = 138_357_544
VGG_B, VGG_STEPS, VGG_PROFILED = 64, 20, 3
LAMB_B, LAMB_STEPS, LAMB_PARAMS = 128, 10, {"learning_rate": 0.01,
                                            "wd": 1e-4}
# the new optimizers on the card against the CPU port: 3 steps, within
# this fraction of each parameter's largest magnitude
OPTIM_TAIL = (("adamax", {}), ("nadam", {}), ("ftml", {}),
              ("lamb", {"wd": 0.01}), ("lars", {"momentum": 0.9}),
              ("lbsgd", {"momentum": 0.9}), ("dcasgd", {"momentum": 0.9}),
              ("sgld", {"wd": 0.01}), ("groupadagrad", {}))
OPTIM_TAIL_TOL = 1e-5
# SSD300-VGG16 at its published widths (ROADMAP A4): example/ssd's 300 x
# 300 VGG-16 settings, 26,285,486 trainable parameters as the JAX
# package's network counts them (``tools/profile_ssd.py``)
SSD_PARAMS = 26_285_486
SSD_B, SSD_STEPS, SSD_BITWISE_B, SSD_CPU_B = 32, 20, 8, 2
# the card against the CPU port at batch 2: the class and location
# outputs within this fraction of their largest value (cuDNN against the
# CPU's convolutions through 15 layers), the loss within this rtol
SSD_CPU_TOL, SSD_LOSS_RTOL = 1e-3, 1e-4
# the detection ops on the card against the CPU port: coordinates,
# scores and box targets within this fraction of max(1, largest), the
# roi_align gradient within it of its largest; integer outputs exact
DET_TOL = 1e-5
N1_THRESH = 0.45  # example/ssd's nms_threshold


def _dropouts(net):
    """The net's Dropout layers."""
    found = []
    net.apply(lambda blk: found.append(blk)
              if isinstance(blk, gluon.nn.Dropout) else None)
    return found


def _zoo_record(net, x, y, loss_fn):
    """One recorded forward and backward: (logits, {name: gradient}) on
    the device."""
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward()
    return out.data.detach().clone(), {
        k: p.grad().data.detach().clone()
        for k, p in net._collect_params_with_prefix().items()
        if p.grad_req != "null"}


def _zoo_vs_cpu(name, net, size):
    """Eval-mode logits and every gradient of ``sum(logits * cot)`` at
    batch 2 on the card against the CPU port with the same weights."""
    rs = onp.random.RandomState(SEED + 1)
    x = rs.standard_normal((ZOO_CPU_B, 3, size, size)).astype("float32")
    cot = rs.standard_normal((ZOO_CPU_B, pz.CLASSES)).astype("float32")
    cpu = vision.get_model(name, classes=pz.CLASSES)
    convert.params_from_numpy(
        cpu, {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()},
        ctx=mx.cpu())
    runs = []
    for n, ctx in ((net, mx.gpu(0)), (cpu, mx.cpu())):
        xin = nd.array(x, ctx=ctx)
        xin.attach_grad()
        with autograd.record(train_mode=False):
            out = n(xin)
            loss = (out * nd.array(cot, ctx=ctx)).sum()
        loss.backward()
        grads = {k: p.grad().asnumpy() for k, p in
                 n._collect_params_with_prefix().items()
                 if p.grad_req != "null"}
        grads["input"] = xin.grad.asnumpy()
        runs.append((out.asnumpy(), grads))
    (out_c, g_c), (out_h, g_h) = runs
    logit_dev = float(onp.abs(out_c - out_h).max() / onp.abs(out_h).max())
    if logit_dev > ZOO_CPU_TOL:
        raise RuntimeError(f"{name}: logits {logit_dev:.3g} off the CPU "
                           f"port's (bound {ZOO_CPU_TOL})")
    worst, near_ties = 0.0, []
    for k in g_h:
        scale = float(onp.abs(g_h[k]).max()) or 1.0
        dev = float(onp.abs(g_c[k] - g_h[k]).max()) / scale
        if dev > ZOO_CPU_TOL:
            l2 = float(onp.linalg.norm((g_c[k] - g_h[k]).ravel())
                       / max(onp.linalg.norm(g_h[k].ravel()), 1e-30))
            if l2 > ZOO_NEAR_TIE_L2:
                raise RuntimeError(f"{name}: gradient {k} {dev:.3g} of its "
                                   f"scale and {l2:.3g} in L2 off the CPU "
                                   "port's")
            near_ties.append((k, dev, l2))
            continue
        worst = max(worst, dev)
    del cpu
    return {"logits": logit_dev, "gradients": worst,
            "near_ties": near_ties[:4], "n_near_ties": len(near_ties),
            "n_gradients": len(g_h)}


def zoo_phase():
    phase("39 the vision zoo at published widths")
    ctx = mx.gpu(0)
    rows = {}
    for name in ZOO_MODELS:
        fused_step.reset_fused_step_cache()
        gluon.reset_cached_op_stats()
        _fresh_peak()
        t_model = time.perf_counter()
        net = pz.build(name, ctx, seed=SEED)
        count = pz.trainable_count(net)
        size = pz.image_size(name)
        # 1. the card against the CPU port at batch 2, eval mode, eager
        cpu = _zoo_vs_cpu(name, net, size)
        # 2. eager against hybridized at batch 32, training mode, dropout
        # off and cuDNN held to deterministic algorithms: bitwise
        x, y = pz.synthetic_batch(ZOO_B, size, ctx, seed=SEED)
        loss_fn = gluon.loss.SoftmaxCELoss()
        drops = _dropouts(net)
        rates = [d._rate for d in drops]
        for d in drops:
            d._rate = 0.0
        aux = [p.data().data for p in net.collect_params().values()
               if p.grad_req == "null"]
        aux0 = [t.detach().clone() for t in aux]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True):
            out_e, g_e = _zoo_record(net, x, y, loss_fn)
            with torch.no_grad():
                for t, v in zip(aux, aux0):
                    t.copy_(v)
            net.hybridize()
            out_h, g_h = _zoo_record(net, x, y, loss_fn)
        bad = [k for k in g_e if not torch.equal(g_e[k], g_h[k])]
        if not torch.equal(out_e, out_h) or bad:
            raise RuntimeError(
                f"{name}: hybridized differs from eager: logits "
                f"{float((out_e - out_h).abs().max()):.3g}, gradients "
                f"{bad[:5]}")
        cached = gluon.cached_op_stats()
        n_bitwise = 1 + len(g_e)
        del out_e, g_e, out_h, g_h
        with torch.no_grad():
            for t, v in zip(aux, aux0):
                t.copy_(v)
        del aux0
        # 3. training steps at the published dropout, hybridized anew (the
        # rate is part of the captured graph), SGD-momentum
        for d, r in zip(drops, rates):
            d._rate = r
        net.hybridize()
        trainer = pz.make_trainer(net)
        # the peak from here takes in the captures' memory pools
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(ZOO_WARMUP):
            loss = pz.train_step(net, trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ZOO_STEPS):
            loss = pz.train_step(net, trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / ZOO_STEPS
        last = float(loss.asscalar())
        if not onp.isfinite(last):
            raise RuntimeError(f"{name}: training loss {last}")
        row = {"trainable_parameters": count, "image": size,
               "bitwise_tensors": n_bitwise,
               "cpu_deviation": cpu, "step_ms": step_ms,
               "img_per_s": ZOO_B * 1e3 / step_ms,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "captures": cached["captures"], "last_loss": last,
               "seconds": time.perf_counter() - t_model}
        rows[name] = row
        print(f"  {name}: {count:,} trainable parameters; eager = "
              f"hybridized bitwise ({row['bitwise_tensors']} tensors); "
              f"CPU: logits {cpu['logits']:.3g}, gradients "
              f"{cpu['gradients']:.3g} ({cpu['n_near_ties']} of "
              f"{cpu['n_gradients']} behind near-ties, {cpu['near_ties']}); "
              f"batch {ZOO_B}: {step_ms:.2f} ms/step, "
              f"{row['img_per_s']:.1f} img/s, peak "
              f"{row['peak_gb']:.2f} GB")
        del net, trainer, x, y, loss
    return rows


def vgg_phase():
    phase("40 VGG-16 training")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    torch.backends.cudnn.benchmark = True
    _fresh_peak()
    net = pz.build("vgg16", ctx, seed=SEED)
    count = pz.trainable_count(net)
    if count != VGG16_PARAMS:
        raise RuntimeError(f"vgg16 has {count:,} trainable parameters, the "
                           f"JAX model {VGG16_PARAMS:,}")
    if [d._rate for d in _dropouts(net)] != [0.5, 0.5]:
        raise RuntimeError("vgg16: dropout 0.5 in its two 4096-wide layers")
    trainer = pz.make_trainer(net)  # SGD 0.01, momentum 0.9, wd 5e-4
    loss_fn = gluon.loss.SoftmaxCELoss()
    net.hybridize()
    x, y = pz.synthetic_batch(VGG_B, 224, ctx, seed=SEED)

    def eval_loss():
        # the batch's loss without dropout's noise
        with autograd.predict_mode():
            return float(loss_fn(net(x), y).mean().asscalar())

    before = eval_loss()
    losses, step_ms = [], []
    for _ in range(VGG_STEPS):
        t0 = time.perf_counter()
        loss = pz.train_step(net, trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.asscalar()))
    after = eval_loss()
    if not all(onp.isfinite(losses)) or not after < before:
        raise RuntimeError(f"VGG-16: the batch's eval-mode loss {before} -> "
                           f"{after}; training losses {losses}")
    cached = gluon.cached_op_stats()
    fs = fused_step.fused_step_stats()
    if cached["captures"] != 2 or cached["backward_replays"] != VGG_STEPS:
        raise RuntimeError(f"VGG-16 hybridized: {cached} in {VGG_STEPS} "
                           "steps (want two captures, training and eval, "
                           "and a backward replay per step)")
    timed = step_ms[2:]
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = pr.profile_steps(lambda: pz.train_step(net, trainer, loss_fn, x,
                                                  y), VGG_PROFILED)
    result = {"trainable_parameters": count, "batch": VGG_B,
              "steps": VGG_STEPS, "eval_loss": [before, after],
              "first_loss": losses[0],
              "last_loss": losses[-1], "losses": losses,
              "mean_step_ms": statistics.mean(timed),
              "median_step_ms": statistics.median(timed),
              "img_per_s": VGG_B * 1e3 / statistics.mean(timed),
              "peak_gb": peak, "cached_op": cached,
              "fused_step": {k: fs[k] for k in ("captures", "replays")},
              "profile": {k: prof[k] for k in (
                  "wall_ms_per_step", "device_busy_ms_per_step",
                  "device_idle_share", "device_ops_per_step",
                  "device_ms_per_step_by_kind")}}
    print("  vgg16 " + json.dumps(result))
    print(f"  VGG-16, batch {VGG_B}, hybridized: {result['mean_step_ms']:.2f}"
          f" ms/step (median {result['median_step_ms']:.2f}) over steps "
          f"3-{VGG_STEPS}, {result['img_per_s']:.1f} img/s, peak "
          f"{peak:.2f} GB, device idle "
          f"{100 * prof['device_idle_share']:.1f}% (profiled "
          f"{prof['wall_ms_per_step']:.2f} ms, busy "
          f"{prof['device_busy_ms_per_step']:.2f} ms); the batch's "
          f"eval-mode loss {before:.4f} -> {after:.4f} (training losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f})")
    del net, trainer, x, y
    return result


def _optimizer_ms(trainer):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.step(LAMB_B)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def lamb_phase():
    phase("41 LAMB on ResNet-50 v2")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    torch.backends.cudnn.benchmark = True
    _fresh_peak()
    net = pz.build("resnet50_v2", ctx, seed=SEED)
    net.hybridize()
    loss_fn = gluon.loss.SoftmaxCELoss()
    x, y = pz.synthetic_batch(LAMB_B, 224, ctx, seed=SEED)
    results = {}
    for opt, params in (("lamb", LAMB_PARAMS),
                        ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-4})):
        trainer = pz.make_trainer(net, opt, params)
        before = fused_step.fused_step_stats()["bypasses"]
        losses, opt_ms, step_ms = [], [], []
        for _ in range(LAMB_STEPS):
            t0 = time.perf_counter()
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            opt_ms.append(_optimizer_ms(trainer))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.mean().asscalar()))
        bypasses = fused_step.fused_step_stats()["bypasses"] - before
        results[opt] = {"first_loss": losses[0], "last_loss": losses[-1],
                        "optimizer_ms": statistics.mean(opt_ms[2:]),
                        "step_ms": statistics.mean(step_ms[2:]),
                        "eager_loop_steps": bypasses}
        if opt == "lamb":
            if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
                raise RuntimeError(f"LAMB on resnet50_v2: losses {losses}")
            if bypasses != LAMB_STEPS:
                raise RuntimeError(f"LAMB ran the eager loop {bypasses} "
                                   f"times in {LAMB_STEPS} steps")
        del trainer
    print("  resnet50_v2 optimizers " + json.dumps(results))
    print(f"  LAMB's eager per-parameter loop: "
          f"{results['lamb']['optimizer_ms']:.2f} ms a step against the "
          f"fused SGD step's {results['sgd']['optimizer_ms']:.2f} ms on the "
          f"same net (batch {LAMB_B}; steps "
          f"{results['lamb']['step_ms']:.2f} and "
          f"{results['sgd']['step_ms']:.2f} ms); LAMB loss "
          f"{results['lamb']['first_loss']:.4f} -> "
          f"{results['lamb']['last_loss']:.4f}")
    del net, x, y
    return results


class _QuietSGLD(mx.optimizer.SGLD):
    """SGLD without its noise: the update the card and the CPU share."""

    def _noise(self, weight, lr):
        return None


def _mlp_weights():
    rs = onp.random.RandomState(SEED)
    return {"0.weight": rs.randn(64, 32).astype("f") * 0.2,
            "0.bias": rs.randn(64).astype("f") * 0.1,
            "1.weight": rs.randn(10, 64).astype("f") * 0.2,
            "1.bias": rs.randn(10).astype("f") * 0.1}


def _optim_run(name, kw, ctx, x, y):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(64, activation="tanh", in_units=32),
            gluon.nn.Dense(10, in_units=64))
    convert.params_from_numpy(net, _mlp_weights(), ctx=ctx)
    params = [p for k, p in sorted(net._collect_params_with_prefix().items())
              if name != "groupadagrad" or k.endswith("weight")]
    opt = _QuietSGLD(learning_rate=0.01, **kw) if name == "sgld" else \
        mx.optimizer.create(name, learning_rate=0.01, **kw)
    trainer = gluon.Trainer(params, opt)
    lf = gluon.loss.SoftmaxCELoss()
    xs, ys = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
    for _ in range(3):
        with autograd.record():
            loss = lf(net(xs), ys).mean()
        loss.backward()
        trainer.step(1)
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def optim_tail_phase():
    phase("42 the new optimizers and their ops against the CPU port")
    rs = onp.random.RandomState(SEED)
    x = rs.randn(16, 32).astype("f")
    y = rs.randint(0, 10, 16).astype("f")
    worst = {}
    for name, kw in OPTIM_TAIL:
        card = _optim_run(name, kw, mx.gpu(0), x, y)
        cpu = _optim_run(name, kw, mx.cpu(), x, y)
        dev = max(float(onp.abs(card[k] - cpu[k]).max()
                        / onp.abs(cpu[k]).max()) for k in cpu)
        moved = sum(not onp.array_equal(cpu[k], w)
                    for k, w in _mlp_weights().items())
        if dev > OPTIM_TAIL_TOL or moved == 0:
            raise RuntimeError(f"{name}: the card {dev:.3g} off the CPU "
                               f"(bound {OPTIM_TAIL_TOL}); {moved} moved")
        worst[name] = dev
    # the ops
    w, g, d, v, z = (rs.randn(256, 128).astype("f") for _ in range(5))
    v, d = onp.abs(v), onp.abs(d) + 0.5

    def ops(ctx):
        a = [nd.array(t, ctx=ctx) for t in (w, g, d, v, z)]
        f = nd.ftml_update(*a, lr=0.01, wd=0.01, t=3)
        b = [nd.array(t, ctx=ctx) for t in (w, g, z, v)]
        p1 = nd.lamb_update_phase1(*b, t=2, wd=0.01)
        r1, r2 = nd.norm(b[0]), nd.norm(p1[0])
        p2 = nd.lamb_update_phase2(b[0], p1[0], r1, r2, lr=0.01)
        lars = nd.multi_lars(*[nd.array(t[0, :8].copy(), ctx=ctx)
                               for t in (onp.abs(w), onp.abs(g), v, d)])
        return [o.asnumpy() for o in (*f, *p1, p2, lars)]

    op_dev = max(float(onp.abs(a - b).max() / onp.abs(b).max())
                 for a, b in zip(ops(mx.gpu(0)), ops(mx.cpu())))
    if op_dev > 1e-6:
        raise RuntimeError(f"ftml/lamb/multi_lars ops: the card {op_dev:.3g} "
                           "off the CPU")
    print("  3 Trainer steps each on a 32-64-10 MLP, card against CPU "
          "(SGLD without its noise), of each parameter's largest value: "
          + json.dumps(worst) + f"; ftml_update, lamb_update_phase1/2, "
          f"multi_lars: {op_dev:.3g}")
    return {"optimizers": worst, "ops": op_dev}


def examples_phase():
    phase("43 the GAN and matrix-factorization twins of examples/")
    from mxnet_tpu_torch.examples import train_gan_toy, train_recommender_mf

    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    t0 = time.perf_counter()
    gan = train_gan_toy.main([])
    gan_s = time.perf_counter() - t0
    cached = gluon.cached_op_stats()
    if not (onp.isfinite(gan["mean_radius"]) and onp.isfinite(gan["d_loss"])):
        raise RuntimeError(f"GAN twin: {gan}")
    t0 = time.perf_counter()
    mf = train_recommender_mf.main([])
    if not mf["last_mse"] < mf["first_mse"]:
        raise RuntimeError(f"MF twin: {mf}")
    print(f"  GAN: {gan_s:.1f} s, mean radius {gan['mean_radius']:.3f} "
          f"(target 2.0), the discriminator captured in two slots "
          f"({cached['captures']} captures, {cached['backward_replays']} "
          f"backward replays); MF: MSE {mf['first_mse']:.4f} -> "
          f"{mf['last_mse']:.4f} in {time.perf_counter() - t0:.1f} s")
    return {"gan": gan, "gan_seconds": gan_s, "gan_cached_op": cached,
            "mf": mf}


def _det_dev(name, card, cpu, exact=(), id_col=None, relative=()):
    """Compare one op's outputs (lists of arrays) card against CPU:
    outputs whose index is in ``exact`` bitwise; with ``id_col`` the id
    column and the -1 rows exactly; the rest within DET_TOL of
    max(1, largest), or of the largest for the indices in ``relative``.
    Returns the worst deviation."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        a, b = onp.asarray(a, "float64"), onp.asarray(b, "float64")
        if a.shape != b.shape:
            raise RuntimeError(f"{name}[{i}]: shape {a.shape} on the card, "
                               f"{b.shape} on the CPU")
        if i in exact:
            if not onp.array_equal(a, b):
                raise RuntimeError(f"{name}[{i}]: card and CPU differ in "
                                   f"{int((a != b).sum())} entries")
            continue
        if id_col is not None and not onp.array_equal(a[..., id_col],
                                                      b[..., id_col]):
            n_bad = int((a[..., id_col] != b[..., id_col]).sum())
            raise RuntimeError(f"{name}: ids or -1 rows differ in {n_bad} "
                               "rows")
        big = float(onp.abs(b).max()) if b.size else 1.0
        dev = float(onp.abs(a - b).max()) / (
            (big or 1.0) if i in relative else max(1.0, big)) \
            if a.size else 0.0
        if dev > DET_TOL:
            raise RuntimeError(f"{name}[{i}]: {dev:.3g} off the CPU port "
                               f"(bound {DET_TOL})")
        worst = max(worst, dev)
    return worst


def _on(ctx, *arrays):
    return [nd.array(a, ctx=ctx) for a in arrays]


def _roi_align_run(ctx, data, rois, pooled, scale, cot):
    d = nd.array(data, ctx=ctx)
    d.attach_grad()
    with autograd.record():
        out = nd.contrib.ROIAlign(d, nd.array(rois, ctx=ctx),
                                  pooled_size=pooled, spatial_scale=scale)
        (out * nd.array(cot, ctx=ctx)).sum().backward()
    return out.asnumpy(), d.grad.asnumpy()


def _detection_op_cases(rs):
    """(name, fn(ctx) -> list of outputs, exact output indices, id
    column, indices held relative to their largest) for each detection op
    at SSD300's shapes and at the JAX package's test shapes
    (tests/test_contrib_ops.py)."""
    from mxnet_tpu_torch.ndarray.ops_contrib import _detection_rows

    _, labels = ps.synthetic_batch(SSD_B, seed=SEED + 3, size=8)
    cls = rs.randn(SSD_B, ps.CLASSES + 1, ps.ANCHORS).astype("float32")
    loc = (rs.randn(SSD_B, ps.ANCHORS * 4) * 0.3).astype("float32")
    gt = labels[..., 1:].copy()
    gt[labels[..., 0] < 0] = 0

    def anchors(ctx):
        return ps.anchors(mx, ctx)

    def iou(ctx):
        return nd.contrib.box_iou(anchors(ctx).reshape((-1, 4)),
                                  nd.array(gt[0], ctx=ctx))

    def bip(ctx):
        s = nd.contrib.box_iou(anchors(ctx), nd.array(gt, ctx=ctx))
        return nd.contrib.bipartite_matching(s, threshold=1e-12)

    def target(ctx):
        return nd.contrib.MultiBoxTarget(anchors(ctx), *_on(ctx, labels, cls),
                                         **ps.TARGET)

    def detection(ctx):
        prob = nd.softmax(nd.array(cls, ctx=ctx), axis=1)
        return nd.contrib.MultiBoxDetection(prob, nd.array(loc, ctx=ctx),
                                            anchors(ctx), **ps.DETECT)

    def nms(ctx, **kw):
        # the decoded rows MultiBoxDetection hands to its box_nms
        prob = nd.softmax(nd.array(cls, ctx=ctx), axis=1)
        rows = _detection_rows(prob._data, nd.array(loc, ctx=ctx)._data,
                               anchors(ctx)._data, True, 0.01, 0,
                               ps.DETECT["variances"])
        return nd.contrib.box_nms(nd.NDArray(rows), overlap_thresh=N1_THRESH,
                                  coord_start=2, score_index=1, id_index=0,
                                  **kw)

    data = rs.randn(2, 512, 38, 38).astype("float32")
    rois = onp.concatenate([rs.randint(0, 2, (64, 1)),
                            rs.uniform(0, 20, (64, 2)),
                            rs.uniform(20, 38, (64, 2))], 1).astype("f")
    cot = rs.randn(64, 512, 7, 7).astype("float32")
    # the JAX package's test inputs
    t_d = onp.array([[[0, 0.9, 0, 0, 2, 2], [0, 0.8, 0.1, 0.1, 2, 2],
                      [1, 0.7, 0, 0, 2, 2], [0, 0.6, 5, 5, 6, 6]]], "f")
    t_anc = onp.array([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
                        [0.0, 0.0, 0.2, 0.2], [0.6, 0.6, 0.8, 0.8]]], "f")
    t_lab = onp.array([[[0, 0.1, 0.1, 0.42, 0.42]]], "f")
    t_cp = onp.random.RandomState(0).rand(1, 3, 4).astype("f")
    t_prob = onp.array([[[0.2, 0.8], [0.7, 0.1], [0.1, 0.1]]], "f")
    t_s = onp.array([[[0.9, 0.1], [0.8, 0.7]]], "f")
    t_roi = onp.arange(16, dtype="f").reshape(1, 1, 4, 4)
    return [
        ("multibox_prior (1, 8732, 4)", lambda c: [anchors(c)], (), None,
         ()),
        ("box_iou (8732, 16)", lambda c: [iou(c)], (), None, ()),
        ("bipartite_matching (32, 8732, 16)", bip, (0, 1), None, ()),
        ("multibox_target (32, 21, 8732)", target, (1, 2), None, ()),
        ("multibox_detection (32, 21, 8732)", lambda c: [detection(c)], (),
         0, ()),
        ("box_nms (32, 8732, 6), class-aware, topk 400",
         lambda c: [nms(c, topk=400)], (), 0, ()),
        ("box_nms (32, 8732, 6), force_suppress, topk 200",
         lambda c: [nms(c, force_suppress=True, topk=200)], (), 0, ()),
        ("roi_align (2, 512, 38, 38), 64 rois, 7x7, and its gradient",
         lambda c: _roi_align_run(c, data, rois, (7, 7), 1.0, cot), (),
         None, (1,)),
        ("box_iou, JAX test", lambda c: [nd.contrib.box_iou(
            *_on(c, [[0, 0, 2, 2], [1, 1, 3, 3]],
                 [[0, 0, 2, 2], [2, 2, 4, 4]]))], (), None, ()),
        ("box_nms, JAX test", lambda c: [nd.contrib.box_nms(
            nd.array(t_d, ctx=c), overlap_thresh=0.5, coord_start=2,
            score_index=1, id_index=0, force_suppress=f)
            for f in (False, True)], (), 0, ()),
        ("multibox_prior, JAX test", lambda c: [nd.contrib.MultiBoxPrior(
            nd.zeros((1, 3, 2, 2), ctx=c), sizes=[0.5, 0.25],
            ratios=[1, 2])], (), None, ()),
        ("multibox_target, JAX test", lambda c: nd.contrib.MultiBoxTarget(
            *_on(c, t_anc, t_lab, t_cp), negative_mining_ratio=1.0,
            negative_mining_thresh=0.0), (1, 2), None, ()),
        ("multibox_detection, JAX test", lambda c: [
            nd.contrib.MultiBoxDetection(*_on(c, t_prob, onp.zeros(
                (1, 8), "f"), t_anc[:, :2]), threshold=0.05)], (), 0, ()),
        ("bipartite_matching, JAX test", lambda c: list(
            nd.contrib.bipartite_matching(nd.array(t_s, ctx=c),
                                          threshold=0.05)), (0, 1), None,
         ()),
        ("roi_align, JAX test", lambda c: _roi_align_run(
            c, t_roi, onp.array([[0, 0, 0, 3, 3]], "f"), (2, 2), 1.0,
            onp.ones((1, 1, 2, 2), "f")), (), None, (1,)),
    ]


def _host_list(outs):
    return [o.asnumpy() if hasattr(o, "asnumpy") else onp.asarray(o)
            for o in outs]


def n1_bound(keep, vs, limit, has_ids):
    """Least ms for one N1 call on these inputs: the bytes it must move
    (each of the ``limit`` swept rows' box, valid flag and class id read
    once, the whole (B, N) mask written once) over the memory rate, and
    the IoU tests this data needs (each kept row against every later
    valid row, ~14 flops each) over the fp32 rate. Also returns the
    sweep's dependent steps: the kept rows of the longest image, one step
    each."""
    B, N = vs.shape
    nbytes = B * limit * (16 + 1 + (4 if has_ids else 0)) + B * N
    v = vs[:, :limit].sum(1, keepdim=True)  # valid rows are a prefix
    idx = torch.arange(N, device=keep.device)[None, :]
    pairs = int(((v - 1 - idx).clamp(min=0) * keep).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 14 * pairs / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            int(keep.sum(1).max()), pairs)


def n1_mask_bound(vs, ids, limit):
    """Least ms for the mask kernel's function on these inputs: its bytes
    (the ``limit`` rows' boxes and ids read once, the triangles written
    once) over the memory rate, against the IoU tests this data needs
    over the fp32 rate: ~14 flops for each pair of valid rows of one
    class (of any class without ``ids``); a pair of two classes is an id
    compare, an invalid row's pairs need no test (its bits are never
    read). Also returns the pairs counted."""
    B = vs.shape[0]
    nbytes = B * limit * (16 + (0 if ids is None else 4)) + \
        B * n1k._triangle_words(limit) * 8
    v = vs[:, :limit]
    if ids is None:
        n = v.sum(1)
    else:  # the valid rows of each (image, class)
        img = torch.arange(B, device=vs.device)[:, None].expand(-1, limit)
        key = torch.stack([img[v].to(ids.dtype), ids[:, :limit][v]], 1)
        n = torch.unique(key, dim=0, return_counts=True)[1]
    pairs = int((n * (n - 1) // 2).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 14 * pairs / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", pairs)


def n1_reduce_bound(keep, vs, limit):
    """Least ms for the reduce kernel's function on these inputs: the
    bytes it needs over the memory rate (its ORs are a few operations a
    byte): each swept row's diagonal word (its fate) and each kept row's
    words right of it (what it removes) read once, the valid flags read
    once, the keep mask written once. Also returns the words counted."""
    B, N = vs.shape
    W = n1k._words(limit)
    rows = torch.arange(limit, device=keep.device)
    right = (W - 1 - rows // 64)[None, :]  # row i's words past its diagonal
    words = B * limit + int((keep[:, :limit].long() * right).sum())
    nbytes = words * 8 + B * limit + B * N
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", words


def _n1_row(what, boxes, vs, ids, limit, flush, plain=True, route=None,
            want=None):
    """N1 on these rows on ``route`` (the route rule's by default): its
    keep mask held to the plain loop's (``want``, or the plain loop run
    here), bit for bit, then its ms, launches by kernel, workspace and
    shared memory, the plain loop's ms (``plain``; a Python loop of a
    quarter second at SSD300's shape, so the median of 5 calls) and the
    sweep's bound; on the mask_reduce route also each kernel's ms."""
    B, N = vs.shape
    plan = n1k._card_plan(boxes.device, B, limit, route)
    route = plan["route"]
    if want is None:
        want = n1k._nms_keep_ref(boxes, vs, ids, N1_THRESH, limit)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    keep = n1k._nms_keep_cuda(boxes, vs, ids, N1_THRESH, limit, route=route)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if not torch.equal(keep, want):
        raise RuntimeError(f"N1 ({route}) disagrees with the plain loop on "
                           f"{what}: {int((keep != want).sum())} of "
                           f"{keep.numel()} flags")
    row = {"case": what, "route": route, "B": B, "N": N, "limit": limit,
           "class_aware": ids is not None, "kept": int(keep.sum()),
           "equal_to_plain": True, "launches": launches,
           "workspace_bytes": plan["workspace_bytes"],
           "smem_bytes": plan["smem"],
           "ms": time_ms(lambda: n1k._nms_keep_cuda(
               boxes, vs, ids, N1_THRESH, limit, route=route), flush),
           "plain_ms": time_ms(lambda: n1k._nms_keep_ref(
               boxes, vs, ids, N1_THRESH, limit), flush,
               reps=5) if plain else None,
           "library_ms": None}
    if route == "mask_reduce":
        mask = n1k._nms_mask_cuda(boxes, ids, N1_THRESH, limit)
        row["mask_ms"] = time_ms(lambda: n1k._nms_mask_cuda(
            boxes, ids, N1_THRESH, limit), flush)
        row["reduce_ms"] = time_ms(lambda: n1k._nms_reduce_cuda(
            mask, vs, limit, plan), flush)
        del mask
    row["bound_ms"], row["bound_by"], row["dependent_steps"], \
        row["iou_tests"] = n1_bound(keep, vs, limit, ids is not None)
    print("  N1 " + json.dumps(row))
    return row


def _n1_kernel_rows(boxes, vs, ids, limit, flush, keep):
    """The mask and the reduce kernel alone on these rows (``keep``: the
    sweep's keep mask), each beside its plain version and its own bound
    (the entries of the kernels line)."""
    B, N = vs.shape
    plan = n1k._card_plan(boxes.device, B, limit, "mask_reduce")
    mask = n1k._nms_mask_cuda(boxes, ids, N1_THRESH, limit)
    mask_row = {"ms": time_ms(lambda: n1k._nms_mask_cuda(
        boxes, ids, N1_THRESH, limit), flush),
        "plain_ms": time_ms(lambda: n1k._nms_mask_ref(
            boxes, ids, N1_THRESH, limit), flush, reps=5),
        "library_ms": None, "B": B, "limit": limit,
        "workspace_bytes": plan["workspace_bytes"]}
    mask_row["bound_ms"], mask_row["bound_by"], mask_row["iou_pairs"] = \
        n1_mask_bound(vs, ids, limit)
    reduce_row = {"ms": time_ms(lambda: n1k._nms_reduce_cuda(
        mask, vs, limit, plan), flush),
        "plain_ms": time_ms(lambda: n1k._nms_reduce_ref(mask, vs, limit),
                            flush, reps=1),
        "library_ms": None, "B": B, "limit": limit,
        "rows_per_stage": plan["rows_per_stage"], "stages": plan["stages"],
        "smem_bytes": plan["smem"]}
    reduce_row["bound_ms"], reduce_row["bound_by"], \
        reduce_row["words_needed"] = n1_reduce_bound(keep, vs, limit)
    print("  N1 mask kernel " + json.dumps(mask_row))
    print("  N1 reduce kernel " + json.dumps(reduce_row))
    return mask_row, reduce_row


def _n1_routes(dev, B, limit):
    """The N1 routes that take ``limit`` rows of ``B`` images on this
    card: the route rule's first, then the other where it fits."""
    rule = n1k._card_plan(dev, B, limit)["route"]
    routes = [rule]
    other = "mask_reduce" if rule == "fused" else "fused"
    try:
        n1k._card_plan(dev, B, limit, other)
        routes.append(other)
    except mx.MXNetError:
        pass
    return routes


def detection_ops_phase():
    phase("44 the detection ops on the card against the CPU port, and N1")
    from mxnet_tpu_torch.ndarray.ops_contrib import (
        _detection_rows, _nms_sorted)

    rs = onp.random.RandomState(SEED)
    worst = {}
    for name, fn, exact, id_col, rel in _detection_op_cases(rs):
        card = _host_list(fn(mx.gpu(0)))
        cpu = _host_list(fn(mx.cpu()))
        worst[name] = _det_dev(name, card, cpu, exact, id_col, rel)
        print(f"  {name}: {worst[name]:.3g} of max(1, largest) off the "
              "CPU port (integer outputs and -1 rows equal)")
    # N1 against its plain version on the card, on detection rows at
    # SSD300's (32, 8732) from random class scores and offsets
    dev = torch.device("cuda")
    cls = torch.randn(SSD_B, ps.CLASSES + 1, ps.ANCHORS, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED))
    loc = 0.3 * torch.randn(SSD_B, ps.ANCHORS * 4, device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                SEED + 1))
    rows = _detection_rows(torch.softmax(cls, 1), loc,
                           ps.anchors(mx, mx.gpu(0))._data, True, 0.01, 0,
                           ps.DETECT["variances"])
    n_checked, n_words, wants = 0, 0, {}
    for topk in (400, -1):
        for force in (False, True):
            _, vs, boxes, ids, limit = _nms_sorted(
                rows, 0.0, topk, 2, 1, 0, -1, force, "corner")
            want = wants[topk, force] = n1k._nms_keep_ref(
                boxes, vs, ids, N1_THRESH, limit)
            for route in _n1_routes(boxes.device, SSD_B, limit):
                got = n1k._nms_keep_cuda(boxes, vs, ids, N1_THRESH, limit,
                                         route=route)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(
                        f"N1 ({route}) disagrees with its plain version at "
                        f"topk {topk}, force_suppress {force}: "
                        f"{int((got != want).sum())} of {got.numel()} flags")
                n_checked += got.numel()
            words = n1k._nms_mask_cuda(boxes, ids, N1_THRESH, limit)
            if not torch.equal(words, n1k._nms_mask_ref(boxes, ids,
                                                        N1_THRESH, limit)):
                raise RuntimeError(f"N1's mask kernel disagrees with its "
                                   f"plain version at topk {topk}, "
                                   f"force_suppress {force}")
            n_words += words.numel()
            del words
    print(f"  N1 keep masks of both routes equal to the plain loop's at "
          f"(32, 8732), topk 400 and -1, class-aware and force_suppress "
          f"({n_checked} flags); the mask kernel's words equal the plain "
          f"mask's ({n_words} words)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    _, vs, boxes, ids, limit = _nms_sorted(rows, 0.0, 400, 2, 1, 0, -1,
                                           False, "corner")
    routes = _n1_routes(boxes.device, SSD_B, limit)
    row = _n1_row("random rows, nms_topk 400, class-aware", boxes, vs, ids,
                  limit, flush, want=wants[400, False])
    row_alt = _n1_row("random rows, nms_topk 400, class-aware", boxes, vs,
                      ids, limit, flush, plain=False, route=routes[-1],
                      want=wants[400, False])
    _, vs, boxes, ids, limit = _nms_sorted(rows, 0.0, -1, 2, 1, 0, -1,
                                           False, "corner")
    full = _n1_row("random rows, nms_topk -1, class-aware", boxes, vs, ids,
                   limit, flush, plain=False, want=wants[-1, False])
    del flush
    return {"ops": worst, "n1": row, "n1_other_route": row_alt,
            "n1_all_rows": full}


def ssd_toy_phase():
    phase("45 the SSD toy twin of examples/train_ssd_toy.py")
    from mxnet_tpu_torch.examples import train_ssd_toy

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    res = train_ssd_toy.main([])
    torch.cuda.synchronize()
    # its detection (4 images x 192 anchors) is a sweep short enough for
    # N1's fused route: one launch
    res["n1_launches"] = {k: v for k, v in _build.launch_counts().items()
                          if k.startswith("box_nms")}
    if res["n1_launches"] != {n1k.FUSED: 1}:
        raise RuntimeError(f"the SSD toy's detection launched N1's kernels "
                           f"{res['n1_launches']}; want {{'{n1k.FUSED}': 1}}")
    if not res["final_loss"] < 2.0:
        raise RuntimeError(f"SSD toy twin: {res}")
    print(f"  loss {res['first_loss']:.4f} -> {res['final_loss']:.4f} in "
          f"{time.perf_counter() - t0:.1f} s; N1 launched "
          f"{res['n1_launches']}; image 0's ground truth "
          f"{onp.round(res['gt'], 3).tolist()}, its detections above 0.1 "
          f"{onp.round(res['detections'], 3).tolist()}")
    return res


def _ssd_record(net, anchor, x, y):
    """One recorded forward, targets, loss and backward: (class outputs,
    location outputs, loss, {name: gradient}) on the device."""
    with autograd.record():
        cls_preds, loc_preds = net(x)
        tgt = ps.targets(mx, anchor, y, cls_preds)
        loss = ps.ssd_loss(mx, cls_preds, loc_preds, *tgt)
    loss.backward()
    return (cls_preds.data.detach().clone(), loc_preds.data.detach().clone(),
            loss.data.detach().clone(),
            {k: p.grad().data.detach().clone()
             for k, p in net._collect_params_with_prefix().items()})


def _ssd_vs_cpu(net):
    """The class and location outputs and the loss at batch 2 on the card
    against the CPU port with the same weights."""
    xs, ys = ps.synthetic_batch(SSD_CPU_B, seed=SEED + 2)
    cpu = convert.params_from_numpy(
        ps.build_ssd300(mx), {k: p.data().asnumpy() for k, p in
                              net._collect_params_with_prefix().items()},
        ctx=mx.cpu())
    runs = []
    for n, ctx in ((net, mx.gpu(0)), (cpu, mx.cpu())):
        x, y = nd.array(xs, ctx=ctx), nd.array(ys, ctx=ctx)
        with autograd.pause():
            cls_preds, loc_preds = n(x)
            tgt = ps.targets(mx, ps.anchors(mx, ctx), y, cls_preds)
            loss = ps.ssd_loss(mx, cls_preds, loc_preds, *tgt)
        runs.append((cls_preds.asnumpy(), loc_preds.asnumpy(),
                     float(loss.asscalar())))
    (c_c, l_c, loss_c), (c_h, l_h, loss_h) = runs
    dev = {"class": float(onp.abs(c_c - c_h).max() / onp.abs(c_h).max()),
           "location": float(onp.abs(l_c - l_h).max() / onp.abs(l_h).max()),
           "loss": abs(loss_c - loss_h) / abs(loss_h),
           "loss_card": loss_c, "loss_cpu": loss_h}
    if dev["class"] > SSD_CPU_TOL or dev["location"] > SSD_CPU_TOL or \
            dev["loss"] > SSD_LOSS_RTOL:
        raise RuntimeError(f"SSD300 on the card against the CPU port: {dev}")
    del cpu
    return dev


def ssd_training_phase():
    phase("46 SSD300-VGG16 training")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    _fresh_peak()
    net = ps.build(mx, ctx, seed=SEED)
    count = ps.trainable_count(net)
    if count != SSD_PARAMS:
        raise RuntimeError(f"SSD300 has {count:,} trainable parameters, the "
                           f"JAX package's network {SSD_PARAMS:,}")
    cpu = _ssd_vs_cpu(net)
    # eager against hybridized, cuDNN deterministic: bitwise
    xs, ys = ps.synthetic_batch(SSD_BITWISE_B, seed=SEED + 1)
    x8, y8 = nd.array(xs, ctx=ctx), nd.array(ys, ctx=ctx)
    anchor = ps.anchors(mx, ctx)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        eager = _ssd_record(net, anchor, x8, y8)
        net.hybridize()
        hyb = _ssd_record(net, anchor, x8, y8)
    bad = [i for i in range(3) if not torch.equal(eager[i], hyb[i])]
    bad += [k for k in eager[3] if not torch.equal(eager[3][k], hyb[3][k])]
    if bad:
        raise RuntimeError(
            f"SSD300 hybridized differs from eager in {bad[:8]}")
    n_bitwise = 3 + len(eager[3])
    del eager, hyb, x8, y8
    # the training path: 2 + 20 hybridized SGD steps at batch 32
    _build.reset_launch_counts()
    result, state = ps.train(SSD_B, SSD_STEPS, seed=SEED, net=net)
    counts = _build.launch_counts()
    losses = result["losses"]
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"SSD300 training losses {losses}")
    result.update({"cpu_deviation": cpu, "bitwise_tensors": n_bitwise,
                   "cached_op": gluon.cached_op_stats(),
                   "launches": counts})
    prof = result["profile"]
    print("  ssd300 " + json.dumps(result))
    print(f"  SSD300-VGG16 ({count:,} parameters, {result['anchors']} "
          f"anchors), batch {SSD_B}, hybridized: "
          f"{result['mean_step_ms']:.2f} ms/step (median "
          f"{result['median_step_ms']:.2f}), {result['img_per_s']:.1f} "
          f"img/s, peak {result['peak_gb']:.2f} GB, device idle "
          f"{100 * prof['device_idle_share']:.1f}% (profiled "
          f"{prof['wall_ms_per_step']:.2f} ms, busy "
          f"{prof['device_busy_ms_per_step']:.2f} ms); MultiBoxTarget "
          f"{result['multibox_target_ms']:.3f} ms and the loss "
          f"{result['loss_ms']:.3f} ms of a step; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; eager = hybridized bitwise ({n_bitwise} "
          f"tensors); CPU: class {cpu['class']:.3g}, location "
          f"{cpu['location']:.3g}, loss {cpu['loss']:.3g}")
    return result, state


def ssd_detection_phase(net, anchor, x):
    phase("47 SSD300 detection")
    from mxnet_tpu_torch.ndarray.ops_contrib import (
        _detection_rows, _nms_sorted)

    def n1_launches(counts):
        return {k: v for k, v in counts.items() if k.startswith("box_nms")}

    # each detection batch, capped (nms_topk 400) and uncapped (-1, the
    # op's default), with the launch counts reset just before it: the
    # route rule's kernels, each as often as its plan says (once at this
    # batch)
    with autograd.predict_mode():
        cls_preds, loc_preds = net(x)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        dets = ps.detect(mx, cls_preds, loc_preds, anchor)
        torch.cuda.synchronize()
        counts = n1_launches(_build.launch_counts())
        _build.reset_launch_counts()
        dets_all = ps.detect(mx, cls_preds, loc_preds, anchor, nms_topk=-1)
        torch.cuda.synchronize()
        counts_all = n1_launches(_build.launch_counts())
    dev = cls_preds._data.device
    topk = ps.DETECT["nms_topk"]
    plans = {"capped": n1k._card_plan(dev, SSD_B, topk),
             "uncapped": n1k._card_plan(dev, SSD_B, int(ps.ANCHORS))}
    routes = {what: plan["route"] for what, plan in plans.items()}
    for what, got_counts in (("capped", counts), ("uncapped", counts_all)):
        want_counts = dict.fromkeys(n1k.ROUTE_KERNELS[routes[what]],
                                    plans[what]["launches"])
        if got_counts != want_counts:
            raise RuntimeError(f"the {what} detection of one batch launched "
                               f"N1's kernels {got_counts}; want "
                               f"{want_counts}")
    # the greedy order's prefix: rows before the cap fare the same with
    # and without it, and the capped rows past it are -1
    if not torch.equal(dets_all._data[:, :topk], dets._data[:, :topk]) or \
            not bool((dets._data[:, topk:] == -1).all()):
        raise RuntimeError("the uncapped detection's first 400 rows differ "
                           "from the capped detection's")
    # the CPU port's detection from the card's class probabilities: the
    # two devices' softmax differ by float32 ulps, which reorder scores
    # tied to an ulp (a trained body gives such pairs now and then); the
    # softmax is held to its own bound
    with autograd.predict_mode():
        probs = nd.softmax(cls_preds, axis=-1)
    want_probs = nd.softmax(nd.array(cls_preds.asnumpy(), ctx=mx.cpu()),
                            axis=-1).asnumpy()
    softmax_err = float(onp.abs(probs.asnumpy() - want_probs).max())
    if softmax_err > DET_TOL:
        raise RuntimeError(f"SSD300 class probabilities {softmax_err:.3g} "
                           f"off the CPU port (bound {DET_TOL})")
    cpu = nd.contrib.MultiBoxDetection(
        *(nd.array(a.asnumpy(), ctx=mx.cpu())
          for a in (probs.transpose((0, 2, 1)), loc_preds, anchor)),
        **ps.DETECT)
    got, want = dets.asnumpy(), cpu.asnumpy()
    err = _det_dev("SSD300 detection", [got], [want], id_col=0)
    times = ps.detection_times(net, anchor, x)
    times_all = ps.detection_times(net, anchor, x, nms_topk=-1)
    # N1 on this detection's own rows, as the main path gave them, on
    # both routes at nms_topk 400 and on the mask_reduce route uncapped
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = _detection_rows(torch.softmax(cls_preds._data, -1).transpose(1, 2),
                           loc_preds._data, anchor._data, True,
                           ps.DETECT["threshold"], 0, ps.DETECT["variances"])
    _, vs, boxes, ids, limit = _nms_sorted(
        rows, 0.0, topk, 2, 1, 0, -1, False, "corner")
    want = n1k._nms_keep_ref(boxes, vs, ids, N1_THRESH, limit)
    row = _n1_row("SSD300 detection rows, nms_topk 400, class-aware", boxes,
                  vs, ids, limit, flush, want=want)
    row_alt = _n1_row("SSD300 detection rows, nms_topk 400, class-aware",
                      boxes, vs, ids, limit, flush, plain=False,
                      route=_n1_routes(dev, SSD_B, limit)[-1], want=want)
    ds, vs, boxes, ids, limit = _nms_sorted(
        rows, 0.0, -1, 2, 1, 0, -1, False, "corner")
    # the fused route at the shape the toy twin's detection gives it
    # (phase 45: 4 images x 192 anchors), on the 192 best rows of four
    # images of this batch
    _, vs4, boxes4, ids4, limit4 = _nms_sorted(
        ds[:4, :192].contiguous(), 0.0, -1, 2, 1, 0, -1, False, "corner")
    row_toy = _n1_row("SSD300 detection rows, the 192 best of 4 images "
                      "(the toy's shape), class-aware", boxes4, vs4, ids4,
                      limit4, flush)
    want = n1k._nms_keep_ref(boxes, vs, ids, N1_THRESH, limit)
    row_all = _n1_row("SSD300 detection rows, nms_topk -1, class-aware",
                      boxes, vs, ids, limit, flush, plain=False, want=want)
    mask_row, reduce_row = _n1_kernel_rows(boxes, vs, ids, limit, flush,
                                           want)
    del flush
    kept = (got[..., 0] >= 0).sum(1)
    kept_all = (dets_all.asnumpy()[..., 0] >= 0).sum(1)
    print(f"  batch {got.shape[0]}: N1 launched {counts} capped, "
          f"{counts_all} uncapped; rows equal to the CPU port's on the "
          f"card's probabilities (values within {err:.3g}; the softmax "
          f"within {softmax_err:.3g}); {kept.mean():.1f} detections an "
          f"image ({kept_all.mean():.1f} uncapped); head "
          f"{times['detection_head_ms']:.2f} ms, with the forward "
          f"{times['detection_with_forward_ms']:.2f} ms; uncapped "
          f"{times_all['detection_head_ms']:.2f} and "
          f"{times_all['detection_with_forward_ms']:.2f} ms; image 0's "
          f"first: {onp.round(got[0, 0], 3).tolist()}")
    return {"n1_launches": counts, "n1_launches_uncapped": counts_all,
            "routes": routes, "max_abs_err": err, "n1": row,
            "n1_other_route": row_alt, "n1_toy_shape": row_toy,
            "n1_all_rows": row_all, "mask_kernel": mask_row,
            "reduce_kernel": reduce_row, "uncapped": times_all, **times}


# -- slice 8: int8 quantization ------------------------------------------------

INT8_TOPS = 1979e12  # H100 SXM dense int8 on the tensor cores
QUANT_CALIB_BATCHES, QUANT_CALIB_B = 10, 32  # naive calibration
# entropy calibration samples 8192 elements of every internal tensor per
# batch with numpy's RandomState.choice (a full permutation of the tensor's
# size, ~70 ns per element on the host): two batches of four images
QUANT_ENTROPY_BATCHES, QUANT_ENTROPY_B = 2, 4
QUANT_ITERS = 20
QUANT_TOL = 1e-5  # card against the CPU port: floats, logits
KV_INT8_BOUND = 0.1  # the JAX package's int8 KV-page accuracy bound


def _quant_run(case, ctx):
    from mxnet_tpu_torch.ndarray import registry as treg

    _, op, args, kw = case
    dev = torch.device("cuda" if ctx.device_type == "gpu" else "cpu")
    out = treg.get_op(op).fn(*[torch.from_numpy(onp.ascontiguousarray(a))
                               .to(dev) for a in args], **kw)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return [o.cpu().numpy() for o in outs]


def _quant_ops_check():
    """Every ops_quant case under both lowerings, card against CPU port:
    integers equal, floats within QUANT_TOL of max(1, largest)."""
    cases = pq.op_cases(onp.random.RandomState(SEED))
    worst = 0.0
    for lw in ("native", "dequant"):
        os.environ["MXNET_QUANTIZE_LOWERING"] = lw
        for case in cases:
            card, cpu = _quant_run(case, mx.gpu(0)), _quant_run(case, mx.cpu())
            for i, (a, b) in enumerate(zip(card, cpu)):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise RuntimeError(f"{case[0]} ({lw}) output {i}: "
                                       f"{a.dtype}{a.shape} on the card, "
                                       f"{b.dtype}{b.shape} on the CPU")
                if a.dtype.kind in "iub":
                    if not onp.array_equal(a, b):
                        raise RuntimeError(
                            f"{case[0]} ({lw}) output {i}: "
                            f"{int((a != b).sum())} codes differ")
                    continue
                err = float(onp.abs(a.astype("f8") - b).max()) / max(
                    1.0, float(onp.abs(b).max()))
                worst = max(worst, err)
                if err > QUANT_TOL:
                    raise RuntimeError(f"{case[0]} ({lw}) output {i} off "
                                       f"the CPU port by {err}")
    os.environ.pop("MXNET_QUANTIZE_LOWERING", None)
    print(f"  {len(cases)} ops_quant cases x 2 lowerings: integers equal to "
          f"the CPU port's, floats within {worst:.3g}")
    return worst


def _s8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.int8)


def _n2_shape_row(gen, flush, x_s, w_s, st, p):
    """N2 at one resnet50_v1 shape: the route the rule gives it, both
    routes' times in turns (mma, sm90, sm90, mma; the sm90 kernel takes
    the stem with its channels padded to 16 when forced), its plain
    version's, the bound, the sm90 route's layout copies (``_to_nhwc``
    of x and w, one launch) beside torch's channels-last and OHWI copies,
    and two library routes that compute the same function: cuDNN's
    float32 convolution of the codes (exact while the sums stay below
    2^24) and torch._int_mm on an explicit im2col (K padded to 8)."""
    from mxnet_tpu_torch.kernels import int8_conv as k8

    x, w = _s8(gen, x_s), _s8(gen, w_s)
    d = (1, 1)
    y_s = k8.conv_output_shape(x_s, w_s, st, p, d)
    M, N, K = y_s[0] * y_s[2] * y_s[3], w_s[0], w_s[1] * w_s[2] * w_s[3]
    ops, nbytes = 2 * M * N * K, x.numel() + w.numel() + 4 * M * N
    t_ops, t_bytes = ops / INT8_TOPS, nbytes / HBM_BYTES_PER_S
    xf, wf = x.float(), w.float()

    def cudnn():
        with ops_nn.cudnn_fp32():
            return torch.nn.functional.conv2d(xf, wf, None, st, p)

    cols = torch.nn.functional.unfold(xf, w_s[2:], padding=p, stride=st)
    cols = cols.transpose(1, 2).reshape(M, K)
    Kp = -(-K // 8) * 8
    a = torch.nn.functional.pad(cols, (0, Kp - K)).to(torch.int8)
    b = torch.nn.functional.pad(wf.reshape(N, K), (0, Kp - K)).to(
        torch.int8).t()
    route = k8._int8_conv_route(x, w, 1, st)
    runs = {"mma": lambda: k8.int8_conv(x, w, st, p, d, 1, route="mma"),
            "sm90": lambda: k8._int8_conv_sm90(x, w, st, p, d)}
    turns = {"mma": [], "sm90": []}
    for r in ("mma", "sm90", "sm90", "mma"):
        turns[r].append(time_ms(runs[r], flush))
    Cp = k8._sm90_channels(x_s[1])
    copies = [(x, Cp)] + ([(w, Cp)] if w_s[2] * w_s[3] > 1 or Cp != x_s[1]
                          else [])
    # each copy reads its tensor once and writes it with Cp channels
    copy_bytes = sum(t.numel() + t.numel() // t.shape[1] * Cp
                     for t, _ in copies)
    plan = k8._sm90_plan(x_s, w_s, st, p, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    row = {"x": list(x_s), "w": list(w_s), "stride": list(st),
           "pad": list(p), "M": M, "N": N, "K": K, "route": route,
           "mma_ms": turns["mma"], "sm90_ms": turns["sm90"],
           "sm90_plan": {k: plan[k] for k in ("flat", "tile", "bn",
                                              "splits", "grid")},
           # the float64 plain version is too slow for 25 at every shape
           "plain_ms": time_ms(lambda: k8._int8_conv_ref(x, w, st, p, d, 1),
                               flush, reps=3),
           "library_ms": time_ms(cudnn, flush),
           "library_int_mm_ms": time_ms(lambda: torch._int_mm(a, b), flush),
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "ops_ms": t_ops * 1e3, "bytes_ms": t_bytes * 1e3,
           "nhwc_ms": time_ms(lambda: k8._to_nhwc(*copies), flush),
           "nhwc_plain_ms": time_ms(
               lambda: [k8._to_nhwc_ref(t, c) for t, c in copies], flush),
           "nhwc_library_ms": time_ms(lambda: (
               x.contiguous(memory_format=torch.channels_last),
               w.permute(0, 2, 3, 1).contiguous()), flush),
           "nhwc_bound_ms": copy_bytes / HBM_BYTES_PER_S * 1e3}
    row["ms"] = statistics.mean(turns[route])
    row["tops"] = ops / row["ms"] / 1e9
    return row


# the sm90 kernel's edges, held bitwise against the plain version beside
# the resnet50_v1 shapes: M not a multiple of 128 and O not one of the tile
# width, C = 16 and 48, a stride-2 1 x 1, a padded 3 x 3 at 7 x 7, a
# dilated and an anisotropic case, a wide image (two spatial tiles a row)
N2_SM90_EDGES = [((3, 16, 9, 7), (48, 16, 3, 3), (1, 1), (1, 1), (1, 1)),
                 ((2, 48, 7, 7), (80, 48, 3, 3), (1, 1), (1, 1), (1, 1)),
                 ((3, 48, 5, 6), (144, 48, 1, 1), (1, 1), (0, 0), (1, 1)),
                 ((2, 64, 9, 9), (128, 64, 1, 1), (2, 2), (0, 0), (1, 1)),
                 ((5, 512, 7, 7), (272, 512, 3, 3), (1, 1), (1, 1), (1, 1)),
                 ((1, 32, 12, 12), (16, 32, 3, 3), (1, 1), (2, 2), (2, 2)),
                 ((2, 16, 11, 13), (32, 16, 3, 3), (2, 1), (1, 2), (1, 1)),
                 ((2, 32, 40, 70), (64, 32, 3, 3), (1, 1), (1, 1), (1, 1))]


def _n2_sm90_checks(gen):
    """The sm90 kernel's edge shapes bitwise against the plain version,
    at the plan's tiles and at each tile width; a K split at batch 1
    (the 3 x 3, 512 at 7 x 7, where the plan splits K) rerun bitwise; the
    layout copies against their plain version."""
    from mxnet_tpu_torch.kernels import int8_conv as k8

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    checked = 0
    for x_s, w_s, st, p, d in N2_SM90_EDGES:
        x, w = _s8(gen, x_s), _s8(gen, w_s)
        want = k8._int8_conv_ref(x, w, st, p, d, 1)
        plans = [None] + [k8._sm90_plan(x_s, w_s, st, p, d, n_sm, bn=bn,
                                        splits=1) for bn in (64, 128, 256)]
        for plan in plans:
            got = k8._int8_conv_sm90(x, w, st, p, d, plan)
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"sm90 N2 differs from its plain version at x {x_s} w "
                    f"{w_s} stride {st} pad {p} dilate {d}, plan "
                    f"{plan and (plan['bn'], plan['splits'])}: "
                    f"{int((got != want).sum())} of {got.numel()}")
            checked += 1
    x_s, w_s = (1, 512, 7, 7), (512, 512, 3, 3)
    plan = k8._sm90_plan(x_s, w_s, (1, 1), (1, 1), (1, 1), n_sm)
    if plan["splits"] < 2:
        raise RuntimeError(f"the batch-1 3 x 3 plan splits no K: {plan}")
    x, w = _s8(gen, x_s), _s8(gen, w_s)
    want = k8._int8_conv_ref(x, w, (1, 1), (1, 1), (1, 1), 1)
    runs = [k8.int8_conv(x, w, (1, 1), (1, 1), (1, 1), 1) for _ in range(2)]
    if not all(torch.equal(r, want) for r in runs):
        raise RuntimeError("the split-K sm90 N2 differs from its plain "
                           "version or from its rerun")
    for shape, Cp in (((32, 3, 224, 224), 16), ((32, 256, 56, 56), 256),
                      ((32, 2048, 7, 7), 2048), ((512, 512, 3, 3), 512),
                      ((5, 130, 14, 14), 144)):
        t = _s8(gen, shape)
        if not torch.equal(k8._to_nhwc((t, Cp))[0], k8._to_nhwc_ref(t, Cp)):
            raise RuntimeError(f"int8_to_nhwc differs from its plain "
                               f"version at {shape} -> {Cp}")
    print(f"  sm90 N2 bitwise equal to its plain version at "
          f"{len(N2_SM90_EDGES)} edge shapes x {checked // len(N2_SM90_EDGES)}"
          f" plans; K split {plan['splits']} ways at batch 1 (3 x 3, 512 at "
          "7 x 7) rerun bitwise; int8_to_nhwc equal to its plain version")
    return {"edge_plans_checked": checked, "split_k": plan["splits"]}


def quant_kernels_phase():
    phase("48 the quantization ops on the card against the CPU port, N2 "
          "and _int_mm")
    from mxnet_tpu_torch.kernels import int8_conv as k8

    ops_worst = _quant_ops_check()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 48)
    cases = [(x, w, st, p, (1, 1), 1) for b in (QUANT_CALIB_B, 1)
             for x, w, st, p in pq.resnet50_convolutions(b)]
    cases += [((2, 8, 13, 11), (12, 4, 3, 3), (2, 1), (1, 2), (1, 1), 2),
              ((3, 6, 17, 17), (8, 6, 3, 3), (1, 1), (2, 2), (2, 2), 1),
              ((2, 5, 9, 9), (7, 5, 5, 3), (3, 2), (2, 1), (1, 2), 1),
              ((1, 3, 31, 31), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
              ((4, 64, 7, 7), (64, 1, 3, 3), (1, 1), (1, 1), (1, 1), 64)]
    checked = set()
    n_routes = 0
    for x_s, w_s, st, p, d, g in cases:
        if (x_s, w_s, st, p, d, g) in checked:
            continue
        checked.add((x_s, w_s, st, p, d, g))
        x, w = _s8(gen, x_s), _s8(gen, w_s)
        want = k8._int8_conv_ref(x, w, st, p, d, g)
        routes = ["mma"] + (["sm90"] if k8._int8_conv_route(x, w, g, st)
                            == "sm90" else [])
        for route in routes:
            got = k8.int8_conv(x, w, st, p, d, g, route=route)
            n_routes += 1
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"N2 ({route}) differs from its plain version at x "
                    f"{x_s} w {w_s} stride {st} pad {p} dilate {d} groups "
                    f"{g}: {int((got != want).sum())} of {got.numel()} "
                    "accumulators")
    print(f"  N2 bitwise equal to its plain version (float64) at "
          f"{len(checked)} shapes, {n_routes} shape-routes: every "
          f"resnet50_v1 convolution at batch {QUANT_CALIB_B} and 1 on both "
          "routes where the rule gives sm90, grouped, dilated, odd-stride "
          "and stem cases")
    sm90_checks = _n2_sm90_checks(gen)
    # _int_mm through the wrapper's padding: batch 1 and 32 at the
    # classifier's shape, an odd K and an odd N
    for M, K, N in ((1, 2048, 1000), (QUANT_CALIB_B, 2048, 1000),
                    (5, 147, 63)):
        a, b = _s8(gen, (M, K)), _s8(gen, (N, K)).t()
        if not torch.equal(k8.int8_mm(a, b), k8._int8_mm_ref(a, b)):
            raise RuntimeError(f"int8_mm differs from its plain version at "
                               f"({M}, {K}) x ({K}, {N})")
    print("  int8_mm (torch._int_mm, operands padded to M > 16 and K, N "
          "multiples of 8) equal to its plain version at M = 1, 32 and an "
          "odd K and N")
    # dequant (cuDNN float32, no TF32) against native: bitwise while the
    # sums stay below 2^24; at resnet50_v1's K = 4608 the largest gap
    x, w = _s8(gen, (4, 64, 14, 14)), _s8(gen, (64, 64, 3, 3))
    with ops_nn.cudnn_fp32():
        deq = torch.round(torch.nn.functional.conv2d(
            x.float(), w.float(), None, 1, 1)).to(torch.int32)
    if not torch.equal(deq, k8.int8_conv(x, w, (1, 1), (1, 1), (1, 1), 1)):
        raise RuntimeError("dequant differs from native at K = 576 (sums "
                           "below 2^24): TF32 in the float32 convolution?")
    x, w = _s8(gen, (QUANT_CALIB_B, 512, 7, 7)), _s8(gen, (512, 512, 3, 3))
    with ops_nn.cudnn_fp32():
        deq = torch.round(torch.nn.functional.conv2d(
            x.float(), w.float(), None, 1, 1)).to(torch.int32)
    nat = k8.int8_conv(x, w, (1, 1), (1, 1), (1, 1), 1)
    full_gap = int((deq - nat).abs().max())
    print(f"  dequant = native bitwise at K = 576; at K = 4608 (3 x 3, 512) "
          f"the largest accumulator gap is {full_gap} (|acc| up to "
          f"{int(nat.abs().max())}; float32 holds every integer below "
          "2^24)")
    # the batched product: _int_mm per batch entry against N2 as a grouped
    # 1 x 1 convolution (one launch), at an attention-like shape
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    a, b = _s8(gen, (96, 128, 64)), _s8(gen, (96, 64, 128))
    bt = b.transpose(1, 2).contiguous()
    bdot = {"shape": [96, 128, 64, 128],
            "n2_grouped_ms": time_ms(lambda: k8.int8_batch_mm(a, b), flush),
            "int_mm_per_batch_ms": time_ms(
                lambda: [torch._int_mm(a[i], bt[i].t()) for i in range(96)],
                flush)}
    print("  batch_dot routes " + json.dumps(bdot))
    # N2's times at every distinct resnet50_v1 shape at batch 32
    shapes = pq.resnet50_convolutions(QUANT_CALIB_B)
    rows = {}
    for x_s, w_s, st, p in shapes:
        key = (x_s, w_s, st, p)
        if key not in rows:
            rows[key] = _n2_shape_row(gen, flush, *key)
    del flush
    turn = {r: [sum(rows[tuple(c)][f"{r}_ms"][i] for c in shapes)
                for i in range(2)] for r in ("mma", "sm90")}
    per_forward = {k: sum(rows[tuple(c)][k] for c in shapes)
                   for k in ("ms", "plain_ms", "library_ms",
                             "library_int_mm_ms", "bound_ms", "ops_ms",
                             "bytes_ms")}
    per_forward["bound_by"] = "operations" if \
        per_forward["ops_ms"] >= per_forward["bytes_ms"] else "bytes"
    per_forward["convolutions"] = len(shapes)
    per_forward["routes"] = {r: sum(rows[tuple(c)]["route"] == r
                                    for c in shapes) for r in ("sm90", "mma")}
    # each route's turns over every convolution (the sm90 kernel takes the
    # stem padded to 16 channels here), and the sm90 route's layout copies
    per_forward["mma_ms"] = turn["mma"]
    per_forward["sm90_ms"] = turn["sm90"]
    on_sm90 = [c for c in shapes if rows[tuple(c)]["route"] == "sm90"]
    nhwc = {k: sum(rows[tuple(c)][k] for c in on_sm90)
            for k in ("nhwc_ms", "nhwc_plain_ms", "nhwc_library_ms",
                      "nhwc_bound_ms")}
    nhwc["copies"] = len(on_sm90)
    for r in rows.values():
        print("  N2 " + json.dumps({k: (round(v, 5) if isinstance(v, float)
                                        else v) for k, v in r.items()}))
    for c in shapes:
        print(f"  route {rows[tuple(c)]['route']}: x {list(c[0])} w "
              f"{list(c[1])} stride {list(c[2])}")
    print("  N2 per resnet50_v1 forward at batch 32 (53 convolutions) "
          + json.dumps(per_forward))
    print("  the sm90 route's layout copies per forward " + json.dumps(nhwc))
    return {"ops_worst": ops_worst, "checked_shapes": len(checked),
            "per_forward": per_forward, "nhwc": nhwc, "sm90": sm90_checks,
            "by_shape": [rows[k] for k in rows], "batch_dot": bdot,
            "dequant_gap_k4608": full_gap}


def _cpu_block(qb):
    """The quantized SymbolBlock's graph with its parameters copied to the
    CPU (int8 weights stay int8)."""
    cpu = gluon.SymbolBlock(qb._outputs, [mx.sym.var("data")])
    params = cpu.collect_params()
    for name, p in qb.collect_params().items():
        val = nd.array(p.data().asnumpy(), ctx=mx.cpu(),
                       dtype=p.data().dtype)
        params[name].dtype = val.dtype
        if val.dtype == onp.int8:
            params[name].grad_req = "null"
        params[name]._load_init_from(val, ctx=mx.cpu())
    return cpu


def _int8_session_row(block, b, x, ctx, hybridize):
    """ms per predict, img/s, the last logits and the launches of one
    predict of ``block`` served at batch ``b`` (eager, or hybridized: the
    forward captured as one CUDA graph per signature and replayed)."""
    if hybridize:
        block.hybridize()
    try:
        sess = pq.session(block, b, ctx)
        ms, out = pq.time_predicts(sess, x, QUANT_ITERS)
        counts = pq.launches_per_predict(sess, x)
    finally:
        if hybridize:
            block.hybridize(False)
    return {"ms": ms, "img_per_s": b * 1e3 / ms, "launches": counts}, out


def int8_resnet_phase():
    phase("49 ResNet-50 v1 served in int8")
    from mxnet_tpu_torch.contrib.quantization import quantize_net_graph
    from mxnet_tpu_torch.kernels import int8_conv as k8

    ctx = mx.gpu(0)
    net = pz.build("resnet50_v1", ctx, seed=pq.SEED, classes=pq.CLASSES)
    calib = pq.calib_batches(ctx, QUANT_CALIB_BATCHES, QUANT_CALIB_B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qb = quantize_net_graph(net, calib_data=calib, calib_mode="naive")
    torch.cuda.synchronize()
    naive_s = time.perf_counter() - t0
    convs, fcs = pq.quantized_counts(qb)
    t0 = time.perf_counter()
    qe = quantize_net_graph(net, calib_data=pq.calib_batches(
        ctx, QUANT_ENTROPY_BATCHES, QUANT_ENTROPY_B), calib_mode="entropy")
    entropy_s = time.perf_counter() - t0
    del calib
    weights = {"fp32_bytes": pq.weight_bytes(net),
               "int8_bytes": pq.weight_bytes(qb)}
    weights["reduction_x"] = weights["fp32_bytes"] / weights["int8_bytes"]
    print(f"  quantize_net_graph naive over {QUANT_CALIB_BATCHES} batches of "
          f"{QUANT_CALIB_B}: {naive_s:.1f} s; entropy over "
          f"{QUANT_ENTROPY_BATCHES} batches of {QUANT_ENTROPY_B}: "
          f"{entropy_s:.1f} s; {convs} quantized convolutions, {fcs} "
          f"quantized FC; weights {json.dumps(weights)}")
    rs = onp.random.RandomState(SEED + 49)
    xs = {b: (rs.randn(b, *pq.IMAGE) * 0.5).astype("float32")
          for b in (1, QUANT_CALIB_B)}
    result = {"naive_calibration_s": naive_s,
              "entropy_calibration_s": entropy_s,
              "quantized_convolutions": convs, "quantized_fc": fcs,
              "weights": weights, "batches": {}}
    n2_launches = int_mm_launches = n2_sm90_launches = nhwc_launches = 0
    # every convolution the route rule gives the sm90 kernel launches it
    n_sm90 = sum(k8._int8_conv_route(
        torch.empty(x_s, dtype=torch.int8, device="meta"),
        torch.empty(w_s, dtype=torch.int8, device="meta"), 1) == "sm90"
        for x_s, w_s, _, _ in pq.resnet50_convolutions(QUANT_CALIB_B))
    want = {k8.KERNEL: convs, k8.SM90_KERNEL: n_sm90, "int_mm": fcs}
    for b, x in xs.items():
        row = {}
        for hyb in (False, True):
            mode = "hybridized" if hyb else "eager"
            fp32, ref = _int8_session_row(net, b, x, ctx, hyb)
            os.environ["MXNET_QUANTIZE_LOWERING"] = "native"
            torch.cuda.reset_peak_memory_stats()
            int8, out = _int8_session_row(qb, b, x, ctx, hyb)
            int8["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = int8.pop("launches")
            n2_launches += counts.get(k8.KERNEL, 0)
            n2_sm90_launches += counts.get(k8.SM90_KERNEL, 0)
            nhwc_launches += counts.get(k8.NHWC_KERNEL, 0)
            int_mm_launches += counts.get("int_mm", 0)
            if {k: counts.get(k) for k in want} != want:
                raise RuntimeError(f"batch {b} {mode}: one int8 predict "
                                   f"launched {counts}; want {want}")
            if out.shape != (b, pq.CLASSES) or not onp.isfinite(out).all():
                raise RuntimeError(f"batch {b}: bad int8 logits {out.shape}")
            fp32.pop("launches")
            int8.update(speedup=fp32["ms"] / int8["ms"],
                        accuracy_delta=pq.accuracy_delta(out, ref))
            row[mode] = {"fp32": fp32, "int8": int8}
        row["launches_per_predict"] = counts
        if b == QUANT_CALIB_B:
            os.environ["MXNET_QUANTIZE_LOWERING"] = "dequant"
            dq, dout = _int8_session_row(qb, b, x, ctx, True)
            dcounts = dq.pop("launches")
            if dcounts.get("int8_conv") or dcounts.get("int_mm"):
                raise RuntimeError(f"dequant launched int8 kernels: "
                                   f"{dcounts}")
            os.environ["MXNET_QUANTIZE_LOWERING"] = "native"
            eout = pq.session(qe, b, ctx).predict(x).asnumpy()
            # where an eager int8 predict's device time goes
            prof = pq.breakdown(pq.session(qb, b, ctx), x)
            row["int8_eager_profile"] = {
                k: prof[k] for k in ("wall_ms_per_step",
                                     "device_busy_ms_per_step",
                                     "device_idle_share",
                                     "device_ops_per_step",
                                     "device_ms_per_step_by_kind")}
            dq.update(accuracy_delta=pq.accuracy_delta(dout, ref),
                      vs_native=pq.accuracy_delta(dout, out))
            row["dequant_hybridized"] = dq
            row["entropy_accuracy_delta"] = pq.accuracy_delta(eout, ref)
        result["batches"][b] = row
        print(f"  batch {b}: " + json.dumps(row))
    # the card's int8 logits against the CPU port's on the same two
    # images (the input boundary's range is the batch's own: the JAX
    # pass calibrates only op outputs)
    x2 = xs[QUANT_CALIB_B][:2]
    with autograd.pause():
        card = qb(nd.array(x2, ctx=ctx)).asnumpy()
        cpu = _cpu_block(qb)(nd.array(x2, ctx=mx.cpu())).asnumpy()
    err = float(onp.abs(card - cpu).max()) / max(float(onp.abs(cpu).max()),
                                                 1e-9)
    if err > QUANT_TOL:
        raise RuntimeError(f"int8 logits off the CPU port by {err}")
    result["cpu_deviation"] = err
    print(f"  the card's int8 logits on two images within {err:.3g} of the "
          "CPU port's")
    # hybridized: the captured int8 graph replays bitwise equal to eager
    x = nd.array(xs[QUANT_CALIB_B], ctx=ctx)
    with autograd.pause():
        eager = qb(x).asnumpy()
        qb.hybridize()
        first = qb(x).asnumpy()
        _build.reset_launch_counts()
        again = qb(x).asnumpy()
        replay_counts = _build.launch_counts()
        qb.hybridize(False)
    if not (onp.array_equal(eager, first) and onp.array_equal(eager, again)):
        raise RuntimeError("the hybridized int8 ResNet-50 differs from its "
                           "eager forward")
    if {k: replay_counts.get(k) for k in want} != want or \
            not replay_counts.get(k8.NHWC_KERNEL):
        raise RuntimeError(f"a replay counted {replay_counts}; want {want} "
                           f"and the sm90 route's layout copies")
    print(f"  hybridized int8 SymbolBlock: captured and replayed bitwise "
          f"equal to eager; a replay counts {replay_counts}: N2 on the sm90 "
          f"route at all {n_sm90} convolutions the rule gives it")
    os.environ.pop("MXNET_QUANTIZE_LOWERING", None)
    result["n2_launches"] = n2_launches
    result["n2_sm90_launches"] = n2_sm90_launches
    result["nhwc_launches"] = nhwc_launches
    result["n2_sm90_convolutions"] = n_sm90
    result["replay_counts"] = replay_counts
    result["int_mm_launches"] = int_mm_launches
    del qb, qe
    torch.cuda.empty_cache()
    return net, result


def quantize_net_phase(net):
    phase("50 quantize_net (the block-swap form) on ResNet-50 v1")
    from mxnet_tpu_torch.contrib.quantization import quantize_net

    ctx = mx.gpu(0)
    x = (onp.random.RandomState(SEED + 50).randn(
        QUANT_CALIB_B, *pq.IMAGE) * 0.5).astype("float32")
    with autograd.pause():
        ref = net(nd.array(x, ctx=ctx)).asnumpy()
    t0 = time.perf_counter()
    quantize_net(net, calib_data=pq.calib_batches(ctx, QUANT_CALIB_BATCHES,
                                                  QUANT_CALIB_B),
                 calib_mode="naive")
    calib_s = time.perf_counter() - t0
    os.environ["MXNET_QUANTIZE_LOWERING"] = "native"
    try:
        sess = pq.session(net, len(x), ctx)
        ms, out = pq.time_predicts(sess, x, QUANT_ITERS)
        counts = pq.launches_per_predict(sess, x)
    finally:
        os.environ.pop("MXNET_QUANTIZE_LOWERING", None)
    result = {"batch": len(x), "calibration_s": calib_s, "ms": ms,
              "img_per_s": len(x) * 1e3 / ms,
              "accuracy_delta": pq.accuracy_delta(out, ref),
              "launches_per_predict": counts}
    if counts.get("int8_conv") != 53 or counts.get("int_mm") != 1 or \
            not onp.isfinite(out).all():
        raise RuntimeError(f"quantize_net's predict: {result}")
    print("  " + json.dumps(result))
    return result


def int8_kv_phase(traffic, fp32):
    phase("51 decode at GPT-2 small widths with int8 KV pages")
    from mxnet_tpu_torch.analysis import quantize as qpass

    net = decode_net()
    cfg = GPT2_SMALL
    lengths, arrivals, toks = (traffic["lengths"], traffic["arrivals"],
                               traffic["toks"])
    store, sess = decode_stack(net, PAGED_STREAMS, PAGE_TOKENS,
                               PAGED_BUCKETS, budget=PAGED_BUDGET,
                               kv_int8=True)
    sids = [f"p{i}" for i in range(PAGED_STREAMS)]
    watch = set(traffic["logits"])
    log = []
    run_store_step = sess._run_store_step

    def logged(arrs, recs, bucket=None):
        host = run_store_step(arrs, recs, bucket)
        ids = [r.sid for r in recs]
        log.append((ids, None, None, {i: host[0][i].copy()
                                      for i, sid in enumerate(ids)
                                      if sid in watch}))
        return host

    sess._run_store_step = logged
    bat = serving.DynamicBatcher(sess, max_batch_size=PAGED_BUCKETS[-1],
                                 max_latency_ms=2.0, timeout_ms=600000,
                                 admission=False)
    pos = {sid: 0 for sid in sids}
    try:
        qpass.reset_counters()
        _build.reset_launch_counts()
        serving.METRICS.reset()
        pending, started = {}, 0
        t0 = time.perf_counter()
        while pending or started < PAGED_STREAMS:
            now = time.perf_counter() - t0
            while started < PAGED_STREAMS and arrivals[started] <= now:
                sid = sids[started]
                pending[bat.submit(onp.array([[toks[sid][0]]], "int32"),
                                   session_id=sid,
                                   slo_class="standard")] = sid
                started += 1
            wait_s = (arrivals[started] - now if started < PAGED_STREAMS
                      else 600)
            done, _ = wait(pending, timeout=max(wait_s, 0.0),
                           return_when=FIRST_COMPLETED)
            if not done and started == PAGED_STREAMS:
                raise RuntimeError("int8-KV serving stalled")
            for fut in done:
                sid = pending.pop(fut)
                logits = onp.asarray(fut.result())
                if not onp.isfinite(logits).all():
                    raise RuntimeError(f"{sid}: non-finite logits")
                pos[sid] += 1
                if pos[sid] < lengths[sids.index(sid)]:
                    # the fp32 run's own next token: the same sequences
                    pending[bat.submit(onp.array([[toks[sid][pos[sid]]]],
                                                 "int32"), session_id=sid,
                                       slo_class="standard")] = sid
        wall = time.perf_counter() - t0
        snap = serving.METRICS.snapshot()
        stats = store.stats()
        quantized = qpass.counters()["kv_pages_quantized"]
        launches = _build.launch_counts().get(KERNEL, 0)
        step_ms = mean_step_ms()
    finally:
        bat.close()
        sess._run_store_step = run_store_step
    got = _stream_logits(log, watch)
    worst = 0.0
    for sid, want in traffic["logits"].items():
        if len(got[sid]) != len(want):
            raise RuntimeError(f"{sid}: {len(got[sid])} steps on int8 pages, "
                               f"{len(want)} on fp32 pages")
        for g, w in zip(got[sid], want):
            worst = max(worst, float(onp.abs(g - w).max())
                        / max(float(onp.abs(w).max()), 1e-6))
    n_tokens = sum(lengths)
    if snap["responses:standard"] != n_tokens or snap["failures"] or \
            snap["evictions"] or quantized < snap["decode_steps"]:
        raise RuntimeError(f"int8-KV serving: {snap}, {quantized} pages "
                           "quantized")
    if worst >= KV_INT8_BOUND:
        raise RuntimeError(f"int8 KV pages drifted {worst} from the fp32 "
                           f"pages' logits (bound {KV_INT8_BOUND})")
    if launches != cfg["num_layers"] * snap["decode_steps"]:
        raise RuntimeError(f"K2 launched {launches} times in "
                           f"{snap['decode_steps']} steps")
    ppr = cfg["max_len"] // PAGE_TOKENS
    result = {"tokens": n_tokens, "wall_s": wall,
              "tokens_per_s": n_tokens / wall,
              "decode_steps": snap["decode_steps"], "mean_step_ms": step_ms,
              "token_latency_p50_ms": snap["latency_p50_ms"],
              "token_latency_p99_ms": snap["latency_p99_ms"],
              "k2_launches": launches, "kv_pages_quantized": quantized,
              "pages_total": store.num_pages,
              "page_bytes": stats["page_bytes"],
              "full_length_sessions_in_budget": {
                  "int8": store.num_pages // ppr,
                  "fp32": fp32["pages_total"] // ppr},
              "max_deviation_from_fp32_pages": worst,
              "compared_steps": sum(len(v) for v in got.values()),
              "fp32": {k: fp32[k] for k in (
                  "tokens_per_s", "mean_step_ms", "token_latency_p50_ms",
                  "token_latency_p99_ms")}}
    print("  int8 KV pages " + json.dumps(result))
    sess.close()
    store.close()
    del sess, store, net
    torch.cuda.empty_cache()
    return result


# dist_sync (phases 52-53): the ranks train at phase 16's widths and
# batch; the loss is read at step 40 as in phase 16 (SGD at lr 0.1 and
# momentum 0.9 overshoots on a fixed batch for ~20 steps)
DIST_BATCH, DIST_WARMUP, DIST_STEPS, DIST_LOSS_STEP = 128, 2, 5, 40
DIST_SIZES, DIST_BW_ITERS = "1e6,1e7,2.56e7", "5"
DIST_TIMEOUT = 420


def _launch_dist(n, args):
    """``tools/profile_dist.py`` as ``n`` local ranks through the
    launcher; each rank's JSON result. The whole job is killed if it
    outlives ``DIST_TIMEOUT``."""
    out = tempfile.mkdtemp(prefix="dist_")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), "--launcher", "local", "--port", str(launch.free_port()),
           sys.executable, "-m", "mxnet_tpu_torch.tools.profile_dist",
           "--out", out] + list(args)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise RuntimeError(f"the {n}-rank job outlived {DIST_TIMEOUT} s")
    if proc.returncode:
        print(log[-6000:])
        raise RuntimeError(f"the {n}-rank job exited {proc.returncode}")
    res = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def _dist_rank_line(r):
    t = r["train"]
    k4 = t["k4_launches"]
    return {"rank": r["rank"], "backend": r["backend"],
            "step_ms": t["step_ms"],
            "mean_step_ms": statistics.mean(t["step_ms"]),
            "img_per_s": statistics.mean(t["img_per_s"]),
            "allreduce_ms": t["allreduce_ms"],
            "mean_allreduce_ms": statistics.mean(t["allreduce_ms"]),
            "grad_bytes_per_step": t["grad_bytes_per_step"],
            "buckets_in_backward": t["buckets_in_backward"],
            "flush_buckets": t["flush_buckets"], "peak_gb": t["peak_gb"],
            "k4_launches_per_step": t["k4_launches_per_step"],
            "k4_fwd": k4.get(pr.FWD_KERNEL, 0),
            "k4_bwd": k4.get(pr.BWD_KERNEL, 0),
            "loss_first_last": [t["losses"][0], t["losses"][-1]],
            "losses": t["losses"]}


def _check_k4(line, steps):
    if line["k4_fwd"] != steps or line["k4_bwd"] != steps:
        raise RuntimeError(f"rank {line['rank']}: K4 launched forward "
                           f"{line['k4_fwd']}, backward {line['k4_bwd']} "
                           f"times in {steps} steps")


def dist_gloo_phase(smi):
    phase("52 dist_sync: ResNet-50 v1 by two ranks on one card over gloo")
    ranks = _launch_dist(2, [
        "--batch", str(DIST_BATCH), "--warmup", str(DIST_WARMUP),
        "--steps", str(DIST_STEPS), "--loss-step", str(DIST_LOSS_STEP),
        "--check", "--compare-sync", "1", "--bandwidth", DIST_SIZES,
        "--bw-iters", DIST_BW_ITERS])
    lines = []
    for r in ranks:
        if r["backend"] != "gloo" or r["ranks"] != 2:
            raise RuntimeError(f"rank {r['rank']}: backend {r['backend']} "
                               f"over {r['ranks']} ranks, expected gloo over 2")
        if not r["start_weights_equal"]:
            raise RuntimeError("the ranks started from different weights")
        t = r["train"]
        bad = [c for c in t["checks"]
               if not (c["reduced_is_sum"] and c["params_equal"])]
        if len(t["checks"]) != DIST_STEPS or bad:
            raise RuntimeError(f"rank {r['rank']}: per-step checks {bad or t['checks']}")
        if not t["loss_falls"] or len(t["losses"]) != DIST_LOSS_STEP:
            raise RuntimeError(f"rank {r['rank']}: loss at step "
                               f"{len(t['losses'])} {t['losses'][-1]} not "
                               f"below the first {t['losses'][0]}")
        if t["buckets_in_backward"] <= 0:
            raise RuntimeError("no bucket was dispatched during backward")
        if not r["compare_sync"]["bitwise_equal"]:
            raise RuntimeError(f"MXNET_ASYNC_GRAD_SYNC 1 and 0 differ: "
                               f"{r['compare_sync']}")
        line = _dist_rank_line(r)
        _check_k4(line, DIST_STEPS)
        line["bandwidth"] = r["bandwidth"]
        line["card"] = r["card"]
        line["seconds"] = r["seconds"]
        lines.append(line)
        print(f"rank {r['rank']}: " + json.dumps(line))
    print(f"two ranks over gloo on {smi}: every timed step's reduced "
          f"gradient bitwise the ranks' sum ({ranks[0]['train']['grad_bytes_per_step']} "
          "bytes), parameters bitwise equal, reducer on/off bitwise equal, "
          f"losses {[line['loss_first_last'] for line in lines]}")
    return lines


def dist_nccl_phase(smi):
    phase("53 dist_device_sync: one rank over NCCL")
    (r,) = _launch_dist(1, [
        "--kvstore", "dist_device_sync", "--batch", str(DIST_BATCH),
        "--warmup", "1", "--steps", "3", "--compare-device", "1",
        "--compression", "3", "--bandwidth", DIST_SIZES,
        "--bw-iters", DIST_BW_ITERS])
    if r["backend"] != "nccl":
        raise RuntimeError(f"one rank on one card took {r['backend']}, "
                           "expected nccl")
    if not r["compare_device"]["bitwise_equal"]:
        raise RuntimeError(f"dist_device_sync differs from device: "
                           f"{r['compare_device']}")
    for c in r["compression"]["steps"]:
        if not (c["codes_equal"] and c["residuals_equal"]
                and c["kept_residual_equal"]) or c["nonzero_codes"] <= 0:
            raise RuntimeError(f"2-bit compression on the card: {c}")
    line = _dist_rank_line(r)
    _check_k4(line, 3)
    line["bandwidth"] = r["bandwidth"]
    line["compression"] = r["compression"]
    line["card"] = r["card"]
    line["seconds"] = r["seconds"]
    print("rank 0: " + json.dumps(line))
    print(f"one rank over NCCL on {smi}: a step bitwise equal to "
          "kvstore='device'; compression codes and residuals equal to the "
          "CPU port's")
    return line


# phases 54-55: the telemetry spans and the profiler's device trace on the
# main paths. Phase 54 times phase 18's own open-loop traffic (its 32
# paged streams of 16-256 tokens, from its seed) with the spans off and
# on in turns, three windows at each level, each window one pass of the
# traffic (3.2-4.4 s a pass alone on the card; one pass, not two, so
# that the whole run keeps its time limit), after a warm-up pass; the
# device trace is taken on a shorter traffic of 16 streams of
# 16-48 tokens, which keeps it near 200,000 events. Phase 55 is phase
# 30's bf16 NHWC hybridized ResNet-50 fed by DeviceFeed
TRACE_TURNS = (0, 1, 1, 0, 0, 1)
TRACE_SETTLE_S = 0.5
TRACE_PASSES = 1
TRACE_STREAMS, TRACE_MIN, TRACE_MAX = 16, 16, 48
TRACE_STEPS = 5


def _with_telemetry(level):
    """Set ``MXNET_TELEMETRY`` (read per span) and empty the ring."""
    from mxnet_tpu_torch import telemetry

    os.environ["MXNET_TELEMETRY"] = str(level)
    telemetry.reset_trace()


def _device_trace(path):
    """The profiler's device trace: (all events, kernel events)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError(f"the device trace {path} holds no kernel event")
    return events, kernels


def _graph_launches(events):
    return sum(1 for e in events if e.get("ph") == "X"
               and e.get("name") == "cudaGraphLaunch")


def _open_loop(seed, streams, lo, hi):
    """Phase 18's open-loop plan: per stream its length in tokens, its
    arrival (s) and its first token."""
    rs = onp.random.RandomState(seed)
    lengths = [int(n) for n in rs.randint(lo, hi + 1, streams)]
    arrivals = onp.cumsum(rs.exponential(PAGED_GAP_S, streams))
    first = [int(rs.randint(GPT2_SMALL["vocab_size"]))
             for _ in range(streams)]
    return lengths, arrivals, first


def _traced_traffic(bat, run, lengths, arrivals, first):
    """Phase 18's open loop: stream i arrives at ``arrivals[i]``, each
    step's argmax is the stream's next token, until it has
    ``lengths[i]`` tokens; every request under a trace id of its own.
    Returns (wall seconds, the request ids, the stream ids)."""
    from mxnet_tpu_torch import telemetry

    n = len(lengths)
    sids = [f"{run}-{i}" for i in range(n)]
    count = {sid: 0 for sid in sids}
    rids, pending, started = [], {}, 0

    def submit(sid, tok):
        with telemetry.trace_context(f"{sid}/{count[sid]}") as rid:
            fut = bat.submit(onp.array([[tok]], "int32"), session_id=sid,
                             slo_class="standard")
        rids.append(rid)
        count[sid] += 1
        pending[fut] = sid

    t0 = time.perf_counter()
    while pending or started < n:
        now = time.perf_counter() - t0
        while started < n and arrivals[started] <= now:
            submit(sids[started], first[started])
            started += 1
        wait_s = arrivals[started] - now if started < n else 600
        done, _ = wait(pending, timeout=max(wait_s, 0.0),
                       return_when=FIRST_COMPLETED)
        if not done and started == n:
            raise RuntimeError("traced serving stalled: no step resolved "
                               "in 600 s")
        for fut in done:
            sid = pending.pop(fut)
            logits = onp.asarray(fut.result())
            if logits.shape != (1, GPT2_SMALL["vocab_size"]) or \
                    not onp.isfinite(logits).all():
                raise RuntimeError(f"{sid}: bad logits {logits.shape}")
            if count[sid] < lengths[sids.index(sid)]:
                submit(sid, int(logits.argmax()))
    return time.perf_counter() - t0, rids, sids


def _check_serving_spans(run, events, rids, steps, dropped):
    """A level-1 run's trace: every request's ``serving.*`` spans under
    its own trace id, one ``serving.decode_step`` a step, none dropped."""
    if dropped:
        raise RuntimeError(f"{run}: {dropped} spans dropped")
    by_rid = {}
    for e in events:
        tid = e.get("args", {}).get("trace_id")
        if tid is not None:
            by_rid.setdefault(tid, set()).add(e["name"])
    lacking = [r for r in rids
               if not {"serving.admission", "serving.queue_wait"}
               <= by_rid.get(r, set())]
    if lacking or set(by_rid) != set(rids):
        raise RuntimeError(f"{run}: requests without their serving spans: "
                           f"{lacking[:5]}, ids {len(by_rid)} != {len(rids)}")
    if any(not n.startswith("serving.") for names in by_rid.values()
           for n in names):
        raise RuntimeError(f"{run}: a request carries a span outside "
                           "serving.*")
    decode_spans = sum(e["name"] == "serving.decode_step" for e in events)
    if decode_spans != steps:
        raise RuntimeError(f"{run}: {decode_spans} serving.decode_step spans "
                           f"for {steps} decode steps")


def traced_serving_phase(smi):
    phase("54 decode serving traced")
    from mxnet_tpu_torch import profiler, telemetry
    from mxnet_tpu_torch.tools import trace_top

    cfg = GPT2_SMALL
    net = decode_net()
    store, sess = decode_stack(net, PAGED_STREAMS, PAGE_TOKENS,
                               PAGED_BUCKETS, budget=PAGED_BUDGET)
    full = _open_loop(SEED + 18, PAGED_STREAMS, PAGED_MIN, PAGED_MAX)
    short = _open_loop(SEED + 54, TRACE_STREAMS, TRACE_MIN, TRACE_MAX)
    # a warm-up pass of phase 18's traffic; windows of its traffic with
    # the spans off and on in turns; then spans on with the device trace
    # over the short traffic
    plan = [("warmup", full, 0, False, 1)] + \
        [(f"level{lv}_{i}", full, lv, False, TRACE_PASSES)
         for i, lv in enumerate(TRACE_TURNS)] + \
        [("level1_profiled", short, 1, True, 1)]
    bat = serving.DynamicBatcher(sess, max_batch_size=PAGED_BUCKETS[-1],
                                 max_latency_ms=2.0, timeout_ms=600000,
                                 admission=False)
    tmp = tempfile.mkdtemp(prefix="smoke54_")
    runs, prev = {}, os.environ.get("MXNET_TELEMETRY")
    try:
        for run, (lengths, arrivals, first), level, profiled, passes \
                in plan:
            _with_telemetry(level)
            serving.METRICS.reset()
            _build.reset_launch_counts()
            if profiled:
                profiler.set_config(filename=os.path.join(tmp, "decode.json"))
                profiler.start()
                # CUPTI's activity collection settles before the traffic
                # (a kernel in the first moments of a window can go
                # unrecorded)
                torch.cuda.synchronize()
                time.sleep(TRACE_SETTLE_S)
            wall, rids = 0.0, []
            for k in range(passes):
                w, r, sids = _traced_traffic(bat, f"{run}.{k}", lengths,
                                             arrivals, first)
                wall += w
                rids += r
                for sid in sids:
                    store.evict(sid, reason="traced pass done")
            if profiled:
                torch.cuda.synchronize()
                time.sleep(TRACE_SETTLE_S)
                profiler.stop()
            snap = serving.METRICS.snapshot()
            n_tokens = passes * sum(lengths)
            if snap["responses:standard"] != n_tokens or snap["failures"]:
                raise RuntimeError(f"{run}: not every step resolved: {snap}")
            steps = snap["decode_steps"]
            events = telemetry.events()
            if level:
                _check_serving_spans(run, events, rids, steps,
                                     telemetry.dropped_spans())
            elif events:
                raise RuntimeError(f"{run}: level 0 recorded {len(events)} "
                                   "spans")
            k2 = _build.launch_counts().get(KERNEL, 0)
            if k2 != cfg["num_layers"] * steps:
                raise RuntimeError(f"{run}: K2 launched {k2} times in "
                                   f"{steps} steps")
            runs[run] = {"level": level, "streams": len(lengths),
                         "passes": passes,
                         "tokens": n_tokens, "requests": len(rids),
                         "wall_s": wall, "tokens_per_s": n_tokens / wall,
                         "decode_steps": steps,
                         "mean_step_ms": mean_step_ms(),
                         "k2_launches": k2, "spans": len(events)}
    finally:
        bat.close()
        if prev is None:
            os.environ.pop("MXNET_TELEMETRY", None)
        else:
            os.environ["MXNET_TELEMETRY"] = prev
    traced = runs["level1_profiled"]
    steps = traced["decode_steps"]
    dev_events, kernels = _device_trace(profiler.device_trace_path())
    k2_events = sum("decode_attention_kernel" in e["name"] for e in kernels)
    graph_launches = _graph_launches(dev_events)
    if k2_events:
        named = True
        if k2_events != cfg["num_layers"] * steps:
            raise RuntimeError(f"the device trace names K2 {k2_events} "
                               f"times for {steps} steps of "
                               f"{cfg['num_layers']} layers")
    else:
        named = False
        if graph_launches != steps:
            raise RuntimeError(f"the device trace has no K2 kernel and "
                               f"{graph_launches} graph launches for "
                               f"{steps} steps")
    # the spans' cost on phase 18's traffic, and whether it stands out of
    # the spread of the runs at one level
    timed = {lv: [v for k, v in runs.items()
                  if k.startswith(f"level{lv}_") and k != "level1_profiled"]
             for lv in (0, 1)}
    tps = {lv: [v["tokens_per_s"] for v in timed[lv]] for lv in (0, 1)}
    step_ms = {lv: [v["mean_step_ms"] for v in timed[lv]] for lv in (0, 1)}
    spread = max(max(t) - min(t) for t in tps.values())
    gap = statistics.mean(tps[0]) - statistics.mean(tps[1])
    result = {"card": smi, "turns": list(TRACE_TURNS),
              "phase18_traffic": {
                  "streams": PAGED_STREAMS, "passes": TRACE_PASSES,
                  "tokens": timed[0][0]["tokens"],
                  "tokens_per_s": {f"level{lv}": tps[lv] for lv in (0, 1)},
                  "decode_steps": {f"level{lv}": [v["decode_steps"]
                                                  for v in timed[lv]]
                                   for lv in (0, 1)},
                  "mean_step_ms": {f"level{lv}": step_ms[lv]
                                   for lv in (0, 1)},
                  "wall_s": {f"level{lv}": [v["wall_s"] for v in timed[lv]]
                             for lv in (0, 1)},
                  "mean_tokens_per_s": {f"level{lv}": statistics.mean(tps[lv])
                                        for lv in (0, 1)},
                  "level0_minus_level1_tokens_per_s": gap,
                  "largest_spread_within_a_level": spread,
                  "level1_cost_resolved": abs(gap) > spread,
                  "spans_per_level1_run": [v["spans"] for v in timed[1]]},
              "traced_traffic": {
                  "streams": TRACE_STREAMS, "tokens": traced["tokens"],
                  "requests": traced["requests"], "decode_steps": steps,
                  "wall_s": traced["wall_s"],
                  "tokens_per_s": traced["tokens_per_s"],
                  "warmup_tokens_per_s": runs["warmup"]["tokens_per_s"],
                  "spans": traced["spans"]},
              "dropped_spans": 0,
              "device_trace_events": len(dev_events),
              "device_kernel_events": len(kernels),
              "k2_kernel_events": k2_events,
              "graph_launch_events": graph_launches,
              "kineto_names_kernels_inside_graphs": named,
              "k2_launches": traced["k2_launches"],
              "k2_launches_all_runs": sum(v["k2_launches"]
                                          for v in runs.values())}
    print("traced decode serving " + json.dumps(result))
    for line in trace_top.table(trace_top.device_op_events(dev_events), 10):
        print("  " + line)
    sess.close()
    store.close()
    del net, sess, store
    torch.cuda.empty_cache()
    return result


def traced_resnet_phase(smi):
    phase("55 ResNet-50 v1 training traced")
    from mxnet_tpu_torch import profiler, telemetry
    from mxnet_tpu_torch.pipeline import DeviceFeed
    from mxnet_tpu_torch.tools import trace_top

    ctx = mx.gpu(0)
    rs = onp.random.RandomState(SEED + 55)

    def batches(n):
        return [(rs.randint(0, 256, (RESNET_B, pr.IMAGE, pr.IMAGE, 3),
                            dtype=onp.uint8),
                 rs.randint(0, pr.CLASSES, RESNET_B).astype("float32"))
                for _ in range(n)]

    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    net = pr.build_resnet50(ctx, seed=SEED, layout="NHWC")
    trainer = pr.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    net.hybridize()
    mean = nd.array(onp.array([123.68, 116.78, 103.94], "f"), ctx=ctx)
    std = nd.array(onp.array([58.40, 57.12, 57.38], "f"), ctx=ctx)
    main_tid = threading.get_ident() % 100000
    tmp = tempfile.mkdtemp(prefix="smoke55_")
    prev = os.environ.get("MXNET_TELEMETRY")

    def run(n, level, profiled=False):
        """``n`` steps fed by a DeviceFeed over ``n`` fresh batches;
        returns (ms per step, per step the step loop's span names)."""
        _with_telemetry(level)
        feed = DeviceFeed(batches(n))
        it = iter(feed)
        if profiled:
            profiler.set_config(filename=os.path.join(tmp, "resnet.json"))
            profiler.start()
        ms, names, seen = [], [], 0
        try:
            for _ in range(n):
                t0 = time.perf_counter()
                xb, yb = next(it)
                x = (xb.astype("float32") - mean) / std
                loss = pr.train_step(net, trainer, x, yb)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                evs = telemetry.events()
                names.append(sorted(e["name"] for e in evs[seen:]
                                    if e["tid"] == main_tid))
                seen = len(evs)
                if not onp.isfinite(loss.asscalar()):
                    raise RuntimeError(f"non-finite loss at level {level}")
        finally:
            if profiled:
                profiler.stop()
            feed.close()
        return ms, names

    try:
        run(HYB_WARMUP, 0)  # the captures
        _build.reset_launch_counts()
        ms0, _ = run(TRACE_STEPS, 0)
        ms1, _ = run(TRACE_STEPS, 1)
        k4_before = _build.launch_counts()
        msp, names = run(TRACE_STEPS, 1, profiled=True)
        staged = sum(e["name"] == "pipeline.prefetch_stage"
                     for e in telemetry.events())
        dropped = telemetry.dropped_spans()
    finally:
        amp.disable()
        if prev is None:
            os.environ.pop("MXNET_TELEMETRY", None)
        else:
            os.environ["MXNET_TELEMETRY"] = prev
    counts = _build.launch_counts()
    k4 = counts.get(pr.FWD_KERNEL, 0) + counts.get(pr.BWD_KERNEL, 0)
    k4_traced = k4 - k4_before.get(pr.FWD_KERNEL, 0) - \
        k4_before.get(pr.BWD_KERNEL, 0)
    for i, step in enumerate(names):
        if step != ["fused_step.execute", "pipeline.feed_wait"]:
            raise RuntimeError(f"traced step {i}: spans {step}")
    if staged != TRACE_STEPS or dropped:
        raise RuntimeError(f"{staged} prefetch_stage spans for "
                           f"{TRACE_STEPS} batches, {dropped} dropped")
    if k4 != 2 * 3 * TRACE_STEPS or k4_traced != 2 * TRACE_STEPS:
        raise RuntimeError(f"K4 launched {k4} times in {3 * TRACE_STEPS} "
                           f"steps, {k4_traced} traced")
    dev_events, kernels = _device_trace(profiler.device_trace_path())
    fwd = sum("rtc_softmax_fwd" in e["name"] for e in kernels)
    bwd = sum("rtc_softmax_bwd" in e["name"] for e in kernels)
    if fwd != TRACE_STEPS or bwd != TRACE_STEPS:
        raise RuntimeError(f"the device trace has rtc_softmax_fwd {fwd} "
                           f"and _bwd {bwd} times in {TRACE_STEPS} steps")
    result = {"card": smi, "steps": TRACE_STEPS,
              "step_ms": {"level0": ms0, "level1": ms1,
                          "level1_profiled": msp},
              "mean_step_ms": {"level0": statistics.mean(ms0),
                               "level1": statistics.mean(ms1),
                               "level1_profiled": statistics.mean(msp)},
              # the first step of each feed waits for its first batch
              "median_step_ms": {"level0": statistics.median(ms0),
                                 "level1": statistics.median(ms1),
                                 "level1_profiled": statistics.median(msp)},
              "spans_per_step": names[0], "prefetch_stage_spans": staged,
              "device_trace_events": len(dev_events),
              "device_kernel_events": len(kernels),
              "k4_kernel_events": fwd + bwd,
              "graph_launch_events": _graph_launches(dev_events),
              "k4_launches": k4}
    print("traced resnet bf16 NHWC " + json.dumps(result))
    for line in trace_top.table(trace_top.device_op_events(dev_events), 10):
        print("  " + line)
    del net, trainer
    torch.cuda.empty_cache()
    return result



# -- the deployment chain: autotune, programs and bundles, the fleet ----------

# the three versions a repository deploys and bundles: wav2vec2 at bucket
# 8 (phase 13's export), ResNet-50 in int8 at batch 32 (phase 49's
# calibration: 10 batches of 32), GPT-2-small decode on a paged store
DEPLOY_W2V_BUCKET = 8
DEPLOY_DECODE = dict(kind="decode", cfg=GPT2_SMALL, seed=SEED, rows=16,
                     buckets=[1, 2, 4, 8, 16], page_tokens=16,
                     budget=2 ** 28)
DEPLOY_DECODE_STREAMS, DEPLOY_DECODE_STEPS = 4, 8
TUNE_ITERS, TUNE_PAIRS, TUNE_BUDGET_MS = 10, 3, 120_000
FLEET_STREAMS, FLEET_STEPS, FLEET_DRAIN_AT = 16, 24, 12
FLEET_TOL = 1e-5  # K2's split count follows the occupancy: not bitwise
FLEET_LONE_STEPS = 16
_DC = "mxnet_tpu_torch.tools.deploy_chain"


def _deploy_models(prefix):
    samples = W2V_SECONDS * SAMPLE_RATE
    return {
        "wav2vec2": dict(kind="symbol", prefix=prefix, samples=samples,
                         bucket=DEPLOY_W2V_BUCKET),
        "resnet50_int8": dict(kind="int8_resnet", model="resnet50_v1",
                              batch=QUANT_CALIB_B,
                              calib_batches=QUANT_CALIB_BATCHES),
        "gpt2_decode": dict(DEPLOY_DECODE, steps=DEPLOY_DECODE_STEPS)}


def _deploy_inputs(models):
    rng = onp.random.default_rng(SEED + 57)
    w = models["wav2vec2"]
    return {
        "wav2vec2": rng.standard_normal(
            (w["bucket"], w["samples"], 1), dtype=onp.float32),
        "resnet50_int8": (rng.standard_normal(
            (QUANT_CALIB_B,) + pq.IMAGE, dtype=onp.float32) * 0.5),
        "gpt2_decode": rng.integers(0, GPT2_SMALL["vocab_size"],
                                    DEPLOY_DECODE_STREAMS).astype("int32")}


def _no_nvcc_env(cache_dir):
    """A child's environment on a host without a compiler: ``nvcc`` off
    ``PATH``, ``CUDA_HOME`` pointing nowhere, an empty compile cache."""
    path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    return {"PATH": os.pathsep.join(path),
            "CUDA_HOME": os.path.join(cache_dir, "no-cuda"),
            "CUDA_PATH": os.path.join(cache_dir, "no-cuda"),
            "MXNET_COMPILE_CACHE_DIR": cache_dir}


def _run_child(spec, env, timeout):
    """``python -m tools.deploy_chain serve`` with ``spec``; its report."""
    path = os.path.join(spec["dir"], "spec.json")
    spec = dict(spec, spawn_wall=time.time())
    with open(path, "w") as f:
        json.dump(spec, f)
    proc = subprocess.run([sys.executable, "-m", _DC, "serve", path],
                          cwd=ROOT, env=dict(os.environ, **env),
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"deploy child failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def autotune_phase(smi, prefix):
    phase("56 autotune")
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.tools import deploy_chain as dc

    os.environ.pop("MXNET_QUANTIZE_LOWERING", None)  # phase 49 forced it
    os.environ["MXNET_AUTOTUNE"] = "tune"
    autotune.reset_autotune_state()
    ctx = mx.gpu(0)
    models = _deploy_models(prefix)
    inputs = _deploy_inputs(models)
    qsess = dc.build_session(models["resnet50_int8"], ctx)
    wsess = dc.build_session(models["wav2vec2"], ctx)
    qx = nd.array(inputs["resnet50_int8"], ctx=ctx)
    wx = nd.array(inputs["wav2vec2"], ctx=ctx)

    def window(predict):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TUNE_ITERS):
                predict()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        return run

    def measure_lowering(choice):
        # a session of its own: the hybridized block captures one graph
        # per resolved lowering
        sess = pq.session(qsess._block, QUANT_CALIB_B, ctx)
        return window(lambda: sess.predict(qx))

    def measure_attention(choice):
        wsess.predict(wx)  # re-optimizes under the candidate's salt
        return window(lambda: wsess.predict(wx))

    attn_key = ("cuda", 64)  # the attention clusters' head width
    t0 = time.perf_counter()
    lowering = autotune.tune(
        "quantize.lowering", ("cuda",), measure_lowering,
        default_choice="native", pairs=TUNE_PAIRS, budget_ms=TUNE_BUDGET_MS)
    t_low = time.perf_counter() - t0
    t0 = time.perf_counter()
    attention = autotune.tune(
        "fusion.attn_compute_bound_seq", attn_key, measure_attention,
        pairs=TUNE_PAIRS, budget_ms=TUNE_BUDGET_MS)
    t_attn = time.perf_counter() - t0
    counters = autotune.counters()
    os.environ["MXNET_AUTOTUNE"] = "consult"
    if counters["measurements"] != len(lowering["measured"]) + \
            len(attention["measured"]) or counters["record_store"] != 2:
        raise RuntimeError(f"autotune counters {counters}")
    result = {"card": smi, "records_dir": autotune.records_dir(),
              "quantize.lowering": {
                  "key": ["cuda"], "measured": lowering["measured"],
                  "winner": lowering["choice"], "won": lowering["won"],
                  "sweep_s": t_low},
              "fusion.attn_compute_bound_seq": {
                  "key": list(attn_key), "measured": attention["measured"],
                  "winner": attention["choice"], "won": attention["won"],
                  "sweep_s": t_attn},
              "counters": counters}
    print("autotune (each candidate's paired-median base/test ratio over "
          f"{TUNE_PAIRS} pairs of {TUNE_ITERS} predicts): "
          + json.dumps(result))
    del qsess, wsess
    torch.cuda.empty_cache()
    return result


def bundle_phase(smi, prefix, tuned):
    phase("57 artifacts and bundles")
    from mxnet_tpu_torch.tools import deploy_chain as dc
    from mxnet_tpu_torch.utils import compile_cache as cc

    ctx = mx.gpu(0)
    models = _deploy_models(prefix)
    inputs = _deploy_inputs(models)
    work = os.path.join(WORK["dir"], "deploy")
    os.makedirs(work)
    # the exporter starts from an empty program cache: cold programs
    os.environ["MXNET_HOME"] = os.path.join(work, "home_export")
    torch.backends.cudnn.deterministic = True
    cc.reset_compile_cache_counters()
    _build.reset_launch_counts()
    repo = serving.ModelRepository(admission=False)
    want, cold = {}, {}
    try:
        for name, spec in models.items():
            t0 = time.perf_counter()
            sess = dc.build_session(spec, ctx)
            repo.deploy(name, sess)
            got = dc.answer(sess, spec, inputs[name])
            torch.cuda.synchronize()
            cold[name] = time.perf_counter() - t0
            for k, v in got.items():
                want[f"{name}/{k}"] = v
        counts = _build.launch_counts()
        exporter = cc.compile_cache_stats()
        path_kernels = {FLASH_KERNEL: "wav2vec2", NORM_ACT_KERNEL: "wav2vec2",
                        N2_KERNEL: "resnet50_int8", KERNEL: "gpt2_decode"}
        idle = [k for k in path_kernels if not counts.get(k)]
        if idle:
            raise RuntimeError(f"the exporter's path never launched {idle}: "
                               f"{counts}")
        bundles, reports = {}, {}
        for name in models:
            bundles[name] = os.path.join(work, f"{name}.bundle")
            reports[name] = repo.export_bundle(name, bundles[name])
    finally:
        repo.close()
    want_libs = {"wav2vec2": {"flash_attention", "norm_act"},
                 "resnet50_int8": {"int8_conv", "int8_conv_sm90"},
                 "gpt2_decode": {"decode_attention"}}
    for name, rep in reports.items():
        if rep["missing"] or not want_libs[name] <= set(rep["libraries"]):
            raise RuntimeError(f"{name} bundle: {rep}")
    if reports["wav2vec2"]["entries"] < 1 or \
            reports["resnet50_int8"]["entries"] < 1:
        raise RuntimeError(f"bundles hold no program: {reports}")
    entries = sum(r["entries"] for r in reports.values())
    onp.savez(os.path.join(work, "inputs.npz"), **inputs)
    lowering = tuned["quantize.lowering"]
    attention = tuned["fusion.attn_compute_bound_seq"]
    spec = {"dir": work, "ctx": "gpu", "deterministic": True,
            "bundles": [bundles[n] for n in models], "models": models,
            "inputs": os.path.join(work, "inputs.npz"),
            "out": os.path.join(work, "out.npz"),
            "forced": {
                "resnet50_int8": {"decision": "quantize.lowering",
                                  "choice": lowering["winner"]},
                "wav2vec2": {"decision": "fusion.attn_compute_bound_seq",
                             "key": attention["key"],
                             "choice": attention["winner"]}}}
    env = _no_nvcc_env(os.path.join(work, "cache_child"))
    env.update(MXNET_HOME=os.path.join(work, "home_child"),
               MXNET_AUTOTUNE="consult",
               MXNET_AUTOTUNE_DIR=tuned["records_dir"])
    t0 = time.perf_counter()
    child = _run_child(spec, env, timeout=600)
    child_s = time.perf_counter() - t0
    c = child["counters"]
    gates = {"kernel_builds": c["compile_cache"]["kernel_builds"],
             "graph_optimizer_runs": c["graph_opt_runs"],
             "retraces": c["compile_cache"]["retraces"],
             "calibrations": c["compile_cache"]["calibrations"],
             "measurements": c["autotune"]["measurements"]}
    if any(gates.values()):
        raise RuntimeError(f"the bundle-warm child built: {gates}")
    if c["compile_cache"]["disk_hits"] != entries:
        raise RuntimeError(f"disk_hits {c['compile_cache']['disk_hits']} "
                           f"!= the bundles' {entries} programs")
    if not c["autotune"]["hits"]:
        raise RuntimeError(f"the child consulted no record: {c['autotune']}")
    idle = [k for k in path_kernels if not child["launches"].get(k)]
    if idle:
        raise RuntimeError(f"the bundle-warm child never launched {idle}")
    got = dict(onp.load(spec["out"]))
    for key, w in want.items():
        if not onp.array_equal(got[key], w):
            raise RuntimeError(f"{key}: the bundle-warm answer differs from "
                               "the exporter's by "
                               f"{float(onp.abs(got[key] - w).max())}")
        forced = got.get(f"forced/{key}")
        if forced is not None and not onp.array_equal(forced, got[key]):
            raise RuntimeError(f"{key}: the forced winner's answer differs "
                               "from the consulted one")
    torch.backends.cudnn.deterministic = False
    result = {
        "card": smi,
        "bundle_bytes": {n: r["bytes"] for n, r in reports.items()},
        "bundle_programs": {n: r["entries"] for n, r in reports.items()},
        "bundle_libraries": {n: r["libraries"] for n, r in reports.items()},
        "cold_ready_s": cold,
        "cold_note": "in the exporting process, kernels already built "
                     "(phase 2's nvcc time apart), programs built",
        "warm_ready_s": {n: m["ready_s"]
                         for n, m in child["models"].items()},
        "warm_first_response_since_spawn_s": child["first_response_s"],
        "warm_child_wall_s": child_s,
        "exporter_compile_cache": {k: exporter[k] for k in (
            "retraces", "calibrations", "disk_writes", "kernel_builds")},
        "child_gates": gates,
        "child_disk_hits": c["compile_cache"]["disk_hits"],
        "child_captures": c["compile_cache"]["captures"],
        "child_autotune": c["autotune"],
        "child_launches": child["launches"],
        "answers_bitwise": sorted(want),
        "forced_winners_bitwise": sorted(spec["forced"])}
    print("artifacts and bundles: " + json.dumps(result))
    os.environ["MXNET_HOME"] = WORK["home"]
    torch.cuda.empty_cache()
    return result, bundles["gpt2_decode"], models["gpt2_decode"]


def _npy(a):
    import io

    buf = io.BytesIO()
    onp.save(buf, a)
    return buf.getvalue()


def _fleet_step(port, sid, tok):
    import io

    status, _, body = _http(port, "POST", "/predict",
                         _npy(onp.array([[tok]], "int32")),
                         {"Content-Type": "application/x-npy",
                          "X-Session-Id": sid})
    if status != 200:
        raise RuntimeError(f"fleet step of {sid}: HTTP {status}: "
                           f"{body[:300]!r}")
    return onp.load(io.BytesIO(body), allow_pickle=False)


def _replica_launches(url):
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        text = resp.read().decode()
    for line in text.splitlines():
        if line.startswith(f"mxnet_kernel_launches_{KERNEL} "):
            return int(float(line.split()[1]))
    return 0


def fleet_phase(smi, bundle, spec, single_tokens_per_s):
    phase("58 replica fleet")
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch.serving import fleet
    from mxnet_tpu_torch.tools import deploy_chain as dc

    work = os.path.join(WORK["dir"], "fleet")
    os.makedirs(work)
    rspec = dict(spec, ctx="gpu")
    rspec.pop("steps", None)
    factory = f"{_DC}:decode_replica"
    # the streams' steps run at one SLO class; no replica or router sheds
    # them (the admission ladder is exercised by phase 20 and the tests)
    base = {"DEPLOY_CHAIN_SPEC": json.dumps(rspec),
            "MXNET_SERVING_ADMISSION": "0"}
    envs = {"a": dict(base, MXNET_HOME=os.path.join(work, "home_a")),
            "b": dict(base, MXNET_HOME=os.path.join(work, "home_b"),
                      **_no_nvcc_env(os.path.join(work, "cache_b")))}
    procs = {}
    t0 = time.perf_counter()

    def spawn(name):
        procs[name] = fleet.spawn_replica(
            factory, bundle=bundle if name == "b" else None,
            env=envs[name], timeout_s=600)

    threads = [threading.Thread(target=spawn, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spawn_s = time.perf_counter() - t0
    if set(procs) != {"a", "b"}:
        for p in procs.values():
            p.stop()
        raise RuntimeError("a replica did not start")
    prev = os.environ.get("MXNET_SERVING_ADMISSION")
    os.environ["MXNET_SERVING_ADMISSION"] = "0"
    try:
        router = fleet.FleetRouter(port=0, probe_ms=50)
    finally:
        if prev is None:
            os.environ.pop("MXNET_SERVING_ADMISSION")
        else:
            os.environ["MXNET_SERVING_ADMISSION"] = prev
    try:
        b_ready = procs["b"].ready["compile"]
        if b_ready["kernel_builds"] or b_ready["retraces"]:
            raise RuntimeError(f"the bundle-warm replica built: {b_ready}")
        router.start()
        for name in "ab":
            router.add_replica(name, procs[name].url, process=procs[name])
        fleet.reset_fleet_counters()
        before = {n: _replica_launches(procs[n].url) for n in "ab"}
        rng = onp.random.default_rng(SEED + 58)
        sids = [f"f{i}" for i in range(FLEET_STREAMS)]
        first = {s: int(t) for s, t in zip(
            sids, rng.integers(0, GPT2_SMALL["vocab_size"], FLEET_STREAMS))}
        tok = dict(first)
        logits = {s: [] for s in sids}
        pins, drain = [], {}
        t_all = time.perf_counter()
        with ThreadPoolExecutor(FLEET_STREAMS) as pool:
            for k in range(FLEET_STEPS):
                if k == FLEET_DRAIN_AT:
                    a_launches = _replica_launches(procs["a"].url)
                    live_a = sum(v == "a" for v in router._sessions.values())
                    t0 = time.perf_counter()
                    moved = router.drain("a")
                    drain = {"seconds": time.perf_counter() - t0,
                             "moved": moved, "live_on_a": live_a}
                outs = list(pool.map(
                    lambda s: _fleet_step(router.port, s, tok[s]), sids))
                for s, out in zip(sids, outs):
                    logits[s].append(out[0])
                    tok[s] = int(out[0].argmax())
                pins.append(dict(router._sessions))
        wall = time.perf_counter() - t_all
        counters = fleet.fleet_counters()
        after = {"a": a_launches, "b": _replica_launches(procs["b"].url)}
        # one stream's steps alone, through the router and straight to
        # the replica: the per-request path without the round's company
        lone = {}
        for via, port in (("router", router.port), ("replica", procs["b"].port)):
            t0 = time.perf_counter()
            nxt = first[sids[0]]
            for _ in range(FLEET_LONE_STEPS):
                nxt = int(_fleet_step(port, f"lone-{via}", nxt)[0].argmax())
            lone[via] = (time.perf_counter() - t0) * 1e3 / FLEET_LONE_STEPS
    finally:
        router.stop()
        for p in procs.values():
            p.stop()
    for s in sids:
        homes = {pins[k][s] for k in range(FLEET_DRAIN_AT)}
        if len(homes) != 1 or any(pins[k][s] != "b"
                                  for k in range(FLEET_DRAIN_AT, FLEET_STEPS)):
            raise RuntimeError(f"{s}: pinned to {[p[s] for p in pins]}")
    if drain["moved"] != drain["live_on_a"] or \
            counters["drained_sessions"] != drain["live_on_a"] or \
            not drain["live_on_a"]:
        raise RuntimeError(f"drain moved {drain} ({counters})")
    if after["b"] <= before["b"] or after["a"] <= before["a"]:
        raise RuntimeError(f"replica b launched no K2: {before} {after}")
    # the same streams on one in-process session, one stream at a time
    _build.reset_launch_counts()
    sess = dc.build_session(rspec, mx.gpu(0))
    worst = 0.0
    for s in sids:
        toks, ref = dc.greedy_decode(sess, [first[s]], FLEET_STEPS)
        got = onp.stack(logits[s])
        worst = max(worst, float(onp.abs(got - ref[0]).max()))
        fleet_toks = [int(g.argmax()) for g in got]
        if fleet_toks != [int(t) for t in toks[0]] or worst > FLEET_TOL:
            raise RuntimeError(f"{s}: the fleet's stream differs from one "
                               f"session's (max_abs_err {worst})")
    if not _build.launch_counts().get(KERNEL):
        raise RuntimeError("the in-process session launched no K2")
    sess.close()
    n_tokens = FLEET_STREAMS * FLEET_STEPS
    result = {"card": smi, "streams": FLEET_STREAMS, "steps": FLEET_STEPS,
              "tokens_per_s_router": n_tokens / wall,
              "phase18_tokens_per_s_single_process": single_tokens_per_s,
              "wall_s": wall, "drain": drain, "spawn_s": spawn_s,
              "replica_b_ready": b_ready,
              "replica_k2_launches": {n: after[n] - before[n]
                                      for n in before},
              "lone_stream_ms_per_step": lone,
              "max_abs_err_vs_one_session": worst, "counters": counters}
    print("replica fleet: " + json.dumps(result))
    torch.cuda.empty_cache()
    return result


RECORD_IMAGES, RECORD_B, RECORD_STEPS = 512, 128, 20


def engine_phase(smi):
    phase("59 the dependency engine on the card")
    out = prec.engine_check()
    out["card"] = smi
    print("  " + json.dumps(out))
    return out


def record_decode_phase(smi):
    phase("60 record decode: the decoder, jpeg_crop, the Python twin")
    rec = prec.write_records(os.path.join(WORK["dir"], "train.rec"),
                             RECORD_IMAGES)
    out = prec.decode_check(rec, RECORD_B)
    out["card"] = smi
    print(f"decoder: {out['decoder']} (jpeglib.h {out['jpeglib_h']}, "
          f"nvJPEG {out['nvjpeg']}, PIL {out['pil']}, {out['cores']} cores)")
    print("  " + json.dumps(out))
    return rec, out


def record_iter_phase(smi, rec):
    phase("61 ImageRecordIter alone")
    out = prec.iter_rate(rec, RECORD_B)
    out["card"] = smi
    out["resize"] = prec.resize_launches(rec, RECORD_B)
    print("  " + json.dumps(out))
    got = out["resize"]
    if got["decoder"] == "nvjpeg" and (
            got["jpeg_crop_scaled_launches"] < got["batches"]
            or got["jpeg_crop_launches"] != 0):
        raise RuntimeError(f"ImageRecordIter with a resize launched the "
                           f"crop kernels {got}")
    return out


def record_resnet_phase(smi, rec):
    phase("62 ResNet-50 v1 trained from the .rec")
    out = prec.train_from_records(rec, RECORD_STEPS, RECORD_B)
    out["card"] = smi
    print("  " + json.dumps(out))
    losses = out["losses"]
    if not all(onp.isfinite(losses)):
        raise RuntimeError(f"non-finite record-fed loss: {losses}")
    if not onp.mean(losses[-5:]) < onp.mean(losses[:5]):
        raise RuntimeError(f"the record-fed loss did not fall: {losses}")
    if out["k4_launches"] != 2 * RECORD_STEPS:
        raise RuntimeError(f"K4 launched {out['k4_launches']} times in "
                           f"{RECORD_STEPS} record-fed steps")
    if out["decoder"] == "nvjpeg" and (
            out["jpeg_crop_launches"] == 0
            or out["jpeg_crop_scaled_launches"] != 0):
        raise RuntimeError(f"the record-fed steps launched jpeg_crop "
                           f"{out['jpeg_crop_launches']} times and "
                           f"jpeg_crop_scaled "
                           f"{out['jpeg_crop_scaled_launches']}")
    return out


def records_phases(smi):
    engine = engine_phase(smi)
    rec, decode = record_decode_phase(smi)
    rate = record_iter_phase(smi, rec)
    train = record_resnet_phase(smi, rec)
    return {"engine": engine, "decode": decode, "iter": rate,
            "train": train}


# -- slice 11a: linalg, image and the contrib tail ---------------------------

def tail_ops_phase(smi):
    """Phase 63: every case of op_sweep's LINALG, IMAGE, CONTRIB2 and
    CONTRIB3 tables on the card against the CPU port (outputs on the
    card), the deterministic ones in one CUDA graph, the random image ops
    replayed under the registered generator."""
    phase("63 the slice's ops on the card: linalg, image, contrib")
    dev = torch.device("cuda", 0)
    rows = op_sweep.card_sweep(dev, op_sweep.TAIL)
    exact = sum(r["exact_outputs"] for r in rows)
    worst = max(rows, key=lambda r: r["worst"])
    n_captured = op_sweep.capture_check(dev, op_sweep.TAIL)
    n_random = op_sweep.random_capture_check(dev, op_sweep.RANDOM_TAIL,
                                             samplers=False)
    skipped = sorted({c.op for c in op_sweep.TAIL
                      if c.op in op_sweep.DATA_DEPENDENT})
    out = {"card": smi, "cases": len(rows), "bitwise_outputs": exact,
           "worst_of_bound": worst["worst"], "worst_case": worst["case"],
           "captured": n_captured, "not_captured": skipped,
           "random_captured": n_random}
    print(f"  {len(rows)} cases on the card against the CPU port, forward "
          f"and backward, every output on the card: {exact} outputs "
          f"bitwise, the worst float deviation {worst['worst']:.3g} of its "
          f"bound ({worst['case']}); {n_captured} cases in one CUDA graph "
          f"(not captured: {skipped}, the solver's error check reads the "
          f"card on the host); {n_random} random image draws replayed under "
          "the registered generator")
    print("  " + json.dumps(out))
    return out


# the two-stage detector ops at published shapes (phase 64): Faster
# R-CNN's RPN at its test settings (a 600 x 1000 image, a stride-16 map of
# 38 x 63, the op's 12 default anchors, pre-NMS 6000, post-NMS 300, NMS
# 0.7), R-FCN's VOC head (7 x 7 x 21 = 1029 channels, 300 rois, output_dim
# 21, pooled and group size 7, spatial scale 1/16) and its deformable
# pooling (trans (300, 2, 7, 7), part 7, 4 samples a part, trans_std 0.1),
# and Deformable ConvNets v1's res5a_branch2b (512 -> 512, 3 x 3,
# dilation 2, pad 2, 4 deformable groups: 72 offset channels)
RPN_MAP, RPN_IMAGE, RPN_K = (38, 63), (600.0, 1000.0, 1.0), 12
RPN = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300, threshold=0.7,
           rpn_min_size=16, scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
           feature_stride=16)
RFCN_ROIS = 300
RFCN = dict(spatial_scale=1.0 / 16, output_dim=21, pooled_size=7,
            group_size=7)
DPSROI = dict(RFCN, part_size=7, sample_per_part=4, trans_std=0.1)
RES5 = dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), num_filter=512,
            num_deformable_group=4, no_bias=True)
# the card against the CPU port: boxes and pooled values within this
# fraction of max(1, |value|) (the proposals' boxes and kept indices are
# in fact bitwise); the deformable convolution's output and gradients
# within DEFORM_TOL of each tensor's largest magnitude (cuBLAS against
# the CPU's BLAS over K = 4608, and the data gradient's scatter-adds)
DET_OPS_TOL, DEFORM_TOL = 1e-5, 1e-4


def _detector_cases(rs):
    """op_sweep Cases at the published shapes (the arrays made here from
    ``rs``; each Case's own RandomState draws its cotangent)."""
    h, w = RPN_MAP
    e = onp.exp(rs.standard_normal((2, 2, RPN_K, h, w)))
    prob = (e / e.sum(1, keepdims=True)).reshape(2, 2 * RPN_K, h, w)
    deltas = 0.1 * rs.standard_normal((2, 4 * RPN_K, h, w))
    info = onp.tile(onp.asarray([RPN_IMAGE]), (2, 1))
    rpn = [a.astype("float32") for a in (prob, deltas, info)]
    x1 = rs.uniform(0, 900, RFCN_ROIS)
    y1 = rs.uniform(0, 500, RFCN_ROIS)
    bw, bh = rs.uniform(24, 500, (2, RFCN_ROIS))
    rois = onp.stack([onp.zeros(RFCN_ROIS), x1, y1,
                      onp.minimum(x1 + bw, 999), onp.minimum(y1 + bh, 599)],
                     1).astype("float32")
    score_maps = rs.standard_normal((1, 1029, h, w)).astype("float32")
    trans = rs.standard_normal((RFCN_ROIS, 2, 7, 7)).astype("float32")
    feat = rs.standard_normal((1, 512, h, w)).astype("float32")
    # offsets off the integers (the bilinear weight's kinks)
    off = (rs.uniform(-2, 2, (1, 72, h, w)) + 0.01).astype("float32")
    weight = (rs.standard_normal((512, 512, 3, 3))
              * (2.0 / (512 * 9)) ** 0.5).astype("float32")
    C = op_sweep.Case
    return [
        ("Proposal", C("proposal", lambda _: [a[:1] for a in rpn], RPN,
                       tag="rpn"), DET_OPS_TOL),
        ("MultiProposal", C("multi_proposal", lambda _: rpn, RPN,
                            tag="rpn_b2"), DET_OPS_TOL),
        ("PSROIPooling", C("psroi_pooling",
                           lambda _: [score_maps, rois], RFCN, diff=(0,),
                           tag="rfcn"), DET_OPS_TOL),
        ("DeformablePSROIPooling", C(
            "deformable_psroi_pooling",
            lambda _: [score_maps, rois, trans], DPSROI, diff=(0, 2),
            tag="rfcn"), DET_OPS_TOL),
        ("DeformableConvolution", C(
            "deformable_convolution", lambda _: [feat, off, weight], RES5,
            diff=(0, 1, 2), tag="res5a_branch2b"), DEFORM_TOL)]


def _rel_dev(got, want):
    """max |got - want| / max(1, max |want|), 0 for equal arrays."""
    got, want = got.double().cpu(), want.double().cpu()
    if torch.equal(got, want):
        return 0.0
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def _fwd_bwd_closure(case, device):
    """``case``'s forward (and, with ``diff``, its backward to them) on
    ``device`` as a closure over inputs made once."""
    from mxnet_tpu_torch.ndarray import registry as reg

    xs, rs = op_sweep._inputs(case, device)
    fn = reg.get_op(case.op).fn
    if not case.diff:
        return lambda: fn(*xs, **case.kw)
    out0 = op_sweep._outs(fn(*xs, **case.kw))[case.out]
    ct = torch.from_numpy(rs.standard_normal(tuple(out0.shape)).astype(
        "float32")).to(device)
    for i in case.diff:
        xs[i] = xs[i].detach().requires_grad_(True)

    def run():
        with torch.enable_grad():
            y = op_sweep._outs(fn(*xs, **case.kw))[case.out]
            return autograd._torch_grad([y], [xs[i] for i in case.diff],
                                        [ct], retain_graph=False)
    return run


def _host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def detector_ops_phase(smi):
    """Phase 64: Proposal, MultiProposal, PSROIPooling,
    DeformablePSROIPooling and DeformableConvolution at the published
    shapes on the card against the CPU port, forward and (where
    differentiable) backward, each timed on the card (CUDA events) beside
    the CPU."""
    from mxnet_tpu_torch.ndarray import ops_contrib2

    phase("64 the two-stage detector ops at published shapes")
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows, bad = {}, []
    for name, case, tol in _detector_cases(onp.random.RandomState(SEED)):
        outs, grads = op_sweep._forward_backward(case, dev)
        c_outs, c_grads = op_sweep._forward_backward(case, cpu)
        if any(t.device != dev for t in outs + grads):
            raise RuntimeError(f"{name}: an output left the card")
        devs = {f"output{i}": _rel_dev(t, c)
                for i, (t, c) in enumerate(zip(outs, c_outs))}
        devs.update({f"grad{i}": _rel_dev(t, c) for i, t, c in
                     zip(case.diff, grads, c_grads)})
        row = {"shapes": [list(a.shape) for a in case.make(None)],
               "max_rel_dev": max(devs.values()), "rel_dev": devs}
        if name in ("Proposal", "MultiProposal"):
            parts = [ops_contrib2._proposal_parts(
                *op_sweep._inputs(case, d)[0], **{
                    k: case.kw[k] for k in (
                        "rpn_pre_nms_top_n", "rpn_post_nms_top_n",
                        "threshold", "rpn_min_size", "scales", "ratios",
                        "feature_stride")}) for d in (dev, cpu)]
            (bx, _, keep), (c_bx, _, c_keep) = parts
            if not torch.equal(keep.cpu(), c_keep):
                raise RuntimeError(f"{name}: the kept indices differ from "
                                   "the CPU port's")
            row["kept_per_image"] = (c_keep >= 0).sum(1).tolist()
            row["boxes_bitwise"] = bool(torch.equal(bx.cpu(), c_bx))
        if row["max_rel_dev"] > tol:
            bad.append(f"{name} {devs} > {tol}")
        fwd_case = op_sweep.Case(case.op, case.make, case.kw, tag=case.id)
        row["ms"] = time_ms(_fwd_bwd_closure(fwd_case, dev), flush, reps=10)
        row["cpu_ms"] = _host_ms(_fwd_bwd_closure(fwd_case, cpu))
        if case.diff:
            row["fwd_bwd_ms"] = time_ms(_fwd_bwd_closure(case, dev), flush,
                                        reps=10)
            row["cpu_fwd_bwd_ms"] = _host_ms(_fwd_bwd_closure(case, cpu))
        rows[name] = row
        print(f"  {name} {json.dumps(row)}")
    if bad:
        raise RuntimeError("the detector ops on the card against the CPU "
                           "port: " + "; ".join(bad))
    out = {"card": smi, "ops": rows}
    print("  " + json.dumps(out))
    return out


DET_REC_IMAGES, DET_B, DET_STEPS = 256, 32, 10


def det_iter_phase(smi):
    """Phase 65: SSD300-VGG16 (phase 46's network, loss and optimizer)
    trained 10 steps at batch 32 from ImageDetIter over a synthetic
    detection .rec written here, beside the same step fed from a batch
    already on the card."""
    from mxnet_tpu_torch.tools import profile_detiter as pdi

    phase("65 SSD300-VGG16 trained from ImageDetIter")
    rec = pdi.write_det_records(os.path.join(WORK["dir"], "det.rec"),
                                DET_REC_IMAGES, seed=SEED % 2 ** 31)
    out = pdi.train_from_det_iter(rec, DET_STEPS, DET_B, seed=0)
    out["card"] = smi
    print("  " + json.dumps(out))
    if not all(onp.isfinite(out["losses"])):
        raise RuntimeError(f"non-finite ImageDetIter-fed loss: "
                           f"{out['losses']}")
    if out["label_faults"]:
        raise RuntimeError(f"labels outside [0, 1] and not padding: "
                           f"{out['label_faults']}")
    if not out["first_labels_equal_host"]:
        raise RuntimeError("the first batch's labels differ from the same "
                           "iterator and seed run on the host")
    print(f"  {smi}: {out['step_ms']:.1f} ms a step, "
          f"{out['images_per_s']:.1f} images/s, device idle "
          f"{100 * out['idle_share']:.1f}%; fed from a batch on the card "
          f"{out['device_fed_step_ms']:.1f} ms, idle "
          f"{100 * out['idle_share_device_fed']:.1f}%")
    return out


def tail_phases(smi):
    return {"ops": tail_ops_phase(smi), "detector": detector_ops_phase(smi),
            "det_iter": det_iter_phase(smi)}


def _tail_only():
    """``python3 chip_smoke.py --tail``: phases 1-2 and 63-65 alone."""
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    tail_phases(smi)
    phase("done")
    print(f"phases 63-65 in {time.perf_counter() - t0:.1f} s")
    return 0


def _records_only():
    """``python3 chip_smoke.py --records``: phases 1-2 and 59-62 alone
    (phase 2 builds only the crop kernels' sources)."""
    t0 = time.perf_counter()
    smi = device_phase()
    phase("2 build")
    _build.build_all([jpk.SOURCE, prec.PIXEL_SOURCE])
    records_phases(smi)
    phase("done")
    print(f"phases 59-62 in {time.perf_counter() - t0:.1f} s")
    return 0


# the sparse phases (66-68): the card against the CPU port over the first
# SPARSE_KEEP steps; row ids bitwise
SPARSE_STEPS, SPARSE_KEEP = 20, 3
SPARSE_LOGITS_TOL, SPARSE_WEIGHTS_TOL = 1e-5, 1e-4


def libsvm_parse_phase(smi):
    """Phase 66: the seeded LibSVM file and its native parse."""
    phase("66 LibSVMIter's parse through csrc/textio.cc")
    path = os.path.join(WORK["dir"], "train.libsvm")
    t0 = time.perf_counter()
    psp.write_libsvm(path, psp.FILE_BATCHES * psp.BATCH, psp.FEATURES,
                     seed=SEED % 2 ** 31)
    out = psp.parse_rate(mx, path)
    out.update(card=smi, write_s=time.perf_counter() - t0 - out["parse_s"],
               file_mb=os.path.getsize(path) / 2 ** 20)
    print(f"  {out['rows']} rows ({out['nnz']} features, "
          f"{out['file_mb']:.1f} MB) parsed in {out['parse_s']:.3f} s: "
          f"{out['rows_per_s']:.0f} rows/s (the parser's g++ build "
          f"{out['parser_build_s']:.2f} s before it)")
    print("  " + json.dumps(out))
    return path, out


def sparse_legs_phase(smi, path):
    """Phase 67: both legs, lazy SGD and lazy Adam, on the card and
    against the CPU port."""
    phase("67 sparse logistic regression and the embedding-bag layer at "
          "1,000,000 features")
    init = psp.embedding_init(psp.FEATURES, psp.WIDTH, SEED % 2 ** 31)
    res = {}
    for leg in ("linear", "embedding"):
        for opt in ("sgd", "adam"):
            card, nums = psp.run_leg(mx, leg, path, opt, SPARSE_STEPS,
                                     psp.FEATURES, psp.BATCH, init)
            t0 = time.perf_counter()
            cpu = psp.run_steps(psp.make_leg(
                mx, leg, mx.cpu(), path, opt, psp.FEATURES, psp.BATCH,
                init), SPARSE_KEEP, keep=SPARSE_KEEP)
            cmp = psp.compare(card, cpu)
            nums.update(cmp, card=smi,
                        cpu_run_s=time.perf_counter() - t0)
            res[f"{leg}_{opt}"] = nums
            stages = ", ".join(f"{k} {v:.2f}"
                               for k, v in nums["stage_ms"].items())
            print(f"  {leg} {opt}: {nums['ms_per_step']:.2f} ms a step "
                  f"({stages}), "
                  f"{nums['rows_per_s']:.0f} rows/s, "
                  f"{nums['unique_rows_per_batch']:.0f} unique rows a batch, "
                  f"idle {100 * nums['idle_share']:.1f}%, peak "
                  f"{nums['leg_peak_gb']:.2f} GB above the "
                  f"{nums['peak_device_gb'] - nums['leg_peak_gb']:.2f} "
                  f"held before; against the CPU: row "
                  f"ids equal {cmp['row_ids_equal']}, logits "
                  f"{cmp['logits_rel_l2']:.3g}, weights "
                  f"{cmp['weights_rel_l2']:.3g}")
            if not cmp["row_ids_equal"] or \
                    cmp["steps_compared"] != SPARSE_KEEP:
                raise RuntimeError(f"{leg} {opt}: the pushed row ids differ "
                                   "from the CPU port's")
            if not cmp["logits_rel_l2"] <= SPARSE_LOGITS_TOL:
                raise RuntimeError(f"{leg} {opt}: logits {cmp}")
            if not cmp["weights_rel_l2"] <= SPARSE_WEIGHTS_TOL:
                raise RuntimeError(f"{leg} {opt}: weights {cmp}")
            if not all(onp.isfinite(w).all() for w in card["weights"]):
                raise RuntimeError(f"{leg} {opt}: non-finite weights")
            del card, cpu
            gc.collect()
            torch.cuda.empty_cache()
    print("  " + json.dumps(res))
    return res


def dgl_phase(smi):
    """Phase 68: the DGL ops on a card-resident graph of ogbn-arxiv's
    size, bitwise against the CPU port."""
    phase("68 the DGL graph ops at ogbn-arxiv's size")
    data, indices, indptr, shape = psp.make_graph(seed=SEED % 2 ** 31)
    runs = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        g = nd.sparse.csr_matrix((data, indices, indptr), shape=shape,
                                 ctx=ctx)
        runs[name] = psp.graph_ops(mx, g, seed=SEED % 2 ** 31)
    (card, card_s, info), (cpu, cpu_s, _) = runs["card"], runs["cpu"]
    for key in card:
        a, b = card[key], cpu[key]
        pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
        for x, y in pairs:
            if x.dtype != y.dtype or x.shape != y.shape or \
                    not onp.array_equal(x, y):
                raise RuntimeError(f"DGL {key}: the card's graph gives "
                                   "another output than the CPU's")
    out = dict(info, card=smi, nodes=shape[0], edges=len(data),
               seeds=psp.GRAPH_SEEDS, hops=psp.GRAPH_HOPS,
               fanout=psp.GRAPH_FANOUT, card_graph_s=card_s,
               cpu_graph_s=cpu_s, bitwise=True)
    print(f"  {info['sampled_vertices']} vertices and "
          f"{info['sample_edges']} edges sampled; "
          f"{info['edge_ids_found']} of 1024 pairs are edges; the card's "
          f"graph: " + ", ".join(f"{k} {v:.3f}" for k, v in card_s.items())
          + "; every output bitwise equal to the CPU's")
    print("  " + json.dumps(out))
    return out


def sparse_phases(smi):
    path, parse = libsvm_parse_phase(smi)
    legs = sparse_legs_phase(smi, path)
    os.remove(path)
    return {"parse": parse, "legs": legs, "dgl": dgl_phase(smi)}


def _sparse_only():
    """``python3 chip_smoke.py --sparse``: phases 1 and 66-68 alone."""
    t0 = time.perf_counter()
    smi = device_phase()
    sparse_phases(smi)
    phase("done")
    print(f"phases 66-68 in {time.perf_counter() - t0:.1f} s")
    return 0


# the interchange phases (69-72): ResNet-50 v1 at BASELINE.md's widths
# (1000 classes, 224 x 224, NCHW, float32), batch 32; the imported graphs
# against the block they were exported from, as tests/test_torch_onnx.py
# holds them on the CPU
ONNX_RTOL = ONNX_ATOL = 1e-5


def onnx_fit_phase(smi):
    """Phase 69: ``Estimator.fit`` against the hand-written loop."""
    phase("69 ResNet-50 v1 through Estimator.fit against a hand-written "
          "loop")
    ctx = mx.gpu(0)
    seed = SEED % 2 ** 31
    _build.reset_launch_counts()
    with po.deterministic():
        net, start = po.build(ctx, seed)
        hand = po.twin(ctx, start)
        net.hybridize()
        hand.hybridize()
        data = po.batches(ctx, seed + 1)
        fit = po.fit(net, data, ctx, os.path.join(WORK["dir"], "fit"))
        loop = po.hand_loop(hand, data, ctx)
        differ = po.same_parameters(net, hand)
    launches = _build.launch_counts()
    if differ:
        raise RuntimeError(f"Estimator.fit and the hand loop end apart in "
                           f"{len(differ)} parameters: {differ[:5]}")
    loss = fit["metrics"][-1][1]
    if not onp.isfinite(loss):
        raise RuntimeError(f"fit's loss is not finite: {fit['metrics']}")
    steps = po.EPOCHS * po.BATCHES
    if len(fit["step_ms"]) != steps or len(loop["step_ms"]) != steps:
        raise RuntimeError(f"fit ran {len(fit['step_ms'])} steps and the "
                           f"loop {len(loop['step_ms'])}, not {steps}")
    seen = sorted({r[0] for r in fit["monitor_rows"]})
    if seen != [1, 1 + po.INTERVAL] or \
            [r[:2] for r in fit["monitor_rows"]] != \
            [r[:2] for r in loop["monitor_rows"]]:
        raise RuntimeError(f"the monitor collected steps {seen}")
    if fit["checkpoints"] != [f"{po.NAME}-epoch{e}.params"
                              for e in range(1, po.EPOCHS + 1)]:
        raise RuntimeError(f"checkpoints {fit['checkpoints']}")
    out = {"card": smi, "steps": steps, "batch": po.BATCH,
           "fit_step_ms": fit["step_ms"], "hand_step_ms": loop["step_ms"],
           "fit_median_step_ms": statistics.median(fit["step_ms"]),
           "hand_median_step_ms": statistics.median(loop["step_ms"]),
           "fit_cycle_ms": fit["cycle_ms"], "hand_cycle_ms": loop["cycle_ms"],
           "fit_median_cycle_ms": statistics.median(fit["cycle_ms"]),
           "hand_median_cycle_ms": statistics.median(loop["cycle_ms"]),
           "fit_s": fit["fit_s"], "hand_loop_s": loop["loop_s"],
           "monitor_stats": len(fit["monitor_rows"]),
           "metrics": fit["metrics"], "log_lines": fit["log_lines"],
           "checkpoints": fit["checkpoints"], "bitwise": True,
           "hand_kernel_launches": launches}
    print(f"  fit: {steps} steps at batch {po.BATCH}, median "
          f"{out['fit_median_step_ms']:.2f} ms a step against the hand "
          f"loop's {out['hand_median_step_ms']:.2f}, from a step's start "
          f"to the next {out['fit_median_cycle_ms']:.2f} against "
          f"{out['hand_median_cycle_ms']:.2f} ({fit['fit_s']:.2f} s "
          f"against {loop['loop_s']:.2f} s in all; fit ran first); "
          f"{len(fit['monitor_rows'])} monitor statistics on steps {seen}; "
          f"every parameter bitwise equal to the hand loop's; "
          + "; ".join(fit["log_lines"][-2:]))
    print("  " + json.dumps(out))
    del hand
    gc.collect()
    torch.cuda.empty_cache()
    return net, out


def onnx_export_phase(smi, net):
    """Phase 70: ``export`` and ``export_model``; the codec reads the
    file back and every initializer is its parameter, bitwise."""
    phase("70 export: HybridBlock.export and contrib.onnx.export_model")
    path, params_file, model, info = po.export(
        net, WORK["dir"], (po.BATCH, 3, po.SIZE, po.SIZE))
    info.update(card=smi, initializers_bitwise=po.check_initializers(
        model, net))
    print(f"  {info['onnx_bytes']} bytes, {info['nodes']} nodes, "
          f"{info['initializers']} initializers (opset {info['opset']}): "
          f"export_model {info['export_s']:.3f} s after export's "
          f"{info['block_export_s']:.3f} s; read back by the codec in "
          f"{info['codec_read_s']:.3f} s, all "
          f"{info['initializers_bitwise']} parameters bitwise")
    print("  " + json.dumps(info))
    return path, params_file, info


def onnx_import_phase(smi, net, path):
    """Phase 71: ``import_to_gluon`` (hybridized) and ``import_model``
    through the Executor against the exported block; predict times."""
    phase("71 import: import_to_gluon and import_model on the card")
    ctx = mx.gpu(0)
    x = po.batches(ctx, SEED % 2 ** 31 + 2, n=1)[0][0]
    with po.deterministic():
        ref = net(x).asnumpy()
        block, g, e, info = po.import_both(path, ctx, x)
    worst = {}
    for what, got in (("import_to_gluon", g), ("executor", e)):
        if got.shape != ref.shape or not onp.isfinite(got).all():
            raise RuntimeError(f"{what}: logits {got.shape}, finite "
                               f"{onp.isfinite(got).all()}")
        onp.testing.assert_allclose(got, ref, rtol=ONNX_RTOL,
                                    atol=ONNX_ATOL, err_msg=what)
        worst[what] = float(onp.abs(got - ref).max())
    zoo, imported = po.predict_ms([net, block], x, ctx)
    info.update(card=smi, max_abs_err=worst,
                zoo_predict_ms=statistics.median(zoo),
                imported_predict_ms=statistics.median(imported),
                zoo_predict_ms_range=[min(zoo), max(zoo)],
                imported_predict_ms_range=[min(imported), max(imported)])
    print(f"  import_to_gluon {info['import_to_gluon_s']:.3f} s, "
          f"import_model and bind {info['import_model_bind_s']:.3f} s; "
          f"logits within {worst} of the exported block's; hybridized "
          f"predict at batch {po.BATCH}: imported "
          f"{info['imported_predict_ms']:.2f} ms against the zoo block's "
          f"{info['zoo_predict_ms']:.2f} (medians of {len(zoo)}, torch's "
          "cuDNN flags)")
    print("  " + json.dumps(info))
    del block
    return x, ref, info


def onnx_store_phase(smi, params_file, x, ref):
    """Phase 72: the exported .params file through the model store and
    ``resnet50_v1(pretrained=True)``, bitwise the exported block."""
    phase("72 pretrained=True through the model store")
    ctx = mx.gpu(0)
    root = os.path.join(WORK["home"], "models")
    t0 = time.perf_counter()
    with po.deterministic():
        stored = po.store_load(params_file, root, ctx)
        load_s = time.perf_counter() - t0
        stored.hybridize()
        got = stored(x).asnumpy()
    if got.tobytes() != ref.tobytes():
        raise RuntimeError(f"the stored weights' logits are not the "
                           f"exported block's: max "
                           f"{float(onp.abs(got - ref).max())}")
    out = {"card": smi, "file": sorted(os.listdir(root)),
           "load_s": load_s, "bitwise": True}
    print(f"  {out['file']} loaded in {load_s:.3f} s; logits bitwise the "
          "exported block's")
    print("  " + json.dumps(out))
    return out


def onnx_phases(smi):
    net, fit = onnx_fit_phase(smi)
    path, params_file, export = onnx_export_phase(smi, net)
    x, ref, imported = onnx_import_phase(smi, net, path)
    store = onnx_store_phase(smi, params_file, x, ref)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return {"fit": fit, "export": export, "import": imported,
            "store": store}


def _onnx_only():
    """``python3 chip_smoke.py --onnx``: phases 1 and 69-72 alone."""
    t0 = time.perf_counter()
    smi = device_phase()
    onnx_phases(smi)
    phase("done")
    print(f"phases 69-72 in {time.perf_counter() - t0:.1f} s")
    return 0


def kernel_entry(name, source, replaces, launches, worst, row, shape, smi,
                 **extra):
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": worst, "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"],
             "shape": shape, "card": smi}
    entry.update(extra)
    return entry


def main():
    """Every phase in a scratch directory of the run's own: the program
    cache and the autotune records live under it (``MXNET_HOME``,
    ``MXNET_AUTOTUNE_DIR``); the kernel libraries stay in ``build/``."""
    import shutil

    import faulthandler

    # a hang prints every thread's stack and ends the run inside the
    # driver's 1200 s, rather than holding the card to the limit
    faulthandler.dump_traceback_later(
        450 if sys.argv[1:] in (["--records"], ["--tail"], ["--sparse"],
                                ["--onnx"])
        else 1150,
        exit=True)
    WORK["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
    WORK["home"] = os.path.join(WORK["dir"], "home")
    os.environ["MXNET_HOME"] = WORK["home"]
    os.environ["MXNET_AUTOTUNE_DIR"] = os.path.join(WORK["dir"], "autotune")
    try:
        if sys.argv[1:] == ["--chain"]:
            return _chain_only()
        if sys.argv[1:] == ["--records"]:
            return _records_only()
        if sys.argv[1:] == ["--tail"]:
            return _tail_only()
        if sys.argv[1:] == ["--sparse"]:
            return _sparse_only()
        if sys.argv[1:] == ["--onnx"]:
            return _onnx_only()
        return _main()
    finally:
        shutil.rmtree(WORK["dir"], ignore_errors=True)


def _chain_only():
    """``python3 chip_smoke.py --chain``: the device and build phases,
    phase 13's export, and the deployment chain's phases 56-58 alone
    (their gates as in the full run; no result lines)."""
    t0 = time.perf_counter()
    os.environ["MXNET_GRAPH_OPT"] = "1"
    smi = device_phase()
    build_phase()
    prefix = os.path.join(WORK["dir"], "wav2vec2-large-lv60")
    export_wav2vec2(prefix, mx.sym, nd, W2V_CFG, SEED)
    tuned = autotune_phase(smi, prefix)
    _, bundle, spec = bundle_phase(smi, prefix, tuned)
    fleet_phase(smi, bundle, spec, None)
    phase("done")
    print(f"phases 56-58 in {time.perf_counter() - t0:.1f} s")
    return 0


def _main():
    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k2_worst = kernel_check_phase(gen)
    k2_rows = kernel_times_phase(gen)
    k2_launches, _ = serving_phase()
    k1_worst = k1_check_phase(gen)
    k1_row = k1_times_phase(gen)
    net, k1_training, _ = training_phase()
    training_vs_cpu_phase(net)
    del net
    k3_worst = k3_check_phase(gen)
    k3_rows, k3_total = k3_times_phase(gen)
    route = k1_route_phase(gen)
    sym_result = symbolic_phase()
    k4_worst, double = k4_check_phase(gen)
    k4_fwd, k4_bwd, k4_double = k4_times_phase(gen, double)
    net, (k4_fwd_n, k4_bwd_n), _ = resnet_phase()
    resnet_vs_cpu_phase(net)
    del net
    torch.cuda.empty_cache()
    net = decode_net()
    k2_paged_launches, paged_fp32, paged_traffic = paged_serving_phase(net)
    graph_vs_eager_phase(net)
    http_phase(net)
    del net
    torch.cuda.empty_cache()
    conv_default_flags_phase()
    k4_floor = k4_floor_phase()
    k1_bf16 = k1_bf16_phase(gen)
    (net, trainer, x, y), resnet_amp, head = resnet_amp_phase()
    k1_bf16_launches, sm90_launches, _ = lm_amp_phase()
    amp_vs_cpu_phase()
    poisoned_step_phase(net, trainer, x, y)
    del net, trainer
    torch.cuda.empty_cache()
    resnet_hyb = resnet_hybrid_phase()
    lm_hyb = lm_hybrid_phase()
    fed = fed_resnet_phase()
    failing_capture_phase()
    mlp = mlp_phase()
    wlm = word_lm_phase(gen)
    bucketing = bucketing_phase()
    gluon_wlm = gluon_word_lm_phase(wlm["captured"]["step_ms"])
    fusion_bind = training_bind_fusion_phase()
    hand = hand_loop_phase()
    sweep = op_sweep_phase()
    torch.cuda.empty_cache()
    zoo = zoo_phase()
    vgg = vgg_phase()
    lamb = lamb_phase()
    optim_tail = optim_tail_phase()
    twins = examples_phase()
    torch.cuda.empty_cache()
    det_ops = detection_ops_phase()
    ssd_toy = ssd_toy_phase()
    ssd, (ssd_net, ssd_anchor, ssd_x, _) = ssd_training_phase()
    ssd_det = ssd_detection_phase(ssd_net, ssd_anchor, ssd_x)
    del ssd_net
    torch.cuda.empty_cache()
    quant_k = quant_kernels_phase()
    rnet, int8_resnet = int8_resnet_phase()
    block_swap = quantize_net_phase(rnet)
    del rnet
    torch.cuda.empty_cache()
    kv_int8 = int8_kv_phase(paged_traffic, paged_fp32)
    gc.collect()
    torch.cuda.empty_cache()
    dist2 = dist_gloo_phase(smi)
    dist1 = dist_nccl_phase(smi)
    traced_dec = traced_serving_phase(smi)
    traced_res = traced_resnet_phase(smi)
    tuned = autotune_phase(smi, WORK["w2v_prefix"])
    deploy, gpt2_bundle, gpt2_spec = bundle_phase(
        smi, WORK["w2v_prefix"], tuned)
    fleet_res = fleet_phase(smi, gpt2_bundle, gpt2_spec,
                            paged_fp32["tokens_per_s"])
    records = records_phases(smi)
    tail = tail_phases(smi)
    gc.collect()
    torch.cuda.empty_cache()
    sparse = sparse_phases(smi)
    interchange = onnx_phases(smi)
    k4_dist = {"resnet50_dist_sync_gloo_rank0": dist2[0]["k4_fwd"],
               "resnet50_dist_sync_gloo_rank1": dist2[1]["k4_fwd"],
               "resnet50_dist_device_sync_nccl": dist1["k4_fwd"]}
    bind_counts = fusion_bind["counts"]
    # the counts after the inference forward hold the training step's too
    k1_bind = bind_counts["after_inference"].get(FLASH_KERNEL, 0)
    k3_bind = bind_counts["after_inference"].get(NORM_ACT_KERNEL, 0)
    k1_hyb = lm_hyb[True]["k1_sm90_launches"] + \
        lm_hyb[False]["k1_sm90_launches"]
    k4_hyb = {"resnet_bf16_hybrid_eager": resnet_hyb[False]["k4_launches"] // 2,
              "resnet_bf16_hybridized": resnet_hyb[True]["k4_launches"] // 2,
              "resnet_bf16_fed": fed["k4_launches"] // 2,
              "resnet_bf16_traced": traced_res["k4_launches"] // 2,
              "resnet_bf16_record_fed":
                  records["train"]["k4_launches"] // 2}
    k4_amp = {f"resnet_bf16_{k}": v["k4_launches"] // 2
              for k, v in resnet_amp.items()}
    big = k2_rows[-1]
    k3_big = k3_rows[0]
    kernels = [
        kernel_entry(
            KERNEL, "mxnet_tpu_torch/csrc/decode_attention.cu",
            "mxnet_tpu/kernels/flash_attention.py:137",
            k2_launches + k2_paged_launches
            + traced_dec["k2_launches_all_runs"], k2_worst, big,
            f"B={big['B']} H={big['H']} S={big['S']} "
            f"D={big['D']} visible={big['visible']} fp32", smi,
            splits=big["splits"], by_batch=k2_rows,
            launches_by_path={"serving": k2_launches,
                              "paged_serving": k2_paged_launches,
                              "traced_serving":
                                  traced_dec["k2_launches_all_runs"]}),
        # K1's headline numbers are the training shape's; the fusion
        # route's shape has its own row under "fusion_route". Its launches
        # are the mma.sync kernel's; the bf16 LM's go to the sm90 kernel
        kernel_entry(
            FLASH_KERNEL, "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/kernels/flash_attention.py:48",
            k1_training + sym_result["k1_launches"] + k1_bf16_launches
            - sm90_launches + wlm["k1_k3_launches"]["k1"] + k1_bind,
            max(k1_worst, route["max_abs_err"]), k1_row,
            f"B={k1_row['B']} H={k1_row['H']} S_q={k1_row['S_q']} "
            f"S_k={k1_row['S_k']} D={k1_row['D']} causal fp32", smi,
            bound_3xtf32_ms=k1_row["bound_3xtf32_ms"],
            launches_by_path={"training": k1_training,
                              "symbolic_serving": sym_result["k1_launches"],
                              "training_bf16": k1_bf16_launches
                              - sm90_launches,
                              "word_lm_module": wlm["k1_k3_launches"]["k1"],
                              "training_bind": k1_bind},
            fusion_route=route, bf16_mma_route_ms=k1_bf16["mma_route_ms"]),
        # K1 in bf16 at D = 64: the wgmma kernel the LM takes under AMP
        kernel_entry(
            FLASH_SM90_KERNEL, "mxnet_tpu_torch/csrc/flash_attention_sm90.cu",
            "mxnet_tpu/kernels/flash_attention.py:48", sm90_launches + k1_hyb,
            k1_bf16["max_abs_err"], k1_bf16,
            f"B={k1_bf16['B']} H={k1_bf16['H']} S_q={k1_bf16['S_q']} "
            f"S_k={k1_bf16['S_k']} D={k1_bf16['D']} causal bf16", smi,
            bound_two_pass_ms=k1_bf16["bound_two_pass_ms"],
            views_ms=k1_bf16["views_ms"],
            mma_route_ms=k1_bf16["mma_route_ms"],
            launches_by_path={
                "training_bf16": sm90_launches,
                "training_bf16_hybrid_eager":
                    lm_hyb[False]["k1_sm90_launches"],
                "training_bf16_hybridized":
                    lm_hyb[True]["k1_sm90_launches"]},
            launches_per_replay=lm_hyb[True]["k1_launches_per_replay"]),
        kernel_entry(
            NORM_ACT_KERNEL, "mxnet_tpu_torch/csrc/norm_act.cu",
            "mxnet_tpu/kernels/norm_act.py:45",
            sym_result["k3_launches"] + wlm["k1_k3_launches"]["k3"]
            + k3_bind,
            k3_worst, k3_big, f"rows={k3_big['rows']} C={k3_big['C']} gelu "
            "fp32 (bucket 8, feature layer 1)", smi,
            library_calls="F.layer_norm then F.gelu", per_forward=k3_total,
            launches_by_path={"symbolic_serving": sym_result["k3_launches"],
                              "word_lm_module": wlm["k1_k3_launches"]["k3"],
                              "training_bind_inference": k3_bind,
                              "training_bind_train": bind_counts["train"]
                              .get(NORM_ACT_KERNEL, 0)}),
        # K4: the launcher and the two kernels it compiles on the ResNet-50
        # path; the double kernel of the launcher's own check rides along
        kernel_entry(
            pr.FWD_KERNEL, "mxnet_tpu_torch/tools/profile_resnet.py "
            "(FWD_SRC, via mxnet_tpu_torch/rtc.py)", "mxnet_tpu/rtc.py:19",
            k4_fwd_n + sum(k4_amp.values()) + sum(k4_hyb.values())
            + sum(k4_dist.values()),
            k4_worst, k4_fwd,
            f"B={k4_fwd['B']} C={k4_fwd['C']} fp32", smi,
            route_detail="NVRTC sm_90a, cuLaunchKernel",
            library_calls="torch.softmax", launcher=k4_double,
            launch_floor=k4_floor,
            launches_by_path={"resnet_fp32": k4_fwd_n, **k4_amp,
                              **k4_hyb, **k4_dist}),
        kernel_entry(
            pr.BWD_KERNEL, "mxnet_tpu_torch/tools/profile_resnet.py "
            "(BWD_SRC, via mxnet_tpu_torch/rtc.py)", "mxnet_tpu/rtc.py:19",
            k4_bwd_n + sum(k4_amp.values()) + sum(k4_hyb.values())
            + sum(k4_dist.values()),
            k4_worst, k4_bwd,
            f"B={k4_bwd['B']} C={k4_bwd['C']} fp32", smi,
            route_detail="NVRTC sm_90a, cuLaunchKernel",
            library_calls="torch._softmax_backward_data",
            launches_by_path={"resnet_fp32": k4_bwd_n, **k4_amp,
                              **k4_hyb, **k4_dist}),
        # N1: not a TPU kernel; box_nms's greedy sweep (a lax.fori_loop in
        # the JAX op). The route rule sends SSD300's detection, capped
        # (nms_topk 400) and uncapped (-1, the op's default), to the mask
        # and reduce kernels, timed apart on the uncapped batch it swept;
        # the fused kernel takes the toy twin's short sweep (phase 45),
        # timed at that shape
        kernel_entry(
            n1k.FUSED, "mxnet_tpu_torch/csrc/box_nms.cu",
            "mxnet_tpu/ndarray/ops_contrib.py:88 (not a TPU kernel: "
            "box_nms's lax.fori_loop)",
            ssd_toy["n1_launches"].get(n1k.FUSED, 0), 0.0,
            ssd_det["n1_toy_shape"],
            f"B={ssd_det['n1_toy_shape']['B']} "
            f"N={ssd_det['n1_toy_shape']['N']} class-aware fp32", smi,
            not_a_tpu_kernel=True, library_calls="none",
            keep_mask_mismatches=0,
            ssd_capped_on_this_route=ssd_det["n1_other_route"],
            launches_by_path={"ssd_toy_detection": ssd_toy["n1_launches"]}),
        kernel_entry(
            n1k.MASK, "mxnet_tpu_torch/csrc/box_nms.cu",
            "mxnet_tpu/ndarray/ops_contrib.py:88 (not a TPU kernel: "
            "box_nms's lax.fori_loop; its IoU matrix, as a bitmask)",
            ssd_det["n1_launches"].get(n1k.MASK, 0)
            + ssd_det["n1_launches_uncapped"].get(n1k.MASK, 0), 0.0,
            ssd_det["mask_kernel"],
            f"B={ssd_det['mask_kernel']['B']} "
            f"limit={ssd_det['mask_kernel']['limit']} nms_topk=-1 "
            "class-aware fp32", smi, not_a_tpu_kernel=True,
            library_calls="none",
            workspace_bytes=ssd_det["mask_kernel"]["workspace_bytes"],
            launches_by_path={
                "ssd300_detection": ssd_det["n1_launches"],
                "ssd300_detection_uncapped":
                    ssd_det["n1_launches_uncapped"]}),
        kernel_entry(
            n1k.REDUCE, "mxnet_tpu_torch/csrc/box_nms.cu",
            "mxnet_tpu/ndarray/ops_contrib.py:88 (not a TPU kernel: "
            "box_nms's lax.fori_loop)",
            ssd_det["n1_launches"].get(n1k.REDUCE, 0)
            + ssd_det["n1_launches_uncapped"].get(n1k.REDUCE, 0), 0.0,
            ssd_det["reduce_kernel"],
            f"B={ssd_det['reduce_kernel']['B']} "
            f"limit={ssd_det['reduce_kernel']['limit']} nms_topk=-1", smi,
            not_a_tpu_kernel=True, library_calls="none",
            keep_mask_mismatches=0, n1_routes=ssd_det["routes"],
            capped=ssd_det["n1"], uncapped=ssd_det["n1_all_rows"],
            random_rows=det_ops["n1"],
            random_rows_uncapped=det_ops["n1_all_rows"],
            launches_by_path={
                "ssd300_detection": ssd_det["n1_launches"],
                "ssd300_detection_uncapped":
                    ssd_det["n1_launches_uncapped"],
                "ssd300_training": {
                    k: v for k, v in ssd["launches"].items()
                    if k.startswith("box_nms")}}),
        # N2: not a TPU kernel; the int8 convolution XLA compiled for the
        # JAX op's native lowering, in two kernels the route rule picks
        # between. Its numbers are one resnet50_v1 forward's 53
        # convolutions at batch 32, each shape timed alone on the route
        # the rule gives it, the sm90 route's layout copies included;
        # mma_ms is every convolution on the mma.sync kernel (the only
        # route before the sm90 kernel), in the same call
        kernel_entry(
            N2_KERNEL, "mxnet_tpu_torch/csrc/int8_conv_sm90.cu (sm90 route), "
            "mxnet_tpu_torch/csrc/int8_conv.cu (mma route)",
            "mxnet_tpu/ndarray/ops_quant.py:341 (not a TPU kernel: "
            "lax.conv_general_dilated, int32)", int8_resnet["n2_launches"],
            0.0, quant_k["per_forward"],
            f"resnet50_v1 batch {QUANT_CALIB_B} 224 x 224, 53 int8 "
            "convolutions NCHW/OIHW -> int32", smi, not_a_tpu_kernel=True,
            library_calls="cuDNN float32 convolution of the codes in "
            "cudnn_fp32(); torch._int_mm on an explicit im2col",
            library_int_mm_ms=quant_k["per_forward"]["library_int_mm_ms"],
            mma_ms=quant_k["per_forward"]["mma_ms"],
            sm90_ms=quant_k["per_forward"]["sm90_ms"],
            routes=quant_k["per_forward"]["routes"],
            launches_by_route={
                "sm90": int8_resnet["n2_sm90_launches"],
                "mma": int8_resnet["n2_launches"]
                - int8_resnet["n2_sm90_launches"]},
            by_shape=quant_k["by_shape"],
            checked_shapes=quant_k["checked_shapes"],
            sm90_checks=quant_k["sm90"],
            launches_by_path={"resnet50_int8_predict":
                              int8_resnet["n2_launches"]}),
        # the sm90 route's layout copies (x to NHWC, w to OHWI, one launch
        # per convolution), timed at the 52 convolutions of a forward that
        # take the sm90 route; its library call is torch's channels-last
        # copy of x and OHWI copy of w
        kernel_entry(
            NHWC_KERNEL, "mxnet_tpu_torch/csrc/int8_conv_sm90.cu",
            "mxnet_tpu/ndarray/ops_quant.py:341 (not a TPU kernel: the "
            "layout of N2's sm90 route)", int8_resnet["nhwc_launches"], 0.0,
            {"ms": quant_k["nhwc"]["nhwc_ms"],
             "plain_ms": quant_k["nhwc"]["nhwc_plain_ms"],
             "bound_ms": quant_k["nhwc"]["nhwc_bound_ms"],
             "bound_by": "bytes",
             "library_ms": quant_k["nhwc"]["nhwc_library_ms"]},
            f"the {quant_k['nhwc']['copies']} sm90 convolutions of a "
            f"resnet50_v1 forward at batch {QUANT_CALIB_B}", smi,
            not_a_tpu_kernel=True,
            library_calls="x.contiguous(memory_format=torch.channels_last)"
            ", w.permute(0, 2, 3, 1).contiguous()",
            launches_by_path={"resnet50_int8_predict":
                              int8_resnet["nhwc_launches"]}),
    ]
    if records["decode"]["decoder"] == "nvjpeg":
        # not TPU kernels: the resize, crop and mirror of the JAX
        # package's host decode (native/recordio.cc decode_one), on the
        # card after nvJPEG's full-size decode; copy_kernel takes the
        # crops with no resize, scaled_kernel the others
        crop = records["decode"]["kernel"]
        scaled = records["decode"]["scaled_kernel"]
        resized = records["iter"]["resize"]
        replaces = ("native/recordio.cc:89 (not a TPU kernel: decode_one's "
                    "resize-short, crop and mirror on the host)")
        kernels.append(kernel_entry(
            jpk.KERNEL, "mxnet_tpu_torch/csrc/jpeg_decode.cu", replaces,
            records["train"]["jpeg_crop_launches"], crop["max_abs_err"],
            crop, crop["shape"], smi, not_a_tpu_kernel=True,
            library_calls="torch.take(src, index), the index of every "
            "output byte made outside its timing",
            vs_python_twin=records["decode"]["vs_python_twin"],
            turns_ms=crop["turns_ms"], bound_share=crop["bound_share"],
            copy_ms=crop["copy_ms"],
            nvjpeg_decode_ms=records["decode"]["nvjpeg_decode_ms"],
            decode_batch_ms=records["decode"]["decode_batch_ms"],
            launches_by_path={
                "resnet50_record_fed": records["train"]["jpeg_crop_launches"],
                "image_record_iter_resize": resized["jpeg_crop_launches"]}))
        kernels.append(kernel_entry(
            jpk.SCALED_KERNEL, "mxnet_tpu_torch/csrc/jpeg_decode.cu",
            replaces, resized["jpeg_crop_scaled_launches"],
            scaled["max_abs_err"], scaled, scaled["shape"], smi,
            not_a_tpu_kernel=True,
            library_calls="none: no PyTorch call computes decode_one's "
            "block means and bilinear taps with its float32 rounding",
            turns_ms=scaled["turns_ms"], bound_share=scaled["bound_share"],
            launches_by_path={
                "image_record_iter_resize":
                    resized["jpeg_crop_scaled_launches"],
                "resnet50_record_fed":
                    records["train"]["jpeg_crop_scaled_launches"]}))
    print("int8 quantization: " + json.dumps({
        "resnet50_v1": int8_resnet, "quantize_net": block_swap,
        "kv_int8_decode": kv_int8, "batch_dot_routes": quant_k["batch_dot"],
        "dequant_gap_k4608": quant_k["dequant_gap_k4608"],
        "ops_worst": quant_k["ops_worst"]}))
    phase("73 report")
    print(f"bf16 ResNet-50 headline layout: {head}")
    print("hybridized: " + json.dumps({
        "resnet50_bf16_nhwc_step_ms": [resnet_hyb[False]["mean_step_ms"],
                                       resnet_hyb[True]["mean_step_ms"]],
        "lm_bf16_step_ms": [lm_hyb[False]["mean_step_ms"],
                            lm_hyb[True]["mean_step_ms"]],
        "fed_step_ms": fed["mean_step_ms"],
        "fed_prefetch_stall_s_per_step": fed["prefetch_stall_s_per_step"]}))
    print("symbolic training: " + json.dumps({
        "mlp_step_ms": mlp["metric"]["step_ms"],
        "mlp_step_ms_no_metric": mlp["no_metric"]["step_ms"],
        "mlp_val_acc": [mlp["metric"]["val_acc_before"],
                        mlp["metric"]["val_acc_after"]],
        "word_lm_step_ms": {"eager": wlm["eager"]["step_ms"],
                            "captured": wlm["captured"]["step_ms"],
                            "eager_no_metric":
                                wlm["eager"]["no_metric_step_ms"],
                            "captured_no_metric":
                                wlm["captured"]["no_metric_step_ms"],
                            "gluon_hybridized": gluon_wlm["step_ms"]},
        "word_lm_tokens_per_s": {"eager": wlm["eager"]["tokens_per_s"],
                                 "captured": wlm["captured"]["tokens_per_s"],
                                 "gluon_hybridized":
                                     gluon_wlm["tokens_per_s"]},
        "word_lm_idle_share": {
            k: wlm[k]["profile"]["device_idle_share"]
            for k in ("eager", "captured")},
        "word_lm_peak_gb": {k: wlm[k]["peak_gb"]
                            for k in ("eager", "captured")},
        "word_lm_perplexity": wlm["perplexity"],
        "rnn_fwd_bwd_ms": wlm["rnn_fwd_bwd_ms"],
        "bucketing_batches": bucketing["batches_per_bucket"]}))
    print("NDArray and op surface: " + json.dumps({
        "hand_step_ms": hand["hand_step_ms"],
        "trainer_step_ms": hand["trainer_step_ms"],
        "hand_vs_trainer": hand["hand_vs_trainer"],
        "sweep_cases": sweep["cases"], "captured": sweep["captured"],
        "opperf_fwd_ms": {r["op"]: r["fwd_ms"] for r in sweep["opperf"]}}))
    print("Gluon surface and vision zoo: " + json.dumps({
        "zoo": {k: {c: v[c] for c in ("trainable_parameters", "step_ms",
                                      "img_per_s", "peak_gb")}
                for k, v in zoo.items()},
        "zoo_cpu_deviation": {k: v["cpu_deviation"]["logits"]
                              for k, v in zoo.items()},
        "vgg16_step_ms": vgg["mean_step_ms"],
        "vgg16_img_per_s": vgg["img_per_s"],
        "vgg16_idle_share": vgg["profile"]["device_idle_share"],
        "vgg16_peak_gb": vgg["peak_gb"],
        "vgg16_eval_loss": vgg["eval_loss"],
        "lamb_optimizer_ms": lamb["lamb"]["optimizer_ms"],
        "fused_sgd_optimizer_ms": lamb["sgd"]["optimizer_ms"],
        "optim_tail_worst": max(optim_tail["optimizers"].values()),
        "mf_mse": [twins["mf"]["first_mse"], twins["mf"]["last_mse"]],
        "gan_mean_radius": twins["gan"]["mean_radius"]}))
    print("SSD300-VGG16: " + json.dumps({
        "trainable_parameters": ssd["trainable_parameters"],
        "step_ms": ssd["mean_step_ms"], "img_per_s": ssd["img_per_s"],
        "idle_share": ssd["profile"]["device_idle_share"],
        "peak_gb": ssd["peak_gb"],
        "multibox_target_ms": ssd["multibox_target_ms"],
        "loss_ms": ssd["loss_ms"], "losses": [ssd["first_loss"],
                                              ssd["last_loss"]],
        "cpu_deviation": ssd["cpu_deviation"],
        "detection_head_ms": ssd_det["detection_head_ms"],
        "detection_with_forward_ms": ssd_det["detection_with_forward_ms"],
        "detections_per_image": ssd_det["detections_per_image"],
        "uncapped_detection": ssd_det["uncapped"],
        "n1_routes": ssd_det["routes"],
        "detection_ops_worst": max(det_ops["ops"].values()),
        "toy_loss": [ssd_toy["first_loss"], ssd_toy["final_loss"]]}))
    print("dist_sync data parallelism: " + json.dumps({
        "card": smi,
        "gloo_two_ranks": [{k: line[k] for k in (
            "rank", "mean_step_ms", "img_per_s", "mean_allreduce_ms",
            "grad_bytes_per_step", "buckets_in_backward", "peak_gb",
            "k4_launches_per_step")} for line in dist2],
        "nccl_one_rank": {k: dist1[k] for k in (
            "mean_step_ms", "img_per_s", "mean_allreduce_ms", "peak_gb")},
        "bandwidth_gbps": {
            "gloo": [(b["size"], b["allreduce_gbps"], b["kvstore_gbps"])
                     for b in dist2[0]["bandwidth"]],
            "nccl": [(b["size"], b["allreduce_gbps"], b["kvstore_gbps"])
                     for b in dist1["bandwidth"]]}}))
    print("telemetry: " + json.dumps({
        "card": smi,
        "decode_tokens_per_s":
            traced_dec["phase18_traffic"]["tokens_per_s"],
        "decode_level1_cost_resolved":
            traced_dec["phase18_traffic"]["level1_cost_resolved"],
        "decode_traced_spans": traced_dec["traced_traffic"]["spans"],
        "decode_device_trace_events": traced_dec["device_trace_events"],
        "kineto_names_kernels_inside_graphs":
            traced_dec["kineto_names_kernels_inside_graphs"],
        "resnet_median_step_ms": traced_res["median_step_ms"],
        "resnet_device_trace_events": traced_res["device_trace_events"]}))
    print("deployment chain: " + json.dumps({
        "card": smi,
        "autotune_winners": {k: tuned[k]["winner"] for k in (
            "quantize.lowering", "fusion.attn_compute_bound_seq")},
        "bundle_bytes": deploy["bundle_bytes"],
        "cold_ready_s": deploy["cold_ready_s"],
        "bundle_warm_ready_s": deploy["warm_ready_s"],
        "fleet_tokens_per_s": fleet_res["tokens_per_s_router"],
        "single_process_tokens_per_s":
            fleet_res["phase18_tokens_per_s_single_process"],
        "drain_s": fleet_res["drain"]["seconds"]}))
    print("host runtime and records: " + json.dumps({
        "card": smi, "decoder": records["decode"]["decoder"],
        "push_us": [records["engine"]["push_us_native"],
                    records["engine"]["push_us_naive"]],
        "iter_images_per_s": records["iter"]["images_per_s"],
        "iter_images_per_s_per_core":
            records["iter"]["images_per_s_per_core"],
        "record_fed_step_ms": records["train"]["step_ms"],
        "record_fed_images_per_s": records["train"]["images_per_s"],
        "record_fed_idle_share": records["train"]["idle_share"],
        "device_fed_step_ms": records["train"]["device_fed_step_ms"],
        "device_fed_idle_share": records["train"]["idle_share_device_fed"],
        "losses": records["train"]["losses"]}))
    print("linalg, image and the contrib tail: " + json.dumps({
        "card": smi, "ops_cases": tail["ops"]["cases"],
        "ops_captured": tail["ops"]["captured"],
        "detector_ops_ms": {k: [v["ms"], v.get("fwd_bwd_ms")]
                            for k, v in tail["detector"]["ops"].items()},
        "det_iter_step_ms": tail["det_iter"]["step_ms"],
        "det_iter_images_per_s": tail["det_iter"]["images_per_s"],
        "det_iter_idle_share": tail["det_iter"]["idle_share"],
        "device_fed_step_ms": tail["det_iter"]["device_fed_step_ms"]}))
    print("sparse storage types: " + json.dumps({
        "card": smi, "parse_rows_per_s": sparse["parse"]["rows_per_s"],
        "legs": {k: {f: v[f] for f in (
            "ms_per_step", "rows_per_s", "idle_share", "largest_stage",
            "unique_rows_per_batch", "peak_device_gb", "leg_peak_gb")}
            for k, v in sparse["legs"].items()},
        "dgl_card_s": sparse["dgl"]["card_graph_s"]}))
    print("interchange and Fit: " + json.dumps({
        "card": smi,
        "fit_median_step_ms": interchange["fit"]["fit_median_step_ms"],
        "hand_median_step_ms": interchange["fit"]["hand_median_step_ms"],
        "fit_bitwise_hand_loop": interchange["fit"]["bitwise"],
        "onnx_bytes": interchange["export"]["onnx_bytes"],
        "export_s": interchange["export"]["export_s"],
        "import_to_gluon_s": interchange["import"]["import_to_gluon_s"],
        "imported_predict_ms": interchange["import"]["imported_predict_ms"],
        "zoo_predict_ms": interchange["import"]["zoo_predict_ms"],
        "import_max_abs_err": interchange["import"]["max_abs_err"],
        "store_bitwise": interchange["store"]["bitwise"]}))
    print(f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
