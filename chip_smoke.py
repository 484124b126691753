#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, torch, numpy and the stdlib, and builds the port's kernels from the
sources under ``tennis_torch/csrc``. Phases, one line each:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: ``nvcc`` of every kernel, all started together, with each one's
   time and ptxas report, and beside them the native host libraries
   (``tennis_torch/native``, the system ``c++``) into ``tennis_torch/build``;
3. kernel vs plain version: the three dense-layer kernels (persistent for
   the large maps, cluster split-K for the small ones, tile) against
   ``dense_layer_reference`` in bf16 at the first and last layer shape of
   each DenseNet121-512 block (batch 8), two more 64^2 shapes (the last c_in
   with w1 resident in the persistent kernel and the first with w1
   streamed), ragged 7x7 and 14x14 maps, batch 1, DenseNet201's c_in 1888
   and a c_in whose units do not divide by the cluster size; the cluster
   kernel at every cluster size; device times of each, which one the wrapper
   chooses, times of the plain version and of the two cuDNN convolutions of
   the layer (the library yardstick). Then ``[route]``: every small-map
   layer shape of DenseNet121/169/201 at 512^2 (c_in in steps of 64) and
   the ragged maps, at batch 1 and 8, each kernel and cluster size timed by
   device time in three rounds of alternating order, the fastest beside the
   wrapper's route, and the same for DenseNet121's 32^2, 16^2 and 7x7
   maps at batch 64. Then the whole 58-layer stack of one batch-8 forward,
   every layer through every kernel against the plain version, and block by
   block: the wrapper's choice, each kernel alone, the plain version and
   cuDNN; and the stack at batch 64 (``[stack64]``), every layer through
   the route's kernel against the plain version, block by block beside
   cuDNN and the bytes bound;
4. classifier path: ``FrameModel(DenseNet121)`` at 512^2 with seeded random
   weights in flax naming, loaded through ``bridge.load_flax``, served by
   ``serve.make_service``: 16 concurrent frames through its ``Batcher``,
   ``GET /healthz`` over HTTP, probabilities checked, 58 kernel launches per
   batch split between the kernels as the wrapper's route names them,
   batch-8 logits against the plain-version forward;
4b. extraction (``[extract]``): ``train.save_features`` over an in-memory
   split of 32 x 64 + 37 frames at 512^2 (256 distinct seeded frames; no
   JPEG is decoded, the card machine may lack cv2), through ``DataLoader``,
   the pinned ``prefetch_to_device`` and the kernels to .npy files: 2085
   files of f32 (4096,), 58 launches a batch split as the route names them
   for batch 64 and 37, the first and the ragged batch against the
   plain-version features; frames/s, device busy and idle share, the
   prefetch and writer stats, peak memory. ``[evaluate]``: the same split
   through ``eval_iter`` and the metric set, PRF1 against the plain
   version's, frames/s; the ``--temp_pool mean`` wrap through the backbone
   at 2 clips x 8 frames (58 launches, one forward);
4c. training (``[train]``, run after phase 7): ``FrameModel(DenseNet121,
   11)`` at 512^2 and
   batch 64 over 256 seeded in-memory uint8 frames, through
   ``make_train_step``: ``apply_augment``, the bf16 train-mode forward and
   backward (plain torch ops and cuDNN, as the JAX package trains through
   its flax module), momentum SGD. With ``remat`` none and block: 3
   warm-up and 3 timed steps each (step ms, samples/s, device busy and
   idle share over 2 profiled steps, the largest kernels, peak memory,
   model FLOPs and ``mfu`` against the dense bf16 peak). Gates: every loss
   finite; 30 steps on one repeated batch lower the loss; the first bf16
   step against the same step in f32 (TF32 off) at batch 16: the loss, the
   running statistics and the update; remat block gives the first-step
   loss of none and a lower peak. ``[train_driver]``: ``train.fit`` over
   in-memory train (256 frames), val and test (64 + 37 each) splits for 2
   epochs of 3 batches into a temporary experiment: ``0000.params``,
   ``0001.params`` and ``scores.txt`` written and read back bit for bit as
   saved, momentum included; each evaluation (2 val passes and the final
   test) 58 dense launches a forward split by the route, its first batch's
   logits against the plain-version forward of a model loaded with that
   epoch's weights, and (val) nearer them than those of the weights before
   (lr 0.01, so a stale BN fold would show); the final test on the best
   epoch's weights; resuming
   from ``0000.params`` and taking epoch 1's first step gives the
   uninterrupted run's parameters;
4d. raw video (``[predict]``, run last, after phase 7d): ``predict.predict``
   past the decoder, the 0006 ``FrameModel(DenseNet121, 11)`` at 512^2 with
   seeded random weights written by the port's checkpoint writer into a
   temporary experiment
   (``scores.txt``, ``classes.names``), over a video of 1000 seeded 544x968
   frames (40 distinct; a short side of 512 + 32, so the test geometry is
   the centre crop and needs no cv2) at ``--every 2`` and ``--batch_size
   64``: 500 rows, 7 batches of 64 and one of 52 edge-padded to 64; gates:
   ``frames.txt`` 0, 2, ..., 998, rows summing to 1, 58 dense launches a
   batch split as the route names them for batch 64, no GRU launch, the
   first and the ragged batch within 1e-2 of the plain-version forward,
   ``events.tsv`` the ``label_runs`` of the argmax tiling [0, 998];
   frames/s, device busy and idle share over 4 batches of ``classify``, the
   prefetch stats, peak memory. ``[flownet]``: FlowNet-S in bf16 through
   ``FlowRunner.flow_batch`` (uint8 upload, normalisation on the device,
   cuDNN) at 8 pairs of seeded 720p frames cropped to 1280x704, seeded
   random weights in flax naming through the bridge: 3 warm-up and 10
   timed calls (pairs/s, device busy and idle share, the largest kernels,
   peak memory, ``FlopCounterMode`` FLOPs and ``mfu``); gates: flow (8,
   176, 320, 2) finite and within 3e-2 of max |f32 flow| of the same module
   in f32 (TF32 off), the ``train=True`` pyramid's shapes, a (176, 320, 3)
   uint8 ``flow_to_image``, no dense-layer or GRU kernel launched;
4e. the exported programs (last, after ``[flownet]``). ``[export]``: the
   0006 ``FrameModel(DenseNet121, 11)`` at 512^2 with seeded random weights
   written by the port's checkpoint writer into a temporary experiment,
   through ``tennis_torch.export.export_classifier`` at batch 8 on the card
   and ``save_exported``; gates: the graph holds 58
   ``tennis_torch.dense_layer`` nodes naming the route's kernels and no
   ``auto_functionalized`` node; a fresh ``python -c`` loads the artifact,
   imports neither ``tennis_torch.models`` nor ``tennis_torch.inference``
   and launches the routed kernels; 16 requests through ``serve
   --from_export``'s ``build_service`` (the sidecar's batch 8 over the
   flag's 2) take 58 launches a batch split as routed; the exported
   probabilities within 1e-5 of the live ``make_predict_probs``, and their
   centred logarithms within 5e-2 of the plain-version forward's centred
   logits (same top-1); export seconds, artifact bytes, the batch-8
   latency exported against live (medians of 10, alternating).
   ``[export_caption]``: the 0102 captioner with seeded random weights as
   ``valid_best.params`` over a caption index written to disk, through
   ``export_captioner`` at batch 4, ``--src_max_len 128``, with
   ``--pallas_gru`` (gates: 3 ``tennis_torch.gru_recurrence`` nodes, 3
   GRU-kernel launches a batch by the routed variant, top beams equal to
   the live ``load_captioner`` translator's on 8 seeded sources) and
   without (no GRU node or launch, top beams equal to the live translator
   run with the plain recurrence); ms a batch, exported against live.
   ``[native]``: which native host libraries built here; with libjpeg, a
   seeded 1280x720 JPEG decoded natively and by cv2 at full size (largest
   pixel difference, ms a decode) and a 2160-line one at ``min_short``
   544 (the 1/2 DCT scale); nothing gated;
5. GRU kernels vs plain version: ``gru_recurrence`` against
   ``gru_recurrence_reference`` in f32, the kernels that take the shape
   (``"async"`` at every cluster size that takes it; ``"general"`` where it
   is routed and where it streams Wh; ``"grid"`` where the general one
   streams; ``"barrier"`` at the two 0102 cases), two launches bit for bit,
   at the 0102 serving shape (T 128, batch 4, H 256), the measured
   ``/caption`` lengths 21/30/104/69 (every row ends before T), H 512, the
   evaluate batch (32), the default width (H 128), T 1, a per-epoch decode
   batch of the captioning trainer (batch 32, T 512, lengths 64-512), and at
   the ``/caption`` lengths the widths past the async kernel: H 300, 504,
   640, 737 (the widest the JAX kernel takes at T 128, batch 4), 185 at
   batch 32 and 1020 at T 1 (the grid kernel's at 640, 737 and 1020); device
   times of each (the profiler's, and beside them ``event_device_ms``: CUDA
   events around one call queued behind a spinning stream, the clock a trace
   falls back to where every profiler session dropped its kernels), which
   one the route takes, times of the plain version, the port's whole layer
   (input GEMM + kernel) and cuDNN's ``nn.GRU`` over the same layer (CUDA
   events around back-to-back calls, and where the general or grid kernel is
   routed also around one call queued behind a spin: device time), the
   bound, and the serial floors: T cluster-barrier round trips for the
   barrier kernel, one ``st.async`` + mbarrier round trip of the kernel's
   own exchange per live step for the async and general ones, one exchange
   through L2 among the grid plan's CTAs per live step for the grid one (its
   own probe), and for the general one its streamed bytes a live step over
   one SM's share of the card's L2 read rate. ``[wide_decode]``: a
   0102-shaped decode (batch 4 over 128 frames at the ``/caption`` lengths)
   at ``--num_hidden`` 640 and 300 through ``BeamSearchTranslator``: 3
   launches each of the kernel the route names (grid at 640, general at
   300), no plain-routed layer, the samples of the plain decode exactly;
6. caption path: the 0102 captioner (features 4096, H 256, 2 layers, 1
   bidirectional, E 100, V 254) with seeded random weights in flax naming,
   served by ``make_service``: 8 concurrent ``POST /caption`` over HTTP at
   ``--caption_batch_size 4``, ``--src_max_len 128``, beam 4, max length 70;
   3 GRU-kernel launches per batch by the routed variant, the kernel-path
   encoder against the
   plain-version encoder, and the kernel path's top beams rescored
   teacher-forced through the plain-encoded decoder; latency split into
   encode and decode loop, device busy and idle share;
6b. captioner training (``[caption_train]``): the same captioner with
   dropout 0.2, Adam 1e-3 and clip 5 over an in-memory train split of 512
   points (64-512 frames of seeded 4096-d features, captions of 8-50 ids),
   through ``make_seq2seq_train_step`` at ``--batch_size 128``: 3 warm-up
   and 3 timed steps over the bucketed batches (step ms, target tokens/s,
   source frames/s, device busy and idle share and launches over 2 profiled
   steps, the largest kernels, peak memory). Gates: every loss finite; 30
   steps on one batch lower the loss; the first step's loss (1e-4 relative)
   and gradients (1e-3 global relative L2) at dropout 0 against the CPU's;
   the differentiable recurrence against the GRU kernel within 1e-4; no
   GRU kernel launch in a train step. ``[caption_driver]``:
   ``train_gnmt.train`` for 2 epochs over that split and val and test splits
   of 96 points at ``--test_batch_size 32``, a resumed run to 3 epochs and
   ``evaluate_gnmt.evaluate --force --metrics_out``, with EOS biased far
   down so that every decode runs the max length of 70 steps: 3 GRU kernel
   launches a decode batch by the routed variant, the first evaluation's
   encoder
   outputs within 1e-4 of the plain version, the epoch files read back bit
   for bit, the resumed run's rate the saved one with one decay after it,
   the evaluator's ``best_test_out.txt`` byte for byte the trainer's, the 7
   metrics in range; decode ms (a batch and a step), a decode's device
   idle share, wall per epoch;
7. DenseNet161 path: ``FrameModel(DenseNet161)`` at 224^2 with seeded
   random weights, its batch-2 warm-up forward through ``make_service``:
   78 dense layers through ``dense_layer_convs`` (widths no TPU kernel
   computes), no dense-kernel launch, logits against the plain-version
   forward;
7b. the temporal and two-stream models (after ``[train_driver]``), each
   built by ``train.build_model`` from the driver's flags with seeded
   random weights in flax naming: ``[cnnrnn_train]``, the 0042 CNN-RNN's
   train step at its published configuration ((64, 30, 4096) features on
   the device, bi-GRU 128 in bf16, SGD): 3 warm-up and 3 timed steps
   (windows/s, device busy and idle share and launches over 2 profiled
   steps, the largest kernels, peak memory), then the LSTM cell (10 timed);
   gates: finite losses, 30 steps on one batch lower the loss, the first
   f32 step on the card against the CPU (loss 1e-5 relative, gradients
   1e-4 global relative L2), no dense-layer or GRU kernel launch in a step.
   ``[cnnrnn_driver]``: ``train.fit`` over in-memory windowed-feature splits
   (train 256, val and test 64 + 37) for 2 epochs of 3 batches, a copy of
   its epoch 0 resumed to 2 epochs, ``evaluate --metrics_out``; gates: the
   epoch files and ``scores.txt`` read back bit for bit as saved, the
   resumed epoch file byte for byte the uninterrupted one, the evaluator's
   PRF1 the trainer's final test's. ``[two_stream]``: the 0010 net
   (``--flow twos``, two DenseNet121 streams) at 512^2, batch 64,
   ``--remat block``, over 256 seeded 6-channel frames on the device: 3
   warm-up and 3 timed steps (samples/s, ``mfu`` of both streams, idle
   share, launches a step, peak memory); ``--flow only`` and ``sixc`` 3
   steps each; after each an evaluation forward at batch 64: 116 (twos) or
   58 dense launches split as the route names them, logits within 5e-2 of
   the plain-version forward (``plain_dense_layers``). ``[cnnrnn_clips]``:
   the CNN-RNN over ``FrameModel(DenseNet121)`` at 512^2, window 30, batch
   2 (60 frames a forward), remat block, ``--freeze_backbone`` off and on, 3
   warm-up and 5 timed steps each (clips/s, peak memory); gates: frozen,
   the backbone's parameters unchanged bit for bit while its BN statistics
   move; an evaluation forward of 58 dense launches at batch 60 against
   the plain version. Each prints its wall time;
7c. ResNet-v2 and R(2+1)D (last), with seeded random weights in flax
   naming: no dense-layer or GRU kernel is on these paths (the JAX package
   runs them through XLA convolutions; here cuDNN's), and every part gates
   that none was launched. ``[resnet_train]``: the drivers' default
   ``FrameModel(resnet18_v2, 11)`` at 512^2, batch 64, over the train
   phase's frames through the driver's step (device augment, bf16, SGD): 3
   warm-up and 3 timed steps (samples/s, idle share, launches, the largest
   kernels, peak memory, model FLOPs counted by ``FlopCounterMode`` and
   ``mfu``), then ``resnet50_v2`` for 3 steps; gates: finite losses, 30
   steps on one batch lower the loss, the first bf16 step against f32 and
   f64 at batch 16. ``[resnet_driver]``: ``train.fit`` (2 epochs of 3 batches), a
   copy of epoch 0 resumed, ``evaluate --metrics_out`` (the epoch files
   read back bit for bit, the resumed epoch within 2e-2 of the
   uninterrupted one, the evaluation's PRF1 the final test's);
   ``save_features`` (512-d); 16 frames through ``make_service`` at batch 8
   (batch-8 logits against the same model in f32 on the CPU); two-stream,
   ``only`` and ``sixc`` 3 steps each; the CNN-RNN over the dumped
   features 3 steps. ``[r21d_train]``: 0031 at 8 x 224^2, batch 64 with
   ``--remat block`` and 32 without, 3 warm-up and 3 timed steps each
   (clips/s, the same fields), window 32 at batch 16 for 3; gates: finite
   losses, 30 steps on one batch of 8 lower the loss, ``init_bn``'s
   statistics bit for bit unchanged and every other BN's moved, the first
   bf16 step against f32 and f64 at batch 4 (its update logged by stage),
   the stem and three blocks in bf16 against f32 one at a time at that
   batch, remat block's first-step loss and gradients those of remat none. ``[r21d_driver]``: ``train.fit`` at
   batch 8 over in-memory clip splits (32 train, 21 val and test), a resume
   and ``evaluate``, with ``[resnet_driver]``'s gates;
7d. the pixels-path captioner and SkipGram (last). ``[kernel_f32]``: the
   f32 dense-layer kernel (``"f32"``, 3xTF32 on the tensor cores) against
   ``dense_layer_reference`` in f32 and against its function in f64 at the
   first and last layer shape of each DenseNet121-512 block at batch 2, a
   ragged 7x7 map and batch 1 (gates: max |kernel - plain| within 1e-4 of
   max |plain|, the other channels untouched, max |kernel - f64| within
   1e-5 of max |f64|; the same measure logged for the plain version), the
   kernel's device time beside the plain version's and cuDNN's two
   convolutions in f32 (TF32 off), the 3xTF32 bound (three TF32 products a
   multiply-add at 495 TFLOP/s); and ``[stack_f32]``: the 58 layers of one
   forward at batch 2 and at the 64 frames of a decode batch, block by
   block, against the plain version, the same figures. ``[skipgram]``:
   ``train_embeddings.train`` for an epoch over a seeded corpus of 250
   words and ~10k sentences with ``--add_extra`` (pairs/s as the log's "wps", the loss over the epoch;
   gates: finite and falling); its ``embeddings-ex.txt`` is the
   ``--emb_file`` of ``[pixcap_driver]``. ``[pixcap_train]``: the 0102
   widths with an f32 DenseNet121 ``src_embed`` at 512^2, ``--remat
   block``, over seeded in-memory uint8 points (batch 2 x 32 frames,
   captions of 8-50 ids): 3 warm-up and 3 timed steps, frozen and not
   (step ms, frames/s, target tokens/s, device busy and idle share, the
   largest kernels, peak memory); gates: finite losses, 30 steps on one
   point of 8 frames lower the loss, the first step at that size against
   the same step with the backbone in f64 (loss, statistics, update),
   frozen ``src_embed`` unchanged bit for bit while its statistics move, no
   dense-layer kernel launched in a step. ``[pixcap_driver]``:
   ``train_gnmt.train`` for an epoch over in-memory uint8 splits with a
   donor DenseNet121 epoch in the classifier trainer's layout,
   ``--backbone_from_id``, ``--freeze_backbone``, its val and test decodes,
   then ``evaluate_gnmt``: 58 launches of the f32 kernel an eval forward,
   3 GRU launches a decode batch, the first decode batch's encoder output
   within 1e-4 of the plain-version forward, the epoch files read back bit for
   bit; decode ms a batch and a step, a decode's idle share;
7e. ``[ddp]`` (before ``[predict]``): data parallelism in a process group
   of one rank, NCCL on cuda:0, through a TCP store on 127.0.0.1 at a free
   port: 2 DenseNet121-512 train steps at batch 8 through the
   data-parallel step (in the group: BN sums and gradients all-reduced) against
   the same steps without a group (the first loss, the parameters against
   a second plain run's spread: ``DDP_*``), 3 more of each timed, the NCCL
   kernels' device ms and the bytes all-reduced a step; one
   ``sharded_eval_iter`` forward of 8
   frames (58 dense launches, the probabilities of ``eval_iter``
   exactly); a 0102-shaped decode (batch 4 over 128 frames, the sentences
   gathered through the group) at ``--num_hidden`` 1024, where no kernel
   takes H and ``gru_decode_route`` names the plain recurrence (no GRU
   launch, 3 layers counted in ``plain_routed``, the samples of the plain
   decode exactly), and at 256 (3 GRU launches); then ``[tp]``, the model
   axis through the same group at a model axis of 1 (``make_mesh(1, 1)``):
   the 0102 captioner's train step (batch 8 over 64 frames) through the
   state the sharding rule places, bit for bit the same step without a
   group; its batch-4 decode over 128 frames at the ``/caption`` lengths
   with the memory sequence-sharded (the attention's MAX and SUM
   combines over the one-rank model group) and the 11 kernels the rule
   shards at a model axis of 2 placed as 1-of-1 blocks (column-parallel,
   Wh gathered before the GRU kernel): 3 async GRU launches and no other,
   the plain decode's samples and lengths, scores within 1e-5 relative;
   the rule's sharded leaves at model axes 2 and 4 (11 each);
   then the group is destroyed;
7f. ``[pretrained]`` (after ``[ddp]``, before ``[predict]``; no trace):
   the weight converter and ``--pretrained_npz``. A seeded
   torchvision-schema DenseNet121 state dict written with ``torch.save``
   and converted through ``python -m tennis_torch.models.convert``'s
   ``main``, loaded by ``train.load_pretrained_backbone`` into the 0006
   ``FrameModel(DenseNet121, 11)`` of ``train.build_model`` at 512^2 on the
   card: every mapped backbone tensor equal to its source tensor bit for
   bit (OIHW conv weights, BN weight, bias and running statistics under
   the port's names); one eval forward at batch 8 making the route's dense
   launches (58: 42 persistent, 16 cluster) with its logits within 5e-2
   of the plain-version forward. The same file through
   ``train_gnmt.load_pretrained_src_embed`` into the pixels-path
   captioner's f32 ``src_embed``: one eval forward of 2 frames, 58 f32
   launches, within 1e-4 of the plain f32 forward. A seeded FlowNet2-S
   state dict converted the same way and opened by
   ``FlowRunner(params_path=*.npz)``: every weight equal to the source's
   (the transposed convolutions' flip and flip back included), and the
   flow of 2 pairs of 1280x704 within 1e-5 of a ``FlowNetS`` given the
   source weights by a direct copy in torch's layout (neither converter
   nor bridge); the phase's seconds;
8. ``{"kernels": [...]}``, then the card line, then ``{"ok": true, ...}``.

Any failure exits nonzero before the last line. Without a GPU, or without
the repo beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores
KERNEL_TOL = 1e-2         # max |kernel - plain| / max |plain|, bf16 state
LOGIT_TOL = 5e-2          # same measure on batch-8 logits after 120 layers
GRU_TOL = 1e-4            # max |kernel - plain|, f32, another summation order
RESCORE_TOL = 1e-3        # |reported - rescored| penalized log-prob of a beam
DATA_SHAPE = 512
BATCH = 8
N_REQUESTS = 16
SEED = 0
KERNELS = ["dense_layer", "dense_layer_persistent", "dense_layer_cluster",
           "dense_layer_f32_tc", "gru_recurrence",
           "gru_recurrence_async", "gru_recurrence_general",
           "gru_recurrence_grid"]
# profiler name of each dense-layer kernel variant (no name holds another);
# the cluster kernel's name also carries its cluster size, <2>, <4> or <8>
DENSE_KERNELS = {"persistent": "dense_layer_persistent_kernel",
                 "tile": "dense_layer_kernel",
                 "cluster": "dense_layer_cluster_kernel",
                 "f32": "dense_layer_f32_tc_kernel"}
# profiler name of each GRU kernel variant (no name holds another)
GRU_KERNELS = {"barrier": "gru_recurrence_kernel",
               "async": "gru_recurrence_async_kernel",
               "general": "gru_recurrence_general_kernel",
               "grid": "gru_recurrence_grid_kernel"}
ROUTE_ROUNDS = 3
# profiler sessions tried before a trace that dropped kernel records fails
# the run (three in a row did, once in a dozen runs), or, where all of them
# recorded none of its kernels, is timed by CUDA events (kernel_device)
TRACE_ATTEMPTS = 6
ROUTE_REPS = 3

# the 0102 captioner (README, train_gnmt flags): 0006 features, 2 GRU layers
# of 256 (the first bidirectional), embeddings of 100, 4 specials + 250 words
FEAT_DIM = 4096
CAPTION_ARGV = ["--feats_model=0006", "--num_hidden=256", "--num_layers=2",
                "--num_bi_layers=1", "--emb_size=100", "--cell_type=gru"]
VOCAB_WORDS = 250
SRC_MAX_LEN = 128
CAPTION_BATCH = 4
N_CAPTIONS = 8
# the captioner's training and per-epoch evaluation (train_gnmt defaults):
# in-memory splits of 512 / 96 / 96 points, sources of 64-512 frames and
# captions of 8-50 ids (BOS and EOS included), both uniform; features drawn
# from (SEED, split, point). The card-vs-CPU gradient check at dropout 0
# takes CAP_CPU_ROWS rows of the shortest train batch.
CAP_POINTS = {"train": 512, "val": 96, "test": 96}
CAP_SRC_LEN, CAP_IDS_LEN = (64, 512), (8, 50)
CAP_TRAIN_ARGV = CAPTION_ARGV + [
    "--batch_size=128", "--test_batch_size=32", "--dropout=0.2",
    "--optimizer=adam", "--lr=0.001", "--clip=5", "--emb_file=",
    "--device=cuda"]
CAP_WARMUP, CAP_TIMED, CAP_PROFILED = 3, 3, 2
CAP_CPU_ROWS = 16
# the driver's EOS logit bias: far enough below every word's that its 12
# Adam steps at 1e-3 cannot lift EOS into a beam, so every decode runs the
# translator's max length (--tgt_max_len + 20), as /caption's decodes do on
# random weights
CAP_EOS_BIAS = -100.0
CAP_LOSS_TOL = 1e-4  # |card - CPU| / |CPU| loss, first step, TF32 off
CAP_GRAD_TOL = 1e-3  # global relative L2 of the gradients, same step
# DenseNet161 (bottleneck 192, growth 48) at the 224^2 of its ImageNet config
D161_SHAPE = 224
D161_BATCH = 2
# feature extraction and evaluation: the drivers' default --batch_size over
# an in-memory split of 32 full batches and a ragged one, 256 distinct
# frames indexed modulo; the pooled wrap at batch 2 x window 8
EXTRACT_BATCH = 64
EXTRACT_FRAMES = 32 * EXTRACT_BATCH + 37
EXTRACT_DISTINCT = 256
PROFILE_BATCHES = 4
PREDICT_FRAMES = 1000     # frames of the [predict] video
PREDICT_EVERY = 2
PREDICT_DISTINCT = 40     # distinct 544x968 frames the video cycles through
PROB_TOL = 1e-2           # max |probability - plain forward's|
FLOW_BATCH = 8            # FlowRunner's default batch of pairs
FLOW_WARMUP, FLOW_TIMED = 3, 10
FLOW_TOL = 3e-2           # max |bf16 flow - f32 flow| / max |f32 flow|
EXPORT_TOL = 1e-5         # max |exported probability - live scorer's|
POOL_BATCH, POOL_WINDOW = 2, 8
# training: the driver's --batch_size and default optimizer; the f32
# comparison at a smaller batch, to hold two models' activations at once
TRAIN_BATCH = 64
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED = 3, 3, 2
OVERFIT_STEPS = 30
F32_BATCH = 16
# bf16 against f32, first step (PERF.md, Findings): relative loss, worst
# running statistic over max |f32 statistic|, global relative L2 of the
# update. The update's bound is O(1): at random weights bf16 rounding moves
# the gradients of a deep DenseNet by O(1) in the JAX package too (tests/
# test_torch_train_densenet.py holds the port's gap to the JAX package's)
TRAIN_LOSS_TOL, TRAIN_STATS_TOL, TRAIN_UPDATE_TOL = 2e-2, 5e-2, 1.0
REMAT_LOSS_TOL = 2 ** -7  # one bf16 step, relative
# the driver: 2 epochs of DRIVER_BATCHES steps over DRIVER_TRAIN frames;
# val and test of a full and a ragged batch; a resumed step's parameters
# within RESUME_TOL of the uninterrupted run's, relative to that step's
# own update (global L2; cuDNN's backward sums in a varying order)
DRIVER_TRAIN, DRIVER_EVAL, DRIVER_BATCHES = 256, EXTRACT_BATCH + 37, 3
RESUME_TOL = 2e-2

# the CNN-RNN (0042, README: --feats_model 0006 --temp_pool gru --window
# 30): 4096-d features, a bi-GRU of 128 in bf16, 11 classes, the driver's
# default --batch_size 64 and SGD, over CNNRNN_POOL seeded windows on the
# device; the LSTM cell timed over fewer steps; its first f32 step on the
# card against the CPU (TF32 off): relative loss, global relative L2 of the
# gradients. Over clips: CLIP_BATCH clips of the same window at 512^2.
CNNRNN_ARGV = ["--backbone=DenseNet121", f"--data_shape={DATA_SHAPE}",
               "--feats_model=0006", "--temp_pool=gru", "--window=30"]
CNNRNN_WINDOW, CNNRNN_BATCH, CNNRNN_POOL = 30, 64, 256
CNNRNN_LSTM_TIMED = 10
CNNRNN_LOSS_TOL, CNNRNN_GRAD_TOL = 1e-5, 1e-4
CLIP_BATCH, CLIP_TIMED = 2, 5
# the two-stream net (0010, --flow twos; the JAX package's figure at
# --remat block) over seeded 6-channel frames; --flow only and sixc briefly
TWO_STREAM_FRAMES, TWO_STREAM_TIMED, OTHER_FLOW_STEPS = 256, 3, 3
# ResNet-v2: the drivers' default backbone (resnet18_v2) at 512^2 over the
# train phase's frames and batch, resnet50_v2 briefly. R(2+1)D: the 0031
# row (--backbone rdnet --window 8 --data_shape 224) over R21D_POOL seeded
# clips on the device, batch 64 with --remat block and 32 without (batch 64
# keeps ~55 GiB of bf16 activations for the backward without remat), window
# 32 briefly; the f32 and remat comparisons at R21D_SMALL clips, remat's
# in f32 (TF32 off): relative loss, global relative L2 of the gradients
# (cuDNN's backward sums in a varying order); the driver at batch 8 over
# in-memory clip splits
RESNET_ARGV = [f"--data_shape={DATA_SHAPE}"]
RESNET50_STEPS = 3
R21D_SHAPE, R21D_WINDOW, R21D_POOL = 224, 8, 64
R21D_ARGV = ["--backbone=rdnet", f"--window={R21D_WINDOW}",
             f"--data_shape={R21D_SHAPE}"]
R21D_BATCH_REMAT, R21D_BATCH_NONE, R21D_W32_BATCH, R21D_TIMED = 64, 32, 16, 3
R21D_SMALL, R21D_OVERFIT_BATCH = 4, 8
R21D_REMAT_LOSS_TOL, R21D_REMAT_GRAD_TOL = 1e-5, 1e-3
# the first step's f32 update against the same step in f64 (global relative
# L2 of cuDNN's f32 sums; R(2+1)D 0.057-0.061 at random weights). ResNet-18's
# bf16 update is held against f32 at RESNET_UPDATE_TOL. R(2+1)D's whole bf16
# step is chaotic at random weights in the JAX package too (its train-mode
# forward grows a perturbation ~1.5x a residual block, and every leaf's bf16
# gradient lies ~1.4 off f64; tests/test_torch_r21d.py): its update is logged
# by stage, and its bf16 arithmetic is held piece by piece at the card's
# shapes (stem, stage 1's, 2's and 4's first blocks, each against f32 over
# the same input): output within R21D_PIECE_OUT_TOL of max |f32 output|,
# statistics within TRAIN_STATS_TOL, every gradient leaf (parameters and
# input) within R21D_PIECE_GRAD_TOL relative L2 of f32
F64_UPDATE_TOL, RESNET_UPDATE_TOL = 0.2, 0.5
R21D_PIECE_OUT_TOL, R21D_PIECE_GRAD_TOL = 2e-2, 0.25
R21D_PIECES = ("stem", "stage1_block1", "stage2_block1", "stage4_block1")
R21D_DRIVER_FRAMES, R21D_DRIVER_TRAIN, R21D_DRIVER_EVAL = 64, 32, 21
R21D_DRIVER_BATCH = 8

# the pixels-path captioner: the 0102 widths over an f32 DenseNet121
# src_embed at 512^2 with --remat block (an f32 block-1 state is 16.8 MB a
# frame, so batches of a few points: the JAX defaults of 128 / 32 points of
# hundreds of frames fit no card), seeded uint8 points of PIXCAP_FRAMES
# frames (the second of a batch ragged) and captions of 8-50 ids; the f64
# comparison and the repeated batch at 1 point x PIXCAP_SMALL frames; the
# driver over PIXCAP_POINTS in-memory points drawn from PIXCAP_POOL frames.
# F32_KERNEL_TOL: max |kernel - plain| / max |plain|, f32 sums in another
# order. F32_F64_TOL: max |kernel - f64| / max |f64|, the f64 side the
# plain version's function in f64 (plain f32 and 3xTF32 lie ~1e-6 off, one
# TF32 product a pair ~3e-4). PIXCAP_ENC_TOL: the same measure as
# F32_KERNEL_TOL on an encoder output after 58 f32 layers and the GRUs.
PIXCAP_ARGV = ["--num_hidden=256", "--num_layers=2", "--num_bi_layers=1",
               "--emb_size=100", "--cell_type=gru", "--backbone=DenseNet121",
               f"--data_shape={DATA_SHAPE}", "--remat=block",
               "--optimizer=adam", "--lr=0.001", "--clip=5", "--device=cuda"]
PIXCAP_BATCH, PIXCAP_FRAMES, PIXCAP_SMALL = 2, 32, 8
PIXCAP_WARMUP, PIXCAP_TIMED = 3, 3
PIXCAP_POOL = 64
PIXCAP_POINTS = {"train": 8, "val": 4, "test": 4}
PIXCAP_F64_LOSS_TOL, PIXCAP_F64_STATS_TOL = 1e-4, 1e-3
F32_KERNEL_TOL, F32_F64_TOL, PIXCAP_ENC_TOL = 1e-4, 1e-5, 1e-4
# (name, batch, side, c_in, c_final): first and last layer of each
# DenseNet121-512 block at batch 2 (a decode batch's frames are B x T), a
# ragged 7x7 map (DenseNet at 224^2), batch 1
F32_LAYER_CASES = [
    ("block0_first", 2, 128, 64, 256), ("block0_last", 2, 128, 224, 256),
    ("block1_first", 2, 64, 128, 512), ("block1_last", 2, 64, 480, 512),
    ("block2_first", 2, 32, 256, 1024), ("block2_last", 2, 32, 992, 1024),
    ("block3_first", 2, 16, 512, 1024), ("block3_last", 2, 16, 992, 1024),
    ("ragged_7x7", 2, 7, 512, 1024), ("batch1", 1, 128, 64, 256),
]
# the 58-layer stack at the frames of one decode batch of [pixcap_driver]
# (the kernels line's figures) and at F32_LAYER_CASES' batch
F32_STACK_BATCH = PIXCAP_BATCH * PIXCAP_FRAMES
F32_STACK_BATCHES = (2, F32_STACK_BATCH)
# SkipGram (train_embeddings defaults, one epoch): a 250-word vocabulary
# (the captioner's words, so the file fills its tgt_embed) over the
# captions file and an extra corpus of SKIPGRAM_EXTRA sentences (the
# reference's has 10,817), each sentence mostly of one topic's words
SKIPGRAM_CAPTIONS, SKIPGRAM_EXTRA = 300, 10_000
SKIPGRAM_LEN, SKIPGRAM_TOPICS = (6, 20), 25
SKIPGRAM_PROBE = 8192  # pairs whose mean loss is taken before and after

# [ddp]: data parallelism through a process group of one rank (NCCL on
# cuda:0; the card machine has one GPU, so scaling over GPUs is not
# measured). DDP_STEPS DenseNet121-512 train steps at DDP_BATCH through the
# data-parallel step against the same steps without a group, and a second
# run without a group beside them (cuDNN's and max-pool's backward sum in a
# varying order, and the bf16 step magnifies it): the first loss within
# DDP_LOSS_TOL relative, and the parameters' distance from the plain run
# (global relative L2 of their difference over the plain run's update)
# within DDP_UPDATE_FACTOR times the two plain runs' distance plus
# DDP_UPDATE_FLOOR; then DDP_TIMED more steps of each, timed (the plain
# ones before the group exists). One sharded evaluation forward of DDP_BATCH frames; a
# 0102-shaped decode (batch 4 over 128 frames) at each of DDP_HIDDEN
DDP_BATCH, DDP_STEPS, DDP_TIMED = 8, 2, 3
DDP_LOSS_TOL, DDP_UPDATE_FACTOR, DDP_UPDATE_FLOOR = 1e-3, 2.0, 1e-2
DDP_HIDDEN = (1024, 256)
# [tp], inside [ddp]'s one-rank group at a model axis of 1: the 0102
# captioner's train step (a TP_BATCH x TP_SRC_LEN batch, captions of
# TP_TGT_LEN ids) and the batch-4 decode over 128 frames, each with the
# sequence-sharded memory and the kernels the rule shards at a model axis
# of 2 placed as 1-of-1 blocks (column-parallel layers, Wh gathered for
# the recurrence and the GRU kernel): the step's loss within TP_LOSS_RTOL
# of the plain step's and its update within TP_STEP_RTOL (relative L2 of
# the difference over the plain update: the sharded softmax's and the
# gathered layers' backward round apart from the whole ones', ~1e-7
# relative, and Adam's first step, g / (|g| + 1e-8), takes that to ~4e-5
# of a 1e-3 update where |g| is near 1e-8: 2.9e-5 on the CPU; a lost or
# doubled gradient path moves it by ~0.1-1), the decode giving the plain decode's samples with scores within
# TP_SCORE_TOL relative (a score sums ~70 steps' log-probabilities), and
# every kind of model-axis collective run in each; the rule's sharded
# leaves of the 0102 captioner at model axes 2 and 4 (TP_AXES)
TP_BATCH, TP_SRC_LEN, TP_TGT_LEN = 8, 64, 16
TP_SCORE_TOL = 1e-5
TP_LOSS_RTOL, TP_STEP_RTOL = 1e-6, 1e-3
TP_AXES = {2: 11, 4: 11}
# [wide_decode]: --num_hidden widths past the async GRU kernel, and the
# kernel the route names at each
WIDE_HIDDEN = {640: "grid", 300: "general"}
# [gru_kernel]: the cases that run the barrier kernel (the A/B of record)
BARRIER_CASES = ("serve_0102", "caption_lengths")

# [pretrained]: seeded source-format weights (torchvision DenseNet121,
# FlowNet2-S) through the converter's CLI into the drivers' loaders. One
# eval forward of PRETRAINED_BATCH frames of the 0006 classifier, one of
# PRETRAINED_FRAMES frames of the pixels-path captioner's f32 src_embed,
# the flow of PRETRAINED_PAIRS pairs; FlowNet-S loaded both ways must agree
# within PRETRAINED_FLOW_TOL (max |difference| / max |flow|: the same
# weights in the same module, so any gap is a wrong weight)
PRETRAINED_BATCH, PRETRAINED_FRAMES, PRETRAINED_PAIRS = 8, 2, 2
PRETRAINED_PAIR_HW = (704, 1280)  # [flownet]'s 720p frames cropped to /64
PRETRAINED_FLOW_TOL = 1e-5

# (name, T, batch, H, valid lengths): the 0102 serving shape, the lengths of
# the measured /caption batch (all end before T), --num_hidden 512, the
# evaluate batch (--test_batch_size 32), the default --num_hidden, one step,
# and a per-epoch decode batch of train_gnmt (batch 32 over sources of
# 64-512 frames)
CAPTION_LENGTHS = [21, 30, 104, 69]
GRU_CASES = [
    ("serve_0102", 128, 4, 256, [128, 100, 37, 1]),
    ("caption_lengths", 128, 4, 256, CAPTION_LENGTHS),
    ("serve_h512", 128, 4, 512, [128, 100, 37, 1]),
    ("evaluate_b32", 128, 32, 256, [128 * (31 - i) // 31 for i in range(32)]),
    ("default_h128", 128, 4, 128, [128, 100, 37, 1]),
    ("t1", 1, 4, 256, [1, 0, 1, 1]),
    ("decode_b32_t512", 512, 32, 256,
     [64 + 448 * ((7 * i) % 32) // 31 for i in range(32)]),
    # widths past the async kernel, at the /caption lengths: a ragged H,
    # one where the async plan fails, past one cluster's share of Wh (the
    # general kernel streams it, the grid kernel holds it: two clusters),
    # the widest the JAX kernel takes at the 0102 encoder's shape, the
    # evaluate batch (4 chunks of rows), the widest at B 4 (three clusters)
    ("ragged_h300", 128, 4, 300, CAPTION_LENGTHS),
    ("plan_gap_h504", 128, 4, 504, CAPTION_LENGTHS),
    ("wide_h640", 128, 4, 640, CAPTION_LENGTHS),
    ("edge_h737", 128, 4, 737, CAPTION_LENGTHS),
    ("ragged_b32_h185", 128, 32, 185, CAPTION_LENGTHS * 8),
    ("t1_h1020", 1, 4, 1020, [min(n, 1) for n in CAPTION_LENGTHS]),
]

# (name, batch, side, c_in, c_final): first and last layer of each
# DenseNet121-512 block at batch 8, the last 64^2 layer with w1 resident in
# the persistent kernel and the first with w1 streamed, ragged maps (DenseNet
# at 224^2), batch 1, DenseNet201's last c_in, 9 units over up to 8 CTAs
LAYER_CASES = [
    ("block0_first", 8, 128, 64, 256), ("block0_last", 8, 128, 224, 256),
    ("block1_first", 8, 64, 128, 512), ("block1_c288", 8, 64, 288, 512),
    ("block1_c320", 8, 64, 320, 512), ("block1_last", 8, 64, 480, 512),
    ("block2_first", 8, 32, 256, 1024), ("block2_last", 8, 32, 992, 1024),
    ("block3_first", 8, 16, 512, 1024), ("block3_last", 8, 16, 992, 1024),
    ("ragged_7x7", 8, 7, 512, 1024), ("ragged_14x14", 8, 14, 256, 512),
    ("batch1", 1, 128, 64, 256), ("batch1_16", 1, 16, 512, 1024),
    ("d201_c1888", 8, 16, 1888, 1920), ("c288", 1, 16, 288, 320),
]


def log(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back calls,
    CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_profile(fn):
    """Device time (ms) and launch count by kernel name over one call of
    ``fn``, from torch.profiler's CUPTI trace of the device's activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    return by_name


class TraceDropped(Exception):
    """Every profiler session of a trace recorded none of its kernels."""


# traces that every profiler session dropped, timed by event_device instead
TRACE_FALLBACKS: list = []
# SM clock cycles the stream spins (~20 ms on an H100) while the host
# queues the launches that event_device times
QUEUE_AHEAD_CYCLES = 40_000_000


def traced_kernels(fn, *names, launches=None, attempts=TRACE_ATTEMPTS):
    """{name: [device ms, launches]} of the kernels whose name holds one of
    ``names`` (any kernel without names) over one call of ``fn``. A trace
    that recorded none of them, or not ``launches`` of them, is taken again,
    up to ``attempts`` times: the tracer drops a session's records now and
    then. Raises TraceDropped if no session recorded any of them, and
    SystemExit if some did, but never ``launches``."""
    seen, recorded = [], []
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5)
        by_name = device_profile(fn)
        hits = {k: v for k, v in by_name.items()
                if not names or any(n in k for n in names)}
        seen.append(sum(v[1] for v in hits.values()))
        recorded.append(sum(v[1] for v in by_name.values()))
        if hits and launches in (None, seen[-1]):
            return hits
    why = (f"the profiler recorded {seen} launches of the kernels "
           f"{names or ''} where {launches} were expected (device records "
           f"of any kind: {recorded})")
    if not any(seen):
        raise TraceDropped(why)
    raise SystemExit(why)


def wrapper_launches(names) -> int:
    """Launches the kernel wrappers have counted so far of the kernels
    whose profiler name is one of ``names`` (every kernel without names)."""
    from tennis_torch.ops import dense_block as db, gru

    counts = {n: db.dense_layer.variant_launches[v]
              for v, n in DENSE_KERNELS.items()}
    counts.update({n: gru.gru_recurrence.variant_launches[v]
                   for v, n in GRU_KERNELS.items()})
    return sum(c for n, c in counts.items() if not names or n in names)


def event_device(fn, names=(), launches=None, reps=5):
    """(device ms, launches) of one call of ``fn`` by CUDA events, median
    of ``reps``: the stream spins (``torch.cuda._sleep``) while the host
    queues ``fn``'s launches, so the events bracket the device's work and
    not the host's (a host slower than the spin adds its excess). The
    launches are the wrappers' counts over one call, checked against
    ``launches`` where given."""
    fn()
    torch.cuda.synchronize()
    times, counted = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = wrapper_launches(names)
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        counted = wrapper_launches(names) - before
        times.append(start.elapsed_time(end))
    if launches is not None and counted != launches:
        raise SystemExit(f"the wrappers counted {counted} launches of the "
                         f"kernels {names} where {launches} were expected")
    return statistics.median(times), counted


def kernel_device(fn, *names, launches=None):
    """(device ms, launches) of the kernels whose name holds one of
    ``names`` over one call of ``fn``, from the profiler; where every
    session of the trace dropped them (twice so far, both times at the
    first ``[gru_kernel]`` trace), from ``event_device``, which times the
    whole call and takes the launches from the wrappers' counts. Once a
    trace fell back, later ones try the profiler twice: it has stayed
    silent for the rest of the phase (every trace of ``[gru_kernel]``)."""
    attempts = 2 if TRACE_FALLBACKS else TRACE_ATTEMPTS
    try:
        hits = traced_kernels(fn, *names, launches=launches,
                              attempts=attempts).values()
    except TraceDropped as dropped:
        ms, n = event_device(fn, names, launches)
        TRACE_FALLBACKS.append({"kernels": list(names), "launches": n,
                                "event_device_ms": ms, "why": str(dropped)})
        print(f"{dropped}; timed by CUDA events instead: {ms} ms, {n} "
              f"launches by the wrappers' counts", file=sys.stderr, flush=True)
        return ms, n
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def dense_device_ms(fn, launches):
    """Device ms of the dense-layer kernels over one call of ``fn``, which
    launches them ``launches`` times."""
    return kernel_device(fn, *DENSE_KERNELS.values(), launches=launches)[0]


def all_device_ms(fn):
    """Device ms of every kernel over one call of ``fn``."""
    return kernel_device(fn)[0]


def layer_work(batch, side, c_in, f=128, g=32, elem=2):
    """(FLOP, bytes) one dense layer needs: each input read once, each output
    written once; ``elem`` bytes a state and kernel element (2 bf16, 4 f32)."""
    px = batch * side * side
    flops = 2 * px * (c_in * f + 9 * f * g)
    nbytes = elem * px * (c_in + g) + elem * (f * c_in + 9 * g * f) + \
        4 * (2 * c_in + 2 * f)
    return flops, nbytes


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _rand(gen, dev, *shape, lo=None, hi=None, std=1.0):
    t = torch.empty(shape, device=dev)
    if lo is not None:
        return t.uniform_(lo, hi, generator=gen)
    return t.normal_(0.0, std, generator=gen)


def random_ops(gen, c_in, dev, dtype=torch.bfloat16):
    """Seeded operands of one dense layer at ``c_in``, kernels in
    ``dtype``."""
    from tennis_torch.ops.dense_block import LayerOperands

    def rand(*shape, **kw):
        return _rand(gen, dev, *shape, **kw)

    return LayerOperands(
        rand(c_in, lo=0.5, hi=1.5), rand(c_in, std=0.5),
        rand(128, c_in, std=c_in ** -0.5).to(dtype),
        rand(128, lo=0.5, hi=1.5), rand(128, std=0.5),
        rand(3, 3, 32, 128, std=1152 ** -0.5).to(dtype))


def random_layer(gen, batch, side, c_in, c_final, dev, dtype=torch.bfloat16):
    state = _rand(gen, dev, batch, side, side, c_final).to(dtype)
    return state, random_ops(gen, c_in, dev, dtype)


def library_convs(state, c_in, ops):
    """The layer's two convolutions as cuDNN calls on contiguous
    channels-last inputs in the state's dtype (bf16; f32 with TF32 off, as
    main sets it): the library yardstick, never on the port's path."""
    x = state[..., :c_in].permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w1 = ops.w1[:, :, None, None].contiguous(memory_format=torch.channels_last)
    w2 = ops.w2.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(F.conv2d(x, w1), w2, padding=1)


def check_layer(state, got, want, c_in, tol=KERNEL_TOL):
    """(max |kernel - plain| over the growth channels, that over max |plain|,
    every other channel untouched, ok: within ``tol``)."""
    part_g = got[..., c_in:c_in + 32].float()
    part_w = want[..., c_in:c_in + 32].float()
    abs_err = (part_g - part_w).abs().max().item()
    rel = abs_err / part_w.abs().max().item()
    untouched = torch.equal(
        torch.cat([got[..., :c_in], got[..., c_in + 32:]], -1),
        torch.cat([state[..., :c_in], state[..., c_in + 32:]], -1))
    ok = bool(torch.isfinite(part_g).all()) and untouched and rel <= tol
    return abs_err, rel, untouched, ok


def kernel_phase():
    """The three dense-layer kernels against the plain version at
    LAYER_CASES, the cluster kernel at every cluster size it takes there;
    returns the worst max |kernel - plain| of each variant."""
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst_abs = dict.fromkeys(db.VARIANTS, 0.0)
    for name, batch, side, c_in, c_final in LAYER_CASES:
        state, ops = random_layer(gen, batch, side, c_in, c_final, dev)
        want = db.dense_layer_reference(state.clone(), c_in, ops)
        chosen, routed_size = db.dense_layer_route(batch, side, side, c_in)
        size = db.dense_layer_cluster_size(batch, side, side, c_in)
        runs = [(v, None) for v in db.VARIANTS if v != "cluster"]
        runs += [("cluster", s) for s in db.CLUSTER_SIZES]
        row, ok = {}, True
        for variant, s in runs:
            key = variant if s is None else f"cluster{s}"
            got = db.dense_layer(state.clone(), c_in, ops, variant, s)
            torch.cuda.synchronize()
            abs_err, rel, untouched, v_ok = check_layer(state, got, want, c_in)
            ok = ok and v_ok
            worst_abs[variant] = max(worst_abs[variant], abs_err)
            row[f"{key}_max_abs_err"] = abs_err
            row[f"{key}_rel_err"] = rel
            row[f"{key}_untouched"] = untouched
            row[f"{key}_device_ms"] = kernel_device(
                lambda v=variant, s=s: db.dense_layer(state, c_in, ops, v, s),
                DENSE_KERNELS[variant], launches=1)[0]
        ms = time_ms(lambda: db.dense_layer(state, c_in, ops))
        plain_ms = time_ms(lambda: db.dense_layer_reference(state, c_in, ops), reps=3)
        lib = library_convs(state, c_in, ops)
        b_ms, b_by = bound(*layer_work(batch, side, c_in))
        smem, resident = db.persistent_smem_bytes(c_in)
        chosen_key = chosen if routed_size is None else f"cluster{routed_size}"
        log("kernel", case=name, shape=[batch, side, side, c_final], c_in=c_in,
            variant=chosen, cluster_size=size, tol=KERNEL_TOL, ms=ms,
            device_ms=row[f"{chosen_key}_device_ms"], **row, plain_ms=plain_ms,
            library_ms=time_ms(lib), library_device_ms=all_device_ms(lib),
            bound_ms=b_ms, bound_by=b_by, persistent_smem_bytes=smem,
            persistent_w1_resident=resident,
            cluster_smem_bytes={s: db.cluster_smem_bytes(s)
                                for s in db.CLUSTER_SIZES}, ok=ok)
        if not ok:
            raise SystemExit(f"a dense_layer kernel disagrees with its plain "
                             f"version at {name}")
    return worst_abs


def route_shapes():
    """(batch, side, c_in) of every small-map layer of DenseNet121/169/201
    at 512^2 (c_in in steps of 64, and each block's last c_in), and of the
    ragged 14x14 and 7x7 maps of DenseNet121 at 224^2, at batch 1 and 8;
    and at the extraction batch (64), DenseNet121's 32^2 and 16^2 maps at
    512^2 and its 7x7 map at 224^2."""
    # side: the blocks' first c_in in steps of 64 to the last of DenseNet201,
    # and the last c_in of DenseNet121, 169 and 201
    c_ins = {32: sorted({*range(256, 1761, 64), 992, 1248, 1760}),
             16: sorted({*range(512, 1889, 64), 992, 1632, 1888}),
             14: [256, 608, 992], 7: [512, 736, 992]}
    d121 = {32: [*range(256, 993, 64), 992], 16: [*range(512, 993, 64), 992],
            7: [*range(512, 993, 64), 992]}
    return [(batch, side, c) for batch in (8, 1) for side, cs in c_ins.items()
            for c in cs] + [(EXTRACT_BATCH, side, c)
                            for side, cs in d121.items() for c in cs]


def route_phase():
    """Device time of every kernel and cluster size at every route_shapes()
    shape, ROUTE_ROUNDS rounds of ROUTE_REPS launches each, the order of the
    kernels rotated from round to round; one profiler session per round,
    whose kernel records are matched to the launches in order. Logs one
    ``[route]`` line per shape; returns how often the route is the fastest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = []
    for batch, side, c_in in route_shapes():
        state, ops = random_layer(gen, batch, side, c_in, c_in + 32, dev)
        runs = [(v, None) for v in ("tile", "persistent")]
        runs += [("cluster", s) for s in db.CLUSTER_SIZES]
        cases.append((batch, side, c_in, state, ops, runs))

    def launch_all(rnd):
        """Every case's kernels, rotated by the round; [(case, key)]."""
        order = []
        for i, (_, _, c_in, state, ops, runs) in enumerate(cases):
            k = rnd % len(runs)
            for variant, s in runs[k:] + runs[:k]:
                for _ in range(ROUTE_REPS):
                    db.dense_layer(state, c_in, ops, variant, s)
                    order.append((i, variant if s is None else f"cluster{s}"))
        return order

    def traced_round(rnd):
        """[(case, key, device ms)] of one round's launches, in order; a
        trace that dropped records is taken again, up to TRACE_ATTEMPTS
        times."""
        for attempt in range(TRACE_ATTEMPTS):
            if attempt:
                time.sleep(0.5)
            launch_all(rnd)  # warm: every kernel built, its cluster size checked
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                order = launch_all(rnd)
                torch.cuda.synchronize()
            records = sorted((e for e in prof.events()
                              if e.device_type == DeviceType.CUDA
                              and "dense_layer" in e.name),
                             key=lambda e: e.time_range.start)
            if len(records) == len(order):
                return [(i, key, e.time_range.elapsed_us() / 1e3)
                        for (i, key), e in zip(order, records)]
        raise SystemExit(f"route phase: {len(records)} kernel records for "
                         f"{len(order)} launches, {TRACE_ATTEMPTS} times")

    times = [{} for _ in cases]  # key -> [per-round mean ms]
    for rnd in range(ROUTE_ROUNDS):
        sums = {}
        for i, key, ms in traced_round(rnd):
            sums[i, key] = sums.get((i, key), 0.0) + ms
        for (i, key), total in sums.items():
            times[i].setdefault(key, []).append(total / ROUTE_REPS)
    agree = {}  # batch -> [shapes where the route is the fastest, shapes]
    for (batch, side, c_in, _, _, _), t in zip(cases, times):
        med = {k: statistics.median(v) for k, v in t.items()}
        fastest = min(med, key=med.get)
        variant, size = db.dense_layer_route(batch, side, side, c_in)
        routed = variant if size is None else f"cluster{size}"
        tally = agree.setdefault(batch, [0, 0])
        tally[0] += routed == fastest
        tally[1] += 1
        log("route", batch=batch, side=side, c_in=c_in, device_ms=med,
            spread=[min(min(v) / med[k] for k, v in t.items()),
                    max(max(v) / med[k] for k, v in t.items())],
            fastest=fastest, routed=routed,
            routed_over_fastest=med[routed] / med[fastest])
    return agree


def stack_phase():
    """The 58 dense layers of one DenseNet121-512 batch-8 forward: every
    layer through every kernel against the plain version, each layer's
    routed kernel, plain version and library convolutions timed, and block
    by block the wrapper's choice, each kernel alone, the plain version and
    the library. Returns the per-block rows, the per-layer rows and the
    device ms of each kernel over the routed stack."""
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    blocks = []  # (state, [(c_in, ops)], flops, bytes)
    side, channels = DATA_SHAPE // 4, 64
    for num_layers in (6, 12, 24, 16):
        c_final = channels + 32 * num_layers
        layers, flops, nbytes = [], 0, 0
        for j in range(num_layers):
            state, ops = random_layer(gen, BATCH, side, channels + 32 * j,
                                      c_final, dev)
            layers.append((channels + 32 * j, ops))
            f, b = layer_work(BATCH, side, channels + 32 * j)
            flops, nbytes = flops + f, nbytes + b
        blocks.append((state, layers, flops, nbytes))
        channels, side = c_final // 2, side // 2

    def run(fn, which, **kw):
        def go():
            for state, layers, _, _ in which:
                for c_in, ops in layers:
                    fn(state, c_in, ops, **kw)
        return go

    layer_rows, worst_rel = [], dict.fromkeys(db.VARIANTS, 0.0)
    for i, (state, layers, _, _) in enumerate(blocks):
        side = state.shape[1]
        for c_in, ops in layers:
            want = db.dense_layer_reference(state.clone(), c_in, ops)
            for variant in db.VARIANTS:
                got = db.dense_layer(state.clone(), c_in, ops, variant)
                torch.cuda.synchronize()
                _, rel, _, ok = check_layer(state, got, want, c_in)
                worst_rel[variant] = max(worst_rel[variant], rel)
                if not ok:
                    raise SystemExit(f"the {variant} kernel disagrees with its "
                                     f"plain version at block {i}, c_in {c_in}")
            flops, nbytes = layer_work(BATCH, side, c_in)
            layer_rows.append({
                "block": i, "c_in": c_in, "flops": flops, "bytes": nbytes,
                "variant": db.dense_layer_variant(BATCH, side, side, c_in),
                "ms": time_ms(lambda: db.dense_layer(state, c_in, ops), rounds=3),
                "plain_ms": time_ms(
                    lambda: db.dense_layer_reference(state, c_in, ops),
                    reps=1, rounds=3),
                "library_ms": time_ms(library_convs(state, c_in, ops), rounds=3)})
    log("stack_check", layers=len(layer_rows), tol=KERNEL_TOL,
        worst_rel_err=worst_rel)

    rows = []
    for i, blk in enumerate(blocks):
        state, layers, flops, nbytes = blk
        lib = [library_convs(state, c_in, ops) for c_in, ops in layers]

        def lib_go(lib=lib):
            for f in lib:
                f()

        mine = [r for r in layer_rows if r["block"] == i]
        b_ms, b_by = bound(flops, nbytes)
        row = {"block": i, "side": state.shape[1], "layers": len(layers),
               "variants": {v: sum(r["variant"] == v for r in mine)
                            for v in db.VARIANTS},
               "ms": time_ms(run(db.dense_layer, [blk]), reps=5),
               "device_ms": dense_device_ms(run(db.dense_layer, [blk]),
                                            len(layers))}
        for variant in db.VARIANTS:
            row[f"{variant}_ms"] = time_ms(
                run(db.dense_layer, [blk], variant=variant), reps=5)
            row[f"{variant}_device_ms"] = dense_device_ms(
                run(db.dense_layer, [blk], variant=variant), len(layers))
        row.update(plain_ms=sum(r["plain_ms"] for r in mine),
                   library_ms=sum(r["library_ms"] for r in mine),
                   library_device_ms=all_device_ms(lib_go), bound_ms=b_ms,
                   bound_by=b_by, flops=flops, bytes=nbytes)
        log("stack_block", **row)
        rows.append(row)

    flops = sum(r["flops"] for r in rows)
    nbytes = sum(r["bytes"] for r in rows)
    ms = time_ms(run(db.dense_layer, blocks), reps=5)
    plain_ms = sum(r["plain_ms"] for r in rows)
    library_ms = sum(r["library_ms"] for r in rows)
    # the kernels' own time, without the host gaps between launches
    n_layers = sum(len(layers) for _, layers, _, _ in blocks)
    by_name = traced_kernels(run(db.dense_layer, blocks),
                             *DENSE_KERNELS.values(), launches=n_layers)
    routed_device = {v: sum(t for k, (t, _) in by_name.items() if n in k)
                     for v, n in DENSE_KERNELS.items()}
    device_ms = sum(routed_device.values())
    launches = sum(c for _, c in by_name.values())
    alone = {f"{v}_only_device_ms": dense_device_ms(
        run(db.dense_layer, blocks, variant=v), n_layers) for v in db.VARIANTS}
    b_ms, b_by = bound(flops, nbytes)
    log("stack", layers=n_layers, batch=BATCH, data_shape=DATA_SHAPE,
        gflop=flops / 1e9, gbytes=nbytes / 1e9, ms=ms, device_ms=device_ms,
        device_ms_by_variant=routed_device, **alone,
        profiled_launches=launches, plain_ms=plain_ms, library_ms=library_ms,
        library_device_ms=sum(r["library_device_ms"] for r in rows),
        bound_ms=b_ms, bound_by=b_by, device_tflops=flops / device_ms / 1e9,
        roofline_share=b_ms / device_ms,
        choice_beats_each_alone=all(device_ms < t for t in alone.values()))
    return rows, layer_rows, routed_device


def stack64_phase():
    """The 58 dense layers of one DenseNet121-512 forward at the extraction
    batch (64): every layer through the route's kernel against the plain
    version, then block by block the device ms of the route's kernels and
    of cuDNN's two convolutions a layer, beside the bytes bound."""
    from tennis_torch.ops import dense_block as db

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    batch, side, channels = EXTRACT_BATCH, DATA_SHAPE // 4, 64
    rows, worst_rel, totals = [], 0.0, {"flops": 0, "bytes": 0}
    for i, num_layers in enumerate((6, 12, 24, 16)):
        c_final = channels + 32 * num_layers
        state = _rand(gen, dev, batch, side, side, c_final).to(torch.bfloat16)
        layers = [(channels + 32 * j, random_ops(gen, channels + 32 * j, dev))
                  for j in range(num_layers)]
        flops = nbytes = 0
        variants = dict.fromkeys(db.VARIANTS, 0)
        for c_in, ops in layers:
            want = db.dense_layer_reference(state.clone(), c_in, ops)
            got = db.dense_layer(state.clone(), c_in, ops)
            torch.cuda.synchronize()
            _, rel, _, ok = check_layer(state, got, want, c_in)
            del want, got
            worst_rel = max(worst_rel, rel)
            if not ok:
                raise SystemExit(f"dense_layer disagrees with its plain version "
                                 f"at batch {batch}, block {i}, c_in {c_in}")
            f, b = layer_work(batch, side, c_in)
            flops, nbytes = flops + f, nbytes + b
            variants[db.dense_layer_variant(batch, side, side, c_in)] += 1

        def routed(state=state, layers=layers):
            for c_in, ops in layers:
                db.dense_layer(state, c_in, ops)

        lib = [library_convs(state, c_in, ops) for c_in, ops in layers]
        b_ms, b_by = bound(flops, nbytes)
        row = {"block": i, "side": side, "layers": num_layers,
               "variants": variants,
               "device_ms": dense_device_ms(routed, num_layers),
               "library_device_ms": all_device_ms(
                   lambda lib=lib: [f() for f in lib]),
               "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
               "bytes": nbytes}
        del lib
        log("stack64_block", batch=batch, **row)
        rows.append(row)
        totals["flops"] += flops
        totals["bytes"] += nbytes
        channels, side = c_final // 2, side // 2
    device_ms = sum(r["device_ms"] for r in rows)
    library_ms = sum(r["library_device_ms"] for r in rows)
    b_ms, b_by = bound(totals["flops"], totals["bytes"])
    variants = {v: sum(r["variants"][v] for r in rows) for v in db.VARIANTS}
    log("stack64", layers=sum(r["layers"] for r in rows), batch=batch,
        data_shape=DATA_SHAPE, tol=KERNEL_TOL, worst_rel_err=worst_rel,
        launches_by_variant=variants, gflop=totals["flops"] / 1e9,
        gbytes=totals["bytes"] / 1e9, device_ms=device_ms,
        device_ms_per_frame=device_ms / batch, library_device_ms=library_ms,
        bound_ms=b_ms, bound_by=b_by, roofline_share=b_ms / device_ms,
        device_tflops=totals["flops"] / device_ms / 1e9)
    return {"rows": rows, "device_ms": device_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def random_flax_tree(tree, rng):
    """Redraw every leaf of a flax-named tree: kernels lecun-normal
    (truncated at 2 std), embeddings normal with variance 1/width, BN scale
    1 / bias 0, statistics perturbed away from (0, 1) so the folded affine is
    non-trivial."""
    def draw(name, leaf):
        shape = leaf.shape
        if name == "embedding":
            return (rng.standard_normal(shape) / shape[-1] ** 0.5).astype(
                np.float32)
        if name == "kernel":
            std = (1.0 / np.prod(shape[:-1])) ** 0.5 / 0.87962566103423978
            z = rng.standard_normal(shape)
            while (bad := np.abs(z) > 2).any():
                z[bad] = rng.standard_normal(int(bad.sum()))
            return (z * std).astype(np.float32)
        if name == "scale":
            return np.ones(shape, np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "mean":
            return (rng.standard_normal(shape) * 0.1).astype(np.float32)
        return np.zeros(shape, np.float32)  # bias

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v)
                for k, v in t.items()}

    return walk(tree)


def routed_launches(db, batch=BATCH):
    """Launches of each dense-layer kernel that the route names for one
    DenseNet121-512 forward at ``batch``."""
    counts = dict.fromkeys(db.ROUTES, 0)
    side, channels = DATA_SHAPE // 4, 64
    for num_layers in (6, 12, 24, 16):
        for j in range(num_layers):
            counts[db.dense_layer_variant(batch, side, side,
                                          channels + 32 * j)] += 1
        channels, side = (channels + 32 * num_layers) // 2, side // 2
    return counts


def main_path_phase(dev):
    from http.server import ThreadingHTTPServer

    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.inference import build_frame_model, make_predict_probs
    from tennis_torch.ops import dense_block as db
    from tennis_torch.serve import make_service

    rng = np.random.default_rng(SEED)
    classes = list(DEFAULT_CLASSES)
    model = build_frame_model("DenseNet121", len(classes), DATA_SHAPE)
    load_flax(model, random_flax_tree(to_flax(model), rng))
    torch.cuda.reset_peak_memory_stats()
    predict_probs = make_predict_probs(model, dev)
    handler, batcher = make_service(classes, predict_probs, BATCH, DATA_SHAPE,
                                    max_wait_ms=200)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        frames = rng.integers(0, 256, (N_REQUESTS, DATA_SHAPE, DATA_SHAPE, 3),
                              dtype=np.uint8)
        reset_dense_counts(db)
        start = time.perf_counter()
        probs, batches = serve_frames(batcher, frames)
        wall = time.perf_counter() - start
        launches = db.dense_layer.launches
        by_variant = dict(db.dense_layer.variant_launches)
        url = "http://127.0.0.1:%d/healthz" % httpd.server_address[1]
        with urllib.request.urlopen(url, timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()

    finite = bool(np.isfinite(probs).all())
    sums_ok = bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3))
    if not (finite and sums_ok and probs.shape == (N_REQUESTS, len(classes))):
        raise SystemExit(f"bad probabilities: finite={finite} sums_ok={sums_ok} "
                         f"shape={probs.shape}")
    if launches != 58 * batches or batches < 1:
        raise SystemExit(f"{launches} dense-layer launches for {batches} "
                         f"batches, expected 58 per batch")
    routed = {v: n * batches for v, n in routed_launches(db).items()}
    if by_variant != routed:
        raise SystemExit(f"dense-layer launches by kernel {by_variant}, the "
                         f"route names {routed}")
    if health["status"] != "ok" or health["requests"] < N_REQUESTS:
        raise SystemExit(f"healthz: {health}")

    # batch-8 latency through the entry point (uint8 in, host probabilities out)
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        predict_probs(frames[:BATCH])
        lat.append((time.perf_counter() - t0) * 1e3)
    latency_ms = statistics.median(lat)
    # where the time of one batch goes on the device
    kernels = device_profile(lambda: predict_probs(frames[:BATCH]))
    busy_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log("breakdown", batch=BATCH, latency_ms=latency_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / latency_ms,
        dense_layer_ms=sum(v[0] for k, v in kernels.items()
                           if any(n in k for n in DENSE_KERNELS.values())),
        top=[[k[:60], v[0], v[1]] for k, v in top])

    # logits: kernel path vs the plain-version forward on the same frames
    # (comparison runs, after the counts were read)
    with torch.inference_mode():
        x = device_prepare(torch.from_numpy(frames[:BATCH]).to(dev))
        got = db.frame_model_apply(model, x)
        want = db.frame_model_apply(model, x, layer=db.dense_layer_reference)
        torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    served = np.allclose(torch.softmax(got, -1).cpu().numpy(), probs[:BATCH],
                         atol=1e-2)
    log("main_path", requests=N_REQUESTS, batches=batches, launches=launches,
        launches_per_batch=launches / batches, launches_by_variant=by_variant,
        routed_launches_by_variant=routed, wall_s=wall,
        batch8_latency_ms=latency_ms, frames_per_s=BATCH / latency_ms * 1e3,
        healthz=health, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        logits_rel_err=rel, logit_tol=LOGIT_TOL, top1_agrees=top1,
        served_probs_match_forward=served)
    if not (rel <= LOGIT_TOL and top1 and served):
        raise SystemExit("kernel forward disagrees with the plain-version forward")
    return by_variant


class MemorySplit:
    """An in-memory split with what the loader, ``save_features``,
    ``train.fit`` and ``evaluate`` read of a TennisSet: ``len``, ``(img,
    label, idx)`` items, ``save_feature_path``, ``classes``, ``num_class``,
    ``_samples`` (``(split, i)``) and the split name. Item i is frame ``i %
    len(frames)`` (so host memory stays bounded; a "frame" may be a (T, F)
    feature window) with label ``i % 11``; ``window`` > 1 makes item i a
    clip of that many consecutive frames."""

    def __init__(self, frames, n, feat_dir, split, window=1):
        from tennis_torch.data.tennis_set import DEFAULT_CLASSES

        self.frames, self.n, self.feat_dir = frames, n, feat_dir
        self._split, self.window = split, window
        self.classes = list(DEFAULT_CLASSES)
        self.num_class = len(self.classes)
        self._samples = [(split, i) for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        k = len(self.frames)
        if self.window == 1:
            img = self.frames[idx % k]
        else:
            img = self.frames[[(idx * self.window + t) % k
                               for t in range(self.window)]]
        return img, idx % 11, idx

    def save_feature_path(self, idx):
        from tennis_torch.data.tennis_set import get_feature_path

        return get_feature_path(self.feat_dir, self._split, int(idx))


def reset_dense_counts(db):
    db.dense_layer.launches = 0
    db.dense_layer.variant_launches = dict.fromkeys(db.ROUTES, 0)


def extraction_inputs(dev):
    """``FrameModel(DenseNet121)`` at 512^2 with seeded random weights in
    flax naming through ``bridge.load_flax``, and EXTRACT_DISTINCT seeded
    uint8 frames."""
    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.inference import build_frame_model

    rng = np.random.default_rng(SEED + 6)
    model = build_frame_model("DenseNet121", 11, DATA_SHAPE)
    load_flax(model, random_flax_tree(to_flax(model), rng))
    frames = rng.integers(0, 256, (EXTRACT_DISTINCT, DATA_SHAPE, DATA_SHAPE, 3),
                          dtype=np.uint8)
    return model, frames


def plain_features(model, frames, dev):
    """f32 backbone features of ``frames`` with every dense layer through
    the plain version (the yardstick, never on the dump's path)."""
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.ops import dense_block as db

    bb = model.backbone
    with torch.inference_mode():
        x = device_prepare(torch.from_numpy(frames).to(dev), bb.dtype)
        return db.densenet_features(bb.spec, bb.operands(), x, bb.dtype,
                                    layer=db.dense_layer_reference).float()


def extract_phase(dev, model, frames):
    """``train.save_features`` at full width: an in-memory split of
    EXTRACT_FRAMES frames through DataLoader -> pinned prefetch_to_device ->
    the dense-layer kernels -> .npy files under a temporary directory."""
    import glob
    import tempfile

    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.inference import make_extract_features
    from tennis_torch.ops import dense_block as db

    extract = make_extract_features(model, dev)

    def dump(ds):
        loader = DataLoader(ds, EXTRACT_BATCH, num_workers=8)
        return driver.save_features(extract, [ds], {ds._split: loader},
                                    dev)[ds._split]

    with tempfile.TemporaryDirectory() as tmp:
        dump(MemorySplit(frames, EXTRACT_BATCH, tmp, "warmup"))
        split = MemorySplit(frames, EXTRACT_FRAMES, tmp, "extract")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_dense_counts(db)
        t0 = time.perf_counter()
        report = dump(split)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = db.dense_layer.launches
        by_variant = dict(db.dense_layer.variant_launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        files = glob.glob(os.path.join(tmp, "extract.mp4", "*", "*.npy"))
        bad = [f for f in files
               if (a := np.load(f)).dtype != np.float32 or a.shape != (FEAT_DIM,)
               or not np.isfinite(a).all()]
        errs = {}
        for name, first, n in (("first", 0, EXTRACT_BATCH),
                               ("ragged", EXTRACT_FRAMES // EXTRACT_BATCH
                                * EXTRACT_BATCH, EXTRACT_FRAMES % EXTRACT_BATCH)):
            idx = np.arange(first, first + n)
            got = np.stack([np.load(split.save_feature_path(i)) for i in idx])
            want = plain_features(model, frames[idx % EXTRACT_DISTINCT],
                                  dev).cpu().numpy()
            errs[name] = float(np.abs(got - want).max() / np.abs(want).max())

        # device busy and idle share over PROFILE_BATCHES batches
        small = MemorySplit(frames, PROFILE_BATCHES * EXTRACT_BATCH, tmp,
                            "profile")
        walls = []

        def profiled():
            t = time.perf_counter()
            dump(small)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)

        by_name = device_profile(profiled)
    copy_ms = sum(v[0] for k, v in by_name.items() if k.startswith("Memcpy"))
    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    full, ragged = divmod(EXTRACT_FRAMES, EXTRACT_BATCH)
    want_counts = {v: full * n + routed_launches(db, ragged)[v]
                   for v, n in routed_launches(db, EXTRACT_BATCH).items()}
    ok = (len(files) == EXTRACT_FRAMES and not bad
          and launches == 58 * (full + 1) and by_variant == want_counts
          and all(e <= LOGIT_TOL for e in errs.values()))
    log("extract", frames=EXTRACT_FRAMES, batch=EXTRACT_BATCH,
        ragged_batch=ragged, data_shape=DATA_SHAPE, files=len(files),
        bad_files=len(bad), launches=launches, launches_by_variant=by_variant,
        routed_launches_by_variant=want_counts, wall_s=wall,
        frames_per_s=EXTRACT_FRAMES / wall, seconds_in_dump=report["seconds"],
        prefetch=report["prefetch"], copy_wait_s=report["copy_wait_s"],
        write_drain_s=report["write_drain_s"], peak_mem_gib=peak_gib,
        features_rel_err=errs, tol=LOGIT_TOL,
        profile={"frames": PROFILE_BATCHES * EXTRACT_BATCH,
                 "wall_ms": walls[-1], "device_busy_ms": busy_ms,
                 "idle_share": 1 - busy_ms / walls[-1],
                 "memcpy_ms": copy_ms,
                 "device_ms_per_frame": busy_ms / (PROFILE_BATCHES
                                                   * EXTRACT_BATCH),
                 "dense_layer_ms": sum(
                     v[0] for k, v in by_name.items()
                     if any(n in k for n in DENSE_KERNELS.values())),
                 "top": [[k[:60], v[0], v[1]] for k, v in sorted(
                     by_name.items(), key=lambda kv: -kv[1][0])[:8]]},
        ok=ok)
    if not ok:
        raise SystemExit("feature extraction failed its gates")
    return by_variant


def evaluate_phase(dev, model, frames):
    """The in-memory split through ``eval_iter`` and the port's metric set,
    the kernel path's PRF1 against the plain version's; then the
    ``--temp_pool mean`` wrap through the backbone at POOL_BATCH clips of
    POOL_WINDOW frames."""
    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader, eval_iter
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.inference import make_eval_step
    from tennis_torch.ops import dense_block as db

    step = make_eval_step(model, dev)

    def probs_fn(x):
        return torch.softmax(step(x), dim=-1)

    def run(ds, fn, batch):
        rows = {}
        for out, _, idxs in eval_iter(DataLoader(ds, batch, num_workers=8),
                                      fn, dev):
            rows.update(zip(idxs.tolist(), out))
        return np.stack([rows[i] for i in range(len(ds))])

    run(MemorySplit(frames, EXTRACT_BATCH, None, "warmup"), probs_fn,
        EXTRACT_BATCH)
    split = MemorySplit(frames, EXTRACT_FRAMES, None, "evaluate")
    reset_dense_counts(db)
    t0 = time.perf_counter()
    probs = run(split, probs_fn, EXTRACT_BATCH)
    wall = time.perf_counter() - t0
    launches = db.dense_layer.launches
    by_variant = dict(db.dense_layer.variant_launches)
    labels = np.arange(EXTRACT_FRAMES) % 11

    with torch.inference_mode():
        plain = np.concatenate([
            torch.softmax(model.head(plain_features(
                model, frames[i:i + EXTRACT_BATCH], dev)), -1).cpu().numpy()
            for i in range(0, EXTRACT_DISTINCT, EXTRACT_BATCH)])
    plain = plain[np.arange(EXTRACT_FRAMES) % EXTRACT_DISTINCT]
    disagree = int((probs.argmax(-1) != plain.argmax(-1)).sum())
    got_m, want_m = (driver._metric_set(DEFAULT_CLASSES) for _ in range(2))
    for m in got_m.values():
        m.update(labels, probs)
    for m in want_m.values():
        m.update(labels, plain)
    same_prf1 = got_m["prf1"].get() == want_m["prf1"].get()

    # the pooled wrap through the backbone: one forward over the folded clips
    clips = MemorySplit(frames, POOL_BATCH, None, "clips", window=POOL_WINDOW)
    pool_step = make_eval_step(model, dev, pool="mean")
    reset_dense_counts(db)
    pooled = run(clips, pool_step, POOL_BATCH)
    pool_launches = db.dense_layer.launches
    pool_by_variant = dict(db.dense_layer.variant_launches)
    clip_frames = np.stack([clips[i][0] for i in range(POOL_BATCH)])
    feats = plain_features(model, clip_frames.reshape(
        (-1,) + clip_frames.shape[2:]), dev)
    with torch.inference_mode():
        want_pooled = model.head(feats.reshape(POOL_BATCH, POOL_WINDOW, -1)
                                 .to(model.dtype).mean(1)).cpu().numpy()
    pool_rel = float(np.abs(pooled - want_pooled).max()
                     / np.abs(want_pooled).max())
    full, ragged = divmod(EXTRACT_FRAMES, EXTRACT_BATCH)
    want_counts = {v: full * n + routed_launches(db, ragged)[v]
                   for v, n in routed_launches(db, EXTRACT_BATCH).items()}
    pool_want = routed_launches(db, POOL_BATCH * POOL_WINDOW)
    ok = (bool(np.isfinite(probs).all()) and launches == 58 * (full + 1)
          and by_variant == want_counts and (disagree > 0 or same_prf1)
          and pool_launches == 58 and pool_by_variant == pool_want
          and pool_rel <= LOGIT_TOL
          and bool((pooled.argmax(-1) == want_pooled.argmax(-1)).all()))
    log("evaluate", frames=EXTRACT_FRAMES, batch=EXTRACT_BATCH, wall_s=wall,
        frames_per_s=EXTRACT_FRAMES / wall, launches=launches,
        launches_by_variant=by_variant, routed_launches_by_variant=want_counts,
        top1_disagreements=disagree, prf1_equals_plain=same_prf1,
        max_abs_prob_diff=float(np.abs(probs - plain).max()),
        AVG_NB_f1=got_m["prf1"].get_dict()["AVG_NB_f1"],
        pool={"clips": POOL_BATCH, "window": POOL_WINDOW, "pool": "mean",
              "launches": pool_launches, "launches_by_variant": pool_by_variant,
              "routed_launches_by_variant": pool_want,
              "logits_rel_err": pool_rel},
        tol=LOGIT_TOL, ok=ok)
    if not ok:
        raise SystemExit("evaluation failed its gates")
    total = {v: by_variant[v] + pool_by_variant[v] for v in by_variant}
    return total


def predict_experiment(work):
    """The 0006 ``FrameModel(DenseNet121, 11)`` at 512^2 with seeded random
    weights in flax naming, written by the port's checkpoint writer as epoch
    0 of ``<work>/models/vision/experiments/0006`` with ``scores.txt``, and
    ``<work>/data/classes.names``; returns the model (CPU, f32 parameters)."""
    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.inference import build_frame_model
    from tennis_torch.utils import checkpoint as ckpt

    model = build_frame_model("DenseNet121", 11, DATA_SHAPE)
    tree = random_flax_tree(to_flax(model), np.random.default_rng(SEED + 40))
    load_flax(model, tree)
    exp = os.path.join(work, "models", "vision", "experiments", "0006")
    ckpt.save_state(ckpt.epoch_path(exp, 0), tree)
    ckpt.append_score(exp, 0, 0.5)
    os.makedirs(os.path.join(work, "data"))
    with open(os.path.join(work, "data", "classes.names"), "w") as f:
        f.write("\n".join(DEFAULT_CLASSES) + "\n")
    return model


def predict_frames(pool, n):
    """The first ``n`` frames of a video cycling through ``pool``, sampled
    at ``--every`` PREDICT_EVERY as the decoder's frames are."""
    from tennis_torch.predict import sample_frames

    return sample_frames((pool[i % len(pool)] for i in range(n)),
                         PREDICT_EVERY)


def predict_phase(dev):
    """``predict.predict`` at full width past the decoder: PREDICT_FRAMES
    seeded 544x968 frames (PREDICT_DISTINCT distinct) at ``--every 2`` and
    ``--batch_size 64`` into a temporary experiment's best epoch, through
    the test geometry, the pinned prefetch and the dense-layer kernels, to
    ``probabilities.npy``, ``frames.txt`` and ``events.tsv``."""
    from tennis_torch import predict
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.data.transforms import device_prepare, test_geometry
    from tennis_torch.inference import load_classifier
    from tennis_torch.ops import dense_block as db

    rng = np.random.default_rng(SEED + 41)
    pool = rng.integers(0, 256, (PREDICT_DISTINCT, DATA_SHAPE + 32, 968, 3),
                        dtype=np.uint8)
    n_rows = PREDICT_FRAMES // PREDICT_EVERY
    with tempfile.TemporaryDirectory() as work, contextlib.chdir(work):
        model = predict_experiment(work)
        argv = ["--root=data", "--model_id=0006", "--backbone=DenseNet121",
                f"--every={PREDICT_EVERY}", f"--batch_size={EXTRACT_BATCH}",
                f"--data_shape={DATA_SHAPE}", f"--device={dev.type}"]
        warm = predict.parse_args(argv + ["--out_dir=warm"])
        predict.predict(warm, predict_frames(pool, 2 * EXTRACT_BATCH))
        args = predict.parse_args(argv + ["--out_dir=out"])
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        probs, ids, events = predict.predict(
            args, predict_frames(pool, PREDICT_FRAMES), stats)
        wall = time.perf_counter() - t0
        dense, gru_n = kernel_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        frames_txt = open(os.path.join("out", "frames.txt")).read()
        events_tsv = open(os.path.join("out", "events.tsv")).read()
        saved = np.load(os.path.join("out", "probabilities.npy"))

        # device busy and idle share over PROFILE_BATCHES batches of the
        # pipeline past the checkpoint load (the same classify call)
        _, predict_probs, _ = load_classifier("DenseNet121", "0006",
                                              DATA_SHAPE, "data", dev)
        walls = []

        def profiled():
            t = time.perf_counter()
            predict.classify(predict_frames(
                pool, PROFILE_BATCHES * EXTRACT_BATCH * PREDICT_EVERY),
                predict_probs, EXTRACT_BATCH, DATA_SHAPE, dev)
            walls.append((time.perf_counter() - t) * 1e3)

        by_name = device_profile(profiled)

    # the first and the ragged batch against the plain-version forward
    model = model.to(dev).eval()
    model.backbone.fold()
    errs = {}
    full, ragged = divmod(n_rows, EXTRACT_BATCH)
    for name, lo, n in (("first", 0, EXTRACT_BATCH),
                        ("ragged", full * EXTRACT_BATCH, ragged)):
        rows = np.arange(lo, lo + n)
        crops = np.stack([test_geometry(pool[(r * PREDICT_EVERY) % len(pool)],
                                        DATA_SHAPE) for r in rows])
        with torch.inference_mode():
            x = device_prepare(torch.from_numpy(crops).to(dev))
            want = torch.softmax(db.frame_model_apply(
                model, x, layer=db.dense_layer_reference), -1).cpu().numpy()
        errs[name] = float(np.abs(probs[rows] - want).max())
    del model
    want_ids = np.arange(0, PREDICT_FRAMES, PREDICT_EVERY)
    want_events = predict.label_runs(probs.argmax(-1), ids, probs)
    want_tsv = "start\tend\tclass\tmean_prob\n" + "".join(
        f"{s}\t{e}\t{DEFAULT_CLASSES[c]}\t{p:.4f}\n"
        for s, e, c, p in want_events)
    tiles = (events[0][0] == 0 and events[-1][1] == want_ids[-1] and all(
        a[1] + PREDICT_EVERY == b[0] for a, b in zip(events, events[1:])))
    batches = -(-n_rows // EXTRACT_BATCH)
    want_counts = {v: batches * n
                   for v, n in routed_launches(db, EXTRACT_BATCH).items()}
    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    ok = (probs.shape == (n_rows, 11) and bool(np.isfinite(probs).all())
          and np.array_equal(saved, probs)
          and bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3))
          and np.array_equal(ids, want_ids)
          and frames_txt == "\n".join(map(str, want_ids)) + "\n"
          and sum(dense.values()) == 58 * batches and dense == want_counts
          and gru_n == 0 and all(e <= PROB_TOL for e in errs.values())
          and events == want_events and events_tsv == want_tsv and tiles)
    log("predict", frames=PREDICT_FRAMES, every=PREDICT_EVERY, rows=n_rows,
        source_hw=list(pool.shape[1:3]), batch=EXTRACT_BATCH, batches=batches,
        ragged_batch=ragged, data_shape=DATA_SHAPE, wall_s=wall,
        classify_s=stats["classify_s"],
        frames_per_s=n_rows / stats["classify_s"],
        frames_per_s_with_load=n_rows / wall,
        prefetch={k: stats[k] for k in ("source_s", "device_put_s",
                                        "queue_full_s", "batches")},
        launches=sum(dense.values()), launches_by_variant=dense,
        routed_launches_by_variant=want_counts, events=len(events),
        probs_abs_err=errs, tol=PROB_TOL, peak_mem_gib=peak_gib,
        profile={"frames": PROFILE_BATCHES * EXTRACT_BATCH,
                 "wall_ms": walls[-1], "device_busy_ms": busy_ms,
                 "idle_share": 1 - busy_ms / walls[-1],
                 "dense_layer_ms": sum(
                     v[0] for k, v in by_name.items()
                     if any(n in k for n in DENSE_KERNELS.values())),
                 "top": [[k[:60], v[0], v[1]] for k, v in sorted(
                     by_name.items(), key=lambda kv: -kv[1][0])[:8]]},
        ok=ok)
    if not ok:
        raise SystemExit("predict failed its gates")
    return dense


def flownet_phase(dev):
    """FlowNet-S in bf16 through ``FlowRunner.flow_batch`` (uint8 upload,
    normalisation on the device, cuDNN convolutions) at FLOW_BATCH pairs of
    seeded 720p frames cropped to 1280x704, seeded random weights in flax
    naming through the bridge; against the same module in f32 (TF32 off)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.models.flownet import FlowNetS
    from tennis_torch.models.flownet_run import FlowRunner, crop_to_64, \
        flow_to_image, normalise_pairs

    rng = np.random.default_rng(SEED + 42)
    params = random_flax_tree(to_flax(FlowNetS()), rng)["params"]
    frames = rng.integers(0, 256, (FLOW_BATCH + 1, 720, 1280, 3),
                          dtype=np.uint8)
    pairs = np.stack([np.stack([crop_to_64(frames[i]),
                                crop_to_64(frames[i + 1])])
                      for i in range(FLOW_BATCH)])
    runner = FlowRunner(params=params, batch_size=FLOW_BATCH, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    times = []
    for _ in range(FLOW_WARMUP + FLOW_TIMED):
        t0 = time.perf_counter()
        flow = runner.flow_batch(pairs)  # a host array: synchronized
        times.append((time.perf_counter() - t0) * 1e3)
    ms = times[FLOW_WARMUP:]
    med = statistics.median(ms)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    walls = []

    def profiled():
        t = time.perf_counter()
        runner.flow_batch(pairs)
        walls.append((time.perf_counter() - t) * 1e3)

    by_name = device_profile(profiled)
    clean = no_kernel_launched(by_name)
    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))

    x = normalise_pairs(torch.from_numpy(pairs).to(dev))
    f32 = load_flax(FlowNetS(dtype=torch.float32), {"params": params}).to(dev)
    with torch.inference_mode():
        want = f32(x)
        pyramid = runner.model(x, train=True)
        with FlopCounterMode(display=False) as fc:
            runner.model(x[:1])
    rel = float((torch.from_numpy(flow).to(dev) - want).abs().max()
                / want.abs().max())
    h, w = pairs.shape[2] // 4, pairs.shape[3] // 4
    shapes = [list(f.shape) for f in pyramid]
    want_shapes = [[FLOW_BATCH, h // s, w // s, 2] for s in (1, 2, 4, 8, 16)]
    image = flow_to_image(flow[0])
    flops = fc.get_total_flops()
    ok = (flow.shape == (FLOW_BATCH, h, w, 2) == (FLOW_BATCH, 176, 320, 2)
          and bool(np.isfinite(flow).all()) and rel <= FLOW_TOL
          and shapes == want_shapes and image.shape == (h, w, 3)
          and image.dtype == np.uint8 and clean)
    log("flownet", pairs=FLOW_BATCH, pair_hw=list(pairs.shape[2:4]),
        dtype="bfloat16", flow_shape=list(flow.shape), pyramid=shapes,
        rel_err_vs_f32=rel, tol=FLOW_TOL, max_abs_f32_flow=float(
            want.abs().max()), image=list(image.shape),
        batch_ms=med, batch_ms_min=min(ms), batch_ms_max=max(ms),
        pairs_per_s=FLOW_BATCH / med * 1e3,
        model_gflop_per_pair=flops / 1e9,
        mfu=flops * FLOW_BATCH / (med / 1e3) / PEAK_BF16_FLOPS,
        device_busy_ms=busy_ms, profiled_wall_ms=walls[-1],
        idle_share=1 - busy_ms / walls[-1],
        device_mfu=flops * FLOW_BATCH / (busy_ms / 1e3) / PEAK_BF16_FLOPS,
        memcpy_ms=sum(v[0] for k, v in by_name.items()
                      if k.startswith("Memcpy")),
        top=[[k[:60], v[0], v[1]] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])[:8]],
        peak_mem_gib=peak_gib, no_kernel_launched=clean, ok=ok)
    if not ok:
        raise SystemExit("FlowNet-S failed its gates")


def serve_frames(batcher, frames):
    """Every frame through ``batcher`` from its own thread; returns the
    rows and the batches run."""
    results = [None] * len(frames)

    def request(i):
        results[i] = batcher.submit(frames[i], timeout=300)

    batches0 = batcher.batches
    threads = [threading.Thread(target=request, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise SystemExit("not every request was answered")
    return np.stack(results), batcher.batches - batches0


def alternating_ms(fns, reps=10):
    """{name: median ms of ``reps`` calls}, the calls of ``fns`` alternating
    (after one warm-up call each)."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def export_phase(dev):
    """``[export]``: the 0006 classifier (DenseNet121 at 512^2) from a
    temporary experiment through ``tennis_torch.export`` at batch 8 on the
    card: its graph, the artifact reloaded in a fresh interpreter that
    imports no model code, 16 requests through ``serve --from_export``'s
    ``build_service``, and the exported probabilities against the live
    scorer's and the plain-version forward's."""
    from tennis_torch import export, serve
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.inference import make_predict_probs
    from tennis_torch.ops import dense_block as db

    rng = np.random.default_rng(SEED + 50)
    frames = rng.integers(0, 256, (N_REQUESTS, DATA_SHAPE, DATA_SHAPE, 3),
                          dtype=np.uint8)
    routed = routed_launches(db)
    with tempfile.TemporaryDirectory() as work, contextlib.chdir(work):
        model = predict_experiment(work)
        t0 = time.perf_counter()
        program, meta = export.export_classifier(
            "DenseNet121", "0006", DATA_SHAPE, BATCH, root="data",
            device=dev.type)
        export_s = time.perf_counter() - t0
        calls = [n for n in program.graph.nodes if n.op == "call_function"]
        dense_nodes = [n for n in calls if str(n.target).startswith(
            "tennis_torch.dense_layer")]
        node_variants = {v: sum(n.args[-2] == v for n in dense_nodes)
                         for v in db.ROUTES}
        functionalized = sum("auto_functionalized" in str(n.target)
                             for n in calls)
        path = os.path.join(work, "0006.pt2")
        export.save_exported(path, program, meta)
        artifact_bytes = os.path.getsize(path)
        del program

        # a fresh interpreter: the two files and the op registrations only
        np.save("frames.npy", frames[:BATCH])
        code = (
            "import json, sys\n"
            "import numpy as np\n"
            "from tennis_torch.export import load_exported\n"
            "from tennis_torch.ops import dense_block as db\n"
            f"_, predict, meta = load_exported({path!r})\n"
            "np.save('fresh.npy', predict(np.load('frames.npy')))\n"
            "print(json.dumps({'by_variant': db.dense_layer.variant_launches,"
            " 'imported': [m for m in ('tennis_torch.models', "
            "'tennis_torch.inference') if m in sys.modules]}))\n")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", code], cwd=work,
                             env={**os.environ, "PYTHONPATH": HERE},
                             capture_output=True, text=True, timeout=600)
        fresh_s = time.perf_counter() - t0
        if out.returncode:
            raise SystemExit(f"the artifact failed in a fresh interpreter:\n"
                             f"{out.stderr[-3000:]}")
        fresh = json.loads(out.stdout.strip().splitlines()[-1])
        fresh_probs = np.load("fresh.npy")

        # serve --from_export: the sidecar sets the batch (the flag says 2)
        t0 = time.perf_counter()
        handler, batcher = serve.build_service(serve.parse_args(
            [f"--from_export={path}", "--max_wait_ms=200", "--batch_size=2"]))
        boot_s = time.perf_counter() - t0
        reset_kernel_counts()
        probs, batches = serve_frames(batcher, frames)
        dense, gru_n = kernel_counts()
        _, exported, _ = export.load_exported(path)

    live = make_predict_probs(model, dev)
    want_live = live(frames[:BATCH])
    got = exported(frames[:BATCH])
    live_err = float(np.abs(got - want_live).max())
    fresh_err = float(np.abs(fresh_probs - want_live).max())
    served_err = float(np.abs(probs[:BATCH] - want_live).max())
    # the plain-version logits against the exported log-probabilities, both
    # centred (the softmax drops a logit's shift)
    with torch.inference_mode():
        x = device_prepare(torch.from_numpy(frames[:BATCH]).to(dev))
        plain = db.frame_model_apply(model, x, layer=db.dense_layer_reference)
    plain = plain.float().cpu().numpy()
    plain -= plain.mean(-1, keepdims=True)
    logp = np.log(got.astype(np.float64))
    logp -= logp.mean(-1, keepdims=True)
    logit_err = float(np.abs(logp - plain).max() / np.abs(plain).max())
    top1 = bool((got.argmax(-1) == plain.argmax(-1)).all())
    latency = alternating_ms({"exported": lambda: exported(frames[:BATCH]),
                              "live": lambda: live(frames[:BATCH])})
    want_counts = {v: n * batches for v, n in routed.items()}
    ok = (len(dense_nodes) == 58 and functionalized == 0
          and node_variants == routed and batcher.batch_size == BATCH
          and meta["platforms"] == ["cuda"] and batches >= 1
          and dense == want_counts and gru_n == 0
          and fresh["imported"] == [] and fresh["by_variant"] == routed
          and max(live_err, fresh_err, served_err) <= EXPORT_TOL
          and logit_err <= LOGIT_TOL and top1)
    log("export", data_shape=DATA_SHAPE, batch=BATCH, export_s=export_s,
        artifact_bytes=artifact_bytes, graph_dense_layer_nodes=len(dense_nodes),
        graph_nodes_by_variant=node_variants,
        auto_functionalized_nodes=functionalized,
        fresh_interpreter={"seconds": fresh_s, **fresh},
        serve_boot_s=boot_s, requests=N_REQUESTS, batches=batches,
        launches=sum(dense.values()), launches_by_variant=dense,
        routed_launches_by_variant=want_counts,
        probs_vs_live_max_abs=live_err, fresh_vs_live_max_abs=fresh_err,
        served_vs_live_max_abs=served_err, tol=EXPORT_TOL,
        logits_rel_err=logit_err, logit_tol=LOGIT_TOL, top1_agrees=top1,
        batch8_latency_ms=latency, ok=ok)
    if not ok:
        raise SystemExit("the exported classifier failed its gates")
    return dense


def caption_dataset(root, vocab_words=VOCAB_WORDS, points=5):
    """A captioning TenniSet on disk for ``export_captioner`` and
    ``load_captioner``: one video of ``points`` points of 10 frames (the
    frame files exist and are empty: only their presence is read), each
    point's caption 50 of the ``vocab_words`` words, a split file, labels,
    and the 4096-d feature of the first point's first frame (which pins
    the feature size)."""
    from tennis_torch.data.tennis_set import get_feature_path, get_image_path

    video = "V000"
    frames = range(10 * points)
    for f in frames:
        path = get_image_path(os.path.join(root, "frames"), video, f)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
    for d in ("splits/02", "annotations/labels"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "splits", "02", "train.txt"), "w") as f:
        f.write("".join(f"{video} {i}\n" for i in frames))
    with open(os.path.join(root, "annotations", "labels", video + ".txt"),
              "w") as f:
        f.write("".join(f"{i} OTH\n" for i in frames))
    words = [f"w{i:03d}" for i in range(vocab_words)]
    per = -(-vocab_words // points)
    with open(os.path.join(root, "annotations", "points.txt"), "w") as f:
        f.write("".join(f"p{p} {video} {10 * p} {10 * p + 10} 0\n"
                        for p in range(points)))
    with open(os.path.join(root, "annotations", "captions.txt"), "w") as f:
        f.write("".join(f"p{p}\t{' '.join(words[p * per:(p + 1) * per])}\n"
                        for p in range(points)))
    path = get_feature_path(os.path.join(root, "features", "0006"), video, 0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.zeros(FEAT_DIM, np.float32))


def export_caption_phase(dev):
    """``[export_caption]``: the 0102 captioner (random weights written as
    ``valid_best.params`` of a temporary experiment over an on-disk caption
    index) through ``export_captioner`` at batch 4, ``--src_max_len 128``,
    with ``--pallas_gru`` and without, against the live ``load_captioner``
    translator on 8 seeded sources."""
    from tennis_torch import export
    from tennis_torch.bridge import to_flax
    from tennis_torch.data.tennis_set import CaptionIndex
    from tennis_torch.inference import load_captioner
    from tennis_torch.ops import gru
    from tennis_torch.train_gnmt import build_model, parse_args
    from tennis_torch.utils import checkpoint as ckpt

    rng = np.random.default_rng(SEED + 51)
    lens = rng.integers(20, SRC_MAX_LEN + 1, N_CAPTIONS).astype(np.int32)
    src = np.zeros((N_CAPTIONS, SRC_MAX_LEN, FEAT_DIM), np.float32)
    for i, n in enumerate(lens):
        src[i, :n] = rng.standard_normal((n, FEAT_DIM))
    batches = [(src[i:i + CAPTION_BATCH], lens[i:i + CAPTION_BATCH])
               for i in range(0, N_CAPTIONS, CAPTION_BATCH)]
    with tempfile.TemporaryDirectory() as work, contextlib.chdir(work):
        caption_dataset("data")
        args = parse_args(["--root=data", "--model_id=0102", *CAPTION_ARGV])
        vocab = CaptionIndex("data", split="train", max_cap_len=50,
                             feats_model="0006").vocab
        model = build_model(args, len(vocab), FEAT_DIM)
        exp = os.path.join("models", "captioning", "experiments", "0102")
        os.makedirs(exp)
        ckpt.save_state(os.path.join(exp, "valid_best.params"),
                        random_flax_tree(to_flax(model), rng))
        artifacts, export_s = {}, {}
        for name, kernel in (("pallas_gru", True), ("default", False)):
            t0 = time.perf_counter()
            program, meta = export.export_captioner(
                "0102", CAPTION_BATCH, src_max_len=SRC_MAX_LEN, root="data",
                gnmt_argv=CAPTION_ARGV, gru_kernel=kernel, device=dev.type)
            export_s[name] = time.perf_counter() - t0
            nodes = sum(str(n.target).startswith("tennis_torch.gru_recurrence")
                        for n in program.graph.nodes)
            path = f"{name}.pt2"
            export.save_exported(path, program, meta)
            artifacts[name] = (export.load_exported_captioner(path)[1], nodes,
                               os.path.getsize(path))
            del program
        _, live, info = load_captioner("0102", root="data",
                                       gnmt_argv=CAPTION_ARGV,
                                       src_max_len=SRC_MAX_LEN,
                                       device=dev.type)
    exported, gru_nodes, gru_bytes = artifacts["pallas_gru"]
    default, default_nodes, default_bytes = artifacts["default"]
    reset_kernel_counts()
    got = [exported(*b) for b in batches]
    launches = gru.gru_recurrence.launches
    by_variant = dict(gru.gru_recurrence.variant_launches)
    reset_kernel_counts()
    got_default = [default(*b) for b in batches]
    default_launches = gru.gru_recurrence.launches
    want = [live(*b) for b in batches]
    with plain_gru():
        want_plain = [live(*b) for b in batches]
    routed = gru.gru_route(SRC_MAX_LEN, CAPTION_BATCH, args.num_hidden)
    latency = alternating_ms({"exported_pallas_gru": lambda: exported(
        *batches[0]), "exported_default": lambda: default(*batches[0]),
        "live": lambda: live(*batches[0])}, reps=5)
    ok = (gru_nodes == 3 and default_nodes == 0
          and launches == 3 * len(batches) and by_variant[routed] == launches
          and default_launches == 0 and got == want
          and got_default == want_plain)
    log("export_caption", batch=CAPTION_BATCH, src_max_len=SRC_MAX_LEN,
        sources=N_CAPTIONS, lengths=lens.tolist(), vocab=len(vocab),
        max_length=info["max_length"], export_s=export_s,
        artifact_bytes={"pallas_gru": gru_bytes, "default": default_bytes},
        graph_gru_nodes={"pallas_gru": gru_nodes, "default": default_nodes},
        gru_launches=launches, gru_launches_by_variant=by_variant,
        default_gru_launches=default_launches,
        top_beams_equal_live=got == want,
        default_top_beams_equal_live_plain_recurrence=got_default == want_plain,
        tokens_per_caption=[len(t) for b in got for t in b],
        ms_per_batch=latency, ok=ok)
    if not ok:
        raise SystemExit("the exported captioner failed its gates")
    return by_variant


def native_phase():
    """``[native]``: which native host libraries built on this machine;
    with libjpeg, a seeded 1280x720 JPEG decoded natively and by cv2 at
    full size (the largest pixel difference; ms a decode) and a 2160-line
    one at ``min_short`` 544 (the 1/2 DCT scale). Nothing is gated: a
    machine without libjpeg takes cv2, the JAX package's own fallback."""
    from tennis_torch import native
    from tennis_torch.native import jpeg

    fields = {"have_native": native.HAVE_NATIVE,
              "have_native_jpeg": jpeg.HAVE_NATIVE_JPEG,
              "built": sorted(native.built)}
    if native.HAVE_NATIVE:
        rng = np.random.default_rng(SEED + 52)
        sents = [list(rng.integers(0, 250, rng.integers(6, 21)))
                 for _ in range(10_300)]
        t0 = time.perf_counter()
        centers, _ = native.center_context_pairs(sents, 3, 1)
        fields["pairs"] = {"n": len(centers),
                           "ms": (time.perf_counter() - t0) * 1e3}
    if jpeg.HAVE_NATIVE_JPEG:
        import cv2

        rng = np.random.default_rng(SEED + 53)

        def encoded(h, w):
            img = cv2.resize(rng.integers(0, 256, (h // 16, w // 16, 3),
                                          np.uint8), (w, h),
                             interpolation=cv2.INTER_CUBIC)
            return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[
                1].tobytes()

        small, large = encoded(720, 1280), encoded(2160, 3840)

        def by_cv2(data):
            return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                             cv2.IMREAD_COLOR),
                                cv2.COLOR_BGR2RGB)

        diff = int(np.abs(jpeg.decode_jpeg(small).astype(np.int16)
                          - by_cv2(small)).max())
        ms = alternating_ms({
            "native_720p": lambda: jpeg.decode_jpeg(small),
            "cv2_720p": lambda: by_cv2(small),
            "native_2160p_min_short_544": lambda: jpeg.decode_jpeg(large, 544),
            "cv2_2160p": lambda: by_cv2(large)}, reps=10)
        fields.update(cv2=cv2.__version__, max_pixel_diff_720p=diff,
                      half_scale_shape=list(jpeg.decode_jpeg(large, 544).shape),
                      decode_ms=ms)
    else:
        fields["jpeg"] = ("libjpeg or its headers are missing here: JPEGs "
                          "decode through cv2, the reference's host fallback")
    log("native", **fields)


def train_flops(batch, side=DATA_SHAPE, blocks=(6, 12, 24, 16), classes=11):
    """Model FLOPs of one DenseNet121 train step, counted from the layer
    shapes: every convolution and the head three times its forward
    (forward, input gradient, weight gradient), the stem's twice (its input
    needs no gradient); a remat's recomputation is not counted."""
    s = side // 2
    stem = 2 * batch * s * s * 64 * 3 * 49
    s //= 2
    rest, channels = 0, 64
    for i, n in enumerate(blocks):
        for j in range(n):
            rest += 2 * batch * s * s * ((channels + 32 * j) * 128 + 9 * 128 * 32)
        channels += 32 * n
        if i != len(blocks) - 1:
            rest += 2 * batch * s * s * channels * (channels // 2)
            channels //= 2
            s //= 2
    k = min(7, s)
    rest += 2 * batch * channels * (s // k) ** 2 * classes
    return 2 * stem + 3 * rest


def train_inputs(dev, frames, seed):
    """Seeded random weights (flax naming) of FrameModel(DenseNet121, 11) at
    512^2, ``frames`` on the device, and labels."""
    from tennis_torch.bridge import to_flax
    from tennis_torch.inference import build_frame_model

    rng = np.random.default_rng(seed)
    tree = random_flax_tree(to_flax(build_frame_model(
        "DenseNet121", 11, DATA_SHAPE)), rng)
    images = torch.from_numpy(frames).to(dev)
    labels = torch.from_numpy(rng.integers(0, 11, len(frames))).to(dev)
    return tree, images, labels


def train_state(dev, tree, remat=None, dtype=torch.bfloat16, lr=0.001):
    """A fresh train state of ``tree``'s weights on ``dev`` with the
    driver's default optimizer (at ``lr``), and its step (the device augment
    first)."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.data.transforms import device_augment
    from tennis_torch.inference import build_frame_model
    from tennis_torch.parallel.train_step import create_train_state, \
        make_train_step, sgd_with_schedule

    model = build_frame_model("DenseNet121", 11, DATA_SHAPE, dtype=dtype,
                              remat=remat)
    load_flax(model, tree).to(dev)
    tx, _ = sgd_with_schedule(lr, 0.9, 1e-4, (10, 20), 0.75,
                              DRIVER_TRAIN // TRAIN_BATCH)
    state = create_train_state(model, tx)
    step = make_train_step(state, lambda x, g: device_augment(x, g, dtype),
                           rng_seed=SEED + 123)
    return state, step


def train_phase(dev, frames):
    """The train step at full width: DenseNet121 at 512^2, batch 64, with
    remat none and block; its gates against f32 and between the modes."""
    tree, images, labels = train_inputs(dev, frames, SEED + 8)
    n_batches = len(frames) // TRAIN_BATCH

    def batch(i, size=TRAIN_BATCH):
        lo = i % n_batches * size
        return images[lo:lo + size], labels[lo:lo + size]

    flops = train_flops(TRAIN_BATCH)
    modes, all_finite = {}, True
    for remat in (None, "block"):
        state, step = train_state(dev, tree, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            t0 = time.perf_counter()
            loss, _ = step(*batch(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        walls = []

        def profiled():
            t = time.perf_counter()
            for i in range(TRAIN_PROFILED):
                step(*batch(i))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)

        by_name = device_profile(profiled)
        busy_ms = sum(v[0] for k, v in by_name.items()
                      if not k.startswith(("Memcpy", "Memset")))
        timed = times[TRAIN_WARMUP:]
        med = statistics.median(timed)
        finite = bool(np.isfinite(losses).all())
        all_finite = all_finite and finite
        modes[remat or "none"] = {
            "first_loss": losses[0], "peak_gib": peak_gib, "step_ms": med}
        log("train", remat=remat or "none", batch=TRAIN_BATCH,
            data_shape=DATA_SHAPE, steps=len(losses), timed_steps=len(timed),
            step_ms=med, step_ms_min=min(timed), step_ms_max=max(timed),
            step_ms_spread=(max(timed) - min(timed)) / med,
            samples_per_s=TRAIN_BATCH / med * 1e3,
            device_busy_ms_per_step=busy_ms / TRAIN_PROFILED,
            idle_share=1 - busy_ms / walls[-1],
            profiled_wall_ms_per_step=walls[-1] / TRAIN_PROFILED,
            device_launches_per_step=sum(v[1] for v in by_name.values())
            / TRAIN_PROFILED,
            top=[[k[:60], v[0] / TRAIN_PROFILED, v[1] // TRAIN_PROFILED]
                 for k, v in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]],
            peak_mem_gib=peak_gib, model_gflop_per_step=flops / 1e9,
            mfu=flops / (med / 1e3) / PEAK_BF16_FLOPS,
            first_losses=losses[:4], last_loss=losses[-1], losses_finite=finite)
        del state, step, by_name

    # 30 steps on one repeated batch (a new augment draw each step)
    state, step = train_state(dev, tree)
    overfit = [step(*batch(0))[0].item() for _ in range(OVERFIT_STEPS)]
    del state, step
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])

    # the first step in bf16 against the same step in f32, at F32_BATCH
    x, y = batch(0, F32_BATCH)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        state, step = train_state(dev, tree, dtype=dtype)
        names = [n for n, _ in state.model.named_parameters()]
        before = [p.detach().clone() for p in state.model.parameters()]
        loss, _ = step(x, y)
        runs[dtype] = (loss.item(), [p.detach() - b for p, b in zip(
            state.model.parameters(), before)],
            [b.clone() for b in state.model.buffers()])
        del state, step, before
    (loss_b, upd_b, stats_b), (loss_f, upd_f, stats_f) = \
        runs[torch.bfloat16], runs[torch.float32]
    loss_rel = abs(loss_b - loss_f) / abs(loss_f)
    stats_rel = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(stats_b, stats_f))
    diff = torch.cat([(a - b).flatten() for a, b in zip(upd_b, upd_f)])
    update_rel = (diff.norm() / torch.cat(
        [b.flatten() for b in upd_f]).norm()).item()
    head = [(a - b).norm() / b.norm() for n, a, b in zip(names, upd_b, upd_f)
            if n.startswith("classes.")]
    remat_rel = abs(modes["block"]["first_loss"] - modes["none"]["first_loss"]) \
        / abs(modes["none"]["first_loss"])
    ok = (all_finite and lowered and loss_rel <= TRAIN_LOSS_TOL
          and stats_rel <= TRAIN_STATS_TOL and update_rel <= TRAIN_UPDATE_TOL
          and remat_rel <= REMAT_LOSS_TOL
          and modes["block"]["peak_gib"] < modes["none"]["peak_gib"])
    log("train_check", losses_finite=all_finite, overfit_losses=overfit,
        overfit_lowered=lowered, f32_batch=F32_BATCH, loss_bf16=loss_b,
        loss_f32=loss_f, loss_rel=loss_rel, loss_tol=TRAIN_LOSS_TOL,
        running_stats_rel=stats_rel, stats_tol=TRAIN_STATS_TOL,
        update_rel_l2=update_rel, update_tol=TRAIN_UPDATE_TOL,
        head_update_rel_l2=max(h.item() for h in head),
        remat_first_loss_rel=remat_rel, remat_tol=REMAT_LOSS_TOL,
        peak_gib={k: v["peak_gib"] for k, v in modes.items()}, ok=ok)
    if not ok:
        raise SystemExit("the train step failed its gates")


def train_driver_phase(dev, frames):
    """``train.fit`` over in-memory splits: 2 epochs of DRIVER_BATCHES
    steps, val after each, the best epoch reloaded and tested; the epoch
    files, each evaluation's kernel launches and logits, and a resumed step
    against the uninterrupted run. Returns the evaluations' dense launches
    by variant."""
    import tempfile
    from unittest import mock

    from tennis_torch import inference
    from tennis_torch import train as driver
    from tennis_torch.bridge import load_flax, state_from_flax
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.inference import build_frame_model
    from tennis_torch.ops import dense_block as db
    from tennis_torch.parallel import train_step as ts
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec

    tree, _, _ = train_inputs(dev, frames[:1], SEED + 9)
    model = build_frame_model("DenseNet121", 11, DATA_SHAPE)
    load_flax(model, tree)
    # lr 0.01: the weights move between evaluations by more than the
    # kernels' distance to the plain version, so a stale fold would show
    args = driver.parse_args([
        "--backbone=DenseNet121", f"--batch_size={TRAIN_BATCH}", "--epochs=2",
        f"--max_batches={DRIVER_BATCHES}", "--log_interval=1", "--lr=0.01"])
    splits = {"train": MemorySplit(frames, DRIVER_TRAIN, None, "train"),
              "val": MemorySplit(frames[::-1], DRIVER_EVAL, None, "val"),
              "test": MemorySplit(frames[1:], DRIVER_EVAL, None, "test")}
    loaders = {k: DataLoader(ds, TRAIN_BATCH, shuffle=k == "train",
                             seed=args.seed, num_workers=8,
                             drop_last=k == "train")
               for k, ds in splits.items()}

    passes, saved, epoch1_first = [], [], {}
    make_eval_step, make_train_step = inference.make_eval_step, \
        ts.make_train_step
    save = ckpt.AsyncCheckpointer.save

    def plain_logits(weights, x):
        """The plain-version forward of a model loaded afresh with
        ``weights``: its BN folded from them, whatever any step cached."""
        from tennis_torch.data.transforms import device_prepare

        ref = build_frame_model("DenseNet121", 11, DATA_SHAPE)
        ref.load_state_dict(weights)
        ref.to(dev)
        with torch.inference_mode():
            return db.frame_model_apply(ref, device_prepare(x, ref.dtype),
                                        layer=db.dense_layer_reference)

    def rel(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    previous = {"weights": {k: v.clone() for k, v in
                            model.state_dict().items()}}

    def recording_eval_step(m, device, **kw):
        """The driver's eval step, recording each pass's launches, and its
        first batch's logits against the plain-version forward of the
        current weights and of the weights of the evaluation before (the
        initial ones for the first)."""
        step = make_eval_step(m, device, **kw)
        record = {"launches": dict.fromkeys(db.ROUTES, 0), "batches": []}
        passes.append(record)

        def wrapped(x):
            before = dict(db.dense_layer.variant_launches)
            out = step(x)
            for v, n in db.dense_layer.variant_launches.items():
                record["launches"][v] += n - before[v]
            record["batches"].append(len(x))
            if "rel_err" not in record:
                weights = {k: v.clone() for k, v in m.state_dict().items()}
                want = plain_logits(weights, x)
                record["rel_err"] = rel(out, want)
                record["previous_weights_rel_err"] = rel(
                    out, plain_logits(previous["weights"], x))
                record["top1_agrees"] = bool(
                    (out.argmax(-1) == want.argmax(-1)).all())
                previous["weights"] = weights
            return out

        return wrapped

    def recording_train_step(state, *a, **kw):
        step = make_train_step(state, *a, **kw)

        def wrapped(images, labels):
            out = step(images, labels)
            if state.step == DRIVER_BATCHES + 1:  # epoch 1's first step
                epoch1_first["params"] = [p.detach().clone() for p in
                                          state.model.parameters()]
                epoch1_first["batch"] = (images.clone(), np.asarray(labels))
            return out

        return wrapped

    def recording_save(self, path, tree):
        saved.append((path, tree))
        return save(self, path, tree)

    with tempfile.TemporaryDirectory() as exp_dir:
        with mock.patch.object(inference, "make_eval_step",
                               recording_eval_step), \
                mock.patch.object(ts, "make_train_step",
                                  recording_train_step), \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  recording_save):
            reset_dense_counts(db)
            t0 = time.perf_counter()
            state, test_metrics = driver.fit(args, model, loaders, exp_dir,
                                             dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(db.dense_layer.variant_launches)
        files = sorted(f for f in os.listdir(exp_dir) if f != "tb")
        # the files read back as they were saved, momentum included
        identical = len(saved) == 2
        for path, snapshot in saved:
            identical = identical and msgpack_codec.serialize(
                ckpt.load_raw(path)) == msgpack_codec.serialize(snapshot)
        best = ckpt.best_epoch(exp_dir)
        want = driver_state_dict(ckpt.load_raw(ckpt.epoch_path(exp_dir,
                                                               best[0])))
        tested_best = all(np.array_equal(t.cpu().numpy(), want[k])
                          for k, t in state.model.state_dict().items())
        # resume from epoch 0, take epoch 1's first step
        resumed, step = train_state(dev, tree, lr=args.lr)
        state_from_flax(resumed, ckpt.load_raw(ckpt.epoch_path(exp_dir, 0)))
        prev = [p.detach().clone() for p in resumed.model.parameters()]
        step(*epoch1_first["batch"])
        num = sum(((p - q) ** 2).sum() for p, q in zip(
            resumed.model.parameters(), epoch1_first["params"]))
        den = sum(((q - r) ** 2).sum() for q, r in zip(
            epoch1_first["params"], prev))
        resume_rel = (num.sqrt() / den.sqrt()).item()

    full, ragged = divmod(DRIVER_EVAL, TRAIN_BATCH)
    want_pass = {v: full * n + routed_launches(db, ragged)[v]
                 for v, n in routed_launches(db, TRAIN_BATCH).items()}
    # the val passes (not the test, whose best-epoch weights may be the last
    # val's) are nearer their own epoch's weights than the previous ones
    passes_ok = len(passes) == 3 and all(
        r["launches"] == want_pass and r["rel_err"] <= LOGIT_TOL
        and r["top1_agrees"] for r in passes) and all(
        r["rel_err"] < r["previous_weights_rel_err"] for r in passes[:2])
    want_total = {v: 3 * n for v, n in want_pass.items()}
    ok = (files == ["0000.params", "0001.params", "scores.txt"]
          and identical and passes_ok and launches == want_total
          and tested_best and resume_rel <= RESUME_TOL
          and state.step in (DRIVER_BATCHES, 2 * DRIVER_BATCHES))
    log("train_driver", epochs=2, steps_per_epoch=DRIVER_BATCHES,
        batch=TRAIN_BATCH, files=files, saved_read_back_identical=identical,
        evaluations=[{k: r[k] for k in (
            "launches", "batches", "rel_err", "previous_weights_rel_err",
            "top1_agrees")} for r in passes],
        routed_launches_per_evaluation=want_pass, launches=launches,
        best_epoch=best[0], test_on_best_weights=tested_best,
        test_AVG_NB_f1=test_metrics["prf1"].get_dict()["AVG_NB_f1"],
        resume_first_step_rel=resume_rel, resume_tol=RESUME_TOL,
        logit_tol=LOGIT_TOL, wall_s=wall, ok=ok)
    if not ok:
        raise SystemExit("the training driver failed its gates")
    return launches


def driver_state_dict(tree):
    """A train-state tree's parameters and statistics as a torch state
    dict of numpy arrays."""
    from tennis_torch.bridge import from_flax

    return {k: v.numpy() for k, v in from_flax(
        {"params": tree["params"],
         "batch_stats": tree["batch_stats"]}).items()}


def reset_kernel_counts():
    """Every kernel wrapper's launch count to 0 (dense layer and GRU)."""
    from tennis_torch.ops import dense_block as db
    from tennis_torch.ops import gru

    reset_dense_counts(db)
    gru.gru_recurrence.launches = 0
    gru.gru_recurrence.variant_launches = dict.fromkeys(gru.VARIANTS, 0)


def kernel_counts():
    """(dense-layer kernel launches by route, GRU kernel launches)."""
    from tennis_torch.ops import dense_block as db
    from tennis_torch.ops import gru

    return dict(db.dense_layer.variant_launches), gru.gru_recurrence.launches


def time_steps(step, batch, warmup, timed, profiled=TRAIN_PROFILED):
    """``warmup + timed`` calls of ``step(*batch(i))``, each timed to a
    synchronize, then (``profiled`` > 0) that many more under the device
    profiler. Returns the losses, the fields every train phase logs (step
    ms, its range, peak memory; device busy ms, idle share and launches a
    step, the largest kernels) and the profile by kernel name."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss, _ = step(*batch(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    ms = times[warmup:]
    med = statistics.median(ms)
    fields = {"steps": len(losses), "timed_steps": timed, "step_ms": med,
              "step_ms_min": min(ms), "step_ms_max": max(ms),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "first_losses": losses[:4], "last_loss": losses[-1],
              "losses_finite": bool(np.isfinite(losses).all())}
    if not profiled:
        return losses, fields, {}
    walls = []

    def run():
        t = time.perf_counter()
        for i in range(profiled):
            step(*batch(i))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    by_name = device_profile(run)
    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    fields.update(
        device_busy_ms_per_step=busy_ms / profiled,
        idle_share=1 - busy_ms / walls[-1],
        profiled_wall_ms_per_step=walls[-1] / profiled,
        device_launches_per_step=sum(v[1] for v in by_name.values())
        / profiled,
        top=[[k[:60], v[0] / profiled, v[1] // profiled]
             for k, v in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]])
    return losses, fields, by_name


def kernel_launches_in(by_name):
    """Launches of the dense-layer and GRU kernels in a profile."""
    names = (*DENSE_KERNELS.values(), *GRU_KERNELS.values())
    return sum(v[1] for k, v in by_name.items()
               if any(n in k for n in names))


def seeded_model(argv, seed, feats=False):
    """``train.build_model`` of the driver flags ``argv`` (11 classes),
    with seeded random weights in flax naming through ``load_flax``; the
    flags and the model, on the CPU."""
    from tennis_torch import train as driver
    from tennis_torch.bridge import load_flax, to_flax

    args = driver.parse_args(argv)
    model = driver.build_model(args, 11, feats)
    rng = np.random.default_rng(seed)
    return args, load_flax(model, random_flax_tree(to_flax(model), rng))


def sgd_state(model, args, steps_per_epoch):
    """The driver's train state and step of ``model`` (on its device):
    momentum SGD at ``--lr`` with the epoch schedule, ``--freeze_backbone``,
    the driver's preprocess."""
    from tennis_torch import train as driver
    from tennis_torch.parallel.train_step import create_train_state, \
        make_train_step, sgd_with_schedule

    tx, _ = sgd_with_schedule(args.lr, args.momentum, args.wd,
                              [int(e) for e in args.lr_steps],
                              args.lr_factor, steps_per_epoch)
    state = create_train_state(model, tx, args.freeze_backbone)
    return state, make_train_step(state, driver.make_preprocess(
        args, model.dtype), rng_seed=args.seed + 123)


def cnnrnn_train_phase(dev):
    """The 0042 CNN-RNN's train step at its published configuration:
    (64, 30, 4096) features on the device, bi-GRU 128 in bf16, SGD; 3
    warm-up and 3 timed steps, then the LSTM cell (10 timed). Gates:
    finite losses, a repeated batch learnt, the first step on the card
    against the CPU in f32 (loss, gradients), and no dense-layer or GRU
    kernel launched in a step."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.models import CNNRNN
    from tennis_torch.parallel.train_step import softmax_ce

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    feats = torch.randn(CNNRNN_POOL, CNNRNN_WINDOW, FEAT_DIM, device=dev,
                        generator=gen)
    labels = torch.randint(0, 11, (CNNRNN_POOL,), device=dev, generator=gen)
    n_batches = CNNRNN_POOL // CNNRNN_BATCH

    def batch(i):
        lo = i % n_batches * CNNRNN_BATCH
        return feats[lo:lo + CNNRNN_BATCH], labels[lo:lo + CNNRNN_BATCH]

    trees, finite, in_steps = {}, True, 0
    reset_kernel_counts()
    for cell, timed in (("gru", TRAIN_TIMED), ("lstm", CNNRNN_LSTM_TIMED)):
        argv = [a for a in CNNRNN_ARGV if not a.startswith("--temp_pool")]
        args, model = seeded_model(argv + [f"--temp_pool={cell}"], SEED + 10,
                                   feats=True)
        trees[cell] = {k: v.clone() for k, v in model.state_dict().items()}
        state, step = sgd_state(model.to(dev), args, n_batches)
        losses, fields, by_name = time_steps(step, batch, TRAIN_WARMUP, timed)
        finite = finite and fields["losses_finite"]
        in_steps += kernel_launches_in(by_name)
        log("cnnrnn_train", cell=cell, batch=CNNRNN_BATCH,
            window=CNNRNN_WINDOW, feat_dim=FEAT_DIM, hidden=128,
            dtype="bfloat16",
            windows_per_s=CNNRNN_BATCH / fields["step_ms"] * 1e3, **fields)
        del state, step, model
    dense, gru_n = kernel_counts()

    # 30 steps on one repeated batch
    args, model = seeded_model(CNNRNN_ARGV, SEED + 10, feats=True)
    _, step = sgd_state(model.to(dev), args, n_batches)
    overfit = [step(*batch(0))[0].item() for _ in range(OVERFIT_STEPS)]
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])
    del model, step

    # the first step in f32 (TF32 off), card against CPU
    runs = []
    for device in (dev, torch.device("cpu")):
        model = CNNRNN(None, 11, 128, "gru", dtype=torch.float32,
                       feature_dim=FEAT_DIM)
        model.load_state_dict(trees["gru"])
        model.to(device)
        x, y = (t.to(device) for t in batch(0))
        loss = softmax_ce(model(x, train=True), y)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append((loss.item(), [g.cpu() for g in grads]))
        del model
    (loss_c, g_c), (loss_h, g_h) = runs
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    grad_rel = (torch.cat([(a - b).flatten() for a, b in zip(g_c, g_h)]).norm()
                / torch.cat([b.flatten() for b in g_h]).norm()).item()
    no_kernel = (sum(dense.values()) == 0 and gru_n == 0 and in_steps == 0)
    ok = (finite and lowered and loss_rel <= CNNRNN_LOSS_TOL
          and grad_rel <= CNNRNN_GRAD_TOL and no_kernel)
    log("cnnrnn_train_check", losses_finite=finite, overfit_losses=overfit,
        overfit_lowered=lowered, loss_card=loss_c, loss_cpu=loss_h,
        loss_rel=loss_rel, loss_tol=CNNRNN_LOSS_TOL, grad_rel_l2=grad_rel,
        grad_tol=CNNRNN_GRAD_TOL, dense_launches=dense, gru_launches=gru_n,
        kernel_launches_profiled=in_steps, wall_s=time.perf_counter() - t_phase,
        ok=ok)
    if not ok:
        raise SystemExit("the CNN-RNN's train step failed its gates")


def cnnrnn_driver_phase(dev):
    """``train.fit`` of the 0042 CNN-RNN over in-memory windowed-feature
    splits (train DRIVER_TRAIN windows, val and test DRIVER_EVAL) for 2
    epochs of DRIVER_BATCHES steps; a copy of its epoch 0 resumed to 2
    epochs; then ``evaluate --metrics_out``. Gates: the epoch files and
    scores.txt read back bit for bit as saved, the resumed run's epoch file
    equal to the uninterrupted one's, the evaluation's PRF1 that of the
    trainer's final test, no kernel launched."""
    import shutil
    import tempfile
    from unittest import mock

    from tennis_torch import evaluate
    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec
    from tennis_torch.utils.experiments import experiment_dir

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    pool = rng.standard_normal((CNNRNN_BATCH, CNNRNN_WINDOW, FEAT_DIM),
                               dtype=np.float32)
    argv = CNNRNN_ARGV + [f"--batch_size={CNNRNN_BATCH}", "--epochs=2",
                          f"--max_batches={DRIVER_BATCHES}",
                          "--log_interval=1", "--model_id=cr"]
    splits = {"train": MemorySplit(pool, DRIVER_TRAIN, None, "train"),
              "val": MemorySplit(pool[::-1], DRIVER_EVAL, None, "val"),
              "test": MemorySplit(pool[1:], DRIVER_EVAL, None, "test")}

    def run_fit(exp_dir):
        args, model = seeded_model(argv, SEED + 11, feats=True)
        loaders = {k: DataLoader(ds, CNNRNN_BATCH, shuffle=k == "train",
                                 seed=args.seed, num_workers=8,
                                 drop_last=k == "train")
                   for k, ds in splits.items()}
        return driver.fit(args, model, loaders, exp_dir, dev)

    saved, scored = [], []
    save, append = ckpt.AsyncCheckpointer.save, ckpt.append_score

    def recording_save(self, path, tree):
        saved.append((path, tree))
        return save(self, path, tree)

    def recording_score(exp_dir, epoch, score):
        scored.append((exp_dir, f"{epoch}\t{score}\n"))
        return append(exp_dir, epoch, score)

    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as work, \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  recording_save), \
                mock.patch.object(ckpt, "append_score", recording_score), \
                mock.patch.object(driver, "make_eval_dataset",
                                  lambda a, split, every_n=None:
                                  splits[split]):
            os.chdir(work)
            exp = experiment_dir("vision", "cr")
            reset_kernel_counts()
            t0 = time.perf_counter()
            _, test_metrics = run_fit(exp)
            torch.cuda.synchronize()
            wall_fit = time.perf_counter() - t0
            files = sorted(f for f in os.listdir(exp) if f != "tb")
            resumed_exp = experiment_dir("vision", "cr_resumed")
            os.makedirs(resumed_exp, exist_ok=True)
            shutil.copy(ckpt.epoch_path(exp, 0), resumed_exp)
            with open(os.path.join(resumed_exp, "scores.txt"), "w") as f:
                f.write(scored[0][1])
            t0 = time.perf_counter()
            run_fit(resumed_exp)
            wall_resume = time.perf_counter() - t0
            uninterrupted, resumed = (ckpt.load_raw(ckpt.epoch_path(e, 1))
                                      for e in (exp, resumed_exp))
            resumed_equal = msgpack_codec.serialize(uninterrupted) == \
                msgpack_codec.serialize(resumed)
            params_max_abs = max(float(np.abs(a - b).max()) for a, b in zip(
                driver_state_dict(uninterrupted).values(),
                driver_state_dict(resumed).values()))
            identical = len(saved) == 3 and all(
                msgpack_codec.serialize(ckpt.load_raw(p))
                == msgpack_codec.serialize(t) for p, t in saved)
            with open(os.path.join(exp, "scores.txt")) as f:
                identical = identical and f.read() == "".join(
                    row for d, row in scored if d == exp)
            metrics_path = os.path.join(work, "metrics.json")
            t0 = time.perf_counter()
            results, _, metrics = evaluate.evaluate_model(evaluate.parse_args(
                argv + [f"--metrics_out={metrics_path}"]))
            wall_eval = time.perf_counter() - t0
            with open(metrics_path) as f:
                dumped = json.load(f)
            dense, gru_n = kernel_counts()
    finally:
        os.chdir(cwd)
    probs = np.stack(list(results.values()))
    probs_ok = (probs.shape == (DRIVER_EVAL, 11)
                and bool(np.isfinite(probs).all())
                and bool(np.allclose(probs.sum(-1), 1, atol=1e-4)))
    same_as_fit = dumped == metrics["prf1"].get_dict() == \
        test_metrics["prf1"].get_dict()
    ok = (files == ["0000.params", "0001.params", "scores.txt"] and identical
          and resumed_equal and probs_ok and same_as_fit
          and sum(dense.values()) == 0 and gru_n == 0)
    log("cnnrnn_driver", epochs=2, steps_per_epoch=DRIVER_BATCHES,
        batch=CNNRNN_BATCH, train_windows=DRIVER_TRAIN,
        eval_windows=DRIVER_EVAL, files=files,
        saved_read_back_identical=identical, resumed_equal=resumed_equal,
        resumed_params_max_abs_diff=params_max_abs, evaluated=len(results),
        probs_ok=probs_ok, metrics_equal_fit_test=same_as_fit,
        test_AVG_NB_f1=dumped.get("AVG_NB_f1"), dense_launches=dense,
        gru_launches=gru_n, fit_wall_s=wall_fit, resume_wall_s=wall_resume,
        evaluate_wall_s=wall_eval, wall_s=time.perf_counter() - t_phase,
        ok=ok)
    if not ok:
        raise SystemExit("the CNN-RNN driver failed its gates")


def eval_against_plain(model, dev, x, streams):
    """One evaluation forward of ``x`` through ``make_eval_step``, the
    launch counts set to 0 just before and read just after; its logits
    against the plain-version forward on the same card. Returns the log
    fields, whether it passed, and the dense launches by route."""
    from tennis_torch.inference import make_eval_step, prepare_input
    from tennis_torch.ops import dense_block as db

    step = make_eval_step(model, dev)
    batch = x.shape[0] * (x.shape[1] if x.dim() == 5 else 1)
    reset_kernel_counts()
    got = step(x)
    torch.cuda.synchronize()
    by_route, gru_n = kernel_counts()
    with torch.inference_mode(), db.plain_dense_layers(model):
        want = model(prepare_input(x, model.dtype))
    torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    routed = {v: streams * n for v, n in routed_launches(db, batch).items()}
    ok = (by_route == routed and gru_n == 0 and rel <= LOGIT_TOL and top1
          and bool(torch.isfinite(got).all()))
    return ({"eval_frames_per_forward": batch,
             "eval_launches": sum(by_route.values()),
             "eval_launches_by_route": by_route,
             "routed_launches_by_route": routed, "eval_logits_rel_err": rel,
             "eval_top1_agrees": top1, "logit_tol": LOGIT_TOL}, ok, by_route)


def two_stream_phase(dev):
    """The 0010 two-stream net (``--flow twos``, two DenseNet121 streams)
    at 512^2, batch 64, ``--remat block``, over TWO_STREAM_FRAMES seeded
    6-channel frames on the device: 3 warm-up and TWO_STREAM_TIMED timed
    steps; then ``--flow only`` and ``sixc``, OTHER_FLOW_STEPS steps each.
    After each, an evaluation forward at batch 64: 58 dense launches a
    stream as routed, logits against the plain version. Returns the
    evaluations' dense launches by route."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    frames = torch.randint(0, 256, (TWO_STREAM_FRAMES, DATA_SHAPE,
                                    DATA_SHAPE, 6), dtype=torch.uint8,
                           device=dev, generator=gen)
    labels = torch.randint(0, 11, (TWO_STREAM_FRAMES,), device=dev,
                           generator=gen)
    n_batches = TWO_STREAM_FRAMES // TRAIN_BATCH

    def batch(i):
        lo = i % n_batches * TRAIN_BATCH
        return frames[lo:lo + TRAIN_BATCH], labels[lo:lo + TRAIN_BATCH]

    launches, all_ok = None, True
    for flow, timed in (("twos", TWO_STREAM_TIMED),
                        ("only", OTHER_FLOW_STEPS), ("sixc", OTHER_FLOW_STEPS)):
        t0 = time.perf_counter()
        args, model = seeded_model(["--backbone=DenseNet121",
                                    f"--data_shape={DATA_SHAPE}",
                                    f"--flow={flow}", "--remat=block"],
                                   SEED + 12)
        state, step = sgd_state(model.to(dev), args, n_batches)
        streams = 2 if flow == "twos" else 1
        warmup = TRAIN_WARMUP if flow == "twos" else 0
        _, fields, _ = time_steps(step, batch, warmup, timed,
                                  TRAIN_PROFILED if flow == "twos" else 0)
        flops = streams * train_flops(TRAIN_BATCH)
        evals, ok, by_route = eval_against_plain(model, dev, batch(0)[0],
                                                 streams)
        ok = ok and fields["losses_finite"]
        all_ok = all_ok and ok
        launches = by_route if launches is None else {
            v: launches[v] + n for v, n in by_route.items()}
        log("two_stream", flow=flow, streams=streams, batch=TRAIN_BATCH,
            data_shape=DATA_SHAPE, remat="block",
            samples_per_s=TRAIN_BATCH / fields["step_ms"] * 1e3,
            model_gflop_per_step=flops / 1e9,
            mfu=flops / (fields["step_ms"] / 1e3) / PEAK_BF16_FLOPS,
            **fields, **evals, wall_s=time.perf_counter() - t0, ok=ok)
        del state, step, model
        torch.cuda.empty_cache()
    log("two_stream_check", wall_s=time.perf_counter() - t_phase, ok=all_ok)
    if not all_ok:
        raise SystemExit("the two-stream net failed its gates")
    return launches


def cnnrnn_clips_phase(dev, frames):
    """The CNN-RNN over clips: ``FrameModel(DenseNet121)`` at 512^2
    time-distributed over CLIP_BATCH clips of CNNRNN_WINDOW frames (one
    forward of their frames), bi-GRU 128, ``--remat block``, with
    ``--freeze_backbone`` off and on: 3 warm-up and CLIP_TIMED timed steps
    each. Gates: frozen, the backbone's parameters unchanged bit for bit
    while its BN statistics and the rest move; an evaluation forward of 58
    dense launches at batch CLIP_BATCH * CNNRNN_WINDOW, logits against the
    plain version. Returns that forward's dense launches by route."""
    t_phase = time.perf_counter()
    images = torch.from_numpy(frames).to(dev)
    labels = torch.arange(CLIP_BATCH * 4, device=dev) % 11
    k = len(frames)

    def batch(i):
        idx = [(((i * CLIP_BATCH + b) * CNNRNN_WINDOW + t) * 7) % k
               for b in range(CLIP_BATCH) for t in range(CNNRNN_WINDOW)]
        clips = images[idx].reshape(CLIP_BATCH, CNNRNN_WINDOW,
                                    *images.shape[1:])
        return clips, labels[i % 4 * CLIP_BATCH:(i % 4 + 1) * CLIP_BATCH]

    all_ok, launches = True, None
    for frozen in (False, True):
        t0 = time.perf_counter()
        argv = ["--backbone=DenseNet121", f"--data_shape={DATA_SHAPE}",
                "--temp_pool=gru", f"--window={CNNRNN_WINDOW}",
                "--remat=block"] + (
            ["--freeze_backbone"] if frozen else [])
        args, model = seeded_model(argv, SEED + 13)
        model.to(dev)
        before = {k_: v.detach().clone() for k_, v in
                  model.state_dict().items()}
        state, step = sgd_state(model, args, 4)
        _, fields, _ = time_steps(step, batch, TRAIN_WARMUP, CLIP_TIMED, 0)
        after = model.state_dict()
        moved = {k_: not torch.equal(before[k_], after[k_]) for k_ in before}
        backbone_params = [n for n, _ in model.named_parameters()
                           if n.startswith("model.backbone.")]
        stats = [n for n, _ in model.named_buffers()]
        rest = [n for n, _ in model.named_parameters()
                if not n.startswith("model.backbone.")]
        if frozen:
            ok = (not any(moved[n] for n in backbone_params)
                  and all(moved[n] for n in stats)
                  and all(moved[n] for n in rest))
        else:
            ok = all(moved[n] for n in backbone_params + stats + rest)
        evals = {}
        if not frozen:
            evals, eval_ok, launches = eval_against_plain(
                model, dev, batch(0)[0], 1)
            ok = ok and eval_ok
        ok = ok and fields["losses_finite"]
        all_ok = all_ok and ok
        log("cnnrnn_clips", freeze_backbone=frozen, clips=CLIP_BATCH,
            window=CNNRNN_WINDOW, data_shape=DATA_SHAPE, remat="block",
            clips_per_s=CLIP_BATCH / fields["step_ms"] * 1e3,
            frames_per_s=CLIP_BATCH * CNNRNN_WINDOW / fields["step_ms"] * 1e3,
            backbone_params_moved=sum(moved[n] for n in backbone_params),
            backbone_params=len(backbone_params),
            stats_moved=sum(moved[n] for n in stats), stats=len(stats),
            rest_moved=sum(moved[n] for n in rest), rest=len(rest),
            **fields, **evals, wall_s=time.perf_counter() - t0, ok=ok)
        del state, step, model, before
        torch.cuda.empty_cache()
    del images
    log("cnnrnn_clips_check", wall_s=time.perf_counter() - t_phase, ok=all_ok)
    if not all_ok:
        raise SystemExit("the CNN-RNN over clips failed its gates")
    return launches


def _round_trip_us(launch):
    """Microseconds a round of ``launch(iters)`` takes, differenced over two
    loop lengths, so launch cost cancels."""
    short, long_ = 64, 4096
    t_short = time_ms(lambda: launch(short), reps=3)
    t_long = time_ms(lambda: launch(long_), reps=3)
    return (t_long - t_short) / (long_ - short) * 1e3


def cluster_round_trip_us():
    """What chains two steps of the barrier GRU kernel, in microseconds: one
    thread of each CTA of an 8-CTA cluster stores one float into every CTA
    through distributed shared memory, then one cluster barrier."""
    from tennis_torch.ops._build import load_library

    fn = load_library("gru_recurrence").cluster_sync_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sink = torch.empty(8, device="cuda")

    def run(iters):
        err = fn(iters, 1, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"cluster probe launch failed: CUDA error {err}")

    return _round_trip_us(run)


def exchange_round_trip_us(cluster: int, floats: int):
    """What chains two steps of the async GRU kernel, in microseconds: each
    CTA of a cluster arms its mbarrier, sends ``floats`` floats (the kernel's
    rows x units) into every CTA as 16-byte st.async stores, and waits."""
    from tennis_torch.ops._build import load_library

    fn = load_library("gru_recurrence_async").gru_exchange_probe_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    sink = torch.empty(cluster, device="cuda")

    def run(iters):
        err = fn(iters, floats, cluster, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"exchange probe launch failed: CUDA error {err}")

    return _round_trip_us(run)


def gru_work(T, B, H, lengths):
    """(FLOP, bytes) of one recurrence on these valid lengths: the h.Wh
    product of every live row-step, gates read for live steps, ys written
    whole, Wh, bh, h0, h_final and the lengths once."""
    live = sum(lengths)
    flops = 2 * live * H * 3 * H
    nbytes = 4 * (live * 3 * H + T * B * H + H * 3 * H + 3 * H + 2 * B * H + B)
    return flops, nbytes


def grid_exchange_round_trip_us(ctas: int, rows: int, hidden: int):
    """What chains two steps of the grid GRU kernel, in microseconds: each
    of ``ctas`` CTAs stores its run of ``hidden`` units of ``rows`` rows
    into device memory, arrives on a counter, waits for every CTA's arrival
    and copies the ``rows`` x ``hidden`` floats back from L2."""
    from tennis_torch.ops import gru
    from tennis_torch.ops._build import load_library

    fn = load_library("gru_recurrence_grid").gru_grid_exchange_probe_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    workspace = torch.zeros(
        gru.COUNTER_STRIDE + 2 * rows * (-(-hidden // 4) * 4),
        dtype=torch.int32, device="cuda")
    sink = torch.empty(ctas, device="cuda")

    def run(iters):
        workspace.zero_()
        err = fn(iters, rows, hidden, ctas, workspace.data_ptr(),
                 sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"grid exchange probe launch failed: CUDA error "
                             f"{err}")

    return _round_trip_us(run)


def gru_runs(gru, name, T, B, H):
    """(key, variant, cluster) of the GRU kernel configurations timed at
    case ``name``: the barrier kernel at BARRIER_CASES where it fits, the
    async one at every cluster size whose plan exists, the general one
    where it is routed and where it streams Wh (the A/B against the grid
    kernel), the grid one where the general one streams and its plan
    exists."""
    runs = [("barrier", "barrier", None)] \
        if name in BARRIER_CASES and gru.barrier_fits(H, B) else []
    runs += [(f"async{c}", "async", c) for c in gru.ASYNC_CLUSTERS
             if gru.gru_plan(H, B, c) is not None]
    general = gru.general_plan(H, B)
    streams = general is not None and general.stream_rows > 0
    if streams or gru.gru_route(T, B, H) == "general":
        runs.append(("general", "general", None))
    if streams and gru.grid_plan(H, B) is not None:
        runs.append(("grid", "grid", None))
    return runs


def gru_routed(gru, T, B, H):
    """(key of the routed configuration, and for the async and general
    kernels their cluster size and the floats each CTA sends a peer per
    step, None for the grid kernel) at (T, B, H)."""
    routed = gru.gru_route(T, B, H)
    if routed == "async":
        plan = gru.gru_plan(H, B)
        return f"async{plan.cluster}", plan.cluster, plan.rows * plan.units
    if routed == "grid":
        return "grid", None, None
    plan = gru.general_plan(H, B)
    return "general", plan.cluster, -(-plan.rows * plan.units // 4) * 4


def l2_read_gbps():
    """Read rate of the whole card from L2 in GB/s: the device time of one
    sum over 16 MB that stays in the 50 MB L2 between calls (a host clock
    around it would time the launch)."""
    x = torch.ones(4 * 1024 * 1024, device="cuda")
    ms, _ = kernel_device(lambda: x.sum(), "reduce")
    return x.numel() * 4 / ms / 1e6


def gru_phase(dev):
    """Every GRU kernel against its plain version at every GRU_CASES
    shape (two launches bit for bit), with their times beside the port's
    whole layer and cuDNN's nn.GRU over the same full-length layer from
    FEAT_DIM features. Returns the worst error of each variant and the
    per-case rows."""
    from tennis_torch.ops import gru

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    barrier_us = cluster_round_trip_us()
    l2_gbps = l2_read_gbps()
    rows, worst = {}, dict.fromkeys(gru.VARIANTS, 0.0)
    for name, T, B, H, lengths in GRU_CASES:
        def rand(*shape, std=1.0):
            return torch.empty(shape, device=dev).normal_(0.0, std, generator=gen)

        x = rand(T, B, FEAT_DIM)
        wx, bx = rand(FEAT_DIM, 3 * H, std=FEAT_DIM ** -0.5), rand(3 * H, std=0.1)
        wh, bh = rand(H, 3 * H, std=H ** -0.5), rand(3 * H, std=0.1)
        h0 = rand(B, H, std=0.5)
        vl = torch.tensor(lengths, dtype=torch.int32, device=dev)
        full = torch.full((B,), T, dtype=torch.int32, device=dev)
        gx = torch.matmul(x, wx) + bx
        routed_key, cluster, floats = gru_routed(gru, T, B, H)
        t_live = max(min(max(n, 0), T) for n in lengths)
        by_key, ok = {}, True
        with torch.inference_mode():
            ys_ref, h_ref = gru.gru_recurrence_reference(gx, h0, wh, bh, vl)
            for key, variant, c in gru_runs(gru, name, T, B, H):
                def call(variant=variant, c=c):
                    return gru.gru_recurrence(gx, h0, wh, bh, vl, variant, c)

                ys, h = call()
                again = call()
                torch.cuda.synchronize()
                err = max((ys - ys_ref).abs().max().item(),
                          (h - h_ref).abs().max().item())
                finite = bool(torch.isfinite(ys).all() and torch.isfinite(h).all())
                frozen = all(not ys[n:, b].any() for b, n in enumerate(lengths))
                same = torch.equal(ys, again[0]) and torch.equal(h, again[1])
                v_ok = finite and frozen and same and err <= GRU_TOL
                ok = ok and v_ok
                worst[variant] = max(worst[variant], err)
                device_ms = kernel_device(call, GRU_KERNELS[variant],
                                          launches=1)[0]
                steps = T if variant == "barrier" else t_live
                # the fallback's clock beside the profiler's, each run
                event_ms = event_device(call, (GRU_KERNELS[variant],), 1)[0]
                by_key[key] = {"max_abs_err": err, "finite": finite,
                               "zero_past_length": frozen,
                               "bitwise_repeatable": same, "ok": v_ok,
                               "ms": time_ms(call, reps=10, rounds=3),
                               "device_ms": device_ms,
                               "event_device_ms": event_ms, "steps": steps,
                               "us_per_step": device_ms / max(steps, 1) * 1e3}
            plain_ms = time_ms(
                lambda: gru.gru_recurrence_reference(gx, h0, wh, bh, vl),
                reps=1, rounds=3)
            layer_ms = time_ms(
                lambda: gru.gru_sequence(x, h0, wx, wh, bx, bh, full), reps=10,
                rounds=3)
            lib = torch.nn.GRU(FEAT_DIM, H).to(dev)
            for p, v in ((lib.weight_ih_l0, wx.t()), (lib.weight_hh_l0, wh.t()),
                         (lib.bias_ih_l0, bx), (lib.bias_hh_l0, bh)):
                p.copy_(v)
            ys_lib, _ = lib(x, h0[None])
            ys_layer, _ = gru.gru_sequence(x, h0, wx, wh, bx, bh, full)
            lib_err = (ys_lib - ys_layer).abs().max().item()
            library_ms = time_ms(lambda: lib(x, h0[None]), reps=10, rounds=3)
            # device time of both layers (every kernel of one call, queued
            # behind a spin: the host's launches would set the events' time
            # at T 1) where the general or grid kernel is routed
            device = {}
            if routed_key in ("general", "grid"):
                device = {"layer_device_ms": event_device(
                    lambda: gru.gru_sequence(x, h0, wx, wh, bx, bh, full))[0],
                    "library_device_ms": event_device(
                        lambda: lib(x, h0[None]))[0]}
        grid = gru.grid_plan(H, B)
        grid_us = None if grid is None else grid_exchange_round_trip_us(
            grid.ctas, min(B, grid.rows), H)
        exchange_us = exchange_round_trip_us(cluster, floats) \
            if cluster is not None else None
        flops, nbytes = gru_work(T, B, H, lengths)
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        fastest = min(by_key, key=lambda k: by_key[k]["device_ms"])
        general = gru.general_plan(H, B)
        # the general kernel's weights read again each live step: its
        # streamed rows of every product thread, over one SM's share of
        # the card's L2 read rate
        stream_bytes = 4 * 3 * general.stream_rows * general.units \
            * general.segments
        row = {"ms": by_key[routed_key]["ms"],
               "device_ms": by_key[routed_key]["device_ms"],
               "plain_ms": plain_ms, "layer_ms": layer_ms,
               "library_ms": library_ms, **device,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               # the routed kernel's exchange, once a live step
               "serial_floor_ms": t_live * (grid_us if cluster is None
                                            else exchange_us) / 1e3,
               "grid_serial_floor_ms": t_live * grid_us / 1e3
               if grid_us is not None else None,
               "barrier_serial_floor_ms": T * barrier_us / 1e3,
               "general_stream_floor_ms": t_live * stream_bytes
               / (l2_gbps * 1e9 / torch.cuda.get_device_properties(
                   0).multi_processor_count) * 1e3}
        log("gru_kernel", case=name, T=T, batch=B, hidden=H, lengths=lengths,
            live_steps=t_live, tol=GRU_TOL, routed=routed_key, fastest=fastest,
            routed_over_fastest=by_key[routed_key]["device_ms"]
            / by_key[fastest]["device_ms"], variants=by_key,
            grid_over_general=by_key["grid"]["device_ms"]
            / by_key["general"]["device_ms"] if "grid" in by_key else None,
            plan=(gru.gru_plan(H, B) or general)._asdict(),
            general_plan=general._asdict(),
            grid_plan=grid._asdict() if grid is not None else None,
            gflop=flops / 1e9, mbytes=nbytes / 1e6,
            cluster_round_trip_us=barrier_us,
            exchange_round_trip_us=exchange_us,
            grid_exchange_round_trip_us=grid_us, l2_read_gbps=l2_gbps,
            general_stream_bytes_per_step=stream_bytes,
            library_vs_layer_full_length_err=lib_err, ok=ok, **row)
        if not ok:
            raise SystemExit(f"a gru_recurrence kernel disagrees with its plain "
                             f"version at {name}")
        rows[name] = {**row, "variants": by_key}
    return worst, rows


def decode_against_plain(dev, hidden, src, vl, rng):
    """One 0102-shaped decode (CAPTION_ARGV at --num_hidden ``hidden``,
    seeded random weights) through ``BeamSearchTranslator.translate`` as
    the drivers and /caption call it, the GRU counts set to 0 just before
    and read just after, then the same decode through the plain
    recurrence. Returns a dict of both results, the launches by variant,
    the plain-routed layers and the decode's ms."""
    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.ops import gru
    from tennis_torch.train_gnmt import build_model, parse_args
    from tennis_torch.translation import BeamSearchTranslator

    vocab = caption_vocab()
    args = parse_args(CAPTION_ARGV + [f"--num_hidden={hidden}"])
    model = build_model(args, len(vocab), FEAT_DIM)
    load_flax(model, random_flax_tree(to_flax(model), rng))
    model.to(dev).eval()
    translator = BeamSearchTranslator(
        model, vocab[vocab.bos_token], vocab[vocab.eos_token],
        args.beam_size, args.lp_alpha, args.lp_k, args.tgt_max_len + 20)
    reset_kernel_counts()
    gru.gru_recurrence.plain_routed = 0
    t0 = time.perf_counter()
    samples, scores, lengths = translator.translate(src, vl)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    by_variant = dict(gru.gru_recurrence.variant_launches)
    plain_routed = gru.gru_recurrence.plain_routed
    with torch.inference_mode():
        want = translator.build_decoder(CAPTION_BATCH)(
            torch.from_numpy(src).to(dev), torch.from_numpy(vl).to(dev))
    want = [t.cpu().numpy() for t in want]
    return {"samples": samples, "scores": scores, "lengths": lengths,
            "plain": want, "launches": by_variant,
            "plain_routed": plain_routed, "decode_ms": decode_ms,
            "samples_equal_plain_decode": np.array_equal(samples, want[0]),
            "max_abs_score_vs_plain": float(np.abs(scores - want[1]).max())}


def wide_decode_phase(dev):
    """The 0102 captioner's beam decode at widths past the async GRU
    kernel: --num_hidden 640 and 300, batch 4 over 128 frames of seeded
    features at the /caption lengths (``decode_against_plain``). Gates: the
    route names WIDE_HIDDEN's kernel (grid at 640, general at 300), 3
    launches of it a decode and none of another, no plain-routed layer, and
    the samples of the plain decode exactly. Returns the GRU launches by
    variant."""
    from tennis_torch.ops import gru

    rng = np.random.default_rng(SEED + 18)
    src = rng.standard_normal((CAPTION_BATCH, SRC_MAX_LEN, FEAT_DIM)) \
        .astype(np.float32)
    vl = np.array(CAPTION_LENGTHS, np.int32)
    launches, ok = dict.fromkeys(gru.VARIANTS, 0), True
    for hidden, want in WIDE_HIDDEN.items():
        route = gru.gru_decode_route(SRC_MAX_LEN, CAPTION_BATCH, hidden)
        d = decode_against_plain(dev, hidden, src, vl, rng)
        by_variant = d["launches"]
        for v in launches:
            launches[v] += by_variant[v]
        d_ok = (route == want and by_variant[want] == 3
                and sum(by_variant.values()) == 3 and d["plain_routed"] == 0
                and d["samples_equal_plain_decode"]
                and bool(np.isfinite(d["scores"]).all()))
        ok = ok and d_ok
        log("wide_decode", num_hidden=hidden, route=route,
            gru_launches_by_variant=by_variant,
            plain_routed=d["plain_routed"],
            samples_equal_plain_decode=d["samples_equal_plain_decode"],
            max_abs_score_vs_plain=d["max_abs_score_vs_plain"],
            lengths_equal_plain_decode=bool(np.array_equal(
                d["lengths"], d["plain"][2])),
            decode_ms=d["decode_ms"], ok=d_ok)
    if not ok:
        raise SystemExit("a decode at a width past the async GRU kernel "
                         "failed its gates")
    return launches


@contextlib.contextmanager
def plain_gru():
    """Route RNNLayer's GRU recurrences inside the decode context through
    the kernel's plain version (the yardstick of the caption-path gates;
    never on the served path)."""
    from tennis_torch.ops import gru, rnn

    rnn.gru_recurrence = gru.gru_recurrence_reference
    try:
        yield
    finally:
        rnn.gru_recurrence = gru.gru_recurrence


def rescore(model, enc, src_vl, samples, scores, lengths, info):
    """Largest |reported - rescored| over the batch's top beams: each top
    beam fed teacher-forced through the decoder from ``enc``, its log-prob
    summed over the tokens the search scored and length-penalized as the
    search does."""
    alpha, K, max_length = info["lp_alpha"], info["lp_k"], info["max_length"]
    top = samples[:, 0].long()
    # a beam cut at max_length carries one unscored trailing EOS
    n = torch.clamp(lengths[:, 0] - 1, max=max_length)
    states = model.init_decoder_state(enc, src_vl)
    out, _ = model.decoder(model.tgt_embed(top[:, :-1]), states)
    logp = torch.log_softmax(model.tgt_proj(out).float(), -1)
    logp = logp.gather(-1, top[:, 1:, None])[..., 0]
    scored = torch.arange(logp.shape[1], device=logp.device)[None] < n[:, None]
    cum = torch.where(scored, logp, torch.zeros_like(logp)).sum(1)
    rescored = cum / ((K + n.float()) / (K + 1)) ** alpha
    return (rescored - scores[:, 0]).abs().max().item()


def caption_phase(dev):
    """The 0102 captioner served over HTTP: POST /caption through the
    port's make_service, the encoder's three GRU recurrences per batch
    through the kernel."""
    import io
    from collections import Counter
    from http.server import ThreadingHTTPServer

    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.vocab import Vocab
    from tennis_torch.inference import make_captioner
    from tennis_torch.ops import gru, rnn
    from tennis_torch.ops.beam_search import beam_search
    from tennis_torch.serve import Captioner, make_service
    from tennis_torch.train_gnmt import build_model, parse_args

    rng = np.random.default_rng(SEED + 3)
    args = parse_args(CAPTION_ARGV)
    vocab = Vocab(Counter({f"w{i:03d}": VOCAB_WORDS - i
                           for i in range(VOCAB_WORDS)}))
    model = build_model(args, len(vocab), FEAT_DIM,
                        generator=torch.Generator().manual_seed(SEED))
    load_flax(model, random_flax_tree(to_flax(model), rng))
    info = {"feat_dim": FEAT_DIM, "src_max_len": SRC_MAX_LEN,
            "beam_size": args.beam_size, "lp_alpha": args.lp_alpha,
            "lp_k": args.lp_k, "max_length": args.tgt_max_len + 20}
    torch.cuda.reset_peak_memory_stats()
    translator, caption_batch = make_captioner(model, vocab, info, dev)
    handler, _ = make_service(None, None, BATCH, DATA_SHAPE, max_wait_ms=200,
                              captioner=Captioner(caption_batch, FEAT_DIM,
                                                  SRC_MAX_LEN, CAPTION_BATCH))
    batcher = handler.caption_batcher
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    lens = rng.integers(20, SRC_MAX_LEN + 1, N_CAPTIONS)
    feats = [rng.standard_normal((n, FEAT_DIM)).astype(np.float32) for n in lens]
    try:
        results = [None] * N_CAPTIONS

        def request(i):
            buf = io.BytesIO()
            np.save(buf, feats[i])
            req = urllib.request.Request(url + "/caption", data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = json.loads(r.read())

        batches0 = batcher.batches
        gru.gru_recurrence.launches = 0
        gru.gru_recurrence.variant_launches = dict.fromkeys(gru.VARIANTS, 0)
        start = time.perf_counter()
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(N_CAPTIONS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - start
        launches = gru.gru_recurrence.launches
        by_variant = dict(gru.gru_recurrence.variant_launches)
        batches = batcher.batches - batches0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    if any(r is None for r in results):
        raise SystemExit("not every caption request was answered")
    in_vocab = all(tok in vocab for r in results for tok in r["tokens"])
    used_ok = all(r["frames_used"] == n for r, n in zip(results, lens))
    if not (in_vocab and used_ok):
        raise SystemExit(f"bad captions: in_vocab={in_vocab} "
                         f"frames_used_ok={used_ok}")
    routed = gru.gru_route(SRC_MAX_LEN, CAPTION_BATCH, args.num_hidden)
    if batches < 1 or launches != 3 * batches or \
            by_variant[routed] != launches:
        raise SystemExit(f"{launches} GRU launches ({by_variant}) for "
                         f"{batches} caption batches, expected 3 per batch "
                         f"through the {routed} kernel")
    if health["status"] != "ok" or health["caption_requests"] < N_CAPTIONS:
        raise SystemExit(f"healthz: {health}")

    # one served batch, as the batcher hands it to caption_batch
    src_np = np.zeros((CAPTION_BATCH, SRC_MAX_LEN, FEAT_DIM), np.float32)
    for b in range(CAPTION_BATCH):
        src_np[b, :lens[b]] = feats[b]
    vl_np = lens[:CAPTION_BATCH].astype(np.int32)
    src = torch.from_numpy(src_np).to(dev)
    src_vl = torch.from_numpy(vl_np).to(dev)

    # gates (comparison runs, after the counts were read)
    with torch.inference_mode():
        with rnn.gru_decode():
            mem_k, st_k = model.encode(src, src_vl)
        with plain_gru(), rnn.gru_decode():
            enc_p = model.encode(src, src_vl)
        mem_p, st_p = enc_p
        enc_err = max([(mem_k - mem_p).abs().max().item()]
                      + [(a - b).abs().max().item() for a, b in zip(st_k, st_p)])
        samples, scores, lengths = translator.translate_tensors(src, src_vl)
        rescore_err = rescore(model, enc_p, src_vl, samples, scores, lengths,
                              info)
        with plain_gru():
            samples_p, _, _ = translator.translate_tensors(src, src_vl)
        same_top = [bool(torch.equal(samples[b, 0], samples_p[b, 0]))
                    for b in range(CAPTION_BATCH)]
        same_beams = [bool(torch.equal(samples[b], samples_p[b]))
                      for b in range(CAPTION_BATCH)]
        torch.cuda.synchronize()

    # latency of one batch through the entry point, and its split
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        caption_batch(src_np, vl_np)
        lat.append((time.perf_counter() - t0) * 1e3)
    latency_ms = statistics.median(lat)
    enc_ms, dec_ms, steps = [], [], []
    for _ in range(10):
        calls = [0]

        def step(tokens, states):
            calls[0] += 1
            return model.decode_step(tokens, states)

        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rnn.gru_decode():
                states = model.init_decoder_state(model.encode(src, src_vl),
                                                  src_vl)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            beam_search(step, states, CAPTION_BATCH, info["beam_size"],
                        vocab[vocab.bos_token], vocab[vocab.eos_token],
                        info["max_length"], info["lp_alpha"], info["lp_k"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        enc_ms.append((t1 - t0) * 1e3)
        dec_ms.append((t2 - t1) * 1e3)
        steps.append(calls[0])
    kernels = device_profile(lambda: caption_batch(src_np, vl_np))
    busy_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log("caption_breakdown", batch=CAPTION_BATCH, lengths=vl_np.tolist(),
        latency_ms=latency_ms, encode_ms=statistics.median(enc_ms),
        decode_loop_ms=statistics.median(dec_ms), decode_steps=steps[0],
        decode_ms_per_step=statistics.median(dec_ms) / max(steps[0], 1),
        device_busy_ms=busy_ms, idle_share=1 - busy_ms / latency_ms,
        device_launches=sum(v[1] for v in kernels.values()),
        gru_kernel_ms=sum(v[0] for k, v in kernels.items()
                          if any(n in k for n in GRU_KERNELS.values())),
        top=[[k[:60], v[0], v[1]] for k, v in top])
    ok = enc_err <= GRU_TOL and rescore_err <= RESCORE_TOL
    log("caption_path", requests=N_CAPTIONS, frames=lens.tolist(),
        batches=batches, launches=launches, launches_by_variant=by_variant,
        launches_per_batch=launches / batches, wall_s=wall, healthz=health,
        vocab=len(vocab), tokens_per_caption=[len(r["tokens"]) for r in results],
        first_caption=results[0]["caption"][:80],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        encoder_max_abs_err=enc_err, encoder_tol=GRU_TOL,
        rescore_max_abs_err=rescore_err, rescore_tol=RESCORE_TOL,
        top_beam_equal_to_plain_encoder=same_top,
        all_beams_equal_to_plain_encoder=same_beams, ok=ok)
    if not ok:
        raise SystemExit("caption path disagrees with its plain-version "
                         "encoder")
    return by_variant


class MemoryCaptionSplit:
    """An in-memory captions-mode split with what ``train_gnmt`` and the
    bucketed loader read of a TennisSet: ``vocab``, ``(features, caption
    ids, frames, ids[, idx])`` items, ``get_captions``, ``get_data_lens``
    and ``stats``. Point i has CAP_SRC_LEN frames of f32 features drawn from
    (SEED, ``offset``, i) and a caption of CAP_IDS_LEN ids over the
    vocabulary's words, both lengths uniform."""

    def __init__(self, vocab, n, offset, inference):
        from concurrent.futures import ThreadPoolExecutor

        from tennis_torch.data.tennis_set import caption_ids

        rng = np.random.default_rng([SEED, offset])
        self.vocab, self.inference, self._split = vocab, inference, offset
        frames = rng.integers(CAP_SRC_LEN[0], CAP_SRC_LEN[1] + 1, n)
        words = rng.integers(CAP_IDS_LEN[0] - 2, CAP_IDS_LEN[1] - 1, n)
        self.captions = [" ".join(vocab.idx_to_token[4 + int(w)] for w in
                                  rng.integers(0, VOCAB_WORDS, k))
                         for k in words]
        self.ids = [caption_ids(vocab, c) for c in self.captions]

        def draw(i):
            return np.random.default_rng([SEED, offset, i]).standard_normal(
                (int(frames[i]), FEAT_DIM), dtype=np.float32)

        with ThreadPoolExecutor(8) as pool:
            self.feats = list(pool.map(draw, range(n)))

    def __len__(self):
        return len(self.feats)

    def __getitem__(self, i):
        item = (self.feats[i], self.ids[i], len(self.feats[i]),
                len(self.ids[i]))
        return item + (i,) if self.inference else item

    def get_captions(self, ids=False, split=False):
        if ids:
            return list(self.ids)
        return [c.split() if split else c for c in self.captions]

    def get_data_lens(self):
        return [(len(f), len(c)) for f, c in zip(self.feats, self.ids)]

    def stats(self):
        return (f"in-memory split {self._split}: {len(self)} points, "
                f"{sum(len(f) for f in self.feats)} frames")


def caption_vocab():
    """The captioners' vocabulary: 4 specials + VOCAB_WORDS words."""
    from collections import Counter

    from tennis_torch.data.vocab import Vocab

    return Vocab(Counter({f"w{i:03d}": VOCAB_WORDS - i
                          for i in range(VOCAB_WORDS)}))


def caption_train_inputs():
    """The vocabulary (4 specials + VOCAB_WORDS words), the three in-memory
    splits and seeded random weights (flax naming) of the 0102 captioner."""
    from tennis_torch.bridge import to_flax
    from tennis_torch.train_gnmt import build_model, parse_args

    vocab = caption_vocab()
    splits = {name: MemoryCaptionSplit(vocab, n, k, name != "train")
              for k, (name, n) in enumerate(CAP_POINTS.items())}
    model = build_model(parse_args(CAP_TRAIN_ARGV), len(vocab), FEAT_DIM)
    tree = random_flax_tree(to_flax(model), np.random.default_rng(SEED + 10))
    return vocab, splits, tree


def caption_model(args, vocab, tree, dev, dropout=None):
    """The captioner the flags describe with ``tree``'s weights, on
    ``dev``; ``dropout`` overrides ``--dropout``."""
    import argparse

    from tennis_torch.bridge import load_flax
    from tennis_torch.train_gnmt import build_model

    if dropout is not None:
        args = argparse.Namespace(**{**vars(args), "dropout": dropout})
    model = build_model(args, len(vocab), FEAT_DIM)
    return load_flax(model, tree).to(dev)


def caption_train_phase(dev, vocab, splits, tree):
    """The captioner's train step at --batch_size 128 through
    make_seq2seq_train_step over the bucketed batches of the train split:
    times, rates, the device's share, launches; gates: finite losses, a
    repeated batch learnt, the first step's loss and gradients on the card
    against the CPU at dropout 0, the differentiable recurrence against the
    GRU kernel, and no GRU kernel launch in a train step."""
    from tennis_torch.models.gnmt import masked_ce_loss
    from tennis_torch.ops import gru, rnn
    from tennis_torch.parallel.train_step import adam_with_clip, \
        create_seq2seq_state, make_seq2seq_train_step
    from tennis_torch.train_gnmt import make_loader, parse_args

    args = parse_args(CAP_TRAIN_ARGV)

    def fresh():
        model = caption_model(args, vocab, tree, dev)
        state = create_seq2seq_state(
            model, adam_with_clip(args.clip, args.optimizer), args.lr)
        return state, make_seq2seq_train_step(state, masked_ce_loss)

    host = list(make_loader(args, splits["train"], "train"))
    batches = [tuple(torch.from_numpy(x).to(dev) for x in b) for b in host]
    shapes = [list(b[0].shape[:2]) + [b[1].shape[1]] for b in batches]
    seeds = np.random.default_rng(args.seed + 1)
    state, step = fresh()
    launches0 = gru.gru_recurrence.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, tokens, frames = [], [], [], []
    for i in range(CAP_WARMUP + CAP_TIMED):
        b = batches[i % len(batches)]
        t0 = time.perf_counter()
        loss = step(*b, seeds.integers(2 ** 31))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        tokens.append(float(b[3].sum()))
        frames.append(float(b[2].sum()))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    walls = []

    def profiled():
        t = time.perf_counter()
        for i in range(CAP_PROFILED):
            step(*batches[i], seeds.integers(2 ** 31))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    by_name = device_profile(profiled)
    gru_in_step = sum(v[1] for k, v in by_name.items()
                      if any(n in k for n in GRU_KERNELS.values()))
    step_launches = gru.gru_recurrence.launches - launches0
    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    timed = times[CAP_WARMUP:]
    med = statistics.median(timed)
    finite = bool(np.isfinite(losses).all())
    log("caption_train", batch=args.batch_size, batches_per_epoch=len(batches),
        batch_shapes_B_T_L=shapes, steps=len(losses), timed_steps=len(timed),
        step_ms=med, step_ms_min=min(timed), step_ms_max=max(timed),
        step_ms_spread=(max(timed) - min(timed)) / med,
        target_tokens_per_s=sum(tokens[CAP_WARMUP:]) / sum(timed) * 1e3,
        source_frames_per_s=sum(frames[CAP_WARMUP:]) / sum(timed) * 1e3,
        profiled_shapes=shapes[:CAP_PROFILED],
        device_busy_ms_per_step=busy_ms / CAP_PROFILED,
        idle_share=1 - busy_ms / walls[-1],
        profiled_wall_ms_per_step=walls[-1] / CAP_PROFILED,
        device_launches_per_step=sum(v[1] for v in by_name.values())
        / CAP_PROFILED,
        top=[[k[:60], v[0] / CAP_PROFILED, v[1] // CAP_PROFILED]
             for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]],
        peak_mem_gib=peak_gib, first_losses=losses[:4], last_loss=losses[-1],
        losses_finite=finite, gru_kernel_launches_in_steps=step_launches,
        gru_kernel_launches_profiled=gru_in_step)
    del state, step, by_name

    # 30 steps on one repeated batch (the shortest), new dropout masks each
    short = min(range(len(batches)), key=lambda i: shapes[i][1])
    state, step = fresh()
    overfit = [step(*batches[short], seeds.integers(2 ** 31)).item()
               for _ in range(OVERFIT_STEPS)]
    del state, step
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])

    # the first step's loss and gradients, card against CPU, dropout 0
    sub = [x[:CAP_CPU_ROWS] for x in batches[short]]
    runs = []
    for device in (dev, torch.device("cpu")):
        model = caption_model(args, vocab, tree, device, dropout=0.0).train()
        src, tgt, svl, tvl = (x.to(device) for x in sub)
        loss = masked_ce_loss(model(src, tgt[:, :-1], svl, tvl - 1),
                              tgt[:, 1:], tvl - 1)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append((loss.item(), [g.cpu() for g in grads]))
        del model
    (loss_c, g_c), (loss_h, g_h) = runs
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    grad_rel = (torch.cat([(a - b).flatten() for a, b in zip(g_c, g_h)]).norm()
                / torch.cat([b.flatten() for b in g_h]).norm()).item()

    # the differentiable recurrence against the kernel, the same operands
    layer = caption_model(args, vocab, tree, dev).encoder.rnn0.fwd
    x, _, x_vl, _ = batches[0]
    with torch.inference_mode():
        final_p, ys_p = layer(x, x_vl)
        with rnn.gru_decode():
            final_k, ys_k = layer(x, x_vl)
        torch.cuda.synchronize()
    rec_err = max((ys_p - ys_k).abs().max().item(),
                  (final_p - final_k).abs().max().item())
    del layer

    ok = (finite and lowered and loss_rel <= CAP_LOSS_TOL
          and grad_rel <= CAP_GRAD_TOL and rec_err <= GRU_TOL
          and step_launches == 0 and gru_in_step == 0)
    log("caption_train_check", losses_finite=finite, overfit_losses=overfit,
        overfit_lowered=lowered, cpu_rows=CAP_CPU_ROWS,
        cpu_shape=list(sub[0].shape[:2]), loss_card=loss_c, loss_cpu=loss_h,
        loss_rel=loss_rel, loss_tol=CAP_LOSS_TOL, grad_rel_l2=grad_rel,
        grad_tol=CAP_GRAD_TOL, recurrence_vs_kernel_max_abs=rec_err,
        recurrence_shape=list(x.shape[:2]), gru_tol=GRU_TOL,
        gru_kernel_launches_in_train_steps=step_launches + gru_in_step, ok=ok)
    if not ok:
        raise SystemExit("the captioner's train step failed its gates")


def caption_driver_phase(dev, vocab, splits, tree):
    """``train_gnmt.train`` for 2 epochs over the in-memory splits, then a
    resumed run to 3 epochs, then ``evaluate_gnmt.evaluate --force
    --metrics_out``, from ``tree`` with EOS biased by CAP_EOS_BIAS: every
    decode batch runs the translator's max length and makes 3 GRU kernel
    launches by the routed variant, the first evaluation's encoder outputs
    agree with the plain version, the epoch files read back as saved, the
    resumed run compounds the decay from the saved rate, the evaluator
    rewrites the trainer's best_test_out.txt byte for byte. Returns the
    decodes' GRU launches by variant."""
    import logging
    import tempfile
    from unittest import mock

    from tennis_torch import evaluate_gnmt, train_gnmt
    from tennis_torch.bridge import load_flax
    from tennis_torch.models.gnmt import NMTModel
    from tennis_torch.ops import gru, rnn
    from tennis_torch.translation import BeamSearchTranslator
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec

    argv = CAP_TRAIN_ARGV + ["--model_id=cap", "--log_interval=1"]
    build, translate = train_gnmt.build_model, \
        BeamSearchTranslator.translate_tokens
    save = ckpt.AsyncCheckpointer.save
    decode_step = NMTModel.decode_step
    flags = train_gnmt.parse_args(argv)
    H, max_steps = flags.num_hidden, flags.tgt_max_len + 20
    bias = tree["params"]["tgt_proj"]["bias"].copy()
    bias[vocab[vocab.eos_token]] = CAP_EOS_BIAS
    tree = {**tree, "params": {**tree["params"], "tgt_proj": {
        **tree["params"]["tgt_proj"], "bias": bias}}}
    decodes, saved, lines = [], [], []
    first_eval = {"batches": None}
    steps = [0]

    def seeded_build(args, vocab_size, feat_dim, generator=None):
        return load_flax(build(args, vocab_size, feat_dim, generator), tree)

    def counting_decode_step(self, *a, **kw):
        steps[0] += 1
        return decode_step(self, *a, **kw)

    def recording_translate(self, src, src_valid_length, vocab_):
        B, T = src.shape[:2]
        before = dict(gru.gru_recurrence.variant_launches)
        steps0 = steps[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = translate(self, src, src_valid_length, vocab_)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"T": T, "B": B, "ms": ms, "steps": steps[0] - steps0,
               "routed": gru.gru_route(T, B, H),
               "launches": {v: n - before[v] for v, n in
                            gru.gru_recurrence.variant_launches.items()}}
        if first_eval["batches"] is None or len(decodes) < first_eval["batches"]:
            # the first evaluation's batches (the first and the ragged ones)
            vl = torch.as_tensor(src_valid_length, device=dev).to(torch.int32)
            with torch.inference_mode():
                with rnn.gru_decode():
                    mem_k, st_k = self._model.encode(src, vl)
                with plain_gru(), rnn.gru_decode():
                    mem_p, st_p = self._model.encode(src, vl)
                torch.cuda.synchronize()
            rec["encoder_max_abs_err"] = max(
                [(mem_k - mem_p).abs().max().item()]
                + [(a - b).abs().max().item() for a, b in zip(st_k, st_p)])
            rec["profile"] = (self, src, src_valid_length)
        decodes.append(rec)
        return out

    def recording_save(self, path, tree_):
        saved.append((path, tree_))
        return save(self, path, tree_)

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logging.getLogger().addHandler(handler)
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as work, \
                mock.patch.object(train_gnmt, "build_model", seeded_build), \
                mock.patch.object(BeamSearchTranslator, "translate_tokens",
                                  recording_translate), \
                mock.patch.object(NMTModel, "decode_step",
                                  counting_decode_step), \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  recording_save):
            os.chdir(work)
            datasets = (splits["train"], splits["val"], splits["test"])
            first_eval["batches"] = len(train_gnmt.make_loader(
                flags, splits["val"], "val"))
            t0 = time.perf_counter()
            train_gnmt.train(train_gnmt.parse_args(argv + ["--epochs=2"]),
                             datasets)
            wall_2 = time.perf_counter() - t0
            exp = os.path.join("models", "captioning", "experiments", "cap")
            identical = len(saved) >= 2 and all(
                msgpack_codec.serialize(ckpt.load_raw(p))
                == msgpack_codec.serialize(t) for p, t in saved)
            saved_lr = float(ckpt.load_raw(ckpt.epoch_path(exp, 1))[
                "opt_state"]["hyperparams"]["learning_rate"])
            n_first = len(lines)
            t0 = time.perf_counter()
            train_gnmt.train(train_gnmt.parse_args(argv + ["--epochs=3"]),
                             datasets)
            wall_3 = time.perf_counter() - t0
            resumed = lines[n_first:]
            with open(os.path.join(exp, "best_test_out.txt"), "rb") as f:
                best_out = f.read()
            metrics_path = os.path.join(work, "metrics.json")
            n_train_decodes = len(decodes)
            t0 = time.perf_counter()
            suite = evaluate_gnmt.evaluate(evaluate_gnmt.parse_args(
                argv + ["--force", f"--metrics_out={metrics_path}"]),
                datasets)
            wall_eval = time.perf_counter() - t0
            with open(os.path.join(exp, "best_test_out.txt"), "rb") as f:
                rewritten = f.read() == best_out
            with open(metrics_path) as f:
                dumped = json.load(f)
            files = sorted(os.listdir(exp))
            self_, src, src_vl = decodes[0]["profile"]
            wall = []

            def one_decode():
                t = time.perf_counter()
                translate(self_, src, src_vl, vocab)
                wall.append((time.perf_counter() - t) * 1e3)

            by_name = device_profile(one_decode)
            os.chdir(cwd)
    finally:
        os.chdir(cwd)
        logging.getLogger().removeHandler(handler)

    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    launches = dict.fromkeys(gru.VARIANTS, 0)
    for r in decodes:
        for v, n in r["launches"].items():
            launches[v] += n
    per_batch_ok = all(r["launches"] == {**dict.fromkeys(gru.VARIANTS, 0),
                                         r["routed"]: 3} for r in decodes)
    enc = [r["encoder_max_abs_err"] for r in decodes
           if "encoder_max_abs_err" in r]
    resume_line = f"resumed from epoch 1 (lr {saved_lr:g})"
    after = [float(m.rsplit(" ", 1)[1]) for m in resumed
             if m.startswith("lr decayed to")]
    resume_ok = resume_line in resumed and len(after) == 1 and \
        abs(after[0] / (saved_lr * 0.5) - 1) < 1e-5
    want_keys = {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                 "CIDEr"}
    metrics_ok = set(dumped) == want_keys and all(
        0.0 <= v <= (10.0 if k == "CIDEr" else 1.0)
        for k, v in dumped.items()) and dumped == suite
    want_files = {"0000.params", "0001.params", "0002.params", "scores.txt",
                  "valid_best.params", "best_test_out.txt", "val_gt.txt",
                  "test_gt.txt", "epoch2_test_out.txt"}
    full_length = all(r["steps"] == max_steps for r in decodes)
    ok = (per_batch_ok and full_length and enc and max(enc) <= GRU_TOL
          and identical
          and resume_ok and rewritten and metrics_ok
          and want_files <= set(files))
    dec_ms = [r["ms"] for r in decodes]
    step_ms = [r["ms"] / r["steps"] for r in decodes]
    log("caption_driver", epochs=[2, 3], train_points=CAP_POINTS["train"],
        eval_points=CAP_POINTS["val"],
        test_batch=flags.test_batch_size, eos_bias=CAP_EOS_BIAS,
        decodes=len(decodes), decodes_in_training=n_train_decodes,
        decode_shapes_B_T=[[r["B"], r["T"]] for r in decodes],
        launches=launches, launches_per_decode_ok=per_batch_ok,
        routed=sorted({r["routed"] for r in decodes}),
        encoder_max_abs_err=enc, gru_tol=GRU_TOL,
        decode_steps=sorted({r["steps"] for r in decodes}),
        max_steps=max_steps, full_length=full_length,
        decode_ms_median=statistics.median(dec_ms), decode_ms_min=min(dec_ms),
        decode_ms_max=max(dec_ms),
        decode_ms_per_step_median=statistics.median(step_ms),
        decode_profiled_B_T=[decodes[0]["B"], decodes[0]["T"]],
        decode_device_busy_ms=busy_ms, decode_wall_ms=wall[-1],
        decode_idle_share=1 - busy_ms / wall[-1],
        decode_device_launches=sum(v[1] for v in by_name.values()),
        wall_s_per_epoch=wall_2 / 2, resumed_epoch_wall_s=wall_3,
        evaluate_wall_s=wall_eval, saved_read_back_identical=identical,
        saved_files=len(saved), resumed_lr_line=resume_line,
        decays_after_resume=after, resume_ok=resume_ok,
        evaluate_rewrites_best_test_out=rewritten, metrics=dumped,
        metrics_ok=metrics_ok, files=files, ok=ok)
    if not ok:
        raise SystemExit("the captioning driver failed its gates")
    return launches


def densenet161_phase(dev):
    """FrameModel(DenseNet161) at 224^2 with seeded random weights: its
    batch-2 warm-up forward through make_service takes every dense layer
    through dense_layer_convs and no dense kernel, and its logits agree with
    the plain-version forward."""
    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.data.transforms import device_prepare
    from tennis_torch.inference import build_frame_model, make_predict_probs
    from tennis_torch.ops import dense_block as db
    from tennis_torch.serve import make_service

    rng = np.random.default_rng(SEED + 5)
    classes = list(DEFAULT_CLASSES)
    model = build_frame_model("DenseNet161", len(classes), D161_SHAPE)
    load_flax(model, random_flax_tree(to_flax(model), rng))
    predict_probs = make_predict_probs(model, dev)
    reset_dense_counts(db)
    t0 = time.perf_counter()
    make_service(classes, predict_probs, D161_BATCH, D161_SHAPE)  # warm-up
    warm_s = time.perf_counter() - t0
    launches = db.dense_layer.launches
    by_variant = dict(db.dense_layer.variant_launches)
    n_layers = sum(model.backbone.spec.block_config)
    want_counts = {**dict.fromkeys(db.ROUTES, 0), "convs": n_layers}
    if n_layers != 78 or launches != 0 or by_variant != want_counts:
        raise SystemExit(f"DenseNet161 warm-up: {launches} dense-kernel "
                         f"launches, {by_variant} by route; expected none and "
                         f"{n_layers} (78) through dense_layer_convs")
    frames = rng.integers(0, 256, (D161_BATCH, D161_SHAPE, D161_SHAPE, 3),
                          dtype=np.uint8)
    probs = predict_probs(frames)
    lat = []
    for _ in range(10):
        t1 = time.perf_counter()
        predict_probs(frames)
        lat.append((time.perf_counter() - t1) * 1e3)
    busy_ms = sum(v[0] for v in device_profile(
        lambda: predict_probs(frames)).values())
    with torch.inference_mode():
        x = device_prepare(torch.from_numpy(frames).to(dev))
        got = db.frame_model_apply(model, x)
        want = db.frame_model_apply(model, x, layer=db.dense_layer_reference)
        torch.cuda.synchronize()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    finite = bool(np.isfinite(probs).all()) and probs.shape == (
        D161_BATCH, len(classes))
    ok = finite and rel <= LOGIT_TOL and top1
    log("densenet161", batch=D161_BATCH, data_shape=D161_SHAPE,
        dense_layers=n_layers, kernel_launches=launches,
        launches_by_route=by_variant, warm_up_s=warm_s,
        latency_ms=statistics.median(lat), device_busy_ms=busy_ms,
        logits_rel_err=rel, logit_tol=LOGIT_TOL, top1_agrees=top1,
        finite=finite, ok=ok)
    if not ok:
        raise SystemExit("DenseNet161 forward disagrees with its plain-version "
                         "forward")
    return by_variant


def step_flops(model, x, labels):
    """(forward FLOPs of one sample, FLOPs of one train step) of ``model``
    over the prepared batch ``x``, counted by ``FlopCounterMode`` from the
    shapes of every convolution and matmul: the forward, the input and the
    weight gradients, no rematerialization (an R(2+1)D's remat is off while
    counting)."""
    from torch.utils.flop_counter import FlopCounterMode

    remat = getattr(model.backbone, "remat", None)
    if remat is not None:
        model.backbone.remat = False
    try:
        with FlopCounterMode(display=False) as fwd:
            with torch.no_grad():
                model(x, train=True)
        with FlopCounterMode(display=False) as both:
            loss = F.cross_entropy(model(x, train=True).float(), labels)
            torch.autograd.grad(loss, [p for p in model.parameters()])
    finally:
        if remat is not None:
            model.backbone.remat = remat
    return fwd.get_total_flops() / len(x), both.get_total_flops()


def weights_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def rebuilt(argv, weights, dev, dtype=torch.bfloat16, steps_per_epoch=4):
    """``train.build_model`` of ``argv`` (11 classes) computing in
    ``dtype``, loaded with ``weights``, on ``dev``; its driver train state
    and step."""
    from tennis_torch import train as driver

    args = driver.parse_args(argv)
    model = driver.build_model(args, 11, dtype=dtype)
    model.load_state_dict(weights)
    model.to(dev)
    if dtype == torch.float64:  # the parameters too
        model.double()
    return (model,) + sgd_state(model, args, steps_per_epoch)


def stage_of(name):
    """``backbone.stage3_block2.conv1.weight`` -> ``stage3``; the stem's
    parameters -> ``stem``, the head's -> ``head``."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return "head"
    return parts[1].split("_block")[0] if parts[1].startswith("stage") \
        else "stem"


def first_step_gap(argv, weights, dev, x, y):
    """The first train step of ``argv``'s model in bf16 against the same
    step in f32 (TF32 off): relative loss, worst running statistic over
    max |f32 statistic|, global relative L2 of the update, and of each
    stage's part of it (``stage_of``); and the bf16 and f32 updates' gaps
    to the same step in f64."""
    runs = {}
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        model, state, step = rebuilt(argv, weights, dev, dtype)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss, _ = step(x, y)
        runs[dtype] = (loss.item(), {
            n: (p.detach() - before[n]).double().flatten()
            for n, p in model.named_parameters()},
            [b.double() for b in model.buffers()])
        del model, state, step, before
    (loss_b, upd_b, stats_b), (loss_f, upd_f, stats_f), (_, upd_d, _) = \
        runs.values()
    stats_rel = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(stats_b, stats_f))

    def rel(a, b, names=tuple(upd_f)):
        a, b = (torch.cat([u[n] for n in names]) for u in (a, b))
        return ((a - b).norm() / b.norm()).item()

    stages = {}
    for n in upd_f:
        stages.setdefault(stage_of(n), []).append(n)
    return {"loss_bf16": loss_b, "loss_f32": loss_f,
            "loss_rel": abs(loss_b - loss_f) / abs(loss_f),
            "running_stats_rel": stats_rel,
            "update_rel_l2": rel(upd_b, upd_f),
            "update_rel_l2_by_stage": {k: rel(upd_b, upd_f, v)
                                       for k, v in stages.items()},
            "update_rel_l2_bf16_to_f64": rel(upd_b, upd_d),
            "update_rel_l2_f32_to_f64": rel(upd_f, upd_d)}


def f32_gaps_ok(gap, update_tol=None):
    """The gates of ``first_step_gap``: the bf16 update's against f32 only
    where ``update_tol`` is given."""
    return (gap["loss_rel"] <= TRAIN_LOSS_TOL
            and gap["running_stats_rel"] <= TRAIN_STATS_TOL
            and (update_tol is None or gap["update_rel_l2"] <= update_tol)
            and gap["update_rel_l2_f32_to_f64"] <= F64_UPDATE_TOL)


def r21d_piece_gaps(model, x):
    """R(2+1)D's R21D_PIECES in bf16 against f32 (TF32 off) at the card's
    shapes, one at a time: the stem (``init`` and the frozen ``init_bn``)
    over the prepared clips ``x``, and each named block over what the f32
    network (train mode, no statistics kept) feeds it. For each, the
    loss ``sum(out * r)`` over a seeded f32 cotangent r: the output's
    largest difference over max |f32 output|, the batch statistics' over
    max |f32 statistic|, and every gradient leaf's (its parameters' and
    its input's) relative L2 gap, with the worst leaf named."""
    bb = model.backbone

    def stem(h, dt, stats):
        h = bb.init(h.to(dt), True, stats, dt)
        return bb.init_bn.train_norm(h, stats, frozen=True)

    def block(name):
        def run(h, dt, stats):
            out, s = getattr(bb, name)(h.to(dt), True, dt)
            stats += s
            return out
        return run

    inputs = {"stem": x}
    with torch.no_grad():
        h = stem(x, torch.float32, [])
        for name in bb.blocks:
            if name in R21D_PIECES:
                inputs[name] = h
            h = block(name)(h, torch.float32, [])
    del h
    gen = torch.Generator(device=x.device).manual_seed(SEED + 27)
    out = {}
    for name in R21D_PIECES:
        run = stem if name == "stem" else block(name)
        params = dict(
            [(f"init.{n}", p) for n, p in bb.init.named_parameters()]
            + [(f"init_bn.{n}", p) for n, p in bb.init_bn.named_parameters()]
            if name == "stem" else getattr(bb, name).named_parameters())
        runs, r = [], None
        for dt in (torch.bfloat16, torch.float32):
            xin = inputs[name].detach().clone().requires_grad_()
            stats = []
            y = run(xin, dt, stats).float()
            if r is None:
                r = torch.randn(y.shape, device=y.device, generator=gen)
            g = torch.autograd.grad((y * r).sum(),
                                    list(params.values()) + [xin])
            runs.append((y.detach(), dict(zip(list(params) + ["input"], g)),
                         [t for _, m, v in stats for t in (m, v)]))
            del xin, y, g
        (yb, gb, sb), (yf, gf, sf) = runs
        leaf = {n: ((gb[n].float() - gf[n].float()).norm()
                    / gf[n].float().norm()).item() for n in gf}
        worst = max(leaf, key=leaf.get)
        out[name] = {
            "out_rel": ((yb - yf).abs().max() / yf.abs().max()).item(),
            "stats_rel": max(((a - b).abs().max() / b.abs().max()).item()
                             for a, b in zip(sb, sf)),
            "input_grad_rel_l2": leaf["input"],
            "worst_leaf": worst, "worst_leaf_rel_l2": leaf[worst]}
        del runs, yb, gb, yf, gf
    torch.cuda.empty_cache()
    return out


def no_kernel_launched(by_name=None):
    """No dense-layer or GRU kernel launch since the counts were set to 0
    (nor in the profile ``by_name``)."""
    dense, gru_n = kernel_counts()
    return (sum(dense.values()) == 0 and gru_n == 0
            and (by_name is None or kernel_launches_in(by_name) == 0))


def resnet_train_phase(dev, frames):
    """The drivers' default model, ``FrameModel(resnet18_v2, 11)``, at
    512^2 and batch 64 over the 256 seeded frames, through the driver's
    train step (device augment, bf16, SGD): 3 warm-up and 3 timed steps,
    2 profiled; then ``resnet50_v2`` for RESNET50_STEPS steps. Gates: finite
    losses, 30 steps on one batch lower the loss, the first bf16 step
    against f32 at batch 16, no kernel launched."""
    from tennis_torch.data.transforms import device_prepare

    t_phase = time.perf_counter()
    images = torch.from_numpy(frames).to(dev)
    labels = torch.from_numpy(np.random.default_rng(SEED + 20).integers(
        0, 11, len(frames))).to(dev)
    n_batches = len(frames) // TRAIN_BATCH

    def batch(i, size=TRAIN_BATCH):
        lo = i % n_batches * size
        return images[lo:lo + size], labels[lo:lo + size]

    finite, clean, weights = True, True, None
    for backbone, warmup, timed, profiled in (
            ("resnet18_v2", TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED),
            ("resnet50_v2", 0, RESNET50_STEPS, 0)):
        argv = RESNET_ARGV + [f"--backbone={backbone}"]
        args, model = seeded_model(argv, SEED + 20)
        if weights is None:
            weights = weights_of(model)
        model.to(dev)
        x, y = batch(0, 2)
        fwd, flops = step_flops(model, device_prepare(x, model.dtype), y)
        flops *= TRAIN_BATCH / 2
        state, step = sgd_state(model, args, n_batches)
        reset_kernel_counts()
        _, fields, by_name = time_steps(step, batch, warmup, timed, profiled)
        clean = clean and no_kernel_launched(by_name)
        finite = finite and fields["losses_finite"]
        log("resnet_train", backbone=backbone, batch=TRAIN_BATCH,
            data_shape=DATA_SHAPE, dtype="bfloat16",
            samples_per_s=TRAIN_BATCH / fields["step_ms"] * 1e3,
            model_gflop_per_image_forward=fwd / 1e9,
            model_gflop_per_step=flops / 1e9,
            mfu=flops / (fields["step_ms"] / 1e3) / PEAK_BF16_FLOPS, **fields)
        del state, step, model
        torch.cuda.empty_cache()

    _, _, step = rebuilt(RESNET_ARGV, weights, dev)
    overfit = [step(*batch(0))[0].item() for _ in range(OVERFIT_STEPS)]
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])
    del step
    gap = first_step_gap(RESNET_ARGV, weights, dev, *batch(0, F32_BATCH))
    ok = finite and lowered and f32_gaps_ok(gap, RESNET_UPDATE_TOL) and clean
    log("resnet_train_check", losses_finite=finite, overfit_losses=overfit,
        overfit_lowered=lowered, f32_batch=F32_BATCH, **gap,
        loss_tol=TRAIN_LOSS_TOL, stats_tol=TRAIN_STATS_TOL,
        update_tol=RESNET_UPDATE_TOL, f64_update_tol=F64_UPDATE_TOL,
        no_kernel_launched=clean,
        wall_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        raise SystemExit("the ResNet-v2 train step failed its gates")


def fit_resume_evaluate(dev, argv, splits, seed, batch):
    """``train.fit`` of ``argv`` (2 epochs) over in-memory ``splits`` in a
    temporary working directory, a copy of its epoch 0 resumed to 2 epochs,
    then ``evaluate --metrics_out``. Returns the log fields and whether the
    gates held: the epoch files and ``scores.txt`` read back bit for bit as
    saved; the resumed epoch 1's parameters within RESUME_TOL of the
    uninterrupted run's, relative to that epoch's own update; the
    evaluation's PRF1 the trainer's final test's; no kernel launched."""
    import shutil
    import tempfile
    from unittest import mock

    from tennis_torch import evaluate
    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec
    from tennis_torch.utils.experiments import experiment_dir

    model_id = [a for a in argv if a.startswith("--model_id=")][0][11:]

    def run_fit(exp_dir):
        args, model = seeded_model(argv, seed)
        loaders = {k: DataLoader(ds, batch, shuffle=k == "train",
                                 seed=args.seed, num_workers=8,
                                 drop_last=k == "train")
                   for k, ds in splits.items()}
        return driver.fit(args, model, loaders, exp_dir, dev)

    saved, scored = [], []
    save, append = ckpt.AsyncCheckpointer.save, ckpt.append_score

    def recording_save(self, path, tree):
        saved.append((path, tree))
        return save(self, path, tree)

    def recording_score(exp_dir, epoch, score):
        scored.append((exp_dir, f"{epoch}\t{score}\n"))
        return append(exp_dir, epoch, score)

    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as work, \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  recording_save), \
                mock.patch.object(ckpt, "append_score", recording_score), \
                mock.patch.object(driver, "make_eval_dataset",
                                  lambda a, split, every_n=None:
                                  splits[split]), \
                mock.patch.object(driver, "_geometry_transform",
                                  lambda a, train: None):
            os.chdir(work)
            exp = experiment_dir("vision", model_id)
            reset_kernel_counts()
            t0 = time.perf_counter()
            _, test_metrics = run_fit(exp)
            torch.cuda.synchronize()
            wall_fit = time.perf_counter() - t0
            files = sorted(f for f in os.listdir(exp) if f != "tb")
            identical = len(saved) == 2 and all(
                msgpack_codec.serialize(ckpt.load_raw(p))
                == msgpack_codec.serialize(t) for p, t in saved)
            with open(os.path.join(exp, "scores.txt")) as f:
                identical = identical and f.read() == "".join(
                    row for _, row in scored)
            resumed_exp = experiment_dir("vision", model_id + "_resumed")
            os.makedirs(resumed_exp, exist_ok=True)
            shutil.copy(ckpt.epoch_path(exp, 0), resumed_exp)
            with open(os.path.join(resumed_exp, "scores.txt"), "w") as f:
                f.write(scored[0][1])
            t0 = time.perf_counter()
            run_fit(resumed_exp)
            wall_resume = time.perf_counter() - t0
            e0, e1, r1 = (driver_state_dict(ckpt.load_raw(ckpt.epoch_path(
                d, e))) for d, e in ((exp, 0), (exp, 1), (resumed_exp, 1)))
            num = sum(float(((r1[k] - e1[k]) ** 2).sum()) for k in e1)
            den = sum(float(((e1[k] - e0[k]) ** 2).sum()) for k in e1)
            resume_rel = (num / den) ** 0.5
            metrics_path = os.path.join(work, "metrics.json")
            t0 = time.perf_counter()
            results, _, metrics = evaluate.evaluate_model(evaluate.parse_args(
                argv + [f"--metrics_out={metrics_path}"]))
            wall_eval = time.perf_counter() - t0
            with open(metrics_path) as f:
                dumped = json.load(f)
            clean = no_kernel_launched()
    finally:
        os.chdir(cwd)
    probs = np.stack(list(results.values()))
    n_eval = len(splits["test"])
    probs_ok = (probs.shape == (n_eval, 11) and bool(np.isfinite(probs).all())
                and bool(np.allclose(probs.sum(-1), 1, atol=1e-3)))
    same_as_fit = dumped == metrics["prf1"].get_dict() == \
        test_metrics["prf1"].get_dict()
    ok = (files == ["0000.params", "0001.params", "scores.txt"] and identical
          and resume_rel <= RESUME_TOL and probs_ok and same_as_fit and clean)
    return {"files": files, "saved_read_back_identical": identical,
            "resume_epoch1_rel": resume_rel, "resume_tol": RESUME_TOL,
            "evaluated": len(results), "probs_ok": probs_ok,
            "metrics_equal_fit_test": same_as_fit,
            "test_AVG_NB_f1": dumped.get("AVG_NB_f1"),
            "no_kernel_launched": clean, "fit_wall_s": wall_fit,
            "resume_wall_s": wall_resume, "evaluate_wall_s": wall_eval}, ok


def resnet_serve(dev, weights):
    """``make_service`` over ``FrameModel(resnet18_v2)``: N_REQUESTS
    concurrent /predict frames at batch BATCH; the card's batch-8 logits
    against the same model in f32 on the CPU."""
    from tennis_torch.data.tennis_set import DEFAULT_CLASSES
    from tennis_torch.inference import build_frame_model, make_eval_step, \
        make_predict_probs, prepare_input
    from tennis_torch.serve import make_service

    classes = list(DEFAULT_CLASSES)
    model = build_frame_model("resnet18_v2", len(classes), DATA_SHAPE)
    model.load_state_dict(weights)
    predict_probs = make_predict_probs(model, dev)
    _, batcher = make_service(classes, predict_probs, BATCH, DATA_SHAPE,
                              max_wait_ms=200)
    frames = np.random.default_rng(SEED + 23).integers(
        0, 256, (N_REQUESTS, DATA_SHAPE, DATA_SHAPE, 3), dtype=np.uint8)
    results = [None] * N_REQUESTS

    def request(i):
        results[i] = batcher.submit(frames[i], timeout=300)

    reset_kernel_counts()
    batches0 = batcher.batches
    t0 = time.perf_counter()
    threads = [threading.Thread(target=request, args=(i,))
               for i in range(N_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    clean = no_kernel_launched()
    answered = all(r is not None for r in results)
    probs = np.stack(results) if answered else np.zeros(1)
    got = make_eval_step(model, dev)(frames[:BATCH]).cpu()
    cpu = build_frame_model("resnet18_v2", len(classes), DATA_SHAPE,
                            dtype=torch.float32)
    cpu.load_state_dict(weights)
    with torch.inference_mode():
        want = cpu(prepare_input(torch.from_numpy(frames[:BATCH]),
                                 torch.float32))
    rel = ((got - want).abs().max() / want.abs().max()).item()
    top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
    served = answered and np.allclose(torch.softmax(got, -1).numpy(),
                                      probs[:BATCH], atol=1e-2)
    ok = (answered and bool(np.isfinite(probs).all()) and served
          and rel <= LOGIT_TOL and top1 and clean)
    return {"requests": N_REQUESTS, "batches": batcher.batches - batches0,
            "wall_s": wall, "logits_rel_err_vs_cpu_f32": rel,
            "logit_tol": LOGIT_TOL, "top1_agrees": top1,
            "served_probs_match_forward": served,
            "no_kernel_launched": clean}, ok


def resnet_driver_phase(dev, frames):
    """The drivers over ResNet-18 at 512^2: ``train.fit`` (2 epochs of
    DRIVER_BATCHES steps), a resume and ``evaluate --metrics_out``;
    ``save_features`` of the test split (512-d); ``/predict`` through
    ``make_service``; two-stream, ``only`` and ``sixc`` for OTHER_FLOW_STEPS
    steps each; the CNN-RNN over the dumped features for OTHER_FLOW_STEPS
    steps."""
    import tempfile

    from tennis_torch import train as driver
    from tennis_torch.data.loader import DataLoader
    from tennis_torch.inference import make_extract_features

    t_phase = time.perf_counter()
    argv = RESNET_ARGV + [f"--batch_size={TRAIN_BATCH}", "--epochs=2",
                          f"--max_batches={DRIVER_BATCHES}",
                          "--log_interval=1", "--model_id=rn"]
    splits = {"train": MemorySplit(frames, DRIVER_TRAIN, None, "train"),
              "val": MemorySplit(frames[::-1], DRIVER_EVAL, None, "val"),
              "test": MemorySplit(frames[1:], DRIVER_EVAL, None, "test")}
    fields, ok = fit_resume_evaluate(dev, argv, splits, SEED + 21,
                                     TRAIN_BATCH)
    log("resnet_driver", part="fit", epochs=2, steps_per_epoch=DRIVER_BATCHES,
        batch=TRAIN_BATCH, **fields, ok=ok)
    all_ok = ok

    _, model = seeded_model(RESNET_ARGV, SEED + 21)
    weights = weights_of(model)
    with tempfile.TemporaryDirectory() as feat_dir:
        split = MemorySplit(frames, DRIVER_EVAL, feat_dir, "test")
        reset_kernel_counts()
        t0 = time.perf_counter()
        report = driver.save_features(
            make_extract_features(model, dev), [split],
            {"test": DataLoader(split, TRAIN_BATCH, num_workers=8)}, dev)
        wall = time.perf_counter() - t0
        feats = np.stack([np.load(split.save_feature_path(i))
                          for i in range(len(split))])
        clean = no_kernel_launched()
    ok = (report["test"]["files"] == DRIVER_EVAL and feats.shape ==
          (DRIVER_EVAL, 512) and feats.dtype == np.float32
          and bool(np.isfinite(feats).all()) and clean)
    all_ok = all_ok and ok
    log("resnet_driver", part="save_feats", files=report["test"]["files"],
        feature_shape=list(feats.shape[1:]), wall_s=wall,
        frames_per_s=DRIVER_EVAL / wall, no_kernel_launched=clean, ok=ok)
    del model

    fields, ok = resnet_serve(dev, weights)
    all_ok = all_ok and ok
    log("resnet_driver", part="serve", **fields, ok=ok)

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    six = torch.randint(0, 256, (2 * TRAIN_BATCH, DATA_SHAPE, DATA_SHAPE, 6),
                        dtype=torch.uint8, device=dev, generator=gen)
    labels = torch.randint(0, 11, (2 * TRAIN_BATCH,), device=dev,
                           generator=gen)

    def six_batch(i):
        lo = i % 2 * TRAIN_BATCH
        return six[lo:lo + TRAIN_BATCH], labels[lo:lo + TRAIN_BATCH]

    for flow in ("twos", "only", "sixc"):
        args, model = seeded_model(RESNET_ARGV + [f"--flow={flow}"],
                                   SEED + 24)
        state, step = sgd_state(model.to(dev), args, 2)
        reset_kernel_counts()
        _, fields, _ = time_steps(step, six_batch, 0, OTHER_FLOW_STEPS, 0)
        clean = no_kernel_launched()
        ok = fields["losses_finite"] and clean
        all_ok = all_ok and ok
        log("resnet_driver", part="flow", flow=flow, batch=TRAIN_BATCH,
            samples_per_s=TRAIN_BATCH / fields["step_ms"] * 1e3,
            no_kernel_launched=clean, **fields, ok=ok)
        del state, step, model
    del six
    torch.cuda.empty_cache()

    # the CNN-RNN over the dumped 512-d features: windows of CNNRNN_WINDOW
    pool = torch.from_numpy(feats).to(dev)
    idx = (torch.arange(CNNRNN_BATCH * CNNRNN_WINDOW, device=dev) * 7) % len(
        pool)
    windows = pool[idx].reshape(CNNRNN_BATCH, CNNRNN_WINDOW, 512)
    win_labels = torch.arange(CNNRNN_BATCH, device=dev) % 11
    args, model = seeded_model(
        RESNET_ARGV + ["--feats_model=rn", "--temp_pool=gru",
                       f"--window={CNNRNN_WINDOW}"], SEED + 25, feats=True)
    state, step = sgd_state(model.to(dev), args, 1)
    reset_kernel_counts()
    _, fields, _ = time_steps(step, lambda i: (windows, win_labels), 0,
                              OTHER_FLOW_STEPS, 0)
    clean = no_kernel_launched()
    ok = fields["losses_finite"] and clean
    all_ok = all_ok and ok
    log("resnet_driver", part="cnnrnn_feats", feat_dim=512,
        batch=CNNRNN_BATCH, window=CNNRNN_WINDOW, no_kernel_launched=clean,
        **fields, ok=ok)
    log("resnet_driver_check", wall_s=time.perf_counter() - t_phase,
        ok=all_ok)
    if not all_ok:
        raise SystemExit("the ResNet-v2 drivers failed their gates")


def r21d_train_phase(dev):
    """0031, R(2+1)D-34 over 8 x 224^2 clips, 11 classes, through the
    driver's train step (``device_prepare`` of the clips, bf16, SGD): batch
    64 with ``--remat block`` and batch 32 without, 3 warm-up and
    R21D_TIMED timed steps each (2 profiled); then ``--window 32`` at batch
    16 with remat block for 3 steps. Gates: finite losses; 30 steps on one
    batch lower the loss; ``init_bn``'s statistics unchanged bit for bit
    and every other BN's moved; the first bf16 step against f32 and f64 at
    batch R21D_SMALL (its bf16 update logged by stage, not gated: it is
    chaotic at random weights); R21D_PIECES in bf16 against f32 at that
    batch (``r21d_piece_gaps``); remat block's first-step loss and
    gradients those of remat none (f32, TF32 off); no kernel launched."""
    from tennis_torch.inference import prepare_input
    from tennis_torch.parallel.train_step import softmax_ce

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    clips = torch.randint(0, 256, (R21D_POOL, R21D_WINDOW, R21D_SHAPE,
                                   R21D_SHAPE, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
    labels = torch.randint(0, 11, (R21D_POOL,), device=dev, generator=gen)

    def batcher(size):
        n = R21D_POOL // size

        def batch(i):
            lo = i % n * size
            return clips[lo:lo + size], labels[lo:lo + size]
        return batch

    finite, clean, weights, stats_ok = True, True, None, True
    runs = [("block", R21D_BATCH_REMAT, R21D_WINDOW, TRAIN_WARMUP,
             R21D_TIMED, TRAIN_PROFILED),
            ("none", R21D_BATCH_NONE, R21D_WINDOW, TRAIN_WARMUP, R21D_TIMED,
             TRAIN_PROFILED),
            ("block", R21D_W32_BATCH, 32, 0, OTHER_FLOW_STEPS, 0)]
    for remat, size, window, warmup, timed, profiled in runs:
        argv = [a for a in R21D_ARGV if not a.startswith("--window")] + [
            f"--window={window}", f"--remat={remat}"]
        args, model = seeded_model(argv, SEED + 26)
        if weights is None:
            weights = weights_of(model)
        model.to(dev)
        if window == R21D_WINDOW:
            batch = batcher(size)
        else:  # 32-frame clips from 4 consecutive pool clips
            def batch(i, size=size):
                idx = [(i * size + b) * 4 % R21D_POOL for b in range(size)]
                x = torch.cat([clips[[(j + t) % R21D_POOL for t in range(4)]]
                               .reshape(1, -1, *clips.shape[2:])
                               for j in idx])
                return x, labels[:size]
        x, y = batch(0)
        fwd, flops = step_flops(model, prepare_input(x[:2], model.dtype),
                                y[:2])
        flops *= size / 2
        before = {k: v.clone() for k, v in model.named_buffers()}
        state, step = sgd_state(model, args, 4)
        reset_kernel_counts()
        _, fields, by_name = time_steps(step, batch, warmup, timed,
                                        profiled)
        clean = clean and no_kernel_launched(by_name)
        finite = finite and fields["losses_finite"]
        after = dict(model.named_buffers())
        frozen = [k for k in before if ".init_bn." in k]
        moved = [k for k in before if k not in frozen
                 and not torch.equal(before[k], after[k])]
        run_stats_ok = (len(frozen) == 2 and all(
            torch.equal(before[k], after[k]) for k in frozen)
            and len(moved) == len(before) - len(frozen))
        stats_ok = stats_ok and run_stats_ok
        log("r21d_train", model_id="0031", remat=remat, batch=size,
            window=window, data_shape=R21D_SHAPE, dtype="bfloat16",
            clips_per_s=size / fields["step_ms"] * 1e3,
            frames_per_s=size * window / fields["step_ms"] * 1e3,
            model_gflop_per_clip_forward=fwd / 1e9,
            model_gflop_per_step=flops / 1e9,
            mfu=flops / (fields["step_ms"] / 1e3) / PEAK_BF16_FLOPS,
            init_bn_unchanged=run_stats_ok, other_bn_moved=len(moved),
            **fields)
        del state, step, model, before, after
        torch.cuda.empty_cache()

    _, _, step = rebuilt(R21D_ARGV, weights, dev)
    small = batcher(R21D_OVERFIT_BATCH)
    overfit = [step(*small(0))[0].item() for _ in range(OVERFIT_STEPS)]
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])
    del step
    x, y = batcher(R21D_SMALL)(0)
    gap = first_step_gap(R21D_ARGV, weights, dev, x, y)
    model, _, _ = rebuilt(R21D_ARGV, weights, dev, torch.float32)
    pieces = r21d_piece_gaps(model, prepare_input(x, torch.float32))
    del model
    pieces_ok = all(p["out_rel"] <= R21D_PIECE_OUT_TOL
                    and p["stats_rel"] <= TRAIN_STATS_TOL
                    and p["worst_leaf_rel_l2"] <= R21D_PIECE_GRAD_TOL
                    for p in pieces.values())

    # remat block against none: the first step's loss and gradients in f32
    grads = []
    for remat in ("none", "block"):
        model, state, _ = rebuilt(R21D_ARGV + [f"--remat={remat}"], weights,
                                  dev, torch.float32)
        loss = softmax_ce(model(prepare_input(x, torch.float32), train=True),
                          y)
        g = torch.autograd.grad(loss, list(model.parameters()))
        grads.append((loss.item(), torch.cat([t.flatten() for t in g])))
        del model, state, g
    (loss_n, g_n), (loss_b, g_b) = grads
    remat_loss_rel = abs(loss_b - loss_n) / abs(loss_n)
    remat_grad_rel = ((g_b - g_n).norm() / g_n.norm()).item()
    del grads, clips
    torch.cuda.empty_cache()
    ok = (finite and lowered and stats_ok and clean and f32_gaps_ok(gap)
          and pieces_ok
          and remat_loss_rel <= R21D_REMAT_LOSS_TOL
          and remat_grad_rel <= R21D_REMAT_GRAD_TOL)
    log("r21d_train_check", losses_finite=finite, overfit_batch=
        R21D_OVERFIT_BATCH, overfit_losses=overfit, overfit_lowered=lowered,
        init_bn_frozen_others_moved=stats_ok, f32_batch=R21D_SMALL, **gap,
        loss_tol=TRAIN_LOSS_TOL, stats_tol=TRAIN_STATS_TOL,
        f64_update_tol=F64_UPDATE_TOL, pieces_bf16_vs_f32=pieces,
        piece_tols=[R21D_PIECE_OUT_TOL, TRAIN_STATS_TOL,
                    R21D_PIECE_GRAD_TOL],
        remat_loss_rel=remat_loss_rel,
        remat_grad_rel_l2=remat_grad_rel,
        remat_tols=[R21D_REMAT_LOSS_TOL, R21D_REMAT_GRAD_TOL],
        no_kernel_launched=clean, wall_s=time.perf_counter() - t_phase,
        ok=ok)
    if not ok:
        raise SystemExit("the R(2+1)D train step failed its gates")


def r21d_driver_phase(dev):
    """``train.fit`` of 0031 (window 8, 224^2, batch R21D_DRIVER_BATCH)
    over in-memory clip splits (R21D_DRIVER_TRAIN train clips, val and test
    of R21D_DRIVER_EVAL), a resume and ``evaluate --metrics_out``, with the
    gates of ``fit_resume_evaluate``."""
    t_phase = time.perf_counter()
    frames = np.random.default_rng(SEED + 27).integers(
        0, 256, (R21D_DRIVER_FRAMES, R21D_SHAPE, R21D_SHAPE, 3),
        dtype=np.uint8)
    argv = R21D_ARGV + [f"--batch_size={R21D_DRIVER_BATCH}", "--epochs=2",
                        "--log_interval=1", "--model_id=0031"]
    splits = {"train": MemorySplit(frames, R21D_DRIVER_TRAIN, None, "train",
                                   window=R21D_WINDOW),
              "val": MemorySplit(frames[::-1], R21D_DRIVER_EVAL, None, "val",
                                 window=R21D_WINDOW),
              "test": MemorySplit(frames[1:], R21D_DRIVER_EVAL, None, "test",
                                  window=R21D_WINDOW)}
    fields, ok = fit_resume_evaluate(dev, argv, splits, SEED + 27,
                                     R21D_DRIVER_BATCH)
    log("r21d_driver", epochs=2, batch=R21D_DRIVER_BATCH,
        train_clips=R21D_DRIVER_TRAIN, eval_clips=R21D_DRIVER_EVAL,
        window=R21D_WINDOW, data_shape=R21D_SHAPE, **fields,
        wall_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        raise SystemExit("the R(2+1)D driver failed its gates")


def f32_bound(flops, nbytes):
    """(ms, bound by) of f32 work on the tensor cores as 3xTF32: three TF32
    products a multiply-add at PEAK_TF32_FLOPS."""
    return bound(3 * flops, nbytes, PEAK_TF32_FLOPS)


def kernel_f32_phase(dev):
    """The f32 dense-layer kernel (``"f32"``, 3xTF32 on the tensor cores)
    against the plain version in f32 and in f64 at F32_LAYER_CASES, then the
    58 layers of one DenseNet121-512 forward at each of F32_STACK_BATCHES
    block by block (kernel, plain, cuDNN). Returns the max |kernel - plain|
    and the stacks' figures by batch."""
    from tennis_torch.ops import dense_block as db

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    worst = 0.0
    name = DENSE_KERNELS["f32"]
    for case, batch, side, c_in, c_final in F32_LAYER_CASES:
        state, ops = random_layer(gen, batch, side, c_in, c_final, dev,
                                  torch.float32)
        want = db.dense_layer_reference(state.clone(), c_in, ops)
        # the plain version in f64 on the same operands
        want64 = db.dense_layer_reference(state.double(), c_in,
                                          ops)[..., c_in:c_in + 32]
        routed = db.dense_layer_route(batch, side, side, c_in,
                                      dtype=torch.float32)
        before = db.dense_layer.variant_launches["f32"]
        got = db.dense_layer(state.clone(), c_in, ops)
        torch.cuda.synchronize()
        abs_err, rel, untouched, ok = check_layer(state, got, want, c_in,
                                                  F32_KERNEL_TOL)

        def rel_f64(t):
            return ((t[..., c_in:c_in + 32].double() - want64).abs().max()
                    / want64.abs().max()).item()

        rel64 = rel_f64(got)
        ok = ok and routed == ("f32", None) and rel64 <= F32_F64_TOL and \
            db.dense_layer.variant_launches["f32"] == before + 1
        worst = max(worst, abs_err)
        lib = library_convs(state, c_in, ops)
        b_ms, b_by = f32_bound(*layer_work(batch, side, c_in, elem=4))
        device_ms = kernel_device(lambda: db.dense_layer(state, c_in, ops),
                                  name, launches=1)[0]
        log("kernel_f32", case=case, shape=[batch, side, side, c_final],
            c_in=c_in, route=routed[0], tol=F32_KERNEL_TOL,
            f64_tol=F32_F64_TOL, max_abs_err=abs_err, rel_err=rel,
            rel_err_f64=rel64, plain_rel_err_f64=rel_f64(want),
            untouched=untouched,
            ms=time_ms(lambda: db.dense_layer(state, c_in, ops)),
            device_ms=device_ms,
            plain_ms=time_ms(lambda: db.dense_layer_reference(state, c_in,
                                                              ops), reps=3),
            library_ms=time_ms(lib), library_device_ms=all_device_ms(lib),
            bound_ms=b_ms, bound_by=b_by,
            roofline_share=b_ms / device_ms, ok=ok)
        if not ok:
            raise SystemExit(f"the f32 dense_layer kernel disagrees with its "
                             f"plain version or f64 at {case}")
        del state, ops, want, want64, got
    return worst, {batch: stack_f32(dev, gen, batch)
                   for batch in F32_STACK_BATCHES}


def stack_f32(dev, gen, batch):
    """The 58 layers of one DenseNet121-512 forward at ``batch`` frames,
    block by block, each block's layers in sequence over one state as the
    forward runs them: the kernel against the plain version, its device
    ms, the plain version's and cuDNN's ms."""
    from tennis_torch.ops import dense_block as db

    rows = []
    name = DENSE_KERNELS["f32"]
    side, channels = DATA_SHAPE // 4, 64
    for block, num_layers in enumerate((6, 12, 24, 16)):
        c_final = channels + 32 * num_layers
        state = _rand(gen, dev, batch, side, side, c_final)
        layers = [(channels + 32 * j, random_ops(gen, channels + 32 * j, dev,
                                                 torch.float32))
                  for j in range(num_layers)]

        def run(fn, st=state, layers=layers):
            for c_in, ops in layers:
                fn(st, c_in, ops)

        got, want = state.clone(), state.clone()
        run(db.dense_layer, got)
        run(db.dense_layer_reference, want)
        torch.cuda.synchronize()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        libs = [library_convs(state, c_in, ops) for c_in, ops in layers]
        work = [layer_work(batch, side, c_in, elem=4) for c_in, _ in layers]
        rows.append({
            "block": block, "side": side, "layers": num_layers,
            "rel_err": rel,
            "ms": time_ms(lambda: run(db.dense_layer), reps=3),
            "device_ms": kernel_device(lambda: run(db.dense_layer), name,
                                       launches=num_layers)[0],
            "plain_ms": time_ms(lambda: run(db.dense_layer_reference),
                                reps=1, rounds=3),
            "library_ms": time_ms(lambda: [f() for f in libs], reps=3),
            "flops": sum(w[0] for w in work),
            "bytes": sum(w[1] for w in work)})
        del state, layers, got, want, libs
        channels, side = c_final // 2, side // 2
    for r in rows:
        r["bound_ms"], r["bound_by"] = f32_bound(r["flops"], r["bytes"])
    stack = {k: sum(r[k] for r in rows) for k in
             ("ms", "device_ms", "plain_ms", "library_ms", "flops", "bytes")}
    stack["bound_ms"], stack["bound_by"] = f32_bound(stack["flops"],
                                                     stack["bytes"])
    ok = all(r["rel_err"] <= F32_KERNEL_TOL for r in rows)
    log("stack_f32", batch=batch, blocks=rows, **stack,
        roofline_share=stack["bound_ms"] / stack["device_ms"],
        tol=F32_KERNEL_TOL, ok=ok)
    if not ok:
        raise SystemExit("the f32 dense_layer kernel's stack disagrees with "
                         "its plain version")
    return stack


def skipgram_phase(root):
    """``train_embeddings.train`` for one epoch over a seeded corpus under
    ``root`` (written here): pairs/s from its log, the loss over the epoch;
    gates: the losses finite and falling, the file written."""
    import logging

    from tennis_torch import train_embeddings

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 41)
    words = [f"w{i:03d}" for i in range(VOCAB_WORDS)]
    # each sentence keeps to one of SKIPGRAM_TOPICS groups of words but for
    # one word in ten (so that contexts can be learnt), Zipf ranks within
    ranks = 1.0 / np.arange(1, VOCAB_WORDS // SKIPGRAM_TOPICS + 1)
    ranks /= ranks.sum()
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for name, n in (("captions.txt", SKIPGRAM_CAPTIONS),
                    ("captions_extra_001-045.txt", SKIPGRAM_EXTRA)):
        lengths = rng.integers(SKIPGRAM_LEN[0], SKIPGRAM_LEN[1] + 1, n)
        topics = rng.integers(0, SKIPGRAM_TOPICS, n)
        with open(os.path.join(root, "annotations", name), "w") as f:
            for i, (k, topic) in enumerate(zip(lengths, topics)):
                ids = topic + SKIPGRAM_TOPICS * rng.choice(len(ranks), k,
                                                           p=ranks)
                stray = rng.random(k) < 0.1
                ids[stray] = rng.integers(0, VOCAB_WORDS, int(stray.sum()))
                f.write(f"{i} " + " ".join(words[j] for j in ids) + "\n")
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logger = logging.getLogger("tennis_torch.train_embeddings")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        args = train_embeddings.parse_args([
            f"--root={root}", "--epochs=1", "--notsne", "--device=cuda"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, vocab, vecs = train_embeddings.train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    # the mean loss of a fixed sample of the epoch's pairs, with fixed
    # negatives, at the trainer's initial parameters and at its last
    from tennis_torch.models.skipgram import SkipGram
    from tennis_torch.native import center_context_pairs

    dev = params["embedding"].device
    model = SkipGram(len(vocab), args.ngram_buckets, args.emb_size,
                     vocab.idx_to_counts, num_negatives=args.num_negatives,
                     idx_to_token=vocab.idx_to_token, device=dev)
    coded = [[vocab[t] for t in sent if t in vocab] for sent in
             train_embeddings.load_corpus(root, True)]
    centers, contexts = (torch.from_numpy(a[:SKIPGRAM_PROBE]).to(dev) for a
                         in center_context_pairs(coded, args.window,
                                                 args.seed + 1))
    negatives = model.sample_negatives(
        torch.Generator(device=dev).manual_seed(SEED + 41), len(centers))
    initial = model.init_params(
        torch.Generator(device=dev).manual_seed(args.seed))
    with torch.no_grad():
        probe = [model.loss(p, centers, contexts, negatives).mean().item()
                 for p in (initial, params)]
    pairs = [int(m.split()[2]) for m in lines if m.startswith("epoch 1:")]
    progress = [m for m in lines if m.startswith("epoch 1, iter")]
    losses = [float(m.split("loss ")[1].split(",")[0]) for m in progress]
    wps = [float(m.rsplit(", ", 1)[1].split("K")[0]) * 1e3 for m in progress]
    path = os.path.join(root, "embeddings-ex.txt")
    ok = (len(losses) >= 4 and bool(np.isfinite(losses + probe).all())
          and probe[1] < probe[0] and os.path.exists(path)
          and bool(np.isfinite(vecs).all()))
    log("skipgram", vocab=len(vocab), sentences=SKIPGRAM_CAPTIONS +
        SKIPGRAM_EXTRA, pairs=pairs[0] if pairs else None,
        batch=args.batch_size, train_wall_s=wall,
        pairs_per_s=(pairs[0] // args.batch_size * args.batch_size) / wall
        if pairs else None, wps_logged_median=statistics.median(wps)
        if wps else None, losses_logged=losses, probe_pairs=len(centers),
        probe_loss_start_end=probe, file=os.path.basename(path),
        wall_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        raise SystemExit("the SkipGram trainer failed its gates")
    return path


class MemoryPixelSplit:
    """An in-memory captions-mode split of uint8 frames with what
    ``train_gnmt`` and the bucketed loader read of a TennisSet (see
    ``MemoryCaptionSplit``): point i has ``frames[i]`` frames of the shared
    ``pool``, from a seeded offset, and a caption of 8-50 ids."""

    def __init__(self, vocab, pool, n, offset, inference,
                 frames=(PIXCAP_FRAMES // 2, PIXCAP_FRAMES)):
        from tennis_torch.data.tennis_set import caption_ids

        rng = np.random.default_rng([SEED + 42, offset])
        self.vocab, self.inference, self._split = vocab, inference, offset
        self.pool = pool
        self.lengths = rng.integers(frames[0], frames[1] + 1, n)
        self.starts = rng.integers(0, len(pool), n)
        words = rng.integers(CAP_IDS_LEN[0] - 2, CAP_IDS_LEN[1] - 1, n)
        self.captions = [" ".join(vocab.idx_to_token[4 + int(w)] for w in
                                  rng.integers(0, VOCAB_WORDS, k))
                         for k in words]
        self.ids = [caption_ids(vocab, c) for c in self.captions]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        idx = (self.starts[i] + np.arange(self.lengths[i])) % len(self.pool)
        item = (self.pool[idx], self.ids[i], int(self.lengths[i]),
                len(self.ids[i]))
        return item + (i,) if self.inference else item

    def get_captions(self, ids=False, split=False):
        if ids:
            return list(self.ids)
        return [c.split() if split else c for c in self.captions]

    def get_data_lens(self):
        return [(int(n), len(c)) for n, c in zip(self.lengths, self.ids)]

    def stats(self):
        return (f"in-memory pixels split {self._split}: {len(self)} points, "
                f"{int(self.lengths.sum())} frames")


def pixcap_model(args, vocab, tree, dev, backbone_dtype=torch.float32):
    """The pixels-path captioner the flags describe with ``tree``'s
    weights on ``dev``; ``backbone_dtype`` float64 runs its backbone in f64
    (the GNMT computes in f32, as the package does)."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.train_gnmt import build_model

    model = load_flax(build_model(args, len(vocab)), tree).to(dev)
    if backbone_dtype != torch.float32:
        model.src_embed.dtype = backbone_dtype
        model.src_embed.to(backbone_dtype)
    return model


def pixcap_train_phase(dev, vocab):
    """The pixels-path captioner's train step (0102 widths, f32 DenseNet121
    at 512^2, remat block) through make_seq2seq_train_step over seeded
    uint8 batches on the device, --freeze_backbone off and on: times,
    rates, the device's share; gates: finite losses, a repeated batch
    learnt, the first step against the backbone in f64, frozen src_embed
    unchanged bit for bit with its statistics moved, no dense-layer kernel
    launched in a step."""
    import argparse

    from tennis_torch.bridge import to_flax
    from tennis_torch.models.gnmt import masked_ce_loss
    from tennis_torch.parallel.train_step import adam_with_clip, \
        create_seq2seq_state, make_seq2seq_train_step
    from tennis_torch.train_gnmt import build_model, parse_args

    t_phase = time.perf_counter()
    args = parse_args(PIXCAP_ARGV)
    tree = random_flax_tree(to_flax(build_model(args, len(vocab))),
                            np.random.default_rng(SEED + 43))
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    pool = torch.randint(0, 256, (PIXCAP_POOL, DATA_SHAPE, DATA_SHAPE, 3),
                         dtype=torch.uint8, device=dev, generator=gen)
    rng = np.random.default_rng(SEED + 43)

    def make_batch(i, points=PIXCAP_BATCH, frames=PIXCAP_FRAMES):
        lengths = [frames] + [frames - 5] * (points - 1)
        idx = (torch.arange(points * frames, device=dev) + 7 * i) % PIXCAP_POOL
        src = pool[idx].reshape(points, frames, DATA_SHAPE, DATA_SHAPE, 3)
        src = src.clone()
        for b, n in enumerate(lengths):
            src[b, n:] = 0  # the loader's padded steps
        r = np.random.default_rng([SEED + 43, i])
        caps = r.integers(CAP_IDS_LEN[0], CAP_IDS_LEN[1] + 1, points)
        tgt = np.ones((points, int(caps.max())), np.int32)
        for b, n in enumerate(caps):
            tgt[b, :n] = r.integers(4, len(vocab), n)
        return (src, torch.from_numpy(tgt).to(dev),
                torch.tensor(lengths, dtype=torch.float32, device=dev),
                torch.from_numpy(caps.astype(np.float32)).to(dev))

    batches = [make_batch(i) for i in range(4)]
    runs, ok = {}, True
    for freeze in (False, True):
        model = pixcap_model(args, vocab, tree, dev)
        state = create_seq2seq_state(model, adam_with_clip(args.clip), args.lr,
                                     freeze)
        step = make_seq2seq_train_step(state, masked_ce_loss)
        before = {k: v.clone() for k, v in model.src_embed.state_dict().items()}
        params = {n for n, _ in model.src_embed.named_parameters()}
        reset_kernel_counts()

        def batch(i):
            return (*batches[i % len(batches)], rng.integers(2 ** 31))

        _, fields, by_name = time_steps(lambda *b: (step(*b), None), batch,
                                        PIXCAP_WARMUP, PIXCAP_TIMED)
        counts = kernel_counts()
        clean = kernel_launches_in(by_name) == 0 and \
            sum(counts[0].values()) == 0 and counts[1] == 0
        after = model.src_embed.state_dict()
        frozen_ok = (not freeze) or (
            all(torch.equal(before[k], after[k]) for k in params)
            and all(not torch.equal(before[k], after[k])
                    for k in before if k not in params))
        frames = PIXCAP_BATCH * PIXCAP_FRAMES
        tokens = statistics.mean(float(b[3].sum()) for b in batches)
        log("pixcap_train", freeze_backbone=freeze, batch=PIXCAP_BATCH,
            frames_per_point=PIXCAP_FRAMES, frames_per_step=frames,
            data_shape=DATA_SHAPE, remat=args.remat, dtype="float32",
            tf32=torch.backends.cudnn.allow_tf32,
            frames_per_s=frames / fields["step_ms"] * 1e3,
            target_tokens_per_s=tokens / fields["step_ms"] * 1e3,
            frozen_unchanged_stats_moved=frozen_ok,
            no_kernel_launched=clean, **fields)
        ok = ok and fields["losses_finite"] and frozen_ok and clean
        runs[freeze] = fields["step_ms"]
        del model, state, step, before, after
        torch.cuda.empty_cache()

    # 30 steps on one repeated small batch, unfrozen
    model = pixcap_model(args, vocab, tree, dev)
    state = create_seq2seq_state(model, adam_with_clip(args.clip), args.lr)
    step = make_seq2seq_train_step(state, masked_ce_loss)
    small = make_batch(0, 1, PIXCAP_SMALL)
    overfit = [step(*small, rng.integers(2 ** 31)).item()
               for _ in range(OVERFIT_STEPS)]
    lowered = statistics.mean(overfit[-5:]) < statistics.mean(overfit[:5])
    del model, state, step

    # the first step at dropout 0, f32 against the backbone in f64
    no_drop = argparse.Namespace(**{**vars(args), "dropout": 0.0})
    results = []
    for dtype in (torch.float32, torch.float64):
        model = pixcap_model(no_drop, vocab, tree, dev, dtype)
        state = create_seq2seq_state(model, adam_with_clip(args.clip), args.lr)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss = make_seq2seq_train_step(state, masked_ce_loss)(*small, 5).item()
        update = torch.cat([(p.detach() - p0[n]).double().flatten()
                            for n, p in model.named_parameters()])
        stats = torch.cat([b.double().flatten() for b in model.buffers()])
        results.append((loss, update, stats))
        del model, state, p0
    (l32, u32, s32), (l64, u64, s64) = results
    gap = {"loss_f32": l32, "loss_f64": l64,
           "loss_rel": abs(l32 - l64) / abs(l64),
           "stats_rel": ((s32 - s64).abs().max() / s64.abs().max()).item(),
           "update_rel_l2": ((u32 - u64).norm() / u64.norm()).item()}
    del results, pool, batches
    torch.cuda.empty_cache()
    ok = (ok and lowered and gap["loss_rel"] <= PIXCAP_F64_LOSS_TOL
          and gap["stats_rel"] <= PIXCAP_F64_STATS_TOL
          and gap["update_rel_l2"] <= F64_UPDATE_TOL)
    log("pixcap_train_check", overfit_points=1, overfit_frames=PIXCAP_SMALL,
        overfit_losses=overfit, overfit_lowered=lowered,
        f64_points=1, f64_frames=PIXCAP_SMALL, **gap,
        tols=[PIXCAP_F64_LOSS_TOL, PIXCAP_F64_STATS_TOL, F64_UPDATE_TOL],
        step_ms={"train": runs[False], "frozen": runs[True]},
        wall_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        raise SystemExit("the pixels-path captioner's train step failed its "
                         "gates")


def pixcap_driver_phase(dev, vocab, root):
    """``train_gnmt.train`` of the pixels-path captioner for an epoch over
    in-memory uint8 splits, its src_embed grafted from a DenseNet121 donor
    epoch (``--backbone_from_id``) and frozen, ``--emb_file`` from
    ``[skipgram]`` under ``root``; then ``evaluate_gnmt --force``. Gates: 58
    f32 dense launches an eval forward, 3 GRU launches a decode batch, the
    first decode batch's encoder output against the plain-version forward,
    the epoch files read back bit for bit. Returns the dense launches by
    route of the whole run."""
    import logging
    import tempfile
    from unittest import mock

    from tennis_torch import evaluate_gnmt, train_gnmt
    from tennis_torch.bridge import from_flax, state_to_flax, to_flax
    from tennis_torch.models import FrameModel, backbone_feature_dim, \
        get_backbone
    from tennis_torch.models.gnmt import NMTModel
    from tennis_torch.ops import dense_block as db
    from tennis_torch.ops import gru, rnn
    from tennis_torch.parallel.train_step import create_train_state, \
        sgd_with_schedule
    from tennis_torch.translation import BeamSearchTranslator
    from tennis_torch.utils import checkpoint as ckpt
    from tennis_torch.utils import msgpack_codec
    from tennis_torch.utils.experiments import experiment_dir

    t_phase = time.perf_counter()
    pool = np.random.default_rng(SEED + 44).integers(
        0, 256, (PIXCAP_POOL, DATA_SHAPE, DATA_SHAPE, 3), dtype=np.uint8)
    splits = [MemoryPixelSplit(vocab, pool, n, k, name != "train")
              for k, (name, n) in enumerate(PIXCAP_POINTS.items())]
    argv = PIXCAP_ARGV + [
        f"--root={root}", "--model_id=pix", "--backbone_from_id=0006",
        "--freeze_backbone", "--epochs=1", f"--batch_size={PIXCAP_BATCH}",
        f"--test_batch_size={PIXCAP_BATCH}", "--emb_file=embeddings-ex.txt",
        "--num_workers=2", "--log_interval=1"]
    translate = BeamSearchTranslator.translate_tokens
    save = ckpt.AsyncCheckpointer.save
    decode_step = NMTModel.decode_step
    decodes, saved, lines = [], [], []
    steps, compared = [0], [0]

    def counting_decode_step(self, *a, **kw):
        steps[0] += 1
        return decode_step(self, *a, **kw)

    def recording_translate(self, src, src_valid_length, vocab_):
        B, T = src.shape[:2]
        dense0 = dict(db.dense_layer.variant_launches)
        gru0, steps0 = gru.gru_recurrence.launches, steps[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = translate(self, src, src_valid_length, vocab_)
        torch.cuda.synchronize()
        rec = {"B": B, "T": T, "ms": (time.perf_counter() - t0) * 1e3,
               "dense": {v: n - dense0[v] for v, n in
                         db.dense_layer.variant_launches.items()},
               "gru": gru.gru_recurrence.launches - gru0,
               "steps": steps[0] - steps0}
        if not decodes:  # the first decode batch: kernels against plain
            vl = torch.as_tensor(src_valid_length, device=dev).to(torch.int32)
            model = self._model
            before = (db.dense_layer.launches, gru.gru_recurrence.launches)
            with torch.inference_mode(), rnn.gru_decode():
                mem_k, _ = model.encode(src, vl)
                with db.plain_dense_layers(model):
                    mem_p, _ = model.encode(src, vl)
            torch.cuda.synchronize()
            # launches of the comparison are not the path's: taken off below
            compared[0] += db.dense_layer.launches - before[0]
            rec["encoder_rel_err"] = ((mem_k - mem_p).abs().max()
                                      / mem_p.abs().max()).item()
            rec["profile"] = (self, src, src_valid_length)
        decodes.append(rec)
        return out

    def recording_save(self, path, tree_):
        saved.append((path, tree_))
        return save(self, path, tree_)

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines()
    logging.getLogger().addHandler(handler)
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as work, \
                mock.patch.object(BeamSearchTranslator, "translate_tokens",
                                  recording_translate), \
                mock.patch.object(NMTModel, "decode_step",
                                  counting_decode_step), \
                mock.patch.object(ckpt.AsyncCheckpointer, "save",
                                  recording_save):
            os.chdir(work)
            # the donor: a DenseNet121 classifier's epoch in the classifier
            # trainer's layout (f32 parameters, as flax keeps its masters)
            donor = FrameModel(get_backbone("DenseNet121"), 11,
                               feature_dim=backbone_feature_dim(
                                   "DenseNet121", DATA_SHAPE))
            donor.load_state_dict(from_flax(random_flax_tree(
                to_flax(donor), np.random.default_rng(SEED + 45))))
            tx, _ = sgd_with_schedule(0.01)
            donor_tree = state_to_flax(create_train_state(donor, tx))
            ckpt.save_state(ckpt.epoch_path(experiment_dir("vision", "0006"),
                                            0), donor_tree)
            saved.clear()
            args = train_gnmt.parse_args(argv)
            reset_kernel_counts()
            t0 = time.perf_counter()
            state = train_gnmt.train(args, tuple(splits))
            wall_train = time.perf_counter() - t0
            n_train_decodes = len(decodes)
            exp = os.path.join("models", "captioning", "experiments", "pix")
            identical = len(saved) >= 2 and all(
                msgpack_codec.serialize(ckpt.load_raw(p))
                == msgpack_codec.serialize(t) for p, t in saved)
            layout = sorted(ckpt.load_raw(ckpt.epoch_path(exp, 0))[
                "opt_state"]["inner_state"])
            donor_kept = all(
                torch.equal(p.detach().cpu(), q) for p, q in zip(
                    state.model.src_embed.parameters(),
                    donor.backbone.parameters()))
            t0 = time.perf_counter()
            suite = evaluate_gnmt.evaluate(evaluate_gnmt.parse_args(
                argv + ["--force"]), tuple(splits))
            wall_eval = time.perf_counter() - t0
            dense_counts, gru_count = kernel_counts()
            dense_counts["f32"] -= compared[0]
            self_, src, src_vl = decodes[0]["profile"]
            wall = []

            def one_decode():
                t = time.perf_counter()
                translate(self_, src, src_vl, vocab)
                wall.append((time.perf_counter() - t) * 1e3)

            # a trace that dropped kernel records is taken again
            for _ in range(TRACE_ATTEMPTS):
                by_name = device_profile(one_decode)
                if sum(v[1] for k, v in by_name.items()
                       if DENSE_KERNELS["f32"] in k) == 58:
                    break
            os.chdir(cwd)
    finally:
        os.chdir(cwd)
        logging.getLogger().removeHandler(handler)

    busy_ms = sum(v[0] for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    traced = sum(v[1] for k, v in by_name.items() if DENSE_KERNELS["f32"] in k)
    per_forward = [r["dense"] for r in decodes]
    launches_ok = bool(decodes) and all(
        d == {**dict.fromkeys(db.ROUTES, 0), "f32": 58}
        for d in per_forward) and all(r["gru"] == 3 for r in decodes)
    enc = decodes[0]["encoder_rel_err"]
    emb_loaded = any(m.startswith("loaded tgt embeddings") for m in lines)
    ok = (launches_ok and enc <= PIXCAP_ENC_TOL and identical
          and layout == ["0", "1", "2"] and donor_kept and emb_loaded
          and set(suite) >= {"Bleu_4", "CIDEr"})
    dec_ms = [r["ms"] for r in decodes]
    step_ms = [r["ms"] / r["steps"] for r in decodes]
    log("pixcap_driver", epochs=1, points=PIXCAP_POINTS,
        frames_per_point=[PIXCAP_FRAMES // 2, PIXCAP_FRAMES],
        batch=PIXCAP_BATCH, data_shape=DATA_SHAPE, decodes=len(decodes),
        decodes_in_training=n_train_decodes,
        decode_shapes_B_T=[[r["B"], r["T"]] for r in decodes],
        dense_launches_per_decode=per_forward[0],
        gru_launches_per_decode=sorted({r["gru"] for r in decodes}),
        launches_ok=launches_ok, dense_launches_in_run=dense_counts,
        gru_launches_in_run=gru_count, encoder_rel_err=enc,
        encoder_tol=PIXCAP_ENC_TOL,
        decode_ms_median=statistics.median(dec_ms), decode_ms_min=min(dec_ms),
        decode_ms_max=max(dec_ms),
        decode_ms_per_step_median=statistics.median(step_ms),
        decode_profiled_B_T=[decodes[0]["B"], decodes[0]["T"]],
        decode_profiled_f32_launches=traced,
        decode_device_busy_ms=busy_ms, decode_wall_ms=wall[-1],
        decode_idle_share=1 - busy_ms / wall[-1],
        decode_top=[[k[:60], v[0], v[1]] for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]],
        train_wall_s=wall_train, evaluate_wall_s=wall_eval,
        saved_read_back_identical=identical, saved_files=len(saved),
        optimizer_chain=layout, donor_kept_bit_for_bit=donor_kept,
        tgt_embed_from_skipgram=emb_loaded, metrics=suite,
        wall_s=time.perf_counter() - t_phase, ok=ok)
    if not ok:
        raise SystemExit("the pixels-path captioning driver failed its gates")
    return dense_counts


def tp_inputs(rng):
    """The 0102 captioner's flags, vocabulary size, seeded weights (flax
    naming) and one train batch for ``[tp]``."""
    from tennis_torch.bridge import to_flax
    from tennis_torch.train_gnmt import build_model, parse_args

    args = parse_args(CAPTION_ARGV)
    n_vocab = len(caption_vocab())
    tree = random_flax_tree(to_flax(build_model(args, n_vocab, FEAT_DIM)),
                            rng)
    src = rng.standard_normal((TP_BATCH, TP_SRC_LEN, FEAT_DIM)) \
        .astype(np.float32)
    src_vl = rng.integers(TP_SRC_LEN // 4, TP_SRC_LEN + 1, TP_BATCH) \
        .astype(np.float32)
    tgt_vl = rng.integers(4, TP_TGT_LEN + 1, TP_BATCH).astype(np.float32)
    src_vl[0], tgt_vl[0] = TP_SRC_LEN, TP_TGT_LEN
    src[np.arange(TP_SRC_LEN)[None, :] >= src_vl[:, None]] = 0.0
    tgt = rng.integers(4, n_vocab, (TP_BATCH, TP_TGT_LEN)).astype(np.int32)
    return args, n_vocab, tree, (src, tgt, src_vl, tgt_vl)


def tp_leaves(model):
    """The names of the parameters the rule shards at a model axis of 2."""
    from tennis_torch.parallel.mesh import World
    from tennis_torch.parallel.sharding_rules import param_shardings

    return [n for n, s in param_shardings(World(size=2, model_size=2),
                                          model).items() if s.sharded]


def tp_train_step(dev, args, n_vocab, tree, batch, world=None):
    """One captioner train step (the driver's dropout, clip and Adam) from
    ``tree``; with ``world``, through the sharded state: the leaves the
    rule shards at a model axis of 2 placed as 1-of-1 blocks
    (column-parallel forward, the output gather's and ``to_model``'s
    backward, Wh gathered whole for the recurrence) and the memory
    sequence-sharded (the attention's combines and ``take_block``'s
    backward), the clip's norm summed over the model group. Returns the
    loss, the step's update of each parameter and the model-axis
    collectives the step issued, by kind."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.models.gnmt import masked_ce_loss
    from tennis_torch.parallel import distributed as D
    from tennis_torch.parallel import train_step as ts
    from tennis_torch.parallel.sharding_rules import place_blocks
    from tennis_torch.train_gnmt import build_model

    model = load_flax(build_model(args, n_vocab, FEAT_DIM), tree).to(dev)
    if world is not None:
        place_blocks(model, world, tp_leaves(model))
        model.mem_sharding = world
    state = ts.create_seq2seq_state(model, ts.adam_with_clip(args.clip),
                                    args.lr, world=world)
    step = ts.make_seq2seq_train_step(state, masked_ce_loss)
    before = [p.detach().clone() for p in model.parameters()]
    D.model_collectives.clear()
    loss = step(*(torch.from_numpy(x).to(dev) for x in batch), SEED + 20)
    torch.cuda.synchronize()
    return (loss.item(), [p.detach() - b for p, b in
                          zip(model.parameters(), before)],
            dict(D.model_collectives))


def tp_checks(dev, world, tp_in, plain_step, rng):
    """``[tp]``: the model axis through the one-rank group at a model axis
    of 1 (``world``, from ``make_mesh(1, 1)``). The captioner's train step
    through the sharded state (``tp_train_step``: the rule's leaves at a
    model axis of 2 as 1-of-1 blocks, the memory sequence-sharded, every
    model-axis forward and backward collective and the clip's norm over
    the model group) against ``plain_step`` (the same step without a
    group) within TP_LOSS_RTOL and TP_STEP_RTOL; the batch-4 decode over 128 frames, placed the
    same way (Wh gathered for the GRU kernel, the attention's MAX and SUM
    combines over the one-rank model group), its GRU counts set to 0 just
    before and read just after, against the plain decode; the model-axis
    collectives of each, counted by kind (each kind must run); the rule's
    sharded leaves of the 0102 captioner at model axes 2 and 4. Returns
    (ok, GRU launches by variant)."""
    from tennis_torch.bridge import load_flax
    from tennis_torch.ops import gru
    from tennis_torch.parallel import distributed as D
    from tennis_torch.parallel.mesh import World
    from tennis_torch.parallel.sharding_rules import param_shardings, \
        place_blocks
    from tennis_torch.train_gnmt import build_model
    from tennis_torch.translation import BeamSearchTranslator

    t0 = time.perf_counter()
    args, n_vocab, tree, _ = tp_in
    loss, update, step_collectives = tp_train_step(dev, *tp_in, world=world)
    plain_loss, plain_update, _ = plain_step
    step_equal = loss == plain_loss and all(
        torch.equal(a, b) for a, b in zip(update, plain_update))
    step_max_abs = max((a - b).abs().max().item()
                       for a, b in zip(update, plain_update))
    step_rel = (sum(((a.double() - b.double()) ** 2).sum()
                    for a, b in zip(update, plain_update))
                / sum((b.double() ** 2).sum() for b in plain_update)) \
        .sqrt().item()
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    step_ok = loss_rel <= TP_LOSS_RTOL and step_rel <= TP_STEP_RTOL
    del update, plain_update

    def model():
        return load_flax(build_model(args, n_vocab, FEAT_DIM), tree) \
            .to(dev).eval()

    def translator(m, w=None):
        vocab = caption_vocab()
        return BeamSearchTranslator(
            m, vocab[vocab.bos_token], vocab[vocab.eos_token],
            args.beam_size, args.lp_alpha, args.lp_k, args.tgt_max_len + 20,
            world=w)

    sharded = model()
    leaves = {m: sum(s.sharded for s in param_shardings(
        World(size=m, model_size=m), sharded).values()) for m in TP_AXES}
    src = rng.standard_normal((CAPTION_BATCH, SRC_MAX_LEN, FEAT_DIM)) \
        .astype(np.float32)
    vl = np.array(CAPTION_LENGTHS, np.int32)
    with torch.inference_mode():
        want = translator(model()).build_decoder(CAPTION_BATCH)(
            torch.from_numpy(src).to(dev), torch.from_numpy(vl).to(dev))
    want = [t.cpu().numpy() for t in want]
    names = tp_leaves(sharded)
    place_blocks(sharded, world, names)
    sharded.mem_sharding = world
    # the decoder steps, and the collectives issued before the first
    decoder_step, steps = sharded.decode_step, {"n": 0, "before": 0}

    def counted_step(*a, **k):
        if not steps["n"]:
            steps["before"] = sum(D.model_collectives.values())
        steps["n"] += 1
        return decoder_step(*a, **k)

    sharded.decode_step = counted_step
    reset_kernel_counts()
    gru.gru_recurrence.plain_routed = 0
    D.model_collectives.clear()
    t1 = time.perf_counter()
    samples, scores, lengths = translator(sharded, world).translate(src, vl)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t1) * 1e3
    decode_collectives = dict(D.model_collectives)
    in_loop = sum(decode_collectives.values()) - steps["before"]
    by_variant = dict(gru.gru_recurrence.variant_launches)
    routed = gru.gru_recurrence.plain_routed
    score_err = float(np.abs(scores - want[1]).max())
    score_rel = float((np.abs(scores - want[1]) / np.abs(want[1])).max())
    decode_ok = (by_variant["async"] == 3 and sum(by_variant.values()) == 3
                 and routed == 0 and np.array_equal(samples, want[0])
                 and np.array_equal(lengths, want[2])
                 and score_rel <= TP_SCORE_TOL)
    kinds = {"all_gather", "sum", "max"}
    axis_ran = all(c.get(k, 0) > 0 for c in (step_collectives,
                                             decode_collectives)
                   for k in kinds)
    ok = step_ok and decode_ok and axis_ran and leaves == TP_AXES
    log("tp", world=[world.data_size, world.model_size], batch=TP_BATCH,
        src_len=TP_SRC_LEN, tgt_len=TP_TGT_LEN, loss=loss,
        plain_loss=plain_loss, loss_rel_vs_plain=loss_rel,
        loss_rtol=TP_LOSS_RTOL, step_bit_equal_plain=step_equal,
        step_update_rel_l2_vs_plain=step_rel, step_update_rtol=TP_STEP_RTOL,
        step_max_abs_param_vs_plain=step_max_abs,
        step_model_collectives=step_collectives,
        sharded_leaves_by_axis=leaves, blocks_placed=len(names),
        decode_model_collectives=decode_collectives,
        decoder_steps=steps["n"],
        model_collectives_per_decoder_step=in_loop / max(steps["n"], 1),
        every_collective_kind_ran=axis_ran,
        decode_gru_launches_by_variant=by_variant, plain_routed=routed,
        samples_equal_plain_decode=bool(np.array_equal(samples, want[0])),
        lengths_equal_plain_decode=bool(np.array_equal(lengths, want[2])),
        max_abs_score_vs_plain=score_err, max_rel_score_vs_plain=score_rel,
        score_rtol=TP_SCORE_TOL,
        decode_ms=decode_ms, wall_s=time.perf_counter() - t0, ok=ok)
    return ok, by_variant


def ddp_phase(dev):
    """Data parallelism on the card at world size 1 (``[ddp]``): the
    data-parallel train step, a sharded evaluation forward and a sharded
    decode past the GRU kernels' H, through a one-rank NCCL group; then
    the model axis at 1 through the same group (``[tp]``, ``tp_checks``).
    Returns the dense-layer and GRU kernel launches of its main-path
    calls."""
    import argparse

    import torch.distributed as dist

    from tennis_torch import train as driver
    from tennis_torch.bridge import load_flax, to_flax
    from tennis_torch.data.loader import DataLoader, eval_iter, \
        sharded_eval_iter
    from tennis_torch.inference import build_frame_model, make_eval_step
    from tennis_torch.ops import gru
    from tennis_torch.parallel import distributed as D
    from tennis_torch.parallel.train_step import create_train_state, \
        make_train_step, sgd_with_schedule

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 16)
    tree = random_flax_tree(to_flax(build_frame_model(
        "DenseNet121", 11, DATA_SHAPE)), rng)
    frames = rng.integers(0, 256, (DDP_BATCH, DATA_SHAPE, DATA_SHAPE, 3),
                          dtype=np.uint8)
    labels_np = rng.integers(0, 11, DDP_BATCH)
    images = torch.from_numpy(frames).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    preprocess = driver.make_preprocess(argparse.Namespace(flow=""),
                                        torch.bfloat16)

    def classifier():
        return load_flax(build_frame_model("DenseNet121", 11, DATA_SHAPE),
                         tree).to(dev)

    def train():
        model = classifier()
        tx, _ = sgd_with_schedule(0.001, 0.9, 1e-4, (10, 20), 0.75, 1)
        state = create_train_state(model, tx)
        step = make_train_step(state, preprocess, rng_seed=SEED + 123)
        losses = [step(images, labels)[0].item() for _ in range(DDP_STEPS)]
        return step, losses, [p.detach().clone() for p in model.parameters()]

    def distance(a, b, init):
        num = sum(((x.double() - y.double()) ** 2).sum() for x, y in zip(a, b))
        den = sum(((y.double() - i.double()) ** 2).sum()
                  for y, i in zip(b, init))
        return (num / den).sqrt().item()

    def step_ms(step):
        times = []
        for _ in range(DDP_TIMED):
            t0 = time.perf_counter()
            step(images, labels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    init = [p.detach().clone() for p in classifier().parameters()]
    plain_step, plain_losses, plain = train()
    _, again_losses, again = train()
    spread = distance(again, plain, init)
    plain_ms = step_ms(plain_step)
    del plain_step
    tp_in = tp_inputs(np.random.default_rng(SEED + 20))
    tp_plain = tp_train_step(dev, *tp_in)
    gru.gru_recurrence.plain_routed = 0
    D.initialize_multihost(f"127.0.0.1:{D.free_port()}", 1, 0, "cuda", 0)
    try:
        world = D.current_world("cuda")
        calls = {"all_reduce": 0, "bytes": 0}
        real = dist.all_reduce

        def counted(t, *a, **k):
            calls["all_reduce"] += 1
            calls["bytes"] += t.numel() * t.element_size()
            return real(t, *a, **k)

        dist.all_reduce = counted
        try:
            step, dp_losses, dp = train()
        finally:
            dist.all_reduce = real
        dp_gap = distance(dp, plain, init)
        dp_ms = step_ms(step)
        by_name = device_profile(lambda: step(images, labels))
        nccl = {k: v for k, v in by_name.items() if "nccl" in k.lower()}
        busy_ms = sum(v[0] for k, v in by_name.items()
                      if not k.startswith(("Memcpy", "Memset")))
        del step
        train_ok = (all(np.isfinite(dp_losses))
                    and abs(dp_losses[0] - plain_losses[0])
                    <= DDP_LOSS_TOL * abs(plain_losses[0])
                    and dp_gap <= DDP_UPDATE_FACTOR * spread
                    + DDP_UPDATE_FLOOR)
        log("ddp", world=[world.rank, world.size, str(world.device)],
            backend=dist.get_backend(), batch=DDP_BATCH, steps=DDP_STEPS,
            plain_losses=plain_losses, again_losses=again_losses,
            dp_losses=dp_losses, plain_spread_rel_l2=spread,
            dp_gap_rel_l2=dp_gap, loss_tol=DDP_LOSS_TOL,
            update_bound=DDP_UPDATE_FACTOR * spread + DDP_UPDATE_FLOOR,
            all_reduce_calls_per_step=calls["all_reduce"] / DDP_STEPS,
            bytes_reduced_per_step=calls["bytes"] / DDP_STEPS,
            nccl_device_ms_per_step=sum(v[0] for v in nccl.values()),
            nccl_launches_per_step=sum(v[1] for v in nccl.values()),
            nccl_kernels=sorted(k[:60] for k in nccl),
            device_busy_ms_per_step=busy_ms,
            device_launches_per_step=sum(v[1] for v in by_name.values()),
            plain_step_ms=plain_ms, dp_step_ms=dp_ms,
            dp_step_cost=dp_ms / plain_ms - 1, ok=train_ok)

        # one sharded evaluation forward against eval_iter's
        class Split:
            def __len__(self):
                return DDP_BATCH

            def __getitem__(self, i):
                return frames[i], labels_np[i], np.int64(i)

        scorer = make_eval_step(classifier(), dev)

        def probs(x):
            return torch.softmax(scorer(x), dim=-1)

        reset_kernel_counts()
        sharded = list(sharded_eval_iter(
            DataLoader(Split(), DDP_BATCH, num_workers=1,
                       num_shards=world.size, shard_id=world.rank),
            DDP_BATCH, DDP_BATCH, probs, dev))
        dense, _ = kernel_counts()
        plain_eval = list(eval_iter(DataLoader(Split(), DDP_BATCH,
                                               num_workers=1), probs, dev))
        (got, got_labels, got_idx), = sharded
        (want, want_labels, want_idx), = plain_eval
        eval_ok = (sum(dense.values()) == 58 and np.array_equal(got, want)
                   and np.array_equal(got_idx, want_idx)
                   and np.array_equal(got_labels, want_labels))
        log("ddp_eval", frames=DDP_BATCH, launches_by_variant=dense,
            max_abs_vs_eval_iter=float(np.abs(got - want).max()), ok=eval_ok)
        launches = dict(dense)

        # a 0102-shaped decode past the GRU kernels' H, and at 256
        src = rng.standard_normal((CAPTION_BATCH, SRC_MAX_LEN, FEAT_DIM)) \
            .astype(np.float32)
        vl = np.array([128, 100, 37, 1], np.int32)
        decode_ok, gru_launches = True, dict.fromkeys(gru.VARIANTS, 0)
        for hidden in DDP_HIDDEN:
            d = decode_against_plain(dev, hidden, src, vl, rng)
            n_gru, routed = sum(d["launches"].values()), d["plain_routed"]
            for v in gru.VARIANTS:
                gru_launches[v] += d["launches"][v]
            same = d["samples_equal_plain_decode"]
            plain = gru.gru_decode_route(SRC_MAX_LEN, CAPTION_BATCH,
                                         hidden) == "plain"
            ok = (n_gru == 0 and routed == 3 and same) if plain \
                else (n_gru == 3 and routed == 0)
            decode_ok = decode_ok and ok
            log("ddp_decode", num_hidden=hidden, gru_launches=n_gru,
                plain_routed=routed, samples_equal_plain_decode=same,
                top_beams_equal_plain_decode=bool(np.array_equal(
                    d["samples"][:, 0], d["plain"][0][:, 0])),
                max_abs_score_vs_plain=d["max_abs_score_vs_plain"],
                decode_ms=d["decode_ms"], ok=ok)

        # the model axis at 1 through the same group
        tp_ok, tp_gru = tp_checks(dev, D.make_mesh(1, 1, dev), tp_in,
                                  tp_plain, rng)
        for v in gru.VARIANTS:
            gru_launches[v] += tp_gru[v]
    finally:
        D.shutdown()
    log("ddp_phase", wall_s=time.perf_counter() - t_phase,
        group_destroyed=not D.grouped())
    if not (train_ok and eval_ok and decode_ok and tp_ok) or D.grouped():
        raise SystemExit("the data-parallel phase failed its gates")
    return launches, gru_launches


def torchvision_densenet121(rng):
    """A seeded state dict of torchvision's ``densenet121`` schema (the
    ``features`` part, which the converter reads): convolutions with
    variance 1/fan-in, BN scales and variances around 1, biases and means
    near 0, so activations stay bounded through the 121 layers."""
    sd = {}

    def conv(name, o, i, k):
        sd[name] = (rng.standard_normal((o, i, k, k), np.float32)
                    / np.float32(np.sqrt(i * k * k)))

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(c, np.float32) * 0.05
        sd[f"{name}.running_mean"] = rng.standard_normal(c, np.float32) * 0.05
        sd[f"{name}.running_var"] = rng.uniform(0.8, 1.2, c).astype(
            np.float32)

    conv("features.conv0.weight", 64, 3, 7)
    bn("features.norm0", 64)
    c = 64
    for b, layers in enumerate((6, 12, 24, 16), start=1):
        for j in range(1, layers + 1):
            p = f"features.denseblock{b}.denselayer{j}"
            bn(f"{p}.norm1", c + 32 * (j - 1))
            conv(f"{p}.conv1.weight", 128, c + 32 * (j - 1), 1)
            bn(f"{p}.norm2", 128)
            conv(f"{p}.conv2.weight", 32, 128, 3)
        c += 32 * layers
        if b < 4:
            bn(f"features.transition{b}.norm", c)
            conv(f"features.transition{b}.conv.weight", c // 2, c, 1)
            c //= 2
    bn("features.norm5", c)
    return sd


def densenet_port_name(key):
    """The port's ``FrameModel`` state-dict name of a torchvision
    DenseNet121 key: the documented layout, read without the converter."""
    import re

    body = key[len("features."):]
    m = re.fullmatch(r"denseblock(\d+)\.denselayer(\d+)\.(norm|conv)(\d)"
                     r"\.(\w+)", body)
    if m:
        b, j, kind, i, leaf = m.groups()
        kind = "bn" if kind == "norm" else "conv"
        return f"backbone.block{int(b) - 1}_layer{int(j) - 1}.{kind}{i}.{leaf}"
    m = re.fullmatch(r"transition(\d+)\.(norm|conv)\.(\w+)", body)
    if m:
        t, kind, leaf = m.groups()
        kind = "bn" if kind == "norm" else "conv"
        return f"backbone.transition{int(t) - 1}.{kind}.{leaf}"
    head, leaf = body.split(".")
    head = {"conv0": "conv0", "norm0": "bn0", "norm5": "bn_final"}[head]
    return f"backbone.{head}.{leaf}"


# FlowNet2-S: (source name, port name, out, in, kernel); transposed
# convolutions (deconv*, upsampled_flow*) are IOHW in both, in and out
# swapped
FLOWNET2S = (
    [(f"{n}.0", n, o, i, k) for n, i, o, k in (
        ("conv1", 6, 64, 7), ("conv2", 64, 128, 5), ("conv3", 128, 256, 5),
        ("conv3_1", 256, 256, 3), ("conv4", 256, 512, 3),
        ("conv4_1", 512, 512, 3), ("conv5", 512, 512, 3),
        ("conv5_1", 512, 512, 3), ("conv6", 512, 1024, 3),
        ("conv6_1", 1024, 1024, 3))]
    + [(f"predict_flow{l}", f"predict_flow{l}", 2, i, 3)
       for l, i in ((6, 1024), (5, 1026), (4, 770), (3, 386), (2, 194))]
    + [(f"deconv{l}.0", f"deconv{l}", i, o, 4)
       for l, i, o in ((5, 1024, 512), (4, 1026, 256), (3, 770, 128),
                       (2, 386, 64))]
    + [(f"upsampled_flow{l}_to_{l - 1}", f"upflow{l}", 2, 2, 4)
       for l in (6, 5, 4, 3)])


def flownet2s_state(rng):
    """A seeded FlowNet2-S state dict (torch layout) and the same tensors
    under the port's ``FlowNetS`` names."""
    src, port = {}, {}
    for name, ours, a, b, k in FLOWNET2S:
        fan = (b if not ours.startswith(("deconv", "upflow")) else a) * k * k
        w = rng.standard_normal((a, b, k, k), np.float32) / np.float32(
            np.sqrt(fan))
        src[f"{name}.weight"], port[f"{ours}.weight"] = w, w
        if not ours.startswith("upflow"):
            bias = rng.standard_normal(b if ours.startswith("deconv") else a,
                                       np.float32) * 0.05
            src[f"{name}.bias"], port[f"{ours}.bias"] = bias, bias
    return src, port


def pretrained_phase(dev):
    """The weight converter and ``--pretrained_npz`` on the card
    (``[pretrained]``): seeded source weights through the converter's CLI
    into the classifier, the pixels-path captioner's ``src_embed`` and
    FlowNet-S, each checked against its source bit for bit and by one
    forward. Returns the dense-layer launches by route and the f32
    launches of its main-path forwards."""
    import copy

    from tennis_torch import train, train_gnmt
    from tennis_torch.inference import fold_densenets
    from tennis_torch.models import convert
    from tennis_torch.models.flownet_run import FlowRunner, normalise_pairs
    from tennis_torch.ops import dense_block as db

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    with tempfile.TemporaryDirectory() as work:
        dense_src = torchvision_densenet121(rng)
        torch.save({k: torch.from_numpy(v) for k, v in dense_src.items()},
                   os.path.join(work, "densenet121.pth"))
        flow_src, flow_port = flownet2s_state(rng)
        torch.save({"state_dict": {k: torch.from_numpy(v)
                                   for k, v in flow_src.items()}},
                   os.path.join(work, "flownets.pth.tar"))
        t0 = time.perf_counter()
        for arch in ("densenet121", "flownets"):
            with contextlib.redirect_stdout(sys.stderr):
                convert.main(["--arch", arch,
                              os.path.join(work, f"{arch}.pth" + (
                                  ".tar" if arch == "flownets" else "")),
                              os.path.join(work, f"{arch}.npz")])
        convert_s = time.perf_counter() - t0
        dense_npz = os.path.join(work, "densenet121.npz")

        # the 0006 classifier: the file at its backbone mount
        args = train.parse_args(["--model_id=0006", "--backbone=DenseNet121",
                                 f"--data_shape={DATA_SHAPE}",
                                 f"--pretrained_npz={dense_npz}"])
        model = train.build_model(args, 11).to(dev)
        t0 = time.perf_counter()
        loaded = train.load_pretrained_backbone(model, args.pretrained_npz,
                                                args.flow)
        load_s = time.perf_counter() - t0
        state = model.state_dict()
        mismatched = [k for k, v in dense_src.items() if not torch.equal(
            state[densenet_port_name(k)].cpu(), torch.from_numpy(v))]
        frames = torch.from_numpy(rng.integers(
            0, 256, (PRETRAINED_BATCH, DATA_SHAPE, DATA_SHAPE, 3),
            dtype=np.uint8)).to(dev)
        fields, eval_ok, by_route = eval_against_plain(model, dev, frames, 1)
        classifier_ok = (loaded == len(dense_src) == 604 and not mismatched
                         and eval_ok and sum(by_route.values()) == 58)
        log("pretrained", part="classifier", arrays_loaded=loaded,
            source_tensors=len(dense_src), bitwise_mismatches=mismatched[:4],
            convert_s=convert_s, load_s=load_s, **fields, ok=classifier_ok)
        del model, state

        # the pixels-path captioner: the same file into its f32 src_embed
        gargs = train_gnmt.parse_args(PIXCAP_ARGV + [
            f"--pretrained_npz={dense_npz}"])
        captioner = train_gnmt.build_model(gargs, 20)
        src_loaded = train_gnmt.load_pretrained_src_embed(captioner, gargs)
        src_state = captioner.src_embed.state_dict()
        src_mismatched = [k for k, v in dense_src.items() if not torch.equal(
            src_state[densenet_port_name(k)[len("backbone."):]],
            torch.from_numpy(v))]
        captioner.to(dev).eval()
        fold_densenets(captioner)
        src = frames[None, :PRETRAINED_FRAMES]
        reset_kernel_counts()
        with torch.inference_mode():
            got = captioner.embed_src(src)
        torch.cuda.synchronize()
        f32_launches = db.dense_layer.variant_launches["f32"]
        by_route_f32, _ = kernel_counts()
        with torch.inference_mode(), db.plain_dense_layers(captioner):
            want = captioner.embed_src(src)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        src_ok = (src_loaded == 604 and not src_mismatched
                  and f32_launches == 58 and sum(by_route_f32.values()) == 58
                  and rel <= F32_KERNEL_TOL
                  and bool(torch.isfinite(got).all()))
        log("pretrained", part="src_embed", arrays_loaded=src_loaded,
            bitwise_mismatches=src_mismatched[:4], frames=PRETRAINED_FRAMES,
            features=list(got.shape), f32_launches=f32_launches,
            launches_by_variant=by_route_f32, rel_err=rel,
            tol=F32_KERNEL_TOL, ok=src_ok)
        del captioner, src_state, got, want

        # FlowNet-S: the runner from the converted file against a direct
        # copy of the source tensors in torch's layout
        runner = FlowRunner(params_path=os.path.join(work, "flownets.npz"),
                            batch_size=PRETRAINED_PAIRS, device=dev)
        ours = runner.model.state_dict()
        flow_mismatched = sorted(set(ours) ^ set(flow_port)) + [
            k for k, v in flow_port.items() if k in ours and not torch.equal(
                ours[k].cpu(), torch.from_numpy(v))]
        # the runner's module (its structure and dtype, no second CPU
        # init), every tensor replaced by the source's (strict)
        direct = copy.deepcopy(runner.model)
        direct.load_state_dict({k: torch.from_numpy(v)
                                for k, v in flow_port.items()}, strict=True)
        images = rng.integers(0, 256, (PRETRAINED_PAIRS + 1,
                                       *PRETRAINED_PAIR_HW, 3),
                              dtype=np.uint8)
        pairs = np.stack([images[i:i + 2] for i in range(PRETRAINED_PAIRS)])
        reset_kernel_counts()
        flow = runner.flow_batch(pairs)
        clean = kernel_counts() == (dict.fromkeys(db.ROUTES, 0), 0)
        with torch.inference_mode():
            want = direct(normalise_pairs(torch.from_numpy(pairs).to(dev)))
        want = want.float().cpu().numpy()
        flow_rel = float(np.abs(flow - want).max() / np.abs(want).max())
        flow_ok = (not flow_mismatched and len(ours) == 42 and clean
                   and flow.shape == (PRETRAINED_PAIRS,
                                      *(s // 4 for s in PRETRAINED_PAIR_HW),
                                      2)
                   and bool(np.isfinite(flow).all())
                   and flow_rel <= PRETRAINED_FLOW_TOL)
        log("pretrained", part="flownets", tensors=len(ours),
            bitwise_mismatches=flow_mismatched[:4], pairs=PRETRAINED_PAIRS,
            flow_shape=list(flow.shape), rel_err_vs_direct_copy=flow_rel,
            tol=PRETRAINED_FLOW_TOL, no_kernel_launched=clean, ok=flow_ok)
        del runner, direct
    wall = time.perf_counter() - t_phase
    log("pretrained", part="phase", wall_s=wall)
    if not (classifier_ok and src_ok and flow_ok):
        raise SystemExit("the pretrained-weights phase failed its gates")
    return by_route, f32_launches


def dense_f32_entry(worst_abs, stacks, launches):
    """The kernels-line entry of the f32 dense-layer kernel over the 58
    layers of one DenseNet121-512 forward at F32_STACK_BATCH."""
    stack = stacks[F32_STACK_BATCH]
    return {
        "name": "dense_layer_f32_tc", "route": "cuda",
        "source": "tennis_torch/csrc/dense_layer_f32_tc.cu",
        "replaces": "tennis_tpu/ops/pallas/dense_block.py:92",
        "launches": launches, "max_abs_err": worst_abs,
        "ms": stack["ms"], "device_ms": stack["device_ms"],
        "plain_ms": stack["plain_ms"], "bound_ms": stack["bound_ms"],
        "bound_by": stack["bound_by"], "library_ms": stack["library_ms"],
        "work": f"the 58 dense layers of an f32 DenseNet121 at "
                f"{DATA_SHAPE}^2, batch {F32_STACK_BATCH} (the pixels-path "
                f"captioner's src_embed); bound_ms is three TF32 products a "
                f"multiply-add at 495 TFLOP/s; launches count the eval "
                f"forwards of [pretrained] and [pixcap_driver] (its val and "
                f"test decodes and "
                f"losses, and evaluate_gnmt); library_ms is cuDNN's two "
                f"convolutions a layer in f32, TF32 off",
    }


def build_phase():
    """nvcc of every kernel, all started together."""
    from tennis_torch.ops import _build

    errors = {}

    def go(name):
        try:
            _build.build(name)
        except Exception as e:  # reported below, the run fails
            errors[name] = e

    def host_libraries():
        # the native host libraries (c++; a missing compiler or libjpeg
        # leaves the numpy and cv2 fallbacks, as in the JAX package)
        from tennis_torch import native
        from tennis_torch.native import jpeg

        t = time.perf_counter()
        have = {"batch_ops": native.HAVE_NATIVE,
                "jpeg_decode": jpeg.HAVE_NATIVE_JPEG}
        host["seconds"], host["built"] = time.perf_counter() - t, have

    host = {}
    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(n,)) for n in KERNELS]
    threads.append(threading.Thread(target=host_libraries))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise SystemExit(f"kernel build failed: {errors}")
    log("build", native=host)
    for name in KERNELS:
        seconds, report = _build.build_info[name]
        log("build", kernel=name, seconds=seconds, wall_s=wall,
            ptxas=[l.strip() for l in report.splitlines()
                   if "registers" in l or "spill" in l or "smem" in l])


def dense_entry(name, variant, stack, launches, max_abs):
    """The kernels-line entry of one dense-layer variant over the layers of
    the 58-layer stack that the route sends to it; for a kernel that the
    route sends nothing, over blocks 2 and 3 (the small maps) run through
    it alone."""
    rows, layer_rows, routed_device = stack
    mine = [r for r in layer_rows if r["variant"] == variant]
    if mine:
        ms = sum(r["ms"] for r in mine)
        device_ms = routed_device[variant]
        work = (f"the {len(mine)} dense layers of DenseNet121 at "
                f"{DATA_SHAPE}^2, batch {BATCH}, that the route sends to it")
    else:
        small = [r for r in rows if r["block"] >= 2]
        mine = [r for r in layer_rows if r["block"] >= 2]
        ms = sum(r[f"{variant}_ms"] for r in small)
        device_ms = sum(r[f"{variant}_device_ms"] for r in small)
        work = (f"not routed on the main path; blocks 2-3 ({len(mine)} dense "
                f"layers) of DenseNet121 at {DATA_SHAPE}^2, batch {BATCH}, "
                f"run through it alone")
    b_ms, b_by = bound(sum(r["flops"] for r in mine),
                       sum(r["bytes"] for r in mine))
    return {
        "name": name, "route": "cuda", "source": f"tennis_torch/csrc/{name}.cu",
        "replaces": "tennis_tpu/ops/pallas/dense_block.py:92",
        "launches": launches[variant], "max_abs_err": max_abs[variant],
        "ms": ms, "device_ms": device_ms,
        "plain_ms": sum(r["plain_ms"] for r in mine),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": sum(r["library_ms"] for r in mine),
        "work": work + "; launches count the /predict batches served and the "
                       "[extract], [evaluate], [predict] and [train_driver] "
                       "runs, the evaluation forwards of [two_stream], "
                       "[cnnrnn_clips], [ddp] and [pretrained], and the "
                       "requests served from the "
                       "exported program in [export]",
    }


def gru_entry(name, variant, rows, launches, max_abs):
    """The kernels-line entry of one GRU variant: the barrier and async
    kernels at the 0102 serving shape (the async one at the cluster size
    its plan takes there), the general one at the 0102 encoder's shape at
    --num_hidden 300 and the grid one at 640 (the full-width decodes of
    [wide_decode])."""
    from tennis_torch.ops import gru

    case = {"general": "ragged_h300", "grid": "wide_h640"}.get(variant,
                                                              "serve_0102")
    _, T, B, H, lengths = next(c for c in GRU_CASES if c[0] == case)
    row = rows[case]
    key = f"async{gru.gru_plan(H, B).cluster}" if variant == "async" \
        else variant
    mine = row["variants"][key]
    floor = {"async": row["serial_floor_ms"],
             "barrier": row["barrier_serial_floor_ms"],
             "general": max(row["serial_floor_ms"],
                            row["general_stream_floor_ms"]),
             "grid": row["grid_serial_floor_ms"]}[variant]
    wide = variant in ("general", "grid")
    return {
        "name": name, "route": "cuda", "source": f"tennis_torch/csrc/{name}.cu",
        "replaces": "tennis_tpu/ops/pallas/gru.py:41",
        "launches": launches[variant], "max_abs_err": max_abs[variant],
        "ms": mine["ms"], "device_ms": mine["device_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "layer_ms": row["layer_ms"],
        "layer_device_ms": row.get("layer_device_ms"),
        "library_device_ms": row.get("library_device_ms"),
        "us_per_step": mine["us_per_step"], "serial_floor_ms": floor,
        "work": f"one GRU recurrence of the 0102 encoder: T {T}, batch {B}, "
                f"H {H}, lengths {lengths} ({key}); launches count the "
                + (f"decodes at --num_hidden {H} of [wide_decode]" if wide else
                   "/caption batches served, the per-epoch and "
                   "evaluate_gnmt decodes of [caption_driver], the "
                   "--pallas_gru exported program's batches in "
                   "[export_caption] and the decodes of [ddp] at 256 and of "
                   "[tp] (Wh gathered over the model group)")
                + f"; library_ms (cuDNN nn.GRU) and layer_ms (the port) "
                f"cover the whole layer from {FEAT_DIM} features at full "
                f"length",
    }


# wall seconds of each phase of this run, by its function's name
PHASE_SECONDS: dict = {}
T_START = time.perf_counter()


def timed(phase, *args):
    """``phase(*args)``, its wall seconds kept in PHASE_SECONDS."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_SECONDS[phase.__name__] = time.perf_counter() - t0


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tennis_torch")):
        print("chip_smoke: tennis_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # the plain versions are the yardstick: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log("card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda)

    timed(build_phase)
    max_abs = timed(kernel_phase)
    f32_abs, f32_stacks = timed(kernel_f32_phase, torch.device("cuda"))
    agree = timed(route_phase)
    stack = timed(stack_phase)
    timed(stack64_phase)
    launches = timed(main_path_phase, torch.device("cuda"))
    model, frames = timed(extraction_inputs, torch.device("cuda"))
    for phase in (extract_phase, evaluate_phase):
        counts = timed(phase, torch.device("cuda"), model, frames)
        launches = {v: launches[v] + counts[v] for v in launches}
    del model
    gru_abs, gru_rows = timed(gru_phase, torch.device("cuda"))
    gru_launches = timed(caption_phase, torch.device("cuda"))
    counts = timed(wide_decode_phase, torch.device("cuda"))
    gru_launches = {v: gru_launches[v] + counts[v] for v in gru_launches}
    vocab, splits, tree = timed(caption_train_inputs)
    timed(caption_train_phase, torch.device("cuda"), vocab, splits, tree)
    counts = timed(caption_driver_phase, torch.device("cuda"), vocab, splits,
                   tree)
    gru_launches = {v: gru_launches[v] + counts[v] for v in gru_launches}
    del vocab, splits, tree
    timed(densenet161_phase, torch.device("cuda"))
    # last: the train step's profile holds ~10,000 launches a step, and a
    # later profiler session once recorded no kernel six times in a row
    timed(train_phase, torch.device("cuda"), frames)
    counts = timed(train_driver_phase, torch.device("cuda"), frames)
    launches = {v: launches[v] + counts[v] for v in launches}
    timed(cnnrnn_train_phase, torch.device("cuda"))
    timed(cnnrnn_driver_phase, torch.device("cuda"))
    for counts in (timed(two_stream_phase, torch.device("cuda")),
                   timed(cnnrnn_clips_phase, torch.device("cuda"), frames)):
        launches = {v: launches[v] + counts[v] for v in launches}
    timed(resnet_train_phase, torch.device("cuda"), frames)
    timed(resnet_driver_phase, torch.device("cuda"), frames)
    del frames
    timed(r21d_train_phase, torch.device("cuda"))
    timed(r21d_driver_phase, torch.device("cuda"))
    with tempfile.TemporaryDirectory() as root:
        timed(skipgram_phase, root)
        timed(pixcap_train_phase, torch.device("cuda"), caption_vocab())
        f32_counts = timed(pixcap_driver_phase, torch.device("cuda"),
                           caption_vocab(), root)
    counts, ddp_gru = timed(ddp_phase, torch.device("cuda"))
    launches = {v: launches[v] + counts[v] for v in launches}
    gru_launches = {v: gru_launches[v] + ddp_gru[v] for v in gru_launches}
    counts, f32_pretrained = timed(pretrained_phase, torch.device("cuda"))
    launches = {v: launches[v] + counts[v] for v in launches}
    # last: their profiles gate nothing, so a profiler session that records
    # nothing after them (as once after [train_driver]) fails no phase
    counts = timed(predict_phase, torch.device("cuda"))
    launches = {v: launches[v] + counts[v] for v in launches}
    timed(flownet_phase, torch.device("cuda"))
    # the exported programs, through the same kernels as the live paths
    counts = timed(export_phase, torch.device("cuda"))
    launches = {v: launches[v] + counts[v] for v in launches}
    counts = timed(export_caption_phase, torch.device("cuda"))
    gru_launches = {v: gru_launches[v] + counts[v] for v in gru_launches}
    timed(native_phase)
    log("phase_seconds", **PHASE_SECONDS,
        total=time.perf_counter() - T_START)
    log("trace_fallbacks", count=len(TRACE_FALLBACKS), traces=TRACE_FALLBACKS)
    log("route_summary", routed_is_fastest_by_batch={
        b: {"fastest": a, "shapes": n} for b, (a, n) in agree.items()})

    print(json.dumps({"kernels": [
        dense_entry("dense_layer", "tile", stack, launches, max_abs),
        dense_entry("dense_layer_persistent", "persistent", stack, launches,
                    max_abs),
        dense_entry("dense_layer_cluster", "cluster", stack, launches,
                    max_abs),
        dense_f32_entry(f32_abs, f32_stacks,
                        f32_counts["f32"] + f32_pretrained),
        gru_entry("gru_recurrence", "barrier", gru_rows, gru_launches, gru_abs),
        gru_entry("gru_recurrence_async", "async", gru_rows, gru_launches,
                  gru_abs),
        gru_entry("gru_recurrence_general", "general", gru_rows,
                  gru_launches, gru_abs),
        gru_entry("gru_recurrence_grid", "grid", gru_rows, gru_launches,
                  gru_abs)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
