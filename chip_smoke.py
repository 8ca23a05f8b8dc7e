#!/usr/bin/env python3
"""Drive the PyTorch port (flexflow_tpu_torch) on one NVIDIA GPU (and,
in the multigpu phase, on every card there is).

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases train    # the training path alone

Phases, each a failure of which exits non-zero:

1. kernels: build every kernel from the sources in this checkout (one
   nvcc per source, started together; sm_90a) and hold each against its
   plain PyTorch version on the card: paged attention (K4) at table
   widths 8 and 64, chunks 1 and 8, and four decode shapes (8 rows at
   mixed positions up to 1023, all 8 at 1023, one at 1023 with 7 idle,
   8 at the serve phase's lengths),
   and the flash-attention forward, dq and dkv kernels (K1-K3) in
   float32 and bfloat16, d 64 and 128, causal and not, at seq 2048, a
   ragged seq 200 and sq != sk.  Time kernel, plain version, a PyTorch
   library yardstick and the card's bound at the main paths' shapes: the
   8-slot decode step for K4 (its device time from torch.profiler, with
   CUDA events beside it, its split grid and a sweep of the split
   length), [96, 2048, 64] (BERT-base at batch 8, seq 2048) for K1-K3 in
   float32 and bfloat16.  Every kernel must give the same bits over two
   launches.  Bounds are those of the tensor cores for K1-K3 and of the
   bytes for K4; K2+K3 is also given over the library's backward.  Every
   K1-K3 instance must hold HMMA instructions (cuobjdump's SASS of the
   built library, whose instruction counts are reported) and use no
   local memory (no spills); its registers, shared memory and blocks per
   SM are reported.
2. serve: full-width GPT-2-small (hidden 768, 12 layers, 12 heads, FFN
   3072, vocab 50257, 1024 positions, float32, weights from
   np.random.RandomState(0)) behind ContinuousScheduler and serve_http;
   16 concurrent greedy requests over HTTP.  The kernels' launch
   counters are set to 0 just before and read just after; every
   kernel of the path must have launched, the paged-attention kernel
   once per layer per forward.
3. parity: two of those requests through the port on device="cpu"
   with the same weights; per-step logits and greedy tokens against the
   card's.
4. profile: torch.profiler over 20 full-width decode steps; device time
   by kernel and the device's idle share.
5. train: full-width BERT-base (hidden 768, 12 layers, 12 heads, FFN
   3072, 2 classes) at batch 8, seq 2048, float32, inputs and labels
   from np.random.RandomState(0): compile with the default SGD, one
   warm-up train_step, fit over 4 batches, one eval_step.  The flash
   kernels' launch counters are set to 0 just before fit and read just
   after: K1, K2 and K3 must each have launched 12 times per step.
6. train_parity: the same BERT cut to 2 layers at batch 2, seq 2048 (the
   flash branch on both devices), two SGD steps on the card against the
   port on device="cpu" with the same weights and batches: losses and
   every weight after the steps.
7. train_profile: torch.profiler over 3 full-width train steps; device
   busy and idle time per step and K1, K2, K3 and K2+K3's shares.
8. bn_kernels: P1, the BatchNorm apply (csrc/bn_apply.cu), against its
   plain version at the four ResNet-50 stage-output shapes of
   scripts/resnet_bn_probe.py ([M, C] = (802816, 256), (200704, 512),
   (50176, 1024), (12544, 2048)) in bfloat16 and float32, with the
   residual and the ReLU, the ReLU only, and neither; plus ragged and
   misaligned cases on the scalar path.  Each case's error and
   tolerance, kernel time, plain time, bytes bound, and for the variant
   with neither the library yardstick F.batch_norm in eval mode.
9. resnet: the torch.fx-imported ResNet-50 of
   examples/python/pytorch/resnet50_search.py (224 px, 1000 classes,
   batch 256, bfloat16 compute, weights from torch.manual_seed(0)
   through copy_weights) compiled with SGD(lr=0.1), one warm-up
   train_step, fit over 4 batches (from the prefetching loader: pinned
   staging, a copy stream), one eval_step.  P1's launch counter
   is set to 0 just before fit and read just after: 53 launches per
   step, 16 of them with the residual by the executor's plan.
10. resnet_parity: a small ResNet (stem 3->8, a downsampling and an
   identity Bottleneck, 32 px, batch 4, 10 classes) in float32, TF32
   off, on the card against the port on device="cpu" from the same
   module: logits, losses, weights and running statistics after 2 SGD
   steps.
11. resnet_profile: torch.profiler over a fit of 3 full-width ResNet-50
   batches through the loader: device busy (the union over both
   streams) and idle, time by stream, cuDNN convolution time, P1 time
   and launches
   by variant, BatchNorm statistics reductions, and every layout copy
   or transpose, with those next to a P1 launch counted.
12. vit: ViT-B/16 (hidden 768, 12 layers, 12 heads, MLP 3072, patch 16,
   224 px, 1000 classes, dropout 0.1, the global-average-pool head) in
   HF's eager attention idiom, imported through torch.fx (module init
   from torch.manual_seed(0) through copy_weights; inputs and labels
   from np.random.RandomState(0)), batch 128, bfloat16 compute, the
   default SGD: one warm-up train_step, fit over 4 batches, one
   eval_step.  The graph's op counts must be VIT_OPS; the first
   Dropout's zero share in training within 5 sigma of 0.1, the identity
   in eval; no hand-written kernel launches on this path (every counter
   is set to 0 before fit and read after, and must stay 0).
13. vit_parity: the small ViT (32 px, patch 8, hidden 64, 2 layers, 4
   heads, 10 classes), float32, TF32 off, dropout 0, batch 4, on the
   card against the port on device="cpu" from the same module: logits,
   losses and every weight after 2 SGD steps.
14. vit_profile: torch.profiler over a fit of 3 full-width ViT
   batches through the loader: device busy and idle, and device time
   by PCG op type (each op's forward in a record_function range, its
   backward matched through the autograd sequence numbers, the loader's
   copies apart) and kernel kind (GEMMs, the patch convolution,
   softmax, Dropout's RNG, copies, casts, reductions, elementwise).
15. zoo: Unity's evaluation models through the calls of
   examples/python/native/*.py (FFConfig.from_args -b, the models
   builder, compile with the example's SGD, loss and metrics), float32,
   inputs and labels from np.random.RandomState(0): Inception-v3 (299
   px, 10 classes), ResNeXt-50 32x4d (224 px, 1000 classes), DLRM and
   XDL (4 tables of 100000 x 64), CANDLE-Uno (width 4192, feature depth
   8, ~0.5 B parameters), the Transformer (12 layers, hidden 1024, 16
   heads, seq 512, batch 8, MSE), the MoE MLP (784 -> 5 experts, k 2,
   hidden 64), build_moe_encoder's defaults, the MLP example, AlexNet
   and the native ResNet-50 at 64 px; batch 64 unless the example sets
   its own.  Each: one warm-up train_step, then fit(shuffle=True) over
   3 batches through the prefetching loader; samples/s, peak memory,
   finite losses, for MoE the dropped-pair share and the expert load;
   every hand-written kernel's counter is set to 0 before fit and must
   stay 0.
16. zoo_parity: every zoo builder at its tiny test size, float32, TF32
   off, on the card against the port on device="cpu" with the same
   weights: the forward, losses and every weight after 2 SGD steps.
17. zoo_profile: torch.profiler over a fit of 3 batches of Inception-v3
   and of ResNeXt-50 (its grouped 3x3 convolutions apart): device time
   by PCG op type and kernel kind, the layout copies and the layout
   pass's plan.

18. nmt: build_nmt at Luong, Pham & Manning's widths (EMNLP 2015, §4.1:
   4 LSTM layers a side, 1000 cells, 1000-dim embeddings, 50 000-word
   vocabularies, 50 tokens; batch 128, its dot-product attention),
   float32, a copy task from np.random.RandomState(0): compile with
   SGD(lr=0.1) and the sparse cross-entropy, one warm-up train_step
   whose gradients must match the same step's on the CPU (within
   NMT_GRAD_TOL of each weight's largest gradient), fit over 3 batches
   through the loader (every weight must move; no hand-written kernel
   may launch), a profile of 3 loader-fed steps by op and kernel kind,
   then greedy_decode of 8 sources.
19. generate: the serve phase's GPT-2-small and weights, batch 8,
   64-token prompts, 32 new tokens: gpt_generate (the re-forward loop
   at seq 1024), the dense decode twin's gpt_generate_cached and
   gpt_generate_scan (greedy tokens equal to gpt_generate's),
   gpt_beam_search against gpt_beam_search_cached
   (beam 4: the same tokens, scores within 1e-4); tokens/s of each, the
   caches' bytes, and a profile of the dense decode step beside the
   profile phase's paged one.
20. keras: each model of examples/python/keras/*.py at its example's
   configuration and the Embedding -> LSTM -> Dense classifier at the
   Reuters loader's shapes (Keras's imdb_lstm.py widths, batch 32),
   rebuilt through flexflow_tpu_torch.keras: a warm-up train_step and
   fit over 4 batches (CIFAR-10 on the vendored sample shard); samples/s,
   losses and each dataset's synthetic flag.
21. onnx: the resnet phase's ResNet-50 (224 px, 1000 classes) as ONNX
   wire bytes (onnx_frontend.module_to_onnx: torch's export node
   sequence through the port's protowire), imported by ONNXModel and
   copy_weights at batch 64, float32: the eval forward against the
   torch module (1e-4 of the scale), a warm-up train_step and fit over
   3 batches; P1 53 launches per forward, as the fx import's plan.
22. seq_parity: the tiny NMT, GPT generation forms and Keras LSTM, card
   against CPU, float32, TF32 off, within SEQ_PARITY_TOL.
23. capture: the train, resnet and vit phases' models (BERT-base at
   batch 8, seq 2048, float32; ResNet-50 at batch 256, 224 px,
   bfloat16; ViT-B/16 at batch 128, bfloat16, dropout 0) each with its
   step eager (build_step(capture=False)) and captured as one CUDA
   graph (capture.py; the default on the card) from the same weights
   and batches: losses and every weight after CAPTURE_STEPS steps
   (PARITY_TOL), then a profile of CAPTURE_PROFILE_STEPS more on each
   side: step ms, device busy and idle share, device events, and each
   kernel's launches per step from the profiler, which sees the kernels
   a replay launches (K1-K3 12 each, P1 53), against what the capture
   counted; peak memory; capture_status.  Then the small ViT at dropout
   0.1, captured: its replays must draw fresh masks, and
   set_learning_rate(0) after the capture must stop its weights.
24. fusion: FFConfig.perform_fusion (--fusion) on the BERT-base
   flagship (its builder folds GELU into ffn1 already: no op to fold)
   and on the vit phase's ViT-B/16 (batch 128, bfloat16, dropout 0;
   its GELUs fold into fc1), each against its unfused compile from the
   same weights: op counts, FUSION_STEPS steps' losses on one batch
   (PARITY_TOL) and the step ms of FUSION_TIMED replays more.
25. search: the train phase's BERT-base (batch 8, seq 2048, float32)
   with FFConfig(search_budget=20, search_calibrate=True) over the
   committed one-node HGX H100 machine file (sim/machines/hgx_h100_8.json):
   unity_search(ff, 8) costs its candidates with op forwards timed on
   the card into a fresh temporary cost cache (attention at seq 2048
   through K1; K1's launches must be > 0; a sequence-sharded attention,
   which cannot run alone, takes the measured/analytic ratio of one
   device's block: its query block against every key), and must return an 8-device strategy, which is written and
   must load back equal.  The simulator's step time of that strategy
   and of data-parallel 8 with the measured costs; then compile with
   search_budget > 0 on the one card (a one-device strategy), and with a
   one-card strategy whose edge chain (repartition and combine, degree
   2) compile must cancel, against the unsearched compile: losses of 2
   SGD steps within PARITY_TOL; then calibrate_overlap on the one-card
   model at batches 2 and 4, whose fitted compute scale must predict
   the measured step at batch 8 within CAL_HELD_OUT_TOL.  K1-K3
   launches of the search, the steps and the calibration go into the
   kernels line.  The searched strategy and the measured op costs are
   left for the multigpu phase.
26. multigpu: nineteen legs, each over a group of spawned ranks (rank r on
   card r % cards; the backend NCCL where every rank has a card of its
   own, else gloo, named, with every collective staged through host
   memory), each taking 2 train steps (the first by train_step, the
   second by fit, each rank loading its shard of the batch) and held
   against the same model
   trained on one card in this process from the same weights and
   batches (losses as error over max(1, |loss|), every weight gathered
   after the steps; MULTIGPU_TOL): BERT-base of the train phase (batch
   8, seq 2048, float32, weights from seed 0) under bert_tp_strategy(4,
   tp=2) (K1-K3 on each rank's local heads, 12 per step each), under
   bert_sp_strategy(4, sp=2) (ring attention: K1-K3 on every 1024-key
   block, 24 per step each), data-parallel over 4 with ZeRO stage 3 and
   Adam (also against stage 0 in the same group; optimizer-state bytes
   per rank), the same with ZeRO stage 2 (dp_zero2: each grad
   reduce-scattered as the backward makes it; against stage 0 too; on
   every rank the device bytes allocated once the backward has ended,
   read in eager steps of each stage (`grad_memory`): stage 2 holds at
   most ZERO2_MEMORY_TOL beyond its shards, and stage 0 at least the
   whole grads less the shards, less ZERO2_MEMORY_TOL, more), and under
   the search phase's 8-GPU strategy loaded from its file over 8 ranks
   (without the search phase, the same search runs here first); and
   resnet_parity's small ResNet data-parallel over 4 (P1 on every
   BatchNorm with the global batch's statistics; running statistics
   held too).  Pipelines over 4 ranks: BERT-base
   under GPipe at data 2 x pipe 2 with 4 microbatches (pp_dp), the same
   with remat (pp_dp_remat), pipe 4 (pp4), and the pipeline the Unity
   search prices cheapest for 4 GPUs of hgx_h100_8.json
   (pp_searched), each with its stacked weights unstacked through
   `_adapt_weight_layout` for the check; and the demo encoder of
   parallel/pipeline.py at BERT-base widths, pipe 4, 8 microbatches,
   under 1F1B and then GPipe from the same weights (pp_1f1b), each
   against the demo trained on this card as one stage and against each
   other, with each schedule's peak memory.  K1-K3 per rank per step
   must be `pipeline_launches`'s; each pipeline leg's record carries
   the search's price of its strategy, and the phase's record K1-K3 at
   the legs' one-row microbatch shape.  Expert parallelism over 4 ranks:
   the MoE encoder of upstream moe.cc (MOE: BERT-base widths, 12
   layers, batch 8, seq 2048, 8 experts, top-2, capacity factor 2,
   balance weight 0.04) under data 4 (moe_dp4), ShardConfig(expert=4)
   on every group_by and experts_dense (ep4), data 2 x expert 2, whose
   expert dim lands on the data axis (dp2_ep2), and the Unity search's
   strategy for 4 GPUs of hgx_h100_8.json (moe_searched); each holds
   its routing against the one-card run's (every token whose experts
   differ, with its gate gap: MOE_FLIP_GAP), its balance losses
   (MOE_BALANCE_TOL) and its expert-weight bytes per rank (1/E of one
   card's), and reports its dropped-pair share and the MoE ops'
   collective bytes per step; K1-K3 launch 12 each per rank per step.
   Factored views and the slice hierarchy over 4 ranks, BERT-base as in
   the train phase: attention at channel 4 (heads on model1 + model0)
   and the first FFN at channel 2 (on model1) over {model0: 2, model1:
   2} (factored_tp4); FFConfig(slices=2) with data 4, run as {slice: 2,
   data: 2} with the hierarchical grad reduction and then flat on the
   same mesh from the same weights (slices2_dp4: the two within
   HIER_FLAT_TOL), with ZeRO-1 and Adam over the intra-slice remainder
   (slices2_zero1), and the Unity search's strategy for 4 GPUs as 2
   nodes x 2 of SLICES_MACHINE, placement included (slices2_searched);
   each reports its execution mesh, hier_axis and wus_axis and every
   rank's collective bytes per step by op and kind, and with NCCL the
   task-graph simulator's price on the switched and on the routed
   machine beside the analytic one.  The four cards of one box stand for
   the slices: the legs show the hierarchy's correctness and its cost on
   NVLink, not InfiniBand.  K1-K3 launch 12 each per rank per step.
   `--legs` runs some of the legs (and only the searches they need).
   The kernels are built once, before
   the ranks start; each rank sets its launch counters to 0 and reports
   them per step, with its step wall time and peak memory.  With NCCL
   the simulator's step for the leg's strategy (the search's measured
   op costs, hgx_h100_8.json at the leg's size) stands beside the
   measured one, and rank 0 profiles a third step (device busy and idle
   share, device ms by kind: collectives, K1-K3, GEMMs, copies).
   Under NCCL a leg's step is captured unless a blocker keeps it eager
   (each leg's record gives its capture_status), and each leg of
   CAPTURE_LEGS runs again in its group eager and captured from the
   same weights and batches: losses and weights after CAPTURE_STEPS
   steps (MULTIGPU_TOL), a profile of CAPTURE_PROFILE_STEPS more on
   each rank (K1-K3 per replayed step from the profiler), and under
   ZeRO-3 how much of the prefetch's all-gathers ran beside compute.

Every train step on the card is captured by default after one eager
warm-up step (capture.py): the kernels' wrappers count the warm-up and
the capturing step, not a replay, so each phase holds its counters to
the steps the wrappers saw (`counted_steps`), and the capture phase
counts a replayed step's launches with the profiler.

`--phases` runs a subset (e.g. `--phases kernels` after editing a
kernel, `--phases capture` for the captured steps, `--phases fusion`
for the fusion pass, `--phases multigpu --legs
dp_tp,dp_zero3,slices2_dp4,dp_zero2` for the captured multi-GPU legs,
`--phases bn_kernels,resnet,resnet_parity,resnet_profile` for
the ResNet path, `--phases vit,vit_parity,vit_profile` for the ViT
path, `--phases zoo,zoo_parity,zoo_profile` for the model zoo,
`--phases nmt,generate,keras,onnx,seq_parity` for the sequence-model
and frontend slice, `--phases search` for the search and simulator,
`--phases multigpu` for multi-GPU execution, `--phases multigpu
--legs moe_dp4,ep4,dp2_ep2,moe_searched` for expert parallelism,
`--phases multigpu --legs
factored_tp4,slices2_dp4,slices2_zero1,slices2_searched` for factored
views and the slice hierarchy).
Every line but the last two is one JSON object; the
one before the last is the card's name and power limit as nvidia-smi
prints them, and the last is {"ok": true, "device": {...}}.  Exits 2,
printing no result, when torch.cuda.is_available() is false.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

# GPT-2-small, build_gpt's own defaults
WIDTH = dict(hidden_size=768, num_layers=12, num_heads=12,
             intermediate_size=3072, vocab_size=50257, seq_length=1024)
SLOTS, PAGE, CHUNK = 8, 16, 8
N_REQUESTS, MAX_NEW = 16, 32
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12       # tensor cores, dense
H100_BF16_FLOPS = 989e12       # tensor cores, dense
# the route each flash kernel's products take: mma.sync on the tensor
# cores (float32 as three TF32 passes, bfloat16 in one)
FLASH_ROUTE = {"K1": "tensor_cores", "K2": "tensor_cores",
               "K3": "tensor_cores"}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_REASON = {
    "float32": "kernel and plain version both accumulate in float32; "
               "they differ only in summation order and exp, ~1e-6",
    "bfloat16": "held against the plain version run in float32 on the "
                "same bfloat16 values (the kernel accumulates in "
                "float32); 2e-2 covers the bfloat16 rounding of the "
                "output, 2^-9 of |out| <= ~4",
}
# BERT-base, build_bert's own defaults, at entry()'s batch and the
# reference's flash crossover
BERT = dict(hidden_size=768, num_layers=12, num_heads=12,
            intermediate_size=3072, num_classes=2)
TRAIN_BATCH, TRAIN_SEQ, FIT_BATCHES = 8, 2048, 4
FLASH_SHAPE = (TRAIN_BATCH * BERT["num_heads"], TRAIN_SEQ,
               BERT["hidden_size"] // BERT["num_heads"])
FLASH_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
FLASH_TOL_REASON = {
    "float32": "error over the output's scale max(1, max|plain|): kernel "
               "and plain version accumulate in float32 in other orders "
               "over up to 2048 keys; K1, K2 and K3 form each product in "
               "three TF32 passes on the tensor cores (lo*lo, 2^-22 of "
               "it, dropped) and sum there",
    "bfloat16": "error over the output's scale, against the plain "
                "version run in float32 on the same bfloat16 values: the "
                "kernels round P and dS to bfloat16 before their products "
                "(as the TPU kernels do) and their outputs to bfloat16, "
                "2^-9 each",
}
# parity of the card's train steps with the port's CPU steps, TF32 off:
# float32 on both, sums in other orders (cuBLAS and the flash kernels
# against MKL and the plain versions)
PARITY_TOL = {"loss": 1e-4, "weights": 2e-5}


# P1 (csrc/bn_apply.cu) at the ResNet-50 stage outputs, b256 at 224 px
BN_SHAPES = ((802816, 256), (200704, 512), (50176, 1024), (12544, 2048))
BN_VARIANTS = {"res_relu": (True, True), "relu": (False, True),
               "none": (False, False)}
BN_TOL = {"float32": 1e-6, "bfloat16": 8e-3}
BN_TOL_REASON = (
    "error over the output's scale max(1, max|plain|): kernel and plain "
    "version do the same float32 multiply and adds in the same order "
    "without contraction and round once, so they should agree exactly; "
    "the tolerance allows one float32 ulp, or one bfloat16 ulp (at most 2^-7 of "
    "the scale), should the two round differently")
RESNET_BATCH, RESNET_PX, RESNET_CLASSES, RESNET_FIT = 256, 224, 1000, 4
# ResNet-50's BatchNorms and the P1 launches of one forward, by the
# executor's plan: 16 bn3 with the block's residual and ReLU, 33 with the
# ReLU only (stem, bn1, bn2), 4 downsample with neither
RESNET_BN = {"res_relu": 16, "relu": 33, "none": 4}
# card against CPU, float32, TF32 off: cuDNN's and oneDNN's convolutions
# sum in other orders, ~1e-6 relative, through 2 SGD steps at lr 0.1
RESNET_PARITY_TOL = {"output": 1e-4, "loss": 1e-4, "weights": 1e-4,
                     "running_stats": 1e-4}
VIT_BATCH, VIT_PX, VIT_CLASSES, VIT_FIT, VIT_DROPOUT = 128, 224, 1000, 4, 0.1
# the ops of the fx-imported ViT-B/16 graph (before compile), by type, as
# the reference's importer builds them: per block 4 Reshape (q, k, v
# split, context merge), 5 Transpose (q, k, v permute, k^T, context
# permute), 2 BatchMatmul, 3 Dropout, 6 Linear, 2 LayerNorm, 2 adds, GELU
# and the 1/sqrt(d) scale; around the blocks the patch Conv2D, its
# flatten(2) and transpose, the position table (a WeightOp) and its add,
# a Dropout, the final LayerNorm, the pooling Mean and the head
VIT_OPS = {"reshape": 49, "transpose": 61, "batch_matmul": 24,
           "dropout": 37, "linear": 73, "layer_norm": 25, "conv2d": 1,
           "weight": 1, "mean": 1, "softmax": 12, "element_binary": 25,
           "element_unary": 24}
# card against CPU, float32, TF32 off, dropout 0: cuBLAS's and MKL's
# GEMMs and the two convolutions sum in other orders (~1e-6 relative)
# through 2 steps of the default SGD (lr 0.01, weight decay 1e-4)
VIT_PARITY_TOL = {"logits": 1e-4, "loss": 1e-4, "weights": 1e-4}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of fn over `iters` runs (CUDA events), each
    after a write of `flush` that evicts the 50 MB L2 and keeps the
    device busy while the host enqueues the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def paged_case(torch, rng, *, b, s, h, d, page, width, dtype, dev):
    """Pools and tables with partial tail pages, one scratch row (slot
    0: seq_len 0, table all zeros) and CoW-shared blocks (rows 2 and 3
    map row 1's first blocks)."""
    nb = 1 + b * width
    pools = [torch.tensor(rng.randn(nb, page, h, d), dtype=torch.float32)
             for _ in range(2)]
    qh = torch.tensor(rng.randn(b, s, h, d), dtype=torch.float32)
    btab = rng.permutation(np.arange(1, nb))[:b * width].reshape(
        b, width).astype(np.int32)
    btab[0] = 0
    btab[2, :2] = btab[1, :2]
    btab[3, 0] = btab[1, 0]
    top = width * page - s
    slen = np.array([0] + [1 + rng.randint(top - 1) for _ in range(b - 1)],
                    np.int32)
    slen[1] = max(slen[1], 2 * page + 3)   # row 1 spans its shared blocks
    slen[2] = max(slen[2], 2 * page + 1)
    to = dict(device=dev)
    return (qh.to(dtype=dtype, **to), pools[0].to(dtype=dtype, **to),
            pools[1].to(dtype=dtype, **to),
            torch.tensor(btab, **to), torch.tensor(slen, **to))


# profiles whose records missed launches of the kernel they time, each
# retried (a CUPTI record lost on the card, not a launch the kernel
# skipped: the launches themselves are counted by the wrappers)
PROFILER_DROPS: list = []
PROFILE_ATTEMPTS = 3


def profiled_ms(torch, fn, flush, tag: str, iters: int = 30,
                warmup: int = 5, attempts: int = PROFILE_ATTEMPTS) -> float:
    """Median device time of the kernel whose name holds `tag`, as
    torch.profiler reports it over `iters` calls of fn, each after a
    write of `flush` that evicts the 50 MB L2: the kernel's own duration,
    whatever the host's enqueue takes.  A profile that holds other than
    `iters` records of the kernel is logged in PROFILER_DROPS and taken
    again, up to `attempts` profiles in all; then it raises."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if "cuda" in str(e.device_type).lower() and tag in e.name]
        if len(us) == iters:
            return float(np.median(us)) / 1e3
        PROFILER_DROPS.append({"tag": tag, "attempt": attempt + 1,
                               "records": len(us), "launches": iters})
    raise RuntimeError(f"profiler saw {len(us)} launches of {tag}, "
                       f"expected {iters}, in each of {attempts} profiles")


def paged_bound(pos, page: int, width: int, h: int, d: int, itemsize: int,
                chunk: int = 1) -> dict:
    """K4's least time at one decode shape: the live KV rows (each read
    once), q, the output, the tables and seq_lens over HBM, against two
    flops per KV element at the float32 SIMT peak."""
    pos = np.asarray(pos, np.int64)
    live_tokens = int((np.minimum(pos + chunk - 1, width * page - 1)
                       + 1).sum())
    b = len(pos)
    kv_bytes = 2 * live_tokens * h * d * itemsize
    io_bytes = (kv_bytes + 2 * b * chunk * h * d * itemsize + b * width * 4
                + b * 4)
    flops = 4 * live_tokens * h * d * chunk
    t_bytes, t_ops = io_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return {"live_tokens": live_tokens, "kv_bytes": kv_bytes,
            "bytes": io_bytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def paged_cases(torch, pk, rng, dev, width: int, cases: list,
                worst: dict) -> None:
    """K4 against its plain version run in float32 on the same values at
    one table width: both dtypes, chunks 1 and 8, d 64 and 128."""
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for s in (1, 8):
            for d in (64, 128):
                qh, kp, vp, bt, sl = paged_case(
                    torch, rng, b=6, s=s, h=12, d=d, page=PAGE, width=width,
                    dtype=dtype, dev=dev)
                scale = 1.0 / np.sqrt(d)
                got = pk.paged_attention(qh, kp, vp, bt, sl, scale)
                ref = pk.paged_attention_plain(
                    qh.float(), kp.float(), vp.float(), bt, sl, scale)
                same = pk.paged_attention_plain(qh, kp, vp, bt, sl, scale)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise RuntimeError(f"kernel output not finite: {dname} "
                                       f"s={s} d={d} width={width}")
                err = float((got.float() - ref).abs().max())
                err_same = float((got.float() - same.float()).abs().max())
                cases.append({
                    "dtype": dname, "s": s, "d": d, "page": PAGE,
                    "width": width, "positions": sl.tolist(),
                    "live_splits": pk.live_splits(
                        sl.cpu().numpy(), s, PAGE, width).tolist(),
                    "max_abs_err": err,
                    "max_abs_err_vs_same_dtype_plain": err_same,
                    "tol": TOL[dname]})
                worst[dname] = max(worst.get(dname, 0.0), err)
                if err > TOL[dname]:
                    raise RuntimeError(
                        f"paged_attention kernel disagrees with its plain "
                        f"version: {dname} s={s} d={d} width={width}: max "
                        f"abs err {err} > {TOL[dname]}")


def phase_kernels(torch, pk, card: str, dev, lib_path, build_s) -> dict:
    pk.load_library()
    rng = np.random.RandomState(0)
    cases, worst = [], {}
    paged_cases(torch, pk, rng, dev, 8, cases, worst)
    # the main path's decode shape: 8 slots, 12 heads, d 64, f32,
    # page 16, rows at mixed positions up to 1024 (the draws of earlier
    # runs, so the shape stays theirs); beside it all 8 rows at 1023, one
    # live row at 1023 with the other 7 idle (seq_len 0 on the scratch
    # block), and 8 rows at the serve phase's lengths (16-256 prompt
    # tokens, up to 32 generated)
    width = 1024 // PAGE
    nb = 1 + SLOTS * width
    h, d = 12, 64
    btab_np = rng.permutation(np.arange(1, nb)).reshape(
        SLOTS, width).astype(np.int32)
    pos = rng.randint(1, 1024, SLOTS).astype(np.int32)
    pos[0] = 1023
    paged_cases(torch, pk, rng, dev, width, cases, worst)
    kp = torch.randn(nb, PAGE, h, d, device=dev)
    vp = torch.randn(nb, PAGE, h, d, device=dev)
    qh = torch.randn(SLOTS, 1, h, d, device=dev)
    btab = torch.tensor(btab_np, device=dev)
    one_tab = btab_np.copy()
    one_tab[1:] = 0
    shapes = {
        "mixed": (pos, btab),
        "all_1023": (np.full(SLOTS, 1023, np.int32), btab),
        "one_live_1023": (np.array([1023] + [0] * (SLOTS - 1), np.int32),
                          torch.tensor(one_tab, device=dev)),
        "serve_lengths": (np.random.RandomState(3).randint(
            16, 256 + MAX_NEW + 1, SLOTS).astype(np.int32), btab),
    }
    scale = 1.0 / np.sqrt(d)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tag = "paged_attention_kernel"
    grid = pk.split_grid(SLOTS, h, width)
    decode = {}
    for name, (p, bt) in shapes.items():
        sl = torch.tensor(p, device=dev)
        got = pk.paged_attention(qh, kp, vp, bt, sl, scale)
        ref = pk.paged_attention_plain(qh, kp, vp, bt, sl, scale)
        err = float((got - ref).abs().max())
        if err > TOL["float32"]:
            raise RuntimeError(f"decode shape {name}: kernel vs plain {err}")
        bound = paged_bound(p, PAGE, width, h, d, 4)
        ms = profiled_ms(torch, lambda: pk.paged_attention(
            qh, kp, vp, bt, sl, scale), flush, tag)
        decode[name] = dict(
            bound, positions=p.tolist(), max_abs_err=err, kernel_ms=ms,
            event_ms=time_ms(torch, lambda: pk.paged_attention(
                qh, kp, vp, bt, sl, scale), flush),
            share_of_bound=bound["bound_ms"] / ms,
            live_blocks=int(pk.live_splits(p, 1, PAGE, width).sum()) * h)
        worst["float32"] = max(worst["float32"], err)
    slen = torch.tensor(pos, device=dev)
    main = decode["mixed"]
    runs = [pk.paged_attention(qh, kp, vp, btab, slen, scale)
            for _ in range(2)]
    deterministic = bool(torch.equal(*runs))
    if not deterministic:
        raise RuntimeError("decode shape: two launches on the same inputs "
                           "differ")
    # the split length against the profiled device time, at the main
    # shape, with every row at 1023 and at the serve phase's lengths
    sweep = {}
    for name in ("mixed", "all_1023", "serve_lengths"):
        bt, sl = shapes[name][1], torch.tensor(shapes[name][0], device=dev)
        sweep[name] = {sp: profiled_ms(torch, lambda: pk.paged_attention(
            qh, kp, vp, bt, sl, scale, split_pages=sp), flush, tag)
            for sp in (1, 2, 4, 8, 16)}

    def library():
        n = width * PAGE
        kv_k = kp[btab.long()].reshape(SLOTS, n, h, d).transpose(1, 2)
        kv_v = vp[btab.long()].reshape(SLOTS, n, h, d).transpose(1, 2)
        mask = (torch.arange(n, device=dev)[None, :]
                <= slen.long()[:, None])[:, None, None, :]
        return torch.nn.functional.scaled_dot_product_attention(
            qh.transpose(1, 2), kv_k, kv_v, attn_mask=mask, scale=scale)

    ref = pk.paged_attention_plain(qh, kp, vp, btab, slen, scale)
    lib_out = library().transpose(1, 2)
    plain_ms = time_ms(torch, lambda: pk.paged_attention_plain(
        qh, kp, vp, btab, slen, scale), flush)
    library_ms = time_ms(torch, library, flush)
    rec = {
        "phase": "kernels", "card": card, "build_s": round(build_s, 3),
        "library": lib_path.name, "cases": cases,
        "tolerance": TOL, "tolerance_reason": TOL_REASON,
        "decode_shape": {"slots": SLOTS, "heads": h, "d": d,
                         "dtype": "float32", "page": PAGE, "width": width,
                         "positions": pos.tolist(),
                         "live_tokens": main["live_tokens"],
                         "kv_bytes": main["kv_bytes"]},
        "split_pages": pk.SPLIT_PAGES, "grid": list(grid),
        "decode": decode, "deterministic": deterministic,
        "split_sweep_profiled_ms": sweep,
        "profiler_drops": list(PROFILER_DROPS),
        "decode_max_abs_err": main["max_abs_err"],
        "library_max_abs_err": float((lib_out - ref).abs().max()),
        "kernel_ms": main["kernel_ms"], "event_ms": main["event_ms"],
        "timing_note": "kernel_ms: the kernel's device duration from "
                       "torch.profiler, median of 30 calls each after a "
                       "256 MB L2-evicting write; event_ms: CUDA events "
                       "around the call, which also take the host's "
                       "enqueue when it outlasts the flush",
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "share_of_bound": main["share_of_bound"],
    }
    emit(rec)
    rec["worst"] = worst
    return rec


def random_weights(ff) -> dict:
    """Weights from np.random.RandomState(0): normal(0, 0.02) for every
    entry, LayerNorm gamma 1 and beta 0, in graph order."""
    rng = np.random.RandomState(0)
    out = {}
    for op in ff.layers.topo_order():
        for spec in op.weight_specs[:op.num_trainable_weights()]:
            shape = spec.shape.logical_shape
            if spec.name == "gamma":
                arr = np.ones(shape, np.float32)
            elif spec.name == "beta":
                arr = np.zeros(shape, np.float32)
            else:
                arr = (rng.standard_normal(shape) * 0.02).astype(np.float32)
            out.setdefault(op.name, {})[spec.name] = arr
    return out


def build_model(device: str, weights=None):
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_gpt

    ff = FFModel(FFConfig(batch_size=SLOTS, device=device))
    build_gpt(ff, batch_size=SLOTS, **WIDTH)
    ff.compile(comp_mode=CompMode.INFERENCE)
    weights = weights if weights is not None else random_weights(ff)
    ff.set_weights(weights)
    return ff, weights


def make_prompts():
    rng = np.random.RandomState(1)
    lens = rng.randint(16, 257, N_REQUESTS)
    prefix = rng.randint(0, WIDTH["vocab_size"], 64).tolist()
    prompts = []
    for i, n in enumerate(lens):
        if i % 4 == 1:  # 4 of the 16 share a 64-token prefix
            n = max(int(n), 80)
            prompts.append(prefix + rng.randint(
                0, WIDTH["vocab_size"], n - 64).tolist())
        else:
            prompts.append(rng.randint(0, WIDTH["vocab_size"], n).tolist())
    return prompts


def timed(fn, log):
    def wrapper(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        log.append(time.perf_counter() - t0)
        return out
    return wrapper


def post(url: str, payload: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def phase_serve(torch, pk, card: str, ff) -> dict:
    from flexflow_tpu_torch.serving import ContinuousScheduler, serve_http

    sched = ContinuousScheduler.from_trained(
        ff, batch_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
        prefix_cache=True)
    step_s, prefill_s = [], []
    sched.model.step = timed(sched.model.step, step_s)
    sched.model.prefill_step = timed(sched.model.prefill_step, prefill_s)
    server = serve_http(generator=sched, port=0, block=False)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v2/generate"
        prompts = make_prompts()
        results = [None] * len(prompts)
        errors = []

        def client(i):
            try:
                results[i] = post(url, {"prompt": prompts[i],
                                        "max_new_tokens": MAX_NEW})
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        torch.cuda.synchronize()
        pk.paged_attention.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = pk.paged_attention.launches
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"serve: requests failed: {errors}")
        stats = sched.stats()
    finally:
        server.shutdown()
        server.server_close()
        sched.close()
    generated = 0
    for p, r in zip(prompts, results):
        toks = r["tokens"][0]
        if len(toks) != len(p) + MAX_NEW or toks[:len(p)] != p:
            raise RuntimeError(
                f"serve: completion of length {len(toks)} for a prompt "
                f"of {len(p)} (+{MAX_NEW})")
        if not all(0 <= t < WIDTH["vocab_size"] for t in toks):
            raise RuntimeError("serve: token id out of the vocabulary")
        generated += len(toks) - len(p)
    forwards = stats["steps"] + stats["prefill_steps"] * CHUNK
    want = WIDTH["num_layers"] * forwards
    if launches != want or launches == 0:
        raise RuntimeError(
            f"serve: paged_attention launched {launches} times, expected "
            f"{WIDTH['num_layers']} x ({stats['steps']} decode steps + "
            f"{stats['prefill_steps']} x {CHUNK} prefill positions) = "
            f"{want}")
    if stats["paged_kernel"]["formulation"] != "cuda":
        raise RuntimeError("serve: the engine did not read through the "
                           "CUDA kernel")
    rec = {
        "phase": "serve", "card": card, "requests": len(prompts),
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "generated_tokens": generated, "wall_s": wall,
        "tokens_per_s": generated / wall,
        "decode_steps": stats["steps"],
        "prefill_steps": stats["prefill_steps"],
        "mean_decode_step_ms": 1e3 * float(np.mean(step_s)),
        "mean_prefill_step_ms": 1e3 * float(np.mean(prefill_s)),
        "prefix_hits": stats["prefix_cache"]["hits"],
        "prefix_hit_tokens": stats["prefix_cache"]["hit_tokens"],
        "kv_blocks_read": stats["paged_kernel"]["blocks_read"],
        "kv_bytes_read": stats["paged_kernel"]["bytes_read"],
        "dense_blocks_equiv": stats["paged_kernel"]["dense_blocks_equiv"],
        "paged_attention_launches": launches,
        "launches_per_forward": launches / forwards,
        "kv_pool_blocks": sched.model.num_blocks,
    }
    emit(rec)
    rec["prompts"] = prompts
    return rec


def run_recorded(ff, prompt):
    """One request alone through a fresh engine on ff's device; returns
    the completion and {position: slot-0 logits} of every step that
    sampled a token."""
    from flexflow_tpu_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler.from_trained(
        ff, batch_slots=SLOTS, page_size=PAGE, prefill_chunk=CHUNK,
        prefix_cache=True)
    rows = {}
    step = sched.model.step

    def recording(tokens, seq_lens, btab):
        logits = step(tokens, seq_lens, btab)
        if seq_lens[0] >= len(prompt) - 1:
            rows[int(seq_lens[0])] = logits[0].copy()
        return logits

    sched.model.step = recording
    try:
        out = sched.generate(prompt, 8, timeout=900)
    finally:
        sched.close()
    return out, rows


def phase_parity(torch, card: str, ff_cuda, weights, prompts) -> dict:
    short = sorted((p for p in prompts if len(p) <= 64), key=len)[:2]
    if len(short) < 2:
        short = [p[:64] for p in prompts[:2]]
    ff_cpu, _ = build_model("cpu", weights)
    worst, checked, steps = 0.0, 0, 0
    for prompt in short:
        out_g, rows_g = run_recorded(ff_cuda, prompt)
        out_c, rows_c = run_recorded(ff_cpu, prompt)
        for pos in sorted(rows_g):
            g, c = rows_g[pos], rows_c[pos]
            if not (np.isfinite(g).all() and np.isfinite(c).all()):
                raise RuntimeError(f"parity: non-finite logits at {pos}")
            worst = max(worst, float(np.abs(g - c).max()))
            steps += 1
            i = pos - len(prompt) + 1  # index of the sampled token
            top2 = np.sort(c)[-2:]
            gap = float(top2[1] - top2[0])
            if out_g[len(prompt) + i] != out_c[len(prompt) + i]:
                if gap > 1e-2:
                    raise RuntimeError(
                        f"parity: greedy tokens differ at position {pos} "
                        f"with a top-2 gap of {gap}")
                break  # the sequences diverge past a near tie
            checked += 1
        if worst > 2e-3:
            raise RuntimeError(f"parity: logits differ by {worst} > 2e-3")
    rec = {"phase": "parity", "card": card, "requests": len(short),
           "prompt_lens": [len(p) for p in short], "steps": steps,
           "tokens_checked": checked, "max_abs_logit_diff": worst,
           "tol": 2e-3, "allow_tf32": False}
    emit(rec)
    return rec


def phase_profile(torch, card: str, ff, steps: int = 20) -> dict:
    """Where a full-width decode step's time goes: torch.profiler over
    `steps` decode steps of 8 rows at mixed positions up to 1024, with
    device time summed by kernel name and the device's idle share of
    the host's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.serving import PagedKVDecodeModel

    width = WIDTH["seq_length"] // PAGE
    model = PagedKVDecodeModel(ff, batch_slots=SLOTS, page_size=PAGE,
                               num_blocks=1 + SLOTS * width)
    rng = np.random.RandomState(2)
    btab = rng.permutation(np.arange(1, model.num_blocks)).reshape(
        SLOTS, width).astype(np.int32)
    pos = rng.randint(1, WIDTH["seq_length"] - steps - 10, SLOTS)
    tokens = rng.randint(0, WIDTH["vocab_size"], SLOTS).astype(np.int32)
    for k in range(5):
        model.step(tokens, (pos + k).astype(np.int32), btab)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            model.step(tokens, (pos + 5 + k).astype(np.int32), btab)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, count = {}, {}
    for evt in prof.events():
        if "cuda" not in str(evt.device_type).lower():
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        count[evt.name] = count.get(evt.name, 0) + 1
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = {
        "phase": "profile", "card": card, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if by_name else None,
        "device_events_per_step": sum(count.values()) / steps,
        "top_kernels": [{"name": n[:80], "ms_per_step": us / 1e3 / steps,
                         "launches_per_step": count[n] / steps}
                        for n, us in top],
    }
    emit(rec)
    return rec

def _scaled_err(got, ref) -> tuple:
    """(max |got - ref|, that over the output's scale max(1, max|ref|))"""
    diff = float((got.float() - ref.float()).abs().max())
    return diff, diff / max(1.0, float(ref.float().abs().max()))


def flash_case(torch, fa, gen, *, bh, sq, sk, d, causal, dtype, dev):
    """K1, K2 and K3 on one case against the plain versions run in
    float32 on the same values; {kernel: (abs err, scaled err)}."""
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=dev).to(dtype)
               for n in (sq, sk, sk))
    dout = torch.randn(bh, sq, d, generator=gen, device=dev).to(dtype)
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_fwd(q, k, v, scale, causal)
    delta = fa.flash_delta(out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    f = [t.float() for t in (q, k, v, dout)]
    r_out, r_lse = fa.flash_fwd_plain(f[0], f[1], f[2], scale, causal)
    r_dq, r_dk, r_dv = fa.flash_bwd_plain(f[0], f[1], f[2], r_out, r_lse,
                                          f[3], scale, causal)
    torch.cuda.synchronize()
    got = {"K1": [(out, r_out), (lse, r_lse)], "K2": [(dq, r_dq)],
           "K3": [(dk, r_dk), (dv, r_dv)]}
    res = {}
    for kern, pairs in got.items():
        for g, _ in pairs:
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{kern} output not finite: {dtype} "
                                   f"bh={bh} sq={sq} sk={sk} d={d} "
                                   f"causal={causal}")
        errs = [_scaled_err(g, r) for g, r in pairs]
        res[kern] = (max(e[0] for e in errs), max(e[1] for e in errs))
    return res


def flash_bounds(bh, sq, sk, d, dtype="float32") -> dict:
    """Least time of each kernel on the card at one shape (non-causal):
    the larger of its bytes (each input read once, each output written
    once) over HBM and its operations over the peak of its route.  On
    the float32 SIMT route that is 67 TFLOP/s (bfloat16 is widened to
    float32 there); on the tensor cores a float32 product takes three
    TF32 passes (3 x flops at 495 TFLOP/s) and a bfloat16 product one
    (989 TFLOP/s).  Both operation bounds are reported; `bound_ms` and
    `bound_by` are those of the kernel's route (FLASH_ROUTE)."""
    itemsize = 4 if dtype == "float32" else 2
    pairs = bh * sq * sk * d
    qb, kb = bh * sq * d * itemsize, bh * sk * d * itemsize
    rows = bh * sq * 4
    work = {
        # QK^T and PV
        "K1": (4 * pairs, 2 * qb + 2 * kb + rows),
        # QK^T, dO V^T and dS K; reads q, k, v, dO, lse, delta; writes dq
        "K2": (6 * pairs, 3 * qb + 2 * kb + 2 * rows),
        # QK^T, dO V^T, P^T dO and dS^T Q; writes dk and dv
        "K3": (8 * pairs, 2 * qb + 4 * kb + 2 * rows),
    }
    tc_name, tc_s_per_flop = (
        ("3xTF32 tensor cores", 3 / H100_TF32_FLOPS) if dtype == "float32"
        else ("bfloat16 tensor cores", 1 / H100_BF16_FLOPS))
    out = {}
    for kern, (flops, nbytes) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S
        t_ops = {"simt": flops / H100_F32_FLOPS,
                 "tensor_cores": flops * tc_s_per_flop}
        route = FLASH_ROUTE[kern]
        ops_name = {"simt": "float32 SIMT",
                    "tensor_cores": tc_name}[route]
        out[kern] = {"flops": flops, "bytes": nbytes, "route": route,
                     "simt_bound_ms": max(t_ops["simt"], t_bytes) * 1e3,
                     "tc_bound_ms": max(t_ops["tensor_cores"],
                                        t_bytes) * 1e3,
                     "bound_ms": max(t_ops[route], t_bytes) * 1e3,
                     "bound_by": f"operations, {ops_name}"
                     if t_ops[route] >= t_bytes else "bytes"}
    return out


def sass_counts(lib_path) -> dict:
    """Instructions in each flash kernel instance of the built library,
    from cuobjdump's SASS (see count_sass)."""
    from flexflow_tpu_torch.ops.kernels import _build

    tool = str(Path(_build.find_nvcc()).with_name("cuobjdump"))
    return count_sass(subprocess.run(
        [tool, "--dump-sass", str(lib_path)], capture_output=True,
        text=True, timeout=300, check=True).stdout)


def count_sass(sass: str) -> dict:
    """{"K2 float32 d64": {"hmma": tensor-core instructions,
    "instructions": all instructions}, ...} per flash kernel instance in
    a SASS listing."""
    names = {"flash_fwd_kernel": "K1", "flash_bwd_dq_kernel": "K2",
             "flash_bwd_dkv_kernel": "K3"}
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_fwd_kernel|flash_bwd_dq_kernel|"
                          r"flash_bwd_dkv_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                          line)
            current = None if m is None else (
                f"{names[m.group(1)]} "
                f"{'float32' if m.group(2) == 'f' else 'bfloat16'} "
                f"d{m.group(3)}")
            if current:
                counts[current] = {"hmma": 0, "instructions": 0}
        elif current and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[current]["instructions"] += 1
            counts[current]["hmma"] += "HMMA" in line
    return counts


def flash_main_shape(torch, fa, gen, dtype, dev, flush,
                     shape=FLASH_SHAPE) -> dict:
    """K1-K3 at a path's shape [batch * heads, seq, head_dim] (the main
    path's by default: BERT-base at batch 8, seq 2048, non-causal) in
    `dtype`: agreement with the plain versions run in float32 on the
    same values, each kernel bit-identical over two launches, and the
    times of the kernels, the plain versions (float32 only) and the
    library."""
    bh, s, d = shape
    dname = str(dtype).removeprefix("torch.")
    q, k, v, dout = (torch.randn(bh, s, d, generator=gen, device=dev).to(
        dtype) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    out, lse = fa.flash_fwd(q, k, v, scale, False)
    out2, lse2 = fa.flash_fwd(q, k, v, scale, False)
    delta = fa.flash_delta(out, dout)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, False)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, False)
    dq2 = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale, False)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale, False)
    deterministic = {"K1": torch.equal(out, out2) and torch.equal(lse, lse2),
                     "K2": torch.equal(dq, dq2),
                     "K3": torch.equal(dk, dk2) and torch.equal(dv, dv2)}
    if not all(deterministic.values()):
        raise RuntimeError(f"main shape {dname}: two launches on the same "
                           f"inputs differ: {deterministic}")
    del out2, lse2, dq2, dk2, dv2
    f = [t.float() for t in (q, k, v, dout)]
    r_out, r_lse = fa.flash_fwd_plain(f[0], f[1], f[2], scale, False)
    r_dq, r_dk, r_dv = fa.flash_bwd_plain(f[0], f[1], f[2], r_out, r_lse,
                                          f[3], scale, False)
    err = {"K1": max(_scaled_err(out, r_out)[1], _scaled_err(lse, r_lse)[1]),
           "K2": _scaled_err(dq, r_dq)[1],
           "K3": max(_scaled_err(dk, r_dk)[1], _scaled_err(dv, r_dv)[1])}
    del f, r_out, r_lse, r_dq, r_dk, r_dv, dq, dk, dv
    for kern, e in err.items():
        if e > FLASH_TOL[dname]:
            raise RuntimeError(f"main shape {dname}: {kern} vs plain {e}")
    h = BERT["num_heads"]
    b = bh // h
    q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q4, k4, v4, scale=scale)
    dout4 = dout.view(b, h, s, d)
    ms = {
        "K1": time_ms(torch, lambda: fa.flash_fwd(q, k, v, scale, False),
                      flush),
        "K2": time_ms(torch, lambda: fa.flash_bwd_dq(
            q, k, v, dout, lse, delta, scale, False), flush),
        "K3": time_ms(torch, lambda: fa.flash_bwd_dkv(
            q, k, v, dout, lse, delta, scale, False), flush),
    }
    plain_ms = None
    if dtype == torch.float32:
        plain_fwd = time_ms(torch, lambda: fa.flash_fwd_plain(
            q, k, v, scale, False), flush, iters=10, warmup=2)
        plain_bwd = time_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, out, lse, dout, scale, False), flush, iters=10,
            warmup=2)
        plain_ms = {"K1": plain_fwd, "K2": plain_bwd, "K3": plain_bwd}
    lib_fwd = time_ms(torch, lambda: sdpa(q4, k4, v4, scale=scale), flush)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (q4, k4, v4), dout4, retain_graph=True), flush)
    bounds = flash_bounds(bh, s, s, d, dname)
    return {
        "err_over_scale": err, "deterministic": deterministic,
        "kernel_ms": ms, "plain_ms": plain_ms,
        "library_ms": {"K1": lib_fwd, "K2": lib_bwd, "K3": lib_bwd},
        "bounds": bounds,
        "tflops": {kern: bounds[kern]["flops"] / ms[kern] / 1e9
                   for kern in ms},
        "share_of_bound": {kern: bounds[kern]["bound_ms"] / ms[kern]
                           for kern in ms},
        "share_of_tc_bound": {kern: bounds[kern]["tc_bound_ms"] / ms[kern]
                              for kern in ms},
        "K2+K3_ms": ms["K2"] + ms["K3"],
        "K2+K3_over_library_bwd": (ms["K2"] + ms["K3"]) / lib_bwd,
    }


def phase_flash_kernels(torch, fa, card: str, dev, lib_path) -> dict:
    fa.load_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [dict(bh=4, sq=2048, sk=2048), dict(bh=4, sq=200, sk=200)]
    cases, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        runs = [dict(sh, d=d, causal=c) for sh in shapes for d in (64, 128)
                for c in (False, True)]
        runs.append(dict(bh=4, sq=300, sk=1000, d=64, causal=False))
        for r in runs:
            res = flash_case(torch, fa, gen, dtype=dtype, dev=dev, **r)
            cases.append(dict(r, dtype=dname, **{
                f"{kern}_max_abs_err": e[0] for kern, e in res.items()},
                **{f"{kern}_err_over_scale": e[1]
                   for kern, e in res.items()}))
            for kern, (abs_err, scaled) in res.items():
                w = worst.setdefault(kern, {}).setdefault(dname, [0.0, 0.0])
                w[0], w[1] = max(w[0], abs_err), max(w[1], scaled)
                if scaled > FLASH_TOL[dname]:
                    raise RuntimeError(
                        f"{kern} disagrees with its plain version: {dname} "
                        f"{r}: error {scaled} of the output's scale > "
                        f"{FLASH_TOL[dname]}")

    bh, s, d = FLASH_SHAPE
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    main = {str(dt).removeprefix("torch."): flash_main_shape(
        torch, fa, gen, dt, dev, flush)
        for dt in (torch.float32, torch.bfloat16)}
    # what the card gives each K1-K3 instance, and proof that its products
    # run on the tensor cores
    resources = {
        f"{kid} {str(dt).removeprefix('torch.')} d{d}":
            fa.bwd_resources(kern, d, dt)
        for kid, kern in (("K1", "fwd"), ("K2", "dq"), ("K3", "dkv"))
        for dt in (torch.float32, torch.bfloat16) for d in (64, 128)}
    sass = sass_counts(lib_path)
    faults = [f"{n} uses {r['local_bytes']} bytes of local memory (spills)"
              for n, r in resources.items() if r["local_bytes"]]
    faults += [f"{n} has no HMMA instruction" for n in resources
               if not sass.get(n, {}).get("hmma")]

    rec = {
        "phase": "kernels", "kernels": "K1-K3", "card": card,
        "library": lib_path.name, "cases": cases,
        "tolerance": FLASH_TOL, "tolerance_reason": FLASH_TOL_REASON,
        "resources": resources, "sass": sass,
        "main_shape": {"bh": bh, "sq": s, "sk": s, "d": d,
                       "causal": False},
        "main": main,
        "plain_note": "K2 and K3 share one plain backward (dq, dk, dv)",
        "library_note": "scaled_dot_product_attention forward; its "
                        "autograd backward (dq, dk, dv) for K2 and K3",
    }
    emit(rec)
    if faults:
        raise RuntimeError("K1-K3: " + "; ".join(faults))
    rec["worst"] = worst
    return rec


def build_bert_model(device: str, num_layers: int, batch: int, seed: int = 0,
                     metrics=("accuracy", "sparse_categorical_crossentropy"),
                     capture: bool = True, fusion: bool = False):
    """Full-width BERT at seq 2048, compiled for training with the
    default SGD; weights drawn by compile from `seed`; the step captured
    on the card unless `capture` is False; the fusion pass with
    `fusion`."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert

    ff = FFModel(FFConfig(batch_size=batch, device=device, seed=seed,
                          perform_fusion=fusion))
    build_bert(ff, batch_size=batch, seq_length=TRAIN_SEQ,
               **dict(BERT, num_layers=num_layers))
    ff.compile(metrics=metrics, seed=seed)
    return ff if capture else keep_eager(ff)


def bert_data(n: int, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, TRAIN_SEQ, BERT["hidden_size"])).astype(
        np.float32)
    y = rng.randint(0, BERT["num_classes"], (n, 1)).astype(np.int32)
    return x, y


def flash_launches(fa) -> dict:
    return {"K1": fa.flash_fwd.launches, "K2": fa.flash_bwd_dq.launches,
            "K3": fa.flash_bwd_dkv.launches}


def reset_flash_launches(fa) -> None:
    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def capture_counts(ff) -> dict:
    """The step's capture record so far (FFModel.executor.capture_status's
    counts), to difference over a run with `counted_steps`."""
    st = ff.executor.capture_status
    return {k: st.get(k, 0) for k in ("warmup_steps", "captures",
                                      "replays")}


def counted_steps(ff, before: dict, steps: int) -> int:
    """Of `steps` train steps run since `before` (capture_counts), those
    whose launches the kernels' wrappers counted: every step of an eager
    step function; of a captured one the warm-up steps and the capturing
    step.  A replay launches again what the capture counted, which no
    wrapper sees: the profile phases count those from the profiler."""
    if ff.executor.capture_status["mode"] == "eager":
        return steps
    now = capture_counts(ff)
    return (now["warmup_steps"] - before["warmup_steps"]
            + now["captures"] - before["captures"])


def settle(ff, inputs, labels) -> list:
    """After a phase's warm-up step, the steps that leave its step
    function steady: the capturing step of a captured one (every later
    step replays), none for an eager one; their metrics.  A phase times
    its fit after them."""
    st, out = ff.executor.capture_status, []
    while st.get("mode") == "graph" and not st.get("captures"):
        out.append(ff.train_step(inputs, labels))
    return out


def phase_train(torch, fa, card: str):
    """Full-width BERT-base at batch 8, seq 2048 through compile,
    train_step, fit and eval_step on the card."""
    t0 = time.perf_counter()
    ff = build_bert_model("cuda", BERT["num_layers"], TRAIN_BATCH)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    n = TRAIN_BATCH * (1 + FIT_BATCHES)
    x, y = bert_data(n, seed=0)
    reset_flash_launches(fa)
    before = capture_counts(ff)
    # the peak from the warm-up on: a captured step's activations live in
    # the graph's pool, allocated at the capture
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = ff.train_step({"input": x[:TRAIN_BATCH]}, y[:TRAIN_BATCH])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    settled = settle(ff, {"input": x[:TRAIN_BATCH]}, y[:TRAIN_BATCH])
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    losses = [m["loss"] for m in settled]
    step = ff.train_step

    def recording(inputs, labels):
        m = step(inputs, labels)
        losses.append(m["loss"])
        return m

    ff.train_step = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = ff.fit(x[TRAIN_BATCH:], y[TRAIN_BATCH:], batch_size=TRAIN_BATCH,
                  epochs=1, verbose=False)
    wall = time.perf_counter() - t0  # fit synchronizes at the epoch's end
    launches = flash_launches(fa)
    counted = counted_steps(ff, before, 1 + len(settled) + FIT_BATCHES)
    del ff.train_step
    peak = torch.cuda.max_memory_allocated()
    reset_flash_launches(fa)
    ev = ff.eval_step({"input": x[:TRAIN_BATCH]}, y[:TRAIN_BATCH])
    logits = ff.forward({"input": x[:TRAIN_BATCH]})
    eval_launches = flash_launches(fa)
    want = BERT["num_layers"] * counted
    if not counted or launches != {"K1": want, "K2": want, "K3": want}:
        raise RuntimeError(
            f"train: flash launches {launches} over {counted} counted "
            f"steps, expected {BERT['num_layers']} per step each ({want})")
    if eval_launches != {"K1": 2 * BERT["num_layers"], "K2": 0, "K3": 0}:
        raise RuntimeError(f"train: eval_step + forward launched "
                           f"{eval_launches}")
    loss_vals = [float(warm["loss"])] + [float(v) for v in losses]
    pm = hist[0]
    if not (np.isfinite(loss_vals).all() and np.isfinite(float(ev["loss"]))
            and tuple(logits.shape) == (TRAIN_BATCH, BERT["num_classes"])
            and torch.isfinite(logits).all()):
        raise RuntimeError(f"train: non-finite or misshapen results: "
                           f"losses {loss_vals}, eval {ev}, logits "
                           f"{tuple(logits.shape)}")
    if pm.train_all != TRAIN_BATCH * FIT_BATCHES:
        raise RuntimeError(f"train: fit scored {pm.train_all} samples")
    rec = {
        "phase": "train", "card": card,
        "model": dict(BERT, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      dtype="float32", optimizer="SGD(lr=0.01, wd=1e-4)"),
        "compile_s": compile_s, "warmup_step_s": warm_s,
        "capture_step_s": settle_s if settled else None,
        "fit_steps": FIT_BATCHES, "fit_wall_s": wall,
        "step_ms": wall / FIT_BATCHES * 1e3,
        "samples_per_s": TRAIN_BATCH * FIT_BATCHES / wall,
        "losses": loss_vals, "eval_loss": float(ev["loss"]),
        "fit_accuracy": pm.accuracy,
        "fit_mean_loss": pm.sparse_cce_loss / pm.train_all,
        "flash_launches": launches,
        "counted_steps": counted,
        "flash_launches_per_counted_step": {k: v / counted
                                            for k, v in launches.items()},
        "capture_status": ff.executor.capture_status,
        "peak_memory_gb": peak / 1e9,
    }
    emit(rec)
    return ff, x[:TRAIN_BATCH], y[:TRAIN_BATCH], rec


def phase_train_parity(torch, fa, card: str) -> dict:
    """Two SGD steps of full-width BERT, 2 layers, batch 2, seq 2048 on
    the card and on the CPU from the same weights and batches."""
    layers, batch, steps = 2, 2, 2
    ff_g = build_bert_model("cuda", layers, batch, seed=1)
    ff_c = build_bert_model("cpu", layers, batch, seed=1)
    ff_c.set_weights(ff_g.get_weights())
    x, y = bert_data(batch * steps, seed=1)
    reset_flash_launches(fa)
    losses = {"cuda": [], "cpu": []}
    for i in range(steps):
        sl = slice(batch * i, batch * (i + 1))
        for dev, ff in (("cuda", ff_g), ("cpu", ff_c)):
            losses[dev].append(float(ff.train_step({"input": x[sl]},
                                                   y[sl])["loss"]))
    launches = flash_launches(fa)
    if launches != {"K1": layers * steps, "K2": layers * steps,
                    "K3": layers * steps}:
        raise RuntimeError(f"train_parity: card launches {launches}")
    loss_diff = max(abs(a - b) for a, b in zip(losses["cuda"],
                                               losses["cpu"]))
    wg, wc = ff_g.get_weights(), ff_c.get_weights()
    weight_diff, worst_w = 0.0, None
    for op, entries in wc.items():
        for k, v in entries.items():
            dlt = float(np.abs(wg[op][k] - v).max())
            if dlt > weight_diff:
                weight_diff, worst_w = dlt, f"{op}.{k}"
    if not all(np.isfinite(losses["cuda"] + losses["cpu"])):
        raise RuntimeError(f"train_parity: non-finite losses {losses}")
    if loss_diff > PARITY_TOL["loss"] or weight_diff > PARITY_TOL["weights"]:
        raise RuntimeError(
            f"train_parity: card vs CPU loss diff {loss_diff}, weight diff "
            f"{weight_diff} ({worst_w}) over {PARITY_TOL}")
    rec = {"phase": "train_parity", "card": card, "layers": layers,
           "batch": batch, "seq": TRAIN_SEQ, "steps": steps,
           "losses": losses, "max_loss_diff": loss_diff,
           "max_weight_diff": weight_diff, "worst_weight": worst_w,
           "tolerance": PARITY_TOL, "allow_tf32": False,
           "flash_launches_on_card": launches}
    emit(rec)
    return rec


def phase_train_profile(torch, fa, card: str, ff, x, y,
                        steps: int = 3) -> dict:
    """torch.profiler over `steps` full-width train steps: device time by
    kernel, K1-K3's shares, busy and idle time per step."""
    from torch.profiler import ProfilerActivity, profile

    ff.train_step({"input": x}, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ff.train_step({"input": x}, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, count = {}, {}
    for evt in prof.events():
        if "cuda" not in str(evt.device_type).lower():
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        count[evt.name] = count.get(evt.name, 0) + 1
    busy_us = sum(by_name.values())
    if not by_name:
        raise RuntimeError("train_profile: the profiler saw no device time")
    flash = {}
    for kern, tag in (("K1", "flash_fwd_kernel"),
                      ("K2", "flash_bwd_dq_kernel"),
                      ("K3", "flash_bwd_dkv_kernel")):
        us = sum(v for n, v in by_name.items() if tag in n)
        n = sum(c for nm, c in count.items() if tag in nm)
        flash[kern] = {"ms_per_step": us / 1e3 / steps,
                       "share_of_busy": us / busy_us,
                       "launches_per_step": n / steps}
    flash["K2+K3"] = {
        key: flash["K2"][key] + flash["K3"][key]
        for key in ("ms_per_step", "share_of_busy")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = {
        "phase": "train_profile", "card": card, "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_ms_per_step": (wall_ms - busy_us / 1e3) / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_events_per_step": sum(count.values()) / steps,
        "flash": flash,
        "top_kernels": [{"name": n[:80], "ms_per_step": us / 1e3 / steps,
                         "launches_per_step": count[n] / steps}
                        for n, us in top],
    }
    emit(rec)
    return rec


def resnet_modules():
    """The example's Bottleneck and ResNet50
    (examples/python/pytorch/resnet50_search.py, copied because that file
    imports flexflow_tpu) and the small ResNet of resnet_parity."""
    import torch
    import torch.nn as nn

    class Bottleneck(nn.Module):
        expansion = 4

        def __init__(self, cin, width, stride=1):
            super().__init__()
            cout = width * self.expansion
            self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(width)
            self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(width)
            self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU()
            self.down = (
                nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                              nn.BatchNorm2d(cout))
                if stride != 1 or cin != cout else None)

        def forward(self, x):
            idt = x if self.down is None else self.down(x)
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            return self.relu(y + idt)

    class ResNet50(nn.Module):
        def __init__(self, classes=1000):
            super().__init__()
            self.stem = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn = nn.BatchNorm2d(64)
            self.pool = nn.MaxPool2d(3, 2, 1)
            self.relu = nn.ReLU()
            layers = []
            cin = 64
            for width, blocks, stride in [(64, 3, 1), (128, 4, 2),
                                          (256, 6, 2), (512, 3, 2)]:
                for i in range(blocks):
                    layers.append(Bottleneck(cin, width,
                                             stride if i == 0 else 1))
                    cin = width * Bottleneck.expansion
            self.layers = nn.Sequential(*layers)
            self.avg = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(cin, classes)

        def forward(self, x):
            x = self.pool(self.relu(self.bn(self.stem(x))))
            x = self.layers(x)
            x = self.avg(x)
            x = torch.flatten(x, 1)
            return self.fc(x)

    class SmallResNet(ResNet50):
        """ResNet50's stem and head around two Bottlenecks: stem 3 -> 8,
        one downsampling block (8 -> 16, stride 2), one identity block."""

        def __init__(self, classes=10):
            nn.Module.__init__(self)
            self.stem = nn.Conv2d(3, 8, 7, 2, 3, bias=False)
            self.bn = nn.BatchNorm2d(8)
            self.pool = nn.MaxPool2d(3, 2, 1)
            self.relu = nn.ReLU()
            self.layers = nn.Sequential(Bottleneck(8, 4, 2),
                                        Bottleneck(16, 4, 1))
            self.avg = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(16, classes)

    return Bottleneck, ResNet50, SmallResNet


def vit_modules():
    """ViT-B/16 (Dosovitskiy et al., ICLR 2021, Table 1: hidden 768, 12
    layers, MLP 3072, 12 heads, patch 16 at 224 px; Table 3: dropout 0.1)
    with the global-average-pool head, written in HF's eager attention
    idiom (view/permute/matmul), and the small ViT of vit_parity (32 px,
    patch 8, hidden 64, 2 layers, 4 heads, MLP 256, 10 classes)."""
    import math

    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class Attention(nn.Module):
        def __init__(self, h, n, p):
            super().__init__()
            self.n, self.d = n, h // n
            self.query, self.key = nn.Linear(h, h), nn.Linear(h, h)
            self.value, self.out = nn.Linear(h, h), nn.Linear(h, h)
            self.drop, self.odrop = nn.Dropout(p), nn.Dropout(p)

        def split(self, x):
            return x.view(x.size()[:-1] + (self.n, self.d)).permute(
                0, 2, 1, 3)

        def forward(self, x):
            q = self.split(self.query(x))
            k = self.split(self.key(x))
            v = self.split(self.value(x))
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.d)
            probs = self.drop(F.softmax(scores, dim=-1))
            c = torch.matmul(probs, v).permute(0, 2, 1, 3).contiguous()
            return self.odrop(self.out(
                c.view(c.size()[:-2] + (self.n * self.d,))))

    class Block(nn.Module):
        """Pre-LN: x + attn(ln1(x)), then x + drop(fc2(gelu(fc1(ln2(x)))))."""

        def __init__(self, h, n, mlp, p):
            super().__init__()
            self.ln1 = nn.LayerNorm(h, eps=1e-6)
            self.attn = Attention(h, n, p)
            self.ln2 = nn.LayerNorm(h, eps=1e-6)
            self.fc1, self.fc2 = nn.Linear(h, mlp), nn.Linear(mlp, h)
            self.act, self.drop = nn.GELU(), nn.Dropout(p)

        def forward(self, x):
            x = x + self.attn(self.ln1(x))
            return x + self.drop(self.fc2(self.act(self.fc1(self.ln2(x)))))

    class ViT(nn.Module):
        def __init__(self, px=224, patch=16, hidden=768, layers=12,
                     heads=12, mlp=3072, classes=1000, dropout=0.1):
            super().__init__()
            tokens = (px // patch) ** 2
            self.patch = nn.Conv2d(3, hidden, patch, patch)
            self.pos = nn.Parameter(0.02 * torch.randn(1, tokens, hidden))
            self.drop = nn.Dropout(dropout)
            self.blocks = nn.Sequential(*[Block(hidden, heads, mlp, dropout)
                                          for _ in range(layers)])
            self.ln = nn.LayerNorm(hidden, eps=1e-6)
            self.head = nn.Linear(hidden, classes)

        def forward(self, x):
            x = self.patch(x).flatten(2).transpose(1, 2)
            x = self.drop(x + self.pos)
            return self.head(self.ln(self.blocks(x)).mean(dim=1))

    class SmallViT(ViT):
        def __init__(self, dropout=0.0):
            super().__init__(px=32, patch=8, hidden=64, layers=2, heads=4,
                             mlp=256, classes=10, dropout=dropout)

    return ViT, SmallViT


def build_vit(module, batch: int, px: int, device: str, compute_dtype: str,
              compile_: bool = True, capture: bool = True,
              fusion: bool = False):
    """PyTorchModel(module).torch_to_ff, then (unless compile_ is False)
    compile with the default SGD and the sparse cross-entropy on the
    logits, and copy_weights; the step captured on the card unless
    `capture` is False; the fusion pass with `fusion`."""
    from flexflow_tpu_torch import FFConfig, FFModel, MetricsType
    from flexflow_tpu_torch.torch_frontend import PyTorchModel

    ff = FFModel(FFConfig(batch_size=batch, device=device,
                          compute_dtype=compute_dtype, perform_fusion=fusion))
    x = ff.create_tensor([batch, 3, px, px], name="input")
    pt = PyTorchModel(module)
    pt.torch_to_ff(ff, [x])
    if compile_:
        ff.compile(metrics=[MetricsType.ACCURACY,
                            MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
        pt.copy_weights(ff)
        if not capture:
            keep_eager(ff)
    return ff


def op_counts(ff) -> dict:
    """The graph's ops by type, inputs left out."""
    counts = {}
    for op in ff.layers.ops:
        kind = op.op_type.value
        if kind != "input":
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def bn_bytes(m: int, c: int, itemsize: int, res: bool) -> int:
    """Bytes P1 must move: x (and res) read once, y written once, scale
    and shift read once."""
    return (3 if res else 2) * m * c * itemsize + 2 * c * itemsize


def bn_bound_ms(m: int, c: int, itemsize: int, res: bool,
                relu: bool) -> tuple:
    """(bound ms, "bytes" or "operations"): the bytes over HBM against
    the float32 multiply and adds (and the ReLU's compare) at the SIMT
    peak."""
    t_bytes = bn_bytes(m, c, itemsize, res) / H100_BYTES_PER_S
    t_ops = m * c * (2 + res + relu) / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_bn_kernels(torch, bk, card: str, dev) -> dict:
    """P1 against its plain version at the probe's shapes, both dtypes,
    every variant; ragged and misaligned cases on the scalar path."""
    import torch.nn.functional as F

    bk.load_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    cases, worst = [], {}

    def check(what, dname, got, ref):
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"bn_apply output not finite: {what}")
        err = _scaled_err(got, ref)
        worst[dname] = max(worst.get(dname, 0.0), err[1])
        if err[1] > BN_TOL[dname]:
            raise RuntimeError(f"bn_apply disagrees with its plain version: "
                               f"{what}: {err[1]} > {BN_TOL[dname]}")
        return err

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        isz = dtype.itemsize
        for m, c in BN_SHAPES:
            x = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            res = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            scale = (torch.rand(c, generator=gen, device=dev) + 0.5).to(dtype)
            shift = (torch.randn(c, generator=gen, device=dev) * 0.1).to(dtype)
            for variant, (has_res, relu) in BN_VARIANTS.items():
                r = res if has_res else None
                got = bk.bn_apply(x, scale, shift, r, relu)
                ref = bk.bn_apply_plain(x, scale, shift, r, relu)
                err = check(f"{dname} {m}x{c} {variant}", dname, got, ref)
                exact = bool(torch.equal(got, ref))
                del got, ref
                ms = time_ms(torch, lambda: bk.bn_apply(x, scale, shift, r,
                                                        relu), flush)
                plain_ms = time_ms(torch, lambda: bk.bn_apply_plain(
                    x, scale, shift, r, relu), flush)
                library_ms, lib_err = None, None
                if variant == "none":
                    # x * scale + shift in one library call
                    zeros = torch.zeros(c, device=dev)
                    ones = torch.ones(c, device=dev) - 1e-5

                    def library():
                        return F.batch_norm(x, zeros, ones, scale.float(),
                                            shift.float(), training=False,
                                            eps=1e-5)

                    lib_err = _scaled_err(library(), bk.bn_apply_plain(
                        x, scale, shift, None, False))[1]
                    library_ms = time_ms(torch, library, flush)
                bound, bound_by = bn_bound_ms(m, c, isz, has_res, relu)
                cases.append({
                    "dtype": dname, "m": m, "c": c, "variant": variant,
                    "vectorized": bk.vectorized(x, r),
                    "max_abs_err": err[0], "err_over_scale": err[1],
                    "bit_exact": exact, "tol": BN_TOL[dname],
                    "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library_err_over_scale": lib_err,
                    "bytes": bn_bytes(m, c, isz, has_res),
                    "bound_ms": bound, "bound_by": bound_by,
                    "share_of_bound": bound / ms,
                    "gb_per_s": bn_bytes(m, c, isz, has_res) / ms / 1e6})
            del x, res
    # ragged C and M, and a misaligned x: the scalar path
    ragged = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        # C 37: scalar path; offset 1: misaligned, scalar path; C 4100:
        # a grid of whole rows; C 2053 (prime): the general loop
        for m, c, offset in ((1001, 37, 0), (333, 64, 1), (7, 4100, 0),
                             (5, 2053, 0)):
            base = torch.randn(m * c + offset, generator=gen,
                               device=dev).to(dtype)
            x = base[offset:].view(m, c)
            res = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            scale = torch.randn(c, generator=gen, device=dev).to(dtype)
            shift = torch.randn(c, generator=gen, device=dev).to(dtype)
            for variant, (has_res, relu) in BN_VARIANTS.items():
                r = res if has_res else None
                err = check(f"{dname} {m}x{c}+{offset} {variant}", dname,
                            bk.bn_apply(x, scale, shift, r, relu),
                            bk.bn_apply_plain(x, scale, shift, r, relu))
                ragged.append({"dtype": dname, "m": m, "c": c,
                               "offset": offset, "variant": variant,
                               "vectorized": bk.vectorized(x, r),
                               "err_over_scale": err[1]})
    if any(r["vectorized"] for r in ragged if r["c"] == 37 or r["offset"]):
        raise RuntimeError("bn_apply took the vector path on a ragged or "
                           "misaligned case")
    main = next(cs for cs in cases if cs["dtype"] == "bfloat16"
                and (cs["m"], cs["c"]) == BN_SHAPES[0]
                and cs["variant"] == "res_relu")
    rec = {"phase": "bn_kernels", "card": card, "cases": cases,
           "ragged": ragged, "tolerance": BN_TOL,
           "tolerance_reason": BN_TOL_REASON,
           "library_note": "F.batch_norm(x, 0, 1 - eps, scale, shift, "
                           "training=False) computes x * scale + shift, "
                           "the variant with neither; no single PyTorch "
                           "call computes the fused variants",
           "main": main}
    emit(rec)
    rec["worst"] = worst
    return rec


def build_resnet(torch, module, batch: int, px: int, device: str,
                 compute_dtype: str, capture: bool = True):
    """The entry points a user calls: PyTorchModel(module).torch_to_ff,
    softmax, compile with SGD(lr=0.1) and the sparse cross-entropy,
    copy_weights; the step captured on the card unless `capture` is
    False."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer)
    from flexflow_tpu_torch.torch_frontend import PyTorchModel

    ff = FFModel(FFConfig(batch_size=batch, device=device,
                          compute_dtype=compute_dtype))
    x = ff.create_tensor([batch, 3, px, px], name="input")
    pt = PyTorchModel(module)
    (out,) = pt.torch_to_ff(ff, [x])
    ff.softmax(out)
    ff.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY,
                        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    pt.copy_weights(ff)
    return ff if capture else keep_eager(ff)


def bn_plan_counts(ff) -> dict:
    """P1 applies of one forward by variant, from the executor's plan."""
    counts = {"res_relu": 0, "relu": 0, "none": 0}
    for plan in ff.executor.bn_plans.values():
        counts["res_relu" if plan.residual is not None
               else "relu" if plan.relu else "none"] += 1
    return counts


def phase_resnet(torch, bk, card: str):
    """Full-width ResNet-50 (torch.fx import), batch 256, 224 px, 1000
    classes, bfloat16 compute, through compile, train_step, fit and
    eval_step on the card."""
    _, ResNet50, _ = resnet_modules()
    torch.manual_seed(0)
    module = ResNet50(classes=RESNET_CLASSES)
    t0 = time.perf_counter()
    ff = build_resnet(torch, module, RESNET_BATCH, RESNET_PX, "cuda",
                      "bfloat16")
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    plan = bn_plan_counts(ff)
    if plan != RESNET_BN:
        raise RuntimeError(f"resnet: BatchNorm plan {plan}, expected "
                           f"{RESNET_BN}")
    n = RESNET_BATCH * (1 + RESNET_FIT)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 3, RESNET_PX, RESNET_PX), dtype=np.float32)
    y = rng.integers(0, RESNET_CLASSES, n).astype(np.int32)
    b = RESNET_BATCH
    bk.bn_apply.launches = 0
    before = capture_counts(ff)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = ff.train_step({"input": x[:b]}, y[:b])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    settled = settle(ff, {"input": x[:b]}, y[:b])
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    losses = [m["loss"] for m in settled]
    step = ff.train_step

    def recording(inputs, labels):
        m = step(inputs, labels)
        losses.append(m["loss"])
        return m

    ff.train_step = recording
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = ff.fit(x[b:], y[b:], batch_size=b, epochs=1, verbose=False)
    wall = time.perf_counter() - t0  # fit synchronizes at the epoch's end
    launches = bk.bn_apply.launches
    counted = counted_steps(ff, before, 1 + len(settled) + RESNET_FIT)
    del ff.train_step
    peak = torch.cuda.max_memory_allocated()
    bk.bn_apply.launches = 0
    ev = ff.eval_step({"input": x[:b]}, y[:b])
    probs = ff.forward({"input": x[:b]})
    eval_launches = bk.bn_apply.launches
    per_forward = sum(RESNET_BN.values())
    if not counted or launches != per_forward * counted:
        raise RuntimeError(f"resnet: P1 launched {launches} times over "
                           f"{counted} counted steps, expected "
                           f"{per_forward} per step")
    if eval_launches != 2 * per_forward:
        raise RuntimeError(f"resnet: eval_step + forward launched P1 "
                           f"{eval_launches} times")
    loss_vals = [float(warm["loss"])] + [float(v) for v in losses]
    if not (np.isfinite(loss_vals).all() and np.isfinite(float(ev["loss"]))
            and tuple(probs.shape) == (b, RESNET_CLASSES)
            and torch.isfinite(probs).all()):
        raise RuntimeError(f"resnet: non-finite or misshapen results: "
                           f"losses {loss_vals}, eval {ev}, output "
                           f"{tuple(probs.shape)}")
    pm = hist[0]
    if pm.train_all != b * RESNET_FIT:
        raise RuntimeError(f"resnet: fit scored {pm.train_all} samples")
    rec = {
        "phase": "resnet", "card": card,
        "model": {"source": "examples/python/pytorch/resnet50_search.py "
                            "ResNet50 via torch.fx",
                  "batch": b, "px": RESNET_PX, "classes": RESNET_CLASSES,
                  "compute_dtype": "bfloat16",
                  "optimizer": "SGD(lr=0.1)",
                  "weights": "torch.manual_seed(0) module init, "
                             "copy_weights"},
        "compile_s": compile_s, "warmup_step_s": warm_s,
        "capture_step_s": settle_s if settled else None,
        "fit_steps": RESNET_FIT, "fit_wall_s": wall,
        "step_ms": wall / RESNET_FIT * 1e3,
        "images_per_s": b * RESNET_FIT / wall,
        "losses": loss_vals, "eval_loss": float(ev["loss"]),
        "bn_apply_launches": launches,
        "counted_steps": counted,
        "bn_apply_launches_per_counted_step": launches / counted,
        "capture_status": ff.executor.capture_status,
        "bn_plan_per_forward": plan,
        "peak_memory_gb": peak / 1e9,
    }
    emit(rec)
    return ff, x[b:], y[b:], rec


def phase_resnet_parity(torch, bk, card: str) -> dict:
    """Two SGD steps of the small ResNet, float32, on the card and on
    the CPU from the same module and batches."""
    _, _, SmallResNet = resnet_modules()
    torch.manual_seed(1)
    module = SmallResNet()
    batch, steps = 4, 2
    ff_g = build_resnet(torch, module, batch, 32, "cuda", "float32")
    ff_c = build_resnet(torch, module, batch, 32, "cpu", "float32")
    rng = np.random.RandomState(1)
    x = rng.randn(batch * (steps + 1), 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, batch * (steps + 1)).astype(np.int32)
    bk.bn_apply.launches = 0
    probs = {dev: ff.forward({"input": x[:batch]}).cpu().numpy()
             for dev, ff in (("cuda", ff_g), ("cpu", ff_c))}
    losses = {"cuda": [], "cpu": []}
    for i in range(steps):
        sl = slice(batch * (i + 1), batch * (i + 2))
        for dev, ff in (("cuda", ff_g), ("cpu", ff_c)):
            losses[dev].append(float(ff.train_step({"input": x[sl]},
                                                   y[sl])["loss"]))
    launches = bk.bn_apply.launches
    per_forward = len(ff_g.executor.bn_plans)
    if launches != per_forward * (1 + steps):
        raise RuntimeError(f"resnet_parity: card launched P1 {launches} "
                           f"times, expected {per_forward} per forward")
    diff = {"output": float(np.abs(probs["cuda"] - probs["cpu"]).max()),
            "loss": max(abs(a - b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))}
    worst = {}
    for key, (g, c) in {"weights": (ff_g.get_weights(), ff_c.get_weights()),
                        "running_stats": (ff_g.get_state(),
                                          ff_c.get_state())}.items():
        diff[key], worst[key] = 0.0, None
        for op, entries in c.items():
            for k, v in entries.items():
                d = float(np.abs(g[op][k] - v).max())
                if d > diff[key]:
                    diff[key], worst[key] = d, f"{op}.{k}"
    if not all(np.isfinite(losses["cuda"] + losses["cpu"])):
        raise RuntimeError(f"resnet_parity: non-finite losses {losses}")
    over = {k: v for k, v in diff.items() if v > RESNET_PARITY_TOL[k]}
    if over:
        raise RuntimeError(f"resnet_parity: card vs CPU {over} over "
                           f"{RESNET_PARITY_TOL} (worst {worst})")
    rec = {"phase": "resnet_parity", "card": card, "batch": batch,
           "px": 32, "steps": steps, "dtype": "float32",
           "allow_tf32": False, "losses": losses, "max_diff": diff,
           "worst": worst, "tolerance": RESNET_PARITY_TOL,
           "bn_apply_launches_on_card": launches,
           "compared": "softmax output of an eval-mode forward, losses, "
                       "every weight and running statistic after the "
                       "steps"}
    emit(rec)
    return rec


# device kernels by kind, from their names: cuDNN's convolutions, P1,
# same-dtype copies over strided iterators (layout permutations),
# dtype casts, host/device copies, torch reductions, the rest
_KINDS = (
    ("p1", ("bn_apply_kernel",)),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "implicit_gemm", "cudnn",
              "xmma")),
    ("layout", ("nchwtonhwc", "nhwctonchw", "transpose", "permute")),
    ("cast", ("bfloat16_copy", "unrolled_elementwise_kernel<at::native::"
              "direct_copy")),
    ("memcpy", ("memcpy",)),
    ("reduction", ("reduce_kernel",)),
    ("gemm", ("gemm", "nvjet", "cutlass")),
)


def _kind(name: str) -> str:
    low = name.lower()
    # a same-dtype copy that is not contiguous on both sides
    if "direct_copy" in low and low.startswith("void at::native::"
                                               "elementwise_kernel<"):
        return "layout"
    for kind, tags in _KINDS:
        if any(t in low for t in tags):
            return kind
    return "elementwise" if "elementwise" in low else "other"


def _self_device_us(avg) -> float:
    t = getattr(avg, "self_device_time_total", None)
    return float(t if t is not None else avg.self_cuda_time_total)


def phase_resnet_profile(torch, card: str, ff, x, y, steps: int = 3) -> dict:
    """torch.profiler over `steps` full-width ResNet-50 train steps fed
    by the prefetching loader (fit's loop)."""
    from torch.profiler import ProfilerActivity, profile

    run = loader_steps(ff, x, y, RESNET_BATCH, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.events()
                     if "cuda" in str(e.device_type).lower()),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError("resnet_profile: the profiler saw no device time")
    by_name, count, by_kind, kind_n = {}, {}, {}, {}
    p1_variant = {}
    for e in events:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        count[e.name] = count.get(e.name, 0) + 1
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + us
        kind_n[k] = kind_n.get(k, 0) + 1
        if k == "p1":
            m = re.search(r"bn_apply_kernel<([^,]+),\s*(\d+),\s*(\w+),\s*"
                          r"(\w+)>", e.name)
            v = ("unparsed" if m is None else
                 "res_relu" if m.group(3) == "true"
                 else "relu" if m.group(4) == "true" else "none")
            p1_variant[v] = p1_variant.get(v, 0) + 1
    # layout copies (and, apart, dtype casts) right before or after a P1
    # launch
    beside = {"layout": {}, "cast": {}}
    for i, e in enumerate(events):
        if _kind(e.name) != "p1":
            continue
        for j in (i - 1, i + 1):
            k = _kind(events[j].name) if 0 <= j < len(events) else None
            if k in beside:
                n = events[j].name[:80]
                beside[k][n] = beside[k].get(n, 0) + 1
    kernel_us = sum(by_name.values())
    busy_us = device_busy_us(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:30]
    # the aten ops that launched the device time, and the copies by shape
    ops = [a for a in prof.key_averages() if _self_device_us(a) > 0]
    top_ops = sorted(ops, key=lambda a: -_self_device_us(a))[:25]
    copies = [a for a in prof.key_averages(group_by_input_shape=True)
              if a.key in ("aten::copy_", "aten::contiguous", "aten::clone",
                           "aten::_to_copy") and _self_device_us(a) > 0]
    copies = sorted(copies, key=lambda a: -_self_device_us(a))[:15]
    rec = {
        "phase": "resnet_profile", "card": card, "steps": steps,
        "run": "train steps fed by the prefetching loader",
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_kernel_ms_per_step": kernel_us / 1e3 / steps,
        "device_idle_ms_per_step": (wall_ms - busy_us / 1e3) / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_events_per_step": len(events) / steps,
        "by_stream": by_stream(events, steps),
        "busy_note": "device busy: the union of the device events' spans "
                     "on every stream (the loader's copies run on a "
                     "stream of their own); kernel ms: their sum",
        "by_kind": {k: {"ms_per_step": us / 1e3 / steps,
                        "share_of_busy": us / kernel_us,
                        "launches_per_step": kind_n[k] / steps}
                    for k, us in sorted(by_kind.items())},
        "kind_note": "by kernel name: conv, cuDNN's convolutions; p1, "
                     "bn_apply_kernel; layout, same-dtype copies over "
                     "strided iterators and transposes; cast, dtype "
                     "conversions; memcpy, host/device copies; "
                     "reduction, torch reductions (BatchNorm statistics, "
                     "P1's backward sums, the loss); gemm, the head",
        "p1_launches_per_step_by_variant": {
            k: v / steps for k, v in sorted(p1_variant.items())},
        "events_beside_p1": beside,
        "layout_kernels": {n[:80]: {"ms_per_step": by_name[n] / 1e3 / steps,
                                    "launches_per_step": count[n] / steps}
                           for n in by_name if _kind(n) == "layout"},
        "top_kernels": [{"name": n[:100], "kind": _kind(n),
                         "ms_per_step": us / 1e3 / steps,
                         "launches_per_step": count[n] / steps}
                        for n, us in top],
        "top_ops": [{"op": a.key, "calls_per_step": a.count / steps,
                     "self_device_ms_per_step":
                         _self_device_us(a) / 1e3 / steps}
                    for a in top_ops],
        "copy_ops_by_shape": [
            {"op": a.key, "input_shapes": str(a.input_shapes)[:160],
             "calls_per_step": a.count / steps,
             "self_device_ms_per_step": _self_device_us(a) / 1e3 / steps}
            for a in copies],
    }
    emit(rec)
    return rec


def loader_steps(ff, x, y, b: int, steps: int):
    """run() for a profile: `steps` train steps fed by the prefetching
    loader, as fit's loop runs them, after one warm step from the same
    loader (so its start stays out of the window) and, for a captured
    step function, the capture on that batch (settle).  x and y hold at
    least steps + 1 batches."""
    from flexflow_tpu_torch import SingleDataLoader

    n = (steps + 1) * b
    xs = ({k: v[:n] for k, v in x.items()} if isinstance(x, dict)
          else x[:n])
    loader = SingleDataLoader(ff, xs, y[:n], batch_size=b)
    inputs, labels = loader.next_batch()
    # copies: the loader may refill its staging buffers meanwhile
    inputs = {k: v.clone() for k, v in inputs.items()}
    labels = labels.clone()
    ff.train_step(inputs, labels)
    settle(ff, inputs, labels)

    def run():
        for _ in range(steps):
            ff.train_step(*loader.next_batch())

    return run


def device_busy_us(device_events) -> float:
    """The union of the device events' spans: a copy on the loader's
    stream that overlaps a kernel adds no busy time."""
    busy, end = 0.0, float("-inf")
    for e in sorted(device_events, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy += e.time_range.end - start
            end = e.time_range.end
    return busy


def by_stream(device_events, steps: int) -> dict:
    """Device ms and events per step on each stream, with the
    host-to-device copies apart."""
    out = {}
    for e in device_events:
        row = out.setdefault(str(getattr(e, "device_resource_id", "?")),
                             {"ms_per_step": 0.0, "events_per_step": 0.0,
                              "h2d_ms_per_step": 0.0})
        ms = e.time_range.elapsed_us() / 1e3 / steps
        row["ms_per_step"] += ms
        row["events_per_step"] += 1 / steps
        if "htod" in e.name.lower():
            row["h2d_ms_per_step"] += ms
    return out


def kernel_launches(pk, fa, bk) -> dict:
    """The launch counters of every hand-written kernel."""
    return dict(flash_launches(fa), K4=pk.paged_attention.launches,
                P1=bk.bn_apply.launches)


def reset_kernel_launches(pk, fa, bk) -> None:
    reset_flash_launches(fa)
    pk.paged_attention.launches = 0
    bk.bn_apply.launches = 0


def watch_op(op, seen: list):
    """Wrap op.forward (on this instance) to append (input, output) of
    each call to `seen`."""
    fwd = op.forward

    def watched(ins, ws, **kw):
        outs = fwd(ins, ws, **kw)
        seen.append((ins[0], outs[0]))
        return outs

    op.forward = watched


def phase_vit(torch, pk, fa, bk, card: str):
    """Full-width ViT-B/16 (torch.fx import), batch 128, 224 px, 1000
    classes, dropout 0.1, bfloat16 compute, through compile (default
    SGD), train_step, fit and eval_step on the card."""
    from flexflow_tpu_torch import OperatorType

    ViT, _ = vit_modules()
    torch.manual_seed(0)
    module = ViT(classes=VIT_CLASSES, dropout=VIT_DROPOUT)
    t0 = time.perf_counter()
    ff = build_vit(module, VIT_BATCH, VIT_PX, "cuda", "bfloat16")
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    counts = op_counts(ff)
    if counts != VIT_OPS:
        raise RuntimeError(f"vit: graph ops {counts}, expected {VIT_OPS}")
    b = VIT_BATCH
    rng = np.random.RandomState(0)
    x = rng.randn(b * (1 + VIT_FIT), 3, VIT_PX, VIT_PX).astype(np.float32)
    y = rng.randint(0, VIT_CLASSES, b * (1 + VIT_FIT)).astype(np.int32)
    # the first Dropout (after the position add) during the warm-up step
    drop = next(op for op in ff.operators.topo_order()
                if op.op_type == OperatorType.DROPOUT)
    seen = []
    watch_op(drop, seen)
    t0 = time.perf_counter()
    warm = ff.train_step({"input": x[:b]}, y[:b])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    inp, out = seen.pop()
    live = inp != 0
    zero_frac = float(((out == 0) & live).sum() / live.sum())
    n_live = int(live.sum())
    sigma = (VIT_DROPOUT * (1 - VIT_DROPOUT) / n_live) ** 0.5
    del inp, out, live
    del drop.forward
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    settled = settle(ff, {"input": x[:b]}, y[:b])
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    losses = [m["loss"] for m in settled]
    step = ff.train_step

    def recording(inputs, labels):
        m = step(inputs, labels)
        losses.append(m["loss"])
        return m

    ff.train_step = recording
    torch.cuda.synchronize()
    reset_kernel_launches(pk, fa, bk)
    t0 = time.perf_counter()
    hist = ff.fit(x[b:], y[b:], batch_size=b, epochs=1, verbose=False)
    wall = time.perf_counter() - t0  # fit synchronizes at the epoch's end
    launches = kernel_launches(pk, fa, bk)
    del ff.train_step
    peak = torch.cuda.max_memory_allocated()
    watch_op(drop, seen)
    ev = ff.eval_step({"input": x[:b]}, y[:b])
    eval_identity = bool(seen) and all(i is o for i, o in seen)
    seen.clear()
    del drop.forward
    logits = ff.forward({"input": x[:b]})
    loss_vals = [float(warm["loss"])] + [float(v) for v in losses]
    if not (np.isfinite(loss_vals).all() and np.isfinite(float(ev["loss"]))
            and tuple(logits.shape) == (b, VIT_CLASSES)
            and torch.isfinite(logits).all()):
        raise RuntimeError(f"vit: non-finite or misshapen results: losses "
                           f"{loss_vals}, eval {ev}, logits "
                           f"{tuple(logits.shape)}")
    if abs(zero_frac - VIT_DROPOUT) > 5 * sigma:
        raise RuntimeError(f"vit: Dropout zeroed {zero_frac} of its output, "
                           f"not within 5 sigma ({sigma}) of {VIT_DROPOUT}")
    if not eval_identity:
        raise RuntimeError("vit: Dropout in eval_step is not the identity")
    if any(launches.values()):
        raise RuntimeError(f"vit: the ViT path launched {launches}")
    if hist[0].train_all != b * VIT_FIT:
        raise RuntimeError(f"vit: fit scored {hist[0].train_all} samples")
    rec = {
        "phase": "vit", "card": card,
        "model": {"source": "ViT-B/16, Dosovitskiy et al. ICLR 2021 "
                            "(Table 1; Table 3 dropout), GAP head, via "
                            "torch.fx",
                  "hidden": 768, "layers": 12, "heads": 12, "mlp": 3072,
                  "patch": 16, "px": VIT_PX, "classes": VIT_CLASSES,
                  "dropout": VIT_DROPOUT, "batch": b,
                  "compute_dtype": "bfloat16",
                  "optimizer": "SGD(lr=0.01, wd=1e-4), the default",
                  "weights": "torch.manual_seed(0) module init, "
                             "copy_weights"},
        "op_counts": counts,
        "compile_s": compile_s, "warmup_step_s": warm_s,
        "capture_step_s": settle_s if settled else None,
        "fit_steps": VIT_FIT, "fit_wall_s": wall,
        "step_ms": wall / VIT_FIT * 1e3,
        "images_per_s": b * VIT_FIT / wall,
        "losses": loss_vals, "eval_loss": float(ev["loss"]),
        "peak_memory_gb": peak / 1e9,
        "dropout_zero_fraction": zero_frac,
        "dropout_zero_fraction_sigma": sigma,
        "dropout_elements": n_live,
        "dropout_eval_identity": eval_identity,
        "kernel_launches_in_fit": launches,
    }
    emit(rec)
    return ff, x[b:], y[b:], rec


def phase_vit_parity(torch, card: str) -> dict:
    """Two default-SGD steps of the small ViT, float32, dropout 0, on the
    card and on the CPU from the same module and batches."""
    _, SmallViT = vit_modules()
    torch.manual_seed(1)
    module = SmallViT()
    batch, steps = 4, 2
    ffs = {dev: build_vit(module, batch, 32, dev, "float32")
           for dev in ("cuda", "cpu")}
    rng = np.random.RandomState(1)
    x = rng.randn(batch * (steps + 1), 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, batch * (steps + 1)).astype(np.int32)
    logits = {dev: ff.forward({"input": x[:batch]}).cpu().numpy()
              for dev, ff in ffs.items()}
    losses = {dev: [] for dev in ffs}
    for i in range(steps):
        sl = slice(batch * (i + 1), batch * (i + 2))
        for dev, ff in ffs.items():
            losses[dev].append(float(ff.train_step({"input": x[sl]},
                                                   y[sl])["loss"]))
    diff = {"logits": float(np.abs(logits["cuda"] - logits["cpu"]).max()),
            "loss": max(abs(a - b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"])),
            "weights": 0.0}
    worst = None
    wg, wc = ffs["cuda"].get_weights(), ffs["cpu"].get_weights()
    for op, entries in wc.items():
        for k, v in entries.items():
            d = float(np.abs(wg[op][k] - v).max())
            if d > diff["weights"]:
                diff["weights"], worst = d, f"{op}.{k}"
    if not all(np.isfinite(losses["cuda"] + losses["cpu"])):
        raise RuntimeError(f"vit_parity: non-finite losses {losses}")
    over = {k: v for k, v in diff.items() if v > VIT_PARITY_TOL[k]}
    if over:
        raise RuntimeError(f"vit_parity: card vs CPU {over} over "
                           f"{VIT_PARITY_TOL} (worst weight {worst})")
    rec = {"phase": "vit_parity", "card": card, "batch": batch, "px": 32,
           "steps": steps, "dtype": "float32", "allow_tf32": False,
           "dropout": 0.0, "losses": losses, "max_diff": diff,
           "worst_weight": worst, "tolerance": VIT_PARITY_TOL,
           "compared": "logits of a forward, losses, every weight after "
                       "the steps"}
    emit(rec)
    return rec


def _vit_kernel_kind(name: str) -> str:
    """A device kernel's kind by name: convolutions (cuDNN's, FFT
    included), pools, GEMMs, softmax, RNG, concat, then _kind's copy
    (strided same-dtype), cast, memcpy, reduction and elementwise."""
    low = name.lower()
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "cudnn",
                              "implicit", "conv", "fft",
                              "pointwise_mult_and_sum_complex")):
        return "conv"
    if "pool" in low:
        return "pool"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "gemm"
    if "softmax" in low:
        return "softmax"
    if any(t in low for t in ("distribution", "uniform", "philox")):
        return "rng"
    if "catarraybatchedcopy" in low:
        return "concat"
    kind = _kind(name)
    return "copy" if kind == "layout" else kind


def _chain(evt):
    """evt and its enclosing CPU events, innermost first."""
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def _backward_node(evt):
    """(whether evt runs in the backward, the record of the autograd node
    it runs for or None).  The engine's own work for a node (the sums
    that undo a broadcast) sits beside the node's record (scope 1),
    under the engine's evaluate_function range."""
    for p in _chain(evt):
        if p.scope == 1:
            return True, p
        if p.name.startswith("autograd::engine::evaluate_function:"):
            return True, next((c for c in p.cpu_children if c.scope == 1),
                              None)
    return False, None


def _ffop_of(evt, fwd_kind: dict):
    """The PCG op label whose forward or backward launched the CPU event
    evt: an enclosing `ffop::<label>` range, or the autograd node made in
    one (matched by sequence number); else None."""
    backward, node = _backward_node(evt)
    if backward:
        return None if node is None else fwd_kind.get(
            (node.sequence_nr, node.fwd_thread))
    for p in _chain(evt):
        if p.name.startswith("ffop::"):
            return p.name[len("ffop::"):]
    return None


def profile_by_op(torch, ff, run, steps: int, label=None) -> dict:
    """torch.profiler over run() (`steps` train steps): device busy and
    idle, device time by PCG op (forward and backward) and kernel kind,
    and by stream.  Each op's forward runs in an `ffop::<label(op)>`
    range (the op type by default); its backward kernels are matched to
    it through the autograd sequence numbers.  Work launched from
    another thread than the ops' (the loader's copies) is "loader".  A
    captured train step runs eager in the window (a replay runs no
    host range to match its kernels to): the capture phase measures the
    captured steps."""
    with eager_steps(ff):
        return _profile_by_op(torch, ff, run, steps, label)


@contextlib.contextmanager
def eager_steps(ff):
    """ff's train steps eager inside (a step function built with
    capture off), its captured step function and record put back
    after."""
    from flexflow_tpu_torch.capture import CapturedStep

    ex = ff.executor
    step, status = ff._step_fn, ex.capture_status
    if isinstance(step, CapturedStep):
        keep_eager(ff)
    try:
        yield
    finally:
        ff._step_fn, ex.capture_status = step, status


def keep_eager(ff):
    """ff (compiled) with its train step built again with capture off:
    the eager side of a comparison; `capture_status` names that."""
    ff._step_fn = ff.executor.build_step(capture=False)
    return ff


def _profile_by_op(torch, ff, run, steps: int, label=None) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    label = label or (lambda op: op.op_type.value)
    for op in ff.operators.ops:
        fwd = op.forward

        def labelled(ins, ws, _fwd=fwd, _tag=f"ffop::{label(op)}", **kw):
            with record_function(_tag):
                return _fwd(ins, ws, **kw)

        op.forward = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for op in ff.operators.ops:
            del op.forward
    events = prof.events()
    # the device timeline also holds the ffop:: ranges as annotations
    # that span their kernels: those are not device work
    device = [e for e in events if "cuda" in str(e.device_type).lower()
              and not e.name.startswith("ffop::")
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("the profiler saw no device time")
    kernel_us = sum(e.time_range.elapsed_us() for e in device)
    busy_us = device_busy_us(device)
    cpu = [e for e in events if "cuda" not in str(e.device_type).lower()]
    op_threads = {e.thread for e in cpu if e.name.startswith("ffop::")}
    fwd_kind = {}
    for e in cpu:
        if e.sequence_nr >= 0:
            kind = _ffop_of(e, {})
            if kind is not None:
                fwd_kind.setdefault((e.sequence_nr, e.thread), kind)
    table, by_kind, names, attributed = {}, {}, {}, 0.0
    for e in cpu:
        if not e.kernels:
            continue
        backward = _backward_node(e)[0]
        if not backward and e.thread not in op_threads:
            # neither the ops' thread nor the autograd engine's
            op, phase = "loader", "forward"
        else:
            op = _ffop_of(e, fwd_kind) or "unattributed"
            phase = "backward" if backward else "forward"
        for k in e.kernels:
            kk = _vit_kernel_kind(k.name)
            by_kind[kk] = by_kind.get(kk, 0.0) + k.duration
            cell = table.setdefault(op, {}).setdefault(
                kk, {"forward": 0.0, "backward": 0.0, "launches": 0})
            cell[phase] += k.duration
            cell["launches"] += 1
            attributed += k.duration
            top = names.setdefault(op, {})
            us, n = top.get(k.name, (0.0, 0))
            top[k.name] = (us + k.duration, n + 1)

    def per_step(us):
        return us / 1e3 / steps

    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": per_step(busy_us),
        "device_kernel_ms_per_step": per_step(kernel_us),
        "device_idle_ms_per_step": (wall_ms - busy_us / 1e3) / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_events_per_step": len(device) / steps,
        "by_stream": by_stream(device, steps),
        "linked_to_host_ops_share": attributed / kernel_us,
        "by_kernel_kind_ms_per_step": {k: per_step(v) for k, v in
                                       sorted(by_kind.items())},
        "by_op_ms_per_step": {
            op: {kk: {"forward": per_step(c["forward"]),
                      "backward": per_step(c["backward"]),
                      "launches_per_step": c["launches"] / steps}
                 for kk, c in sorted(row.items())}
            for op, row in sorted(table.items())},
        "top_kernels_by_op": {
            op: [{"name": n[:100], "ms_per_step": per_step(us),
                  "launches_per_step": c / steps}
                 for n, (us, c) in sorted(top.items(),
                                          key=lambda kv: -kv[1][0])[:4]]
            for op, top in sorted(names.items())},
        "note": "device busy: the union of the device events' spans on "
                "every stream, kernel ms: their sum.  by_op: the PCG op "
                "whose forward (an ffop:: range) or backward (the "
                "autograd node made in that range) launched each kernel; "
                "loader: the prefetching loader's host-to-device copies "
                "(its own thread and stream); unattributed: the loss, "
                "metrics, optimizer and the executor's layout "
                "conversions and weight casts.  Kernel kinds by name: "
                "gemm (cuBLAS), conv (cuDNN, FFT included), pool, "
                "softmax, rng (Dropout's draws), concat, copy (strided same-dtype copies: layout "
                "conversions and what Transpose and Reshape force), "
                "cast, memcpy, reduction, elementwise",
    }


def phase_vit_profile(torch, card: str, ff, x, y, steps: int = 3) -> dict:
    """torch.profiler over `steps` full-width ViT-B/16 train steps fed
    by the prefetching loader: device busy and idle, and device time by
    PCG op type (forward and backward) and kernel kind."""
    rec = {"phase": "vit_profile", "card": card,
           "run": "train steps fed by the prefetching loader"}
    rec.update(profile_by_op(torch, ff,
                             loader_steps(ff, x, y, VIT_BATCH, steps),
                             steps))
    emit(rec)
    return rec


# -- the native model zoo: Unity's evaluation models through the calls of
# examples/python/native/*.py (FFConfig.from_args -> a models builder ->
# compile -> fit), each at its example's configuration
ZOO_STEPS = 3
ZOO_EMB = (100000, 100000, 100000, 100000)  # dlrm.py's and xdl.py's tables
SCE_METRICS = ("accuracy", "sparse_categorical_crossentropy")
MSE_METRICS = ("mean_squared_error",)


def _zoo_images(px, classes, name="input"):
    def data(rng, n):
        return ({name: rng.randn(n, 3, px, px).astype(np.float32)},
                rng.randint(0, classes, n).astype(np.int32))
    return data


def _zoo_recsys(dense):
    def data(rng, n):
        x = {f"sparse_input_{i}": rng.randint(0, v, size=(n, 1)).astype(
            np.int32) for i, v in enumerate(ZOO_EMB)}
        if dense:
            x["dense_input"] = rng.randn(n, dense).astype(np.float32)
        return x, rng.rand(n, 2).astype(np.float32)
    return data


def _zoo_candle(rng, n):
    return ({f"input_{i}": rng.randn(n, d).astype(np.float32)
             for i, d in enumerate((942, 5270, 2048))},
            rng.rand(n, 1).astype(np.float32))


def _zoo_transformer(rng, n):
    return ({"input": rng.randn(n, 512, 1024).astype(np.float32)},
            rng.rand(n, 512, 1).astype(np.float32))


def _zoo_mlp_data(rng, n):
    w_true = rng.randn(64, 10)
    x = rng.randn(n, 64).astype(np.float32)
    y = np.argmax(x @ w_true + 0.1 * rng.randn(n, 10), axis=1)
    return {"x": x}, y.astype(np.int32)


def _zoo_moe_data(rng, n):
    return ({"input": rng.randn(n, 784).astype(np.float32)},
            rng.randint(0, 10, size=n).astype(np.int32))


def _zoo_encoder_data(rng, n):
    return ({"input": rng.randn(n, 128, 64).astype(np.float32)},
            rng.randint(0, 10, size=(n, 128)).astype(np.int32))


def _build_mlp_example(ff, b):
    """examples/python/native/mlp.py's graph, through the layer calls."""
    from flexflow_tpu_torch import ActiMode

    x = ff.create_tensor([b, 64], name="x")
    t = ff.dense(x, 256, activation=ActiMode.RELU)
    t = ff.dense(t, 256, activation=ActiMode.RELU)
    return ff.softmax(ff.dense(t, 10))


def _zoo_builder(name, **kw):
    def build(ff, b):
        from flexflow_tpu_torch import models

        return getattr(models, name)(ff, batch_size=b, **kw)
    return build


# name -> (example, batch, build(ff, batch), SGD lr, loss, metrics,
# data(rng, n)).  Batch 64 is the examples' -b default; the Transformer
# runs at -b 8 (the Unity AE setting its docstring names), the MLP
# example sets 64 itself, build_moe_encoder takes its own defaults.
ZOO = {
    "inception_v3": ("examples/python/native/inception.py", 64,
                     _zoo_builder("build_inception_v3", num_classes=10,
                                  image_size=299),
                     0.001, "sparse_categorical_crossentropy", SCE_METRICS,
                     _zoo_images(299, 10)),
    "resnext50": ("examples/python/native/resnext.py", 64,
                  _zoo_builder("build_resnext50", num_classes=1000,
                               image_size=224),
                  0.001, "sparse_categorical_crossentropy", SCE_METRICS,
                  _zoo_images(224, 1000)),
    "dlrm": ("examples/python/native/dlrm.py", 64,
             _zoo_builder("build_dlrm", embedding_size=ZOO_EMB,
                          sparse_feature_size=64, dense_feature_dim=64,
                          mlp_bot=[64, 64], mlp_top=[64, 64, 2]),
             0.01, "mean_squared_error_avg", MSE_METRICS, _zoo_recsys(64)),
    "xdl": ("examples/python/native/xdl.py", 64,
            _zoo_builder("build_xdl", embedding_size=ZOO_EMB,
                         sparse_feature_size=64),
            0.01, "mean_squared_error_avg", MSE_METRICS, _zoo_recsys(0)),
    "candle_uno": ("examples/python/native/candle_uno.py", 64,
                   _zoo_builder("build_candle_uno",
                                input_dims=[942, 5270, 2048],
                                dense_layers=[4192] * 4,
                                dense_feature_layers=[4192] * 8),
                   0.001, "mean_squared_error_avg", MSE_METRICS,
                   _zoo_candle),
    "transformer": ("examples/python/native/transformer.py", 8,
                    _zoo_builder("build_transformer", seq_length=512,
                                 hidden_size=1024, num_layers=12,
                                 num_heads=16),
                    0.001, "mean_squared_error_avg", MSE_METRICS,
                    _zoo_transformer),
    "moe_mlp": ("examples/python/native/moe.py", 64,
                _zoo_builder("build_moe_mlp", input_dim=784, num_classes=10,
                             num_exp=5, num_select=2, hidden_size=64),
                0.001, "sparse_categorical_crossentropy", SCE_METRICS,
                _zoo_moe_data),
    "moe_encoder": ("flexflow_tpu_torch/models/moe.py build_moe_encoder "
                    "defaults", 8, _zoo_builder("build_moe_encoder"),
                    0.001, "sparse_categorical_crossentropy", SCE_METRICS,
                    _zoo_encoder_data),
    "mlp": ("examples/python/native/mlp.py", 64, _build_mlp_example, 0.05,
            "sparse_categorical_crossentropy", SCE_METRICS, _zoo_mlp_data),
    "alexnet": ("examples/python/native/alexnet_cifar10.py", 64,
                _zoo_builder("build_alexnet", num_classes=10,
                             image_size=64),
                0.01, "sparse_categorical_crossentropy", SCE_METRICS,
                _zoo_images(64, 10)),
    "resnet50": ("examples/python/native/resnet.py", 64,
                 _zoo_builder("build_resnet50", num_classes=10,
                              image_size=64),
                 0.001, "sparse_categorical_crossentropy", SCE_METRICS,
                 _zoo_images(64, 10)),
}


def build_zoo_model(name: str, device: str = "cuda", batch=None):
    """The example's calls: FFConfig.from_args(-b), the builder, compile
    with its SGD, loss and metrics."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer

    _, b, build, lr, loss, metrics, _ = ZOO[name]
    b = batch or b
    cfg = FFConfig.from_args(["-b", str(b), "--device", device])
    ff = FFModel(cfg)
    build(ff, cfg.batch_size)
    ff.compile(optimizer=SGDOptimizer(lr=lr), loss_type=loss,
               metrics=list(metrics))
    return ff


def zoo_data(name: str, batches: int, batch=None):
    _, b, _, _, _, _, data = ZOO[name]
    b = batch or b
    return b, data(np.random.RandomState(0), b * batches)


def moe_routing(torch, records) -> dict:
    """Dropped-pair share and expert load of the recorded (GroupBy op,
    assignment) pairs, per GroupBy op: the dispatch's own keep rule."""
    from flexflow_tpu_torch.ops.moe_dispatch import dispatch_indices

    out = {}
    for op, assign in records:
        n = op.params.n
        cap = op.outputs[0].shape.logical_shape[1]
        _, keep = dispatch_indices(assign, cap, n)
        row = out.setdefault(op.name, {"experts": n, "capacity": cap,
                                       "pairs": 0, "dropped": 0,
                                       "load": [0] * n})
        row["pairs"] += keep.numel()
        row["dropped"] += int((~keep).sum())
        counts = torch.bincount(assign.reshape(-1).long(), minlength=n)
        row["load"] = [a + int(c) for a, c in zip(row["load"],
                                                  counts.tolist())]
    for row in out.values():
        row["dropped_share"] = row["dropped"] / row["pairs"]
        row["load_share"] = [c / row["pairs"] for c in row["load"]]
    return out


def record_losses(ff) -> list:
    """Wrap ff.train_step (on the instance) to append each step's loss
    tensor to the list returned; `del ff.train_step` unwraps it."""
    losses, step = [], ff.train_step

    def recording(inputs, labels):
        m = step(inputs, labels)
        losses.append(m["loss"])
        return m

    ff.train_step = recording
    return losses


def phase_zoo(torch, pk, fa, bk, card: str) -> dict:
    """Each zoo model: one warm-up train_step and the capturing one (a
    captured step function), then fit(shuffle=True) over ZOO_STEPS
    batches through the prefetching loader; samples/s, peak memory,
    finite losses, MoE routing (of the warm-up step and of the capturing
    step, whose copy of the assignments each replay refreshes: the last
    fit step's); no hand-written kernel launches."""
    from flexflow_tpu_torch import OperatorType

    rows = {}
    for name, (example, *_rest) in ZOO.items():
        t0 = time.perf_counter()
        ff = build_zoo_model(name)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        b, (x, y) = zoo_data(name, 1 + ZOO_STEPS)
        routed = []
        groups = [op for op in ff.operators.ops
                  if op.op_type == OperatorType.GROUP_BY]
        for op in groups:
            fwd = op.forward

            def watched(ins, ws, _fwd=fwd, _op=op, **kw):
                routed.append((_op, ins[1].detach().clone()))
                return _fwd(ins, ws, **kw)

            op.forward = watched
        t0 = time.perf_counter()
        warm = ff.train_step({k: v[:b] for k, v in x.items()}, y[:b])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        settled = settle(ff, {k: v[:b] for k, v in x.items()}, y[:b])
        losses = record_losses(ff)
        torch.cuda.synchronize()
        reset_kernel_launches(pk, fa, bk)
        t0 = time.perf_counter()
        hist = ff.fit({k: v[b:] for k, v in x.items()}, y[b:],
                      batch_size=b, epochs=1, shuffle=True, verbose=False)
        wall = time.perf_counter() - t0  # fit synchronizes at its end
        launches = kernel_launches(pk, fa, bk)
        peak = torch.cuda.max_memory_allocated()
        del ff.train_step
        for op in groups:
            del op.forward
        loss_vals = [float(m["loss"]) for m in [warm] + settled] + [
            float(v) for v in losses]
        if len(loss_vals) != 1 + len(settled) + ZOO_STEPS or not np.isfinite(
                loss_vals).all():
            raise RuntimeError(f"zoo {name}: losses {loss_vals}")
        if any(launches.values()):
            raise RuntimeError(f"zoo {name}: the zoo path launched "
                               f"{launches}")
        if hist[0].train_all <= 0:
            raise RuntimeError(f"zoo {name}: fit scored no sample")
        row = {"example": example, "batch": b,
               "params": sum(w.numel() for e in ff._weights.values()
                             for w in e.values()),
               "ops": len(ff.operators.ops),
               "compile_s": compile_s, "warmup_step_s": warm_s,
               "fit_steps": ZOO_STEPS, "fit_wall_s": wall,
               "step_ms": wall / ZOO_STEPS * 1e3,
               "samples_per_s": b * ZOO_STEPS / wall,
               "peak_memory_gb": peak / 1e9, "losses": loss_vals,
               "kernel_launches_in_fit": launches}
        if groups:
            row["moe_routing"] = moe_routing(torch, routed)
        rows[name] = row
        emit({"phase": "zoo", "card": card, "model": name, **row})
        del ff, x, y, routed
        torch.cuda.empty_cache()
    rec = {"phase": "zoo", "card": card, "models": sorted(rows),
           "samples_per_s": {k: r["samples_per_s"] for k, r in rows.items()},
           "launches": {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "P1": 0},
           "note": "float32, one device, fit(shuffle=True) over "
                   f"{ZOO_STEPS} batches after a warm-up train_step; "
                   "samples/s over fit's wall time, the loader's start "
                   "included"}
    emit(rec)
    return rec


# tiny configurations of every zoo builder (tests/test_model_zoo.py's),
# card against CPU
ZOO_TINY = {
    "build_resnet50": dict(num_classes=4, image_size=32,
                           stage_blocks=(1, 1), base_channels=8),
    "build_resnext50": dict(num_classes=4, image_size=32,
                            stage_blocks=(1, 1), groups=4, base_channels=8),
    "build_inception_v3": dict(num_classes=4, image_size=75,
                               channel_scale=1 / 16),
    "build_dlrm": dict(embedding_size=(50, 60, 70), sparse_feature_size=8,
                       dense_feature_dim=8, mlp_bot=[8, 8], mlp_top=[16, 2]),
    "build_xdl": dict(embedding_size=(40, 40), sparse_feature_size=8,
                      mlp_dims=[16, 2]),
    "build_candle_uno": dict(input_dims=[12, 20, 8], dense_layers=[16, 16],
                             dense_feature_layers=[16, 16]),
    "build_mlp_unify": dict(input_dim=16, hidden_dims=[32, 32, 4]),
    "build_moe_mlp": dict(input_dim=16, num_classes=4, num_exp=4,
                          num_select=2, hidden_size=16),
    "build_moe_encoder": dict(seq_length=8, hidden_size=16, num_layers=1,
                              num_heads=4, num_exp=4, num_select=2,
                              num_classes=4),
    "build_alexnet": dict(num_classes=4, image_size=64),
    "build_transformer": dict(seq_length=8, hidden_size=16, num_layers=2,
                              num_heads=4),
}
# card against CPU, float32, TF32 off: cuDNN's and cuBLAS's sums in other
# orders than oneDNN's and MKL's (~1e-6 relative) through 2 SGD steps
ZOO_PARITY_TOL = {"output": 1e-4, "loss": 1e-4, "weights": 1e-4}


def _tiny_feed(ff, rng):
    """Seeded inputs for every source op and labels for the sink."""
    feed = {}
    for op in ff.layers.source_ops():
        shape = op.outputs[0].shape.logical_shape
        if op.outputs[0].dtype.value == "int32":
            # ids below the smallest table that reads them
            vocab = min(c.params.num_entries for c in ff.layers.ops
                        if op.outputs[0] in c.inputs)
            feed[op.name] = rng.randint(0, vocab, size=shape).astype(
                np.int32)
        else:
            feed[op.name] = rng.randn(*shape).astype(np.float32)
    sink = ff.layers.sink_op().outputs[0].shape.logical_shape
    if ff.loss.loss_type.value.startswith("sparse"):
        labels = rng.randint(0, sink[-1], size=sink[:-1]).astype(np.int32)
    else:
        labels = rng.rand(*sink).astype(np.float32)
    return feed, labels


def phase_zoo_parity(torch, card: str) -> dict:
    """Every zoo builder at its tiny size, float32: the forward and 2
    SGD steps on the card against the port on the CPU with the same
    weights and batches."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer, models

    batch, steps = 8, 2
    out, worst = {}, {}
    for name, kw in ZOO_TINY.items():
        regress = name in ("build_dlrm", "build_xdl", "build_candle_uno",
                           "build_transformer")
        loss = ("mean_squared_error_avg" if regress
                else "sparse_categorical_crossentropy")
        metrics = MSE_METRICS if regress else ("accuracy",)
        ffs = {}
        for dev in ("cuda", "cpu"):
            ff = FFModel(FFConfig(batch_size=batch, device=dev))
            getattr(models, name)(ff, batch_size=batch, **kw)
            ff.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=loss,
                       metrics=list(metrics))
            ffs[dev] = ff
        ffs["cpu"].set_weights(ffs["cuda"].get_weights())
        rng = np.random.RandomState(1)
        feeds = [_tiny_feed(ffs["cpu"], rng)
                 for _ in range(1 + steps)]
        outs = {dev: ff.forward(feeds[0][0]).cpu().numpy()
                for dev, ff in ffs.items()}
        losses = {dev: [] for dev in ffs}
        for feed, y in feeds[1:]:
            for dev, ff in ffs.items():
                losses[dev].append(float(ff.train_step(feed, y)["loss"]))
        diff = {"output": float(np.abs(outs["cuda"] - outs["cpu"]).max()),
                "loss": max(abs(a - b) for a, b in zip(losses["cuda"],
                                                       losses["cpu"])),
                "weights": 0.0}
        wg, wc = ffs["cuda"].get_weights(), ffs["cpu"].get_weights()
        for op, entries in wc.items():
            for k, v in entries.items():
                d = float(np.abs(wg[op][k] - v).max())
                if d > diff["weights"]:
                    diff["weights"], worst[name] = d, f"{op}.{k}"
        if not all(np.isfinite(losses["cuda"] + losses["cpu"])):
            raise RuntimeError(f"zoo_parity {name}: losses {losses}")
        over = {k: v for k, v in diff.items() if v > ZOO_PARITY_TOL[k]}
        if over:
            raise RuntimeError(f"zoo_parity {name}: card vs CPU {over} over "
                               f"{ZOO_PARITY_TOL} (worst weight "
                               f"{worst.get(name)})")
        out[name] = diff
    rec = {"phase": "zoo_parity", "card": card, "batch": batch,
           "steps": steps, "dtype": "float32", "allow_tf32": False,
           "max_diff": out, "worst_weight": worst,
           "tolerance": ZOO_PARITY_TOL,
           "compared": "the sink output of a forward, losses, every "
                       "weight after the steps"}
    emit(rec)
    return rec


def phase_zoo_profile(torch, card: str, steps: int = 3) -> dict:
    """torch.profiler over `steps` train steps of Inception-v3 (299 px,
    batch 64) and of ResNeXt-50 (224 px, batch 64) fed by the
    prefetching loader: device time by PCG op type and kernel kind, the
    layout copies, and ResNeXt's grouped convolutions apart."""
    recs = {}
    for name, label in (
            ("inception_v3", None),
            ("resnext50", lambda op: (
                "conv2d_grouped" if op.op_type.value == "conv2d"
                and op.params.groups > 1 else op.op_type.value))):
        ff = build_zoo_model(name)
        b, (x, y) = zoo_data(name, 1 + steps)
        run = loader_steps(ff, x, y, b, steps)
        torch.cuda.synchronize()
        rec = {"phase": "zoo_profile", "card": card, "model": name,
               "batch": b, "run": "train steps fed by the prefetching "
                                  "loader"}
        rec.update(profile_by_op(torch, ff, run, steps, label))
        copies = {op: row["copy"] for op, row in
                  rec["by_op_ms_per_step"].items() if "copy" in row}
        rec["layout_copies"] = copies
        rec["layout_plan"] = layout_conversions(ff)
        emit(rec)
        recs[name] = rec
        del ff, x, y, run
        torch.cuda.empty_cache()
    return recs


def layout_conversions(ff) -> dict:
    """The executor's NCHW<->NHWC conversions of one forward, by the
    layout pass: a 4-D input of an NHWC op stored logical (to_nhwc), an
    NHWC-stored input of a logical op (to_nchw)."""
    from flexflow_tpu_torch.pcg.layout import NHWC

    ex = ff.executor
    out = {"to_nhwc": 0, "to_nchw": 0}
    for op in ex.order:
        want = ex.op_layout.get(op.guid)
        for t in op.inputs:
            if t.shape.logical_rank != 4:
                continue
            stored = ex.t_layout.get(t.guid)
            if want == NHWC and stored != NHWC:
                out["to_nhwc"] += 1
            elif want is None and stored == NHWC:
                out["to_nchw"] += 1
    return out


# -- the sequence-model and frontend slice: the NMT at Luong et al.'s
# widths, GPT generation on the dense KV cache, the Keras examples, the
# ONNX-imported ResNet-50, each card against the CPU at a tiny size
# Luong, Pham & Manning (EMNLP 2015) §4.1: 4 LSTM layers a side, 1000
# cells, 1000-dim embeddings, 50 000-word vocabularies, sentences of up
# to 50 tokens, batch 128
NMT_WIDTH = dict(src_len=50, tgt_len=50, src_vocab=50000, tgt_vocab=50000,
                 embed_dim=1000, hidden_size=1000, num_layers=4)
NMT_BATCH, NMT_FIT, NMT_LR, NMT_DECODE = 128, 3, 0.1, 8
# the full-width step's gradients, card against CPU from the same
# weights and batch, float32, TF32 off: per weight, the largest
# difference over the largest gradient (cuBLAS's and MKL's sums in
# other orders, through 50 steps of BPTT over 4 layers a side)
NMT_GRAD_TOL = 1e-4
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_BEAM = 8, 64, 32, 4
GEN_BEAM_TOL = 1e-4
KERAS_BATCHES = 4
ONNX_BATCH, ONNX_FIT = 64, 3
# the ONNX-imported ResNet-50 against the torch module in eval mode on
# the card, float32, TF32 off: the same cuDNN convolutions in
# channels_last with BatchNorm applied by P1 (x * scale + shift against
# torch's folded form), relative to the logits' scale
ONNX_TOL = 1e-4
# card against CPU, float32, TF32 off: the zoo_parity tolerance (cuBLAS's
# and MKL's sums in other orders, through 2 SGD steps); greedy tokens and
# beams must be equal
SEQ_PARITY_TOL = {"output": 1e-4, "loss": 1e-4, "weights": 1e-4}
NMT_TINY = dict(src_len=6, tgt_len=5, src_vocab=17, tgt_vocab=13,
                embed_dim=8, hidden_size=12, num_layers=2)
GPT_TINY = dict(seq_length=16, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, vocab_size=97)


def nmt_flops(batch, src_len, tgt_len, src_vocab, tgt_vocab, embed_dim,
              hidden_size, num_layers) -> dict:
    """Forward multiply-adds x 2 of build_nmt: the LSTMs' gate products,
    the attention's two batch matmuls, its combine and the vocabulary
    projection; a train step is ~3x the forward."""
    h, d = hidden_size, embed_dim
    lstm = sum(2 * batch * s * ((d if i == 0 else h) + h) * 4 * h
               for s in (src_len, tgt_len) for i in range(num_layers))
    attn = 2 * 2 * batch * tgt_len * src_len * h
    comb = 2 * batch * tgt_len * 2 * h * h
    vocab = 2 * batch * tgt_len * h * tgt_vocab
    fwd = lstm + attn + comb + vocab
    return {"lstm": lstm, "attention": attn + comb, "vocab_proj": vocab,
            "forward": fwd, "train_step": 3 * fwd}


def nmt_data(rng, n, src_len, tgt_len, src_vocab, tgt_vocab, **_):
    """A copy task: labels are the source's first tgt_len tokens, the
    decoder reads them shifted right behind BOS (id 1)."""
    src = rng.randint(2, src_vocab, (n, src_len)).astype(np.int32)
    labels = src[:, :tgt_len] % tgt_vocab
    tgt = np.concatenate([np.ones((n, 1), np.int32), labels[:, :-1]], 1)
    return {"src": src, "tgt": tgt.astype(np.int32)}, labels.astype(
        np.int32)


def build_nmt_model(device: str, batch: int, width=None):
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer)
    from flexflow_tpu_torch.models import build_nmt

    ff = FFModel(FFConfig(batch_size=batch, device=device))
    build_nmt(ff, batch_size=batch, **(width or NMT_WIDTH))
    ff.compile(optimizer=SGDOptimizer(lr=NMT_LR),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY,
                        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    return ff


def record_grads(ff) -> dict:
    """Wrap ff's optimizer update (on the instance) to copy each step's
    gradients to the host into the {op: {name: array}} returned (the
    last step's); `del ff.executor.optimizer.update` unwraps it."""
    opt, grads = ff.executor.optimizer, {}
    update = opt.update

    def recording(weights, g, opt_state):
        grads.clear()
        grads.update({op: {k: v.detach().cpu().numpy()
                           for k, v in e.items()} for op, e in g.items()})
        return update(weights, g, opt_state)

    opt.update = recording
    return grads


def grad_rel_diff(a: dict, b: dict) -> dict:
    """{op.name: max|a - b| / max|b|} over the weights of b."""
    return {f"{op}.{k}": float(np.abs(a[op][k] - v).max()
                               / max(float(np.abs(v).max()), 1e-30))
            for op, e in b.items() for k, v in e.items()}


def nmt_cpu_grads(init, batch, labels, width=None) -> dict:
    """One train_step's gradients and loss on the CPU (at full width by
    default) from the weights `init`."""
    ff = build_nmt_model("cpu", len(labels), width)
    ff.set_weights(init)
    grads = record_grads(ff)
    loss = float(ff.train_step(batch, labels)["loss"])
    return {"loss": loss, "grads": grads}


def phase_nmt(torch, pk, fa, bk, card: str) -> dict:
    """build_nmt at Luong et al.'s widths through compile (SGD, the
    sparse cross-entropy on the softmax), one warm-up train_step whose
    gradients are held against the same step on the CPU (within
    NMT_GRAD_TOL of each weight's largest gradient), fit over NMT_FIT
    batches through the prefetching loader, a profile of
    NMT_FIT loader-fed steps, then greedy_decode of NMT_DECODE
    sources."""
    from flexflow_tpu_torch.models import greedy_decode

    b = NMT_BATCH
    t0 = time.perf_counter()
    ff = build_nmt_model("cuda", b)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    params = sum(w.numel() for e in ff._weights.values() for w in e.values())
    init = ff.get_weights()
    x, y = nmt_data(np.random.RandomState(0), (2 + NMT_FIT) * b,
                    **NMT_WIDTH)
    grads = record_grads(ff)
    t0 = time.perf_counter()
    warm = ff.train_step({k: v[:b] for k, v in x.items()}, y[:b])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del ff.executor.optimizer.update
    t0 = time.perf_counter()
    cpu = nmt_cpu_grads(init, {k: v[:b] for k, v in x.items()}, y[:b])
    cpu_step_s = time.perf_counter() - t0
    grad_diff = grad_rel_diff(grads, cpu["grads"])
    worst = max(grad_diff, key=grad_diff.get)
    if set(grads) != set(cpu["grads"]) or grad_diff[worst] > NMT_GRAD_TOL \
            or abs(float(warm["loss"]) - cpu["loss"]) > NMT_GRAD_TOL:
        raise RuntimeError(
            f"nmt: the card's step is not the CPU's: {worst} gradients "
            f"differ by {grad_diff[worst]} of their scale, losses "
            f"{float(warm['loss'])} and {cpu['loss']}")
    del grads, cpu
    torch.cuda.reset_peak_memory_stats()
    settled = settle(ff, {k: v[:b] for k, v in x.items()}, y[:b])
    losses = record_losses(ff)
    torch.cuda.synchronize()
    reset_kernel_launches(pk, fa, bk)
    t0 = time.perf_counter()
    hist = ff.fit({k: v[b:(1 + NMT_FIT) * b] for k, v in x.items()},
                  y[b:(1 + NMT_FIT) * b], batch_size=b, epochs=1,
                  verbose=False)
    wall = time.perf_counter() - t0  # fit synchronizes at its end
    launches = kernel_launches(pk, fa, bk)
    peak = torch.cuda.max_memory_allocated()
    del ff.train_step
    loss_vals = [float(m["loss"]) for m in [warm] + settled] + [
        float(v) for v in losses]
    if (len(loss_vals) != 1 + len(settled) + NMT_FIT
            or not np.isfinite(loss_vals).all()):
        raise RuntimeError(f"nmt: losses {loss_vals}")
    if any(launches.values()):
        raise RuntimeError(f"nmt: the NMT path launched {launches}")
    if hist[0].train_all != NMT_FIT * b * NMT_WIDTH["tgt_len"]:
        raise RuntimeError(f"nmt: fit scored {hist[0].train_all} tokens")
    # at init the model's outputs are near uniform (the loss sits at
    # ln(tgt_vocab)), so the steps show in the weights
    moved = {op: max(float(np.abs(v - init[op][k]).max())
                     for k, v in e.items())
             for op, e in ff.get_weights().items()}
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"nmt: weights that did not move: {moved}")
    flops = nmt_flops(b, **NMT_WIDTH)
    prof = profile_by_op(torch, ff, loader_steps(ff, x, y, b, NMT_FIT),
                         NMT_FIT)
    src = x["src"][:NMT_DECODE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_decode(ff, src, bos_id=1)
    decode_s = time.perf_counter() - t0
    if out.shape != (NMT_DECODE, NMT_WIDTH["tgt_len"]) or not (
            (out[:, 0] == 1).all() and (out >= 0).all()
            and (out < NMT_WIDTH["tgt_vocab"]).all()):
        raise RuntimeError(f"nmt: greedy_decode gave {out}")
    # the decode's first token is the argmax of one forward's first row
    first = ff.forward({"src": src, "tgt": np.pad(
        out[:, :1], ((0, 0), (0, NMT_WIDTH["tgt_len"] - 1)))})
    if not np.array_equal(first[:, 0].argmax(-1).cpu().numpy(), out[:, 1]):
        raise RuntimeError("nmt: greedy_decode's first step is not the "
                           "forward's argmax")
    rec = {"phase": "nmt", "card": card, "config": NMT_WIDTH, "batch": b,
           "lr": NMT_LR, "params": params, "flops": flops,
           "compile_s": compile_s, "warmup_step_s": warm_s,
           "grad_check": {"tolerance": NMT_GRAD_TOL,
                          "worst": worst, "worst_rel_diff": grad_diff[worst],
                          "rel_diff": grad_diff,
                          "cpu_step_s": cpu_step_s},
           "fit_steps": NMT_FIT, "fit_wall_s": wall,
           "step_ms": wall / NMT_FIT * 1e3,
           "samples_per_s": b * NMT_FIT / wall,
           "target_tokens_per_s": b * NMT_WIDTH["tgt_len"] * NMT_FIT / wall,
           "achieved_tflops": flops["train_step"] * NMT_FIT / wall / 1e12,
           "peak_memory_gb": peak / 1e9, "losses": loss_vals,
           "ln_tgt_vocab": float(np.log(NMT_WIDTH["tgt_vocab"])),
           "max_weight_change": moved,
           "kernel_launches_in_fit": launches,
           "greedy_decode": {"sources": NMT_DECODE, "wall_s": decode_s,
                             "tokens_per_s": NMT_DECODE * (
                                 NMT_WIDTH["tgt_len"] - 1) / decode_s,
                             "forwards": NMT_WIDTH["tgt_len"] - 1},
           "profile": {k: prof[k] for k in (
               "wall_ms_per_step", "device_busy_ms_per_step",
               "device_kernel_ms_per_step", "device_idle_share",
               "device_events_per_step", "by_kernel_kind_ms_per_step")},
           "profile_by_op_ms_per_step": prof["by_op_ms_per_step"],
           "note": "float32, TF32 off; step_ms over fit's wall time with "
                   "the loader's start; device events per step (kernels "
                   "and copies) from the profile"}
    emit(rec)
    del ff
    torch.cuda.empty_cache()
    return rec


def cache_bytes(ffd) -> int:
    return sum(v.numel() * v.element_size() for e in ffd._state.values()
               for k, v in e.items() if k in ("k_cache", "v_cache"))


def first_divergence(a: np.ndarray, b: np.ndarray, start: int):
    """(row, position) of the first token where a and b differ, or
    None."""
    diff = np.argwhere(a[:, start:] != b[:, start:])
    if not len(diff):
        return None
    row = int(diff[np.argmin(diff[:, 1] * len(a) + diff[:, 0])][0])
    return row, start + int(np.argmax(a[row, start:] != b[row, start:]))


def greedy_equal(name: str, want: np.ndarray, got: np.ndarray,
                 plen: int):
    """Greedy tokens of two forms of one model must be equal: raise at
    the first generated position where they differ."""
    at = first_divergence(want, got, plen)
    if at is not None:
        r, p = at
        raise RuntimeError(
            f"generate: {name} differs from gpt_generate at row {r}, "
            f"position {p}: {got[r, p]} against {want[r, p]}")


def phase_generate(torch, pk, fa, bk, card: str, paged=None) -> dict:
    """Full-width GPT-2-small (the serve phase's model and weights),
    batch GEN_BATCH, GEN_PROMPT-token prompts, GEN_NEW new tokens:
    gpt_generate (the re-forward loop at seq 1024), then the dense
    decode twin with gpt_generate_cached and gpt_generate_scan; greedy
    tokens equal across the three; gpt_beam_search and
    gpt_beam_search_cached (beam GEN_BEAM) on one prompt agree in tokens
    and score; a profile of the dense decode step beside the paged
    one's (`paged`, the profile phase's record)."""
    from flexflow_tpu_torch import decoding as D
    from flexflow_tpu_torch.models import gpt_beam_search, gpt_generate

    ff, _ = build_model("cuda")
    rng = np.random.RandomState(3)
    prompts = rng.randint(0, WIDTH["vocab_size"],
                          (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    total = GEN_PROMPT + GEN_NEW
    reset_kernel_launches(pk, fa, bk)
    runs, toks = {}, {}

    def run(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        runs[name] = {"wall_s": time.perf_counter() - t0}
        return out

    toks["gpt_generate"] = run("gpt_generate", gpt_generate, ff, prompts,
                               GEN_NEW)
    ffd = D.make_gpt_decoder(ff)
    toks["gpt_generate_cached"] = run("gpt_generate_cached",
                                      D.gpt_generate_cached, ffd, prompts,
                                      GEN_NEW)
    toks["gpt_generate_scan"] = run("gpt_generate_scan",
                                    D.gpt_generate_scan, ffd, prompts,
                                    GEN_NEW)
    for name, t in toks.items():
        if t.shape != (GEN_BATCH, total) or not np.array_equal(
                t[:, :GEN_PROMPT], prompts):
            raise RuntimeError(f"generate: {name} gave shape {t.shape}")
        runs[name]["tokens_per_s"] = GEN_BATCH * GEN_NEW / runs[name][
            "wall_s"]
    for name in ("gpt_generate_cached", "gpt_generate_scan"):
        greedy_equal(name, toks["gpt_generate"], toks[name], GEN_PROMPT)
    kv_bytes = cache_bytes(ffd)
    want_bytes = (2 * WIDTH["num_layers"] * GEN_BATCH * WIDTH["seq_length"]
                  * WIDTH["hidden_size"] * 4)
    if kv_bytes != want_bytes:
        raise RuntimeError(f"generate: caches hold {kv_bytes} bytes")
    # beam search on one prompt, both forms
    prompt = prompts[:1]
    btoks, bscore = run("gpt_beam_search", gpt_beam_search, ff, prompt,
                        GEN_NEW, beam_size=GEN_BEAM)
    ffd4 = D.make_gpt_decoder(ff, batch_size=GEN_BEAM)
    ctoks, cscores = run("gpt_beam_search_cached", D.gpt_beam_search_cached,
                         ffd4, prompt, GEN_NEW, beam_size=GEN_BEAM)
    if not np.array_equal(ctoks[0], btoks) or abs(
            cscores[0] - bscore) > GEN_BEAM_TOL:
        raise RuntimeError(
            f"generate: beam search forms disagree: {btoks.tolist()} "
            f"{bscore} against {ctoks[0].tolist()} {cscores[0]}")
    for name in ("gpt_beam_search", "gpt_beam_search_cached"):
        runs[name]["tokens_per_s"] = GEN_NEW / runs[name]["wall_s"]
    launches = kernel_launches(pk, fa, bk)
    if any(launches.values()):
        raise RuntimeError(f"generate: the dense path launched {launches}")
    # the dense decode step at positions 64.., as the cached loop runs it
    ffd.reset_decode_state()
    tok = prompts[:, :1]

    def step(k):
        ffd.decode_step({"input": tok, "positions": np.full(
            (GEN_BATCH, 1), k, np.int32)})

    for k in range(GEN_PROMPT):
        step(k)
    torch.cuda.synchronize()

    def twenty_steps():
        for k in range(20):
            step(GEN_PROMPT + k)

    dense = profile_by_op(torch, ffd, twenty_steps, 20)
    rec = {"phase": "generate", "card": card, "batch": GEN_BATCH,
           "prompt": GEN_PROMPT, "new_tokens": GEN_NEW, "beam": GEN_BEAM,
           "runs": runs, "greedy_equal": True,
           "beam_score": bscore, "beam_cached_score": float(cscores[0]),
           "kv_cache_bytes": kv_bytes, "kernel_launches": launches,
           "dense_decode_step": {k: dense[k] for k in (
               "wall_ms_per_step", "device_busy_ms_per_step",
               "device_idle_share", "device_events_per_step",
               "by_kernel_kind_ms_per_step")},
           "dense_decode_step_by_op_ms": dense["by_op_ms_per_step"],
           "paged_decode_step": None if paged is None else {
               k: paged[k] for k in ("wall_ms_per_step",
                                     "device_busy_ms_per_step",
                                     "device_idle_share")},
           "note": "float32, TF32 off; tokens/s = new tokens over the "
                   "call's wall time (the prompt's pass included); the "
                   "dense step profiled at positions 64-83 with all 8 "
                   "rows live, the paged one (profile phase) at mixed "
                   "positions up to 1023"}
    emit(rec)
    del ff, ffd, ffd4
    torch.cuda.empty_cache()
    return rec


def keras_models(K):
    """{name: (build(config) -> uncompiled model, optimizer, loss,
    metrics, dataset)}: each model of examples/python/keras/*.py (their
    layers, batch 64, optimizer, loss and metrics; callback_demo's
    callbacks but VerifyMetrics, whose floor a few batches need not
    reach), and the Embedding -> LSTM -> Dense classifier of
    tests/test_keras_frontend.py at the Reuters loader's default shapes
    and the widths of Keras's examples/imdb_lstm.py (batch 32)."""
    sce, acc = "sparse_categorical_crossentropy", ["accuracy"]

    def seq(layers, shape):
        return lambda cfg: K.Sequential(layers(), input_shape=shape,
                                        config=cfg)

    def functional(body, shape):
        def build(cfg):
            inp = K.Input(shape=shape)
            return K.Model(inp, body(inp), config=cfg)
        return build

    def alexnet(inp):
        t = K.Conv2D(64, (5, 5), strides=(1, 1), padding="same",
                     activation="relu")(inp)
        t = K.MaxPooling2D((3, 3), strides=(2, 2))(t)
        t = K.Conv2D(192, (5, 5), strides=(1, 1), padding="same",
                     activation="relu")(t)
        t = K.MaxPooling2D((3, 3), strides=(2, 2))(t)
        t = K.Conv2D(384, (3, 3), padding="same", activation="relu")(t)
        t = K.Conv2D(256, (3, 3), padding="same", activation="relu")(t)
        t = K.Conv2D(256, (3, 3), padding="same", activation="relu")(t)
        t = K.MaxPooling2D((3, 3), strides=(2, 2))(t)
        t = K.Flatten()(t)
        t = K.Dense(1024, activation="relu")(t)
        t = K.Dropout(0.5)(t)
        t = K.Dense(1024, activation="relu")(t)
        return K.Dense(10, activation="softmax")(t)

    def cifar_cnn(inp):
        t = K.Conv2D(32, (3, 3), padding="same", activation="relu")(inp)
        t = K.Conv2D(32, (3, 3), padding="same", activation="relu")(t)
        t = K.MaxPooling2D((2, 2), strides=(2, 2))(t)
        t = K.Conv2D(64, (3, 3), padding="same", activation="relu")(t)
        t = K.Conv2D(64, (3, 3), padding="same", activation="relu")(t)
        t = K.MaxPooling2D((2, 2), strides=(2, 2))(t)
        t = K.Flatten()(t)
        t = K.Dense(256, activation="relu")(t)
        return K.Dense(10, activation="softmax")(t)

    def cifar_concat(inp):
        a = K.Conv2D(32, (3, 3), padding="same", activation="relu")(inp)
        b = K.Conv2D(32, (5, 5), padding="same", activation="relu")(inp)
        t = K.Concatenate(axis=1)([a, b])
        t = K.MaxPooling2D((2, 2), strides=(2, 2))(t)
        t = K.Conv2D(64, (3, 3), padding="same", activation="relu")(t)
        t = K.MaxPooling2D((2, 2), strides=(2, 2))(t)
        t = K.Flatten()(t)
        t = K.Dense(128, activation="relu")(t)
        return K.Dense(10, activation="softmax")(t)

    def mnist_concat(inp):
        a = K.Dense(128, activation="relu")(inp)
        b = K.Dense(128, activation="sigmoid")(inp)
        t = K.Concatenate(axis=1)([a, b])
        t = K.Dense(64, activation="relu")(t)
        return K.Dense(10, activation="softmax")(t)

    def elementwise(inp):
        a = K.Dense(64, activation="relu")(inp)
        b = K.Dense(64, activation="tanh")(inp)
        merged = K.Concatenate(axis=1)([
            K.Add()([a, b]), K.Subtract()([a, b]), K.Multiply()([a, b])])
        t = K.Dense(32, activation="relu")(merged)
        return K.Dense(1)(t)

    return {
        "callback_demo": (seq(lambda: [
            K.Dense(256, activation="relu"),
            K.Dense(10, activation="softmax")], (784,)),
            "sgd", sce, acc, "mnist_flat", 64),
        "elementwise": (functional(elementwise, (32,)), "adam",
                        "mean_squared_error", ["mean_squared_error"],
                        "regression", 64),
        "func_cifar10_alexnet": (functional(alexnet, (3, 32, 32)), "sgd",
                                 sce, acc, "cifar10", 64),
        "func_cifar10_cnn": (functional(cifar_cnn, (3, 32, 32)), "sgd",
                             sce, acc, "cifar10", 64),
        "func_cifar10_cnn_concat": (functional(cifar_concat, (3, 32, 32)),
                                    "sgd", sce, acc, "cifar10", 64),
        "func_mnist_mlp_concat": (functional(mnist_concat, (784,)), "adam",
                                  sce, acc, "mnist_flat", 64),
        "seq_mnist_cnn": (seq(lambda: [
            K.Conv2D(32, (3, 3), strides=(1, 1), padding="same",
                     activation="relu"),
            K.Conv2D(64, (3, 3), strides=(1, 1), padding="same",
                     activation="relu"),
            K.MaxPooling2D((2, 2), strides=(2, 2)), K.Flatten(),
            K.Dense(128, activation="relu"), K.Dropout(0.25),
            K.Dense(10, activation="softmax")], (1, 28, 28)),
            "adam", sce, acc, "mnist_image", 64),
        "seq_mnist_mlp": (seq(lambda: [
            K.Dense(256, activation="relu"), K.Dropout(0.2),
            K.Dense(128, activation="relu"),
            K.Dense(10, activation="softmax")], (784,)),
            "adam", sce, acc, "mnist_flat", 64),
        "seq_reuters_mlp": (seq(lambda: [
            K.Dense(512, activation="relu"), K.Dropout(0.5),
            K.Dense(46, activation="softmax")], (2000,)),
            "adam", sce, acc, "reuters_bow", 64),
        "lstm_reuters": (lambda cfg: K.Sequential([
            K.Embedding(10000, 128, input_length=200),
            K.LSTM(128, return_sequences=False),
            K.Dense(46, activation="softmax")], config=cfg),
            "sgd", sce, acc, "reuters_ids", 32),
    }


def keras_data(ds, kind: str, n: int):
    """(x, y, synthetic flag) as each example prepares its dataset."""
    if kind == "cifar10":
        (x, y), _ = ds.cifar10.load_data(n)
        return (x.astype(np.float32) / 255.0, y.ravel().astype(np.int32),
                ds.cifar10.synthetic)
    if kind.startswith("mnist"):
        (x, y), _ = ds.mnist.load_data(n)
        shape = (len(x), 784) if kind == "mnist_flat" else (len(x), 1, 28,
                                                             28)
        return (x.reshape(shape).astype(np.float32) / 255.0,
                y.astype(np.int32), ds.mnist.synthetic)
    if kind == "reuters_bow":  # seq_reuters_mlp's binary term matrix
        (x, y), _ = ds.reuters.load_data(num_words=2000, maxlen=200,
                                         num_samples=n)
        m = np.zeros((len(x), 2000), np.float32)
        for i, row in enumerate(x):
            m[i, row[row > 0]] = 1.0
        return m, y.astype(np.int32), ds.reuters.synthetic
    if kind == "reuters_ids":  # the loader's defaults
        (x, y), _ = ds.reuters.load_data(num_samples=n)
        return x.astype(np.int32), y.astype(np.int32), ds.reuters.synthetic
    rng = np.random.RandomState(0)  # elementwise.py's regression
    x = rng.randn(n, 32).astype(np.float32)
    return (x, (np.sin(x[:, :1]) + x[:, 1:2] * x[:, 2:3]).astype(
        np.float32), None)


def phase_keras(torch, pk, fa, bk, card: str) -> dict:
    """Each keras_models() entry through flexflow_tpu_torch.keras on the
    card: compile, fit over KERAS_BATCHES batches (the CIFAR-10 models
    on the vendored sample shard, 64 images: fit over KERAS_BATCHES
    epochs of its one batch); samples/s, the losses, the dataset's
    synthetic flag; no hand-written kernel launches."""
    import shutil
    import tempfile

    import flexflow_tpu_torch.keras as K

    ds = K.datasets
    home_cache = ds._CACHE
    with tempfile.TemporaryDirectory(dir=Path(__file__).parent) as cache:
        shutil.copy(Path(__file__).parent / "examples" / "data"
                    / "cifar10_sample.tar.gz",
                    Path(cache) / "cifar-10-python.tar.gz")
        ds._CACHE = cache  # the loaders look here first
        try:
            rows = {name: keras_fit(torch, pk, fa, bk, card, K, name, *row)
                    for name, row in keras_models(K).items()}
        finally:
            ds._CACHE = home_cache
    rec = {"phase": "keras", "card": card, "models": sorted(rows),
           "samples_per_s": {k: r["samples_per_s"] for k, r in rows.items()},
           "synthetic": {k: r["synthetic"] for k, r in rows.items()},
           "launches": {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "P1": 0},
           "note": "float32; samples/s over fit's wall time with the "
                   "loader's start; CIFAR-10 from the vendored sample "
                   "shard (64 images), MNIST and Reuters synthetic (no "
                   "cached file)"}
    emit(rec)
    return rec


def keras_fit(torch, pk, fa, bk, card, K, name, build, opt, loss, metrics,
              kind, b) -> dict:
    """One keras model of phase_keras: compile, a warm-up train_step,
    fit, its record."""
    from flexflow_tpu_torch import FFConfig

    x, y, synthetic = keras_data(K.datasets, kind, KERAS_BATCHES * b)
    epochs = KERAS_BATCHES if len(y) < 2 * b else 1
    model = build(FFConfig(batch_size=b, device="cuda"))
    t0 = time.perf_counter()
    model.compile(optimizer=opt, loss=loss, metrics=metrics)
    compile_s = time.perf_counter() - t0
    callbacks = []
    if name == "callback_demo":
        callbacks = [K.LearningRateScheduler(lambda e, lr: lr * 0.9),
                     K.EarlyStopping(monitor="accuracy", patience=3)]
    # one warm-up step, as the other phases take, keeps cuDNN's and
    # cuBLAS's first-call set-up out of fit's time, and the capture
    # after it (settle) keeps the capture out too
    feed = {model.ffmodel.layers.source_ops()[0].name: x[:b]}
    model.ffmodel.train_step(feed, y[:b])
    settle(model.ffmodel, feed, y[:b])
    losses = record_losses(model.ffmodel)
    reset_kernel_launches(pk, fa, bk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = model.fit(x, y, epochs=epochs, callbacks=callbacks,
                     verbose=False)
    wall = time.perf_counter() - t0
    launches = kernel_launches(pk, fa, bk)
    if any(launches.values()):
        raise RuntimeError(f"keras {name}: launched {launches}")
    loss_vals = [float(v) for v in losses]
    if not loss_vals or not np.isfinite(loss_vals).all():
        raise RuntimeError(f"keras {name}: losses {loss_vals}")
    row = {"batch": b, "steps": len(loss_vals), "epochs": len(hist),
           "compile_s": compile_s, "fit_wall_s": wall,
           "samples_per_s": len(loss_vals) * b / wall, "losses": loss_vals,
           "accuracy": "accuracy" in metrics and hist[-1].accuracy,
           "synthetic": synthetic, "dataset": kind}
    emit({"phase": "keras", "card": card, "model": name, **row})
    del model
    torch.cuda.empty_cache()
    return row


def phase_onnx(torch, pk, fa, bk, card: str) -> dict:
    """The resnet phase's torch ResNet-50 (224 px, 1000 classes; its
    running statistics moved off their init by two train-mode forwards)
    as ONNX wire bytes (module_to_onnx), imported with ONNXModel and
    copy_weights at batch ONNX_BATCH, float32: the eval-mode forward
    against the torch module on the card, then one warm-up train_step
    and fit over ONNX_FIT batches through the loader; P1 launches per
    step (53 by the executor's plan)."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer)
    from flexflow_tpu_torch.onnx_frontend import ONNXModel, module_to_onnx

    b = ONNX_BATCH
    _, ResNet50, _ = resnet_modules()
    torch.manual_seed(0)
    module = ResNet50(RESNET_CLASSES).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        module.train()
        for _ in range(2):
            module(torch.randn(16, 3, RESNET_PX, RESNET_PX, device="cuda",
                               generator=gen))
    module.eval()
    t0 = time.perf_counter()
    wire = module_to_onnx(module, (b, 3, RESNET_PX, RESNET_PX))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ff = FFModel(FFConfig(batch_size=b, device="cuda"))
    m = ONNXModel(wire)
    (out,) = m.apply(ff, [ff.create_tensor([b, 3, RESNET_PX, RESNET_PX],
                                           name="input")])
    ff.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY,
                        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    m.copy_weights(ff)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    plan = bn_plan_counts(ff)
    if plan != RESNET_BN:
        raise RuntimeError(f"onnx: BatchNorm plan {plan} != {RESNET_BN}")
    rng = np.random.RandomState(0)
    x = rng.randn((2 + ONNX_FIT) * b, 3, RESNET_PX, RESNET_PX).astype(
        np.float32)
    y = rng.randint(0, RESNET_CLASSES, (2 + ONNX_FIT) * b).astype(np.int32)
    reset_kernel_launches(pk, fa, bk)
    got = ff.forward({"input": x[:b]})
    fwd_p1 = bk.bn_apply.launches
    with torch.no_grad():
        want = module(torch.from_numpy(x[:b]).to("cuda"))
    err = float((got - want).abs().max() / max(1.0, float(
        want.abs().max())))
    if not err <= ONNX_TOL:
        raise RuntimeError(f"onnx: eval forward {err} over {ONNX_TOL}")
    del module, want
    reset_kernel_launches(pk, fa, bk)
    before = capture_counts(ff)
    t0 = time.perf_counter()
    warm = ff.train_step({"input": x[b:2 * b]}, y[b:2 * b])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    settled = settle(ff, {"input": x[b:2 * b]}, y[b:2 * b])
    losses = record_losses(ff)
    t0 = time.perf_counter()
    ff.fit(x[2 * b:], y[2 * b:], batch_size=b, epochs=1, verbose=False)
    wall = time.perf_counter() - t0
    launches = kernel_launches(pk, fa, bk)
    counted = counted_steps(ff, before, 1 + len(settled) + ONNX_FIT)
    peak = torch.cuda.max_memory_allocated()
    del ff.train_step
    per_step = sum(RESNET_BN.values())
    if not counted or launches["P1"] != counted * per_step or any(
            v for k, v in launches.items() if k != "P1"):
        raise RuntimeError(f"onnx: fit launched {launches}")
    if fwd_p1 != per_step:
        raise RuntimeError(f"onnx: the forward launched P1 {fwd_p1} times")
    loss_vals = [float(m["loss"]) for m in [warm] + settled] + [
        float(v) for v in losses]
    if (len(loss_vals) != 1 + len(settled) + ONNX_FIT
            or not np.isfinite(loss_vals).all()):
        raise RuntimeError(f"onnx: losses {loss_vals}")
    rec = {"phase": "onnx", "card": card, "batch": b, "px": RESNET_PX,
           "classes": RESNET_CLASSES, "dtype": "float32",
           "wire_bytes": len(wire), "nodes": len(m.graph.node),
           "export_s": export_s, "import_compile_s": import_s,
           "eval_forward_err_over_scale": err, "tolerance": ONNX_TOL,
           "bn_plan": plan, "p1_launches_forward": fwd_p1,
           "warmup_step_s": warm_s, "fit_steps": ONNX_FIT,
           "fit_wall_s": wall, "step_ms": wall / ONNX_FIT * 1e3,
           "images_per_s": b * ONNX_FIT / wall,
           "p1_launches": launches["P1"], "counted_steps": counted,
           "p1_launches_per_counted_step": launches["P1"] / counted,
           "peak_memory_gb": peak / 1e9, "losses": loss_vals,
           "note": "TF32 off; step ms over fit's wall time with the "
                   "loader's start"}
    emit(rec)
    del ff
    torch.cuda.empty_cache()
    return rec


def _max_weight_diff(a, b) -> float:
    return max((float(np.abs(a[op][k] - v).max()) for op, e in b.items()
                for k, v in e.items()), default=0.0)


def phase_seq_parity(torch, card: str) -> dict:
    """Card against CPU at tiny sizes, float32, TF32 off: the NMT
    (forward, 2 SGD steps, greedy_decode), the GPT's generation forms
    (greedy tokens of gpt_generate, the cached twin and the scan; the
    cached beam search; the decode step's logits) and the Keras LSTM
    classifier (fit's metrics and weights)."""
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel
    from flexflow_tpu_torch import decoding as D
    from flexflow_tpu_torch import keras as K
    from flexflow_tpu_torch.models import build_gpt, greedy_decode

    diff = {}
    # NMT
    ffs = {dev: build_nmt_model(dev, 4, NMT_TINY) for dev in ("cuda", "cpu")}
    ffs["cpu"].set_weights(ffs["cuda"].get_weights())
    rng = np.random.RandomState(4)
    x, y = nmt_data(rng, 12, **NMT_TINY)
    outs = {d: ff.forward({k: v[:4] for k, v in x.items()}).cpu().numpy()
            for d, ff in ffs.items()}
    losses = {d: [float(ff.train_step({k: v[4 * i:4 * i + 4]
                                       for k, v in x.items()},
                                      y[4 * i:4 * i + 4])["loss"])
                  for i in (1, 2)] for d, ff in ffs.items()}
    toks = {d: greedy_decode(ff, x["src"][:4]) for d, ff in ffs.items()}
    diff["nmt"] = {
        "output": float(np.abs(outs["cuda"] - outs["cpu"]).max()),
        "loss": max(abs(a - c) for a, c in zip(losses["cuda"],
                                               losses["cpu"])),
        "weights": _max_weight_diff(ffs["cuda"].get_weights(),
                                    ffs["cpu"].get_weights()),
        "greedy_equal": bool(np.array_equal(toks["cuda"], toks["cpu"]))}
    # GPT generation
    gffs = {}
    for dev in ("cuda", "cpu"):
        ff = FFModel(FFConfig(batch_size=4, device=dev))
        build_gpt(ff, batch_size=4, **GPT_TINY)
        ff.compile(comp_mode=CompMode.INFERENCE)
        gffs[dev] = ff
    gffs["cpu"].set_weights(gffs["cuda"].get_weights())
    ids = np.random.RandomState(5).randint(
        0, GPT_TINY["vocab_size"], (4, 6)).astype(np.int32)
    gen = {}
    for dev, ff in gffs.items():
        ffd = D.make_gpt_decoder(ff)
        ffd4 = D.make_gpt_decoder(ff, batch_size=2)
        ffd.reset_decode_state()
        logits = [ffd.decode_step({"input": ids[:, t:t + 1],
                                   "positions": np.full((4, 1), t, np.int32)}
                                  ).cpu().numpy() for t in range(6)]
        gen[dev] = {"logits": np.stack(logits),
                    "tokens": [D.gpt_generate_cached(ffd, ids[:, :3], 10),
                               D.gpt_generate_scan(ffd, ids[:, :3], 10)],
                    "beam": D.gpt_beam_search_cached(ffd4, ids[:1, :3], 8,
                                                     beam_size=2)}
    g, c = gen["cuda"], gen["cpu"]
    forms = g["tokens"] + c["tokens"]  # cached and scan, on each device
    diff["generate"] = {
        "output": float(np.abs(g["logits"] - c["logits"]).max()),
        "greedy_equal": all(np.array_equal(forms[0], t) for t in forms),
        "beam_equal": bool(np.array_equal(g["beam"][0], c["beam"][0])),
        "beam_score": float(abs(g["beam"][1][0] - c["beam"][1][0]))}
    # the Keras LSTM classifier
    models = {}
    for dev in ("cuda", "cpu"):
        m = K.Sequential([K.Embedding(50, 8, input_length=10, name="emb"),
                          K.LSTM(12, name="lstm"),
                          K.Dense(5, activation="softmax", name="head")],
                         config=FFConfig(batch_size=4, device=dev))
        m.compile(metrics=["accuracy", "sparse_categorical_crossentropy"])
        models[dev] = m
    models["cpu"].ffmodel.set_weights(models["cuda"].ffmodel.get_weights())
    rng = np.random.RandomState(6)
    kx = rng.randint(0, 50, (16, 10)).astype(np.int32)
    ky = rng.randint(0, 5, 16).astype(np.int32)
    hist = {d: m.fit(kx, ky, epochs=2, verbose=False)
            for d, m in models.items()}
    diff["keras_lstm"] = {
        "loss": max(abs(a.sparse_cce_loss - b.sparse_cce_loss)
                    for a, b in zip(hist["cuda"], hist["cpu"])),
        "weights": _max_weight_diff(models["cuda"].ffmodel.get_weights(),
                                    models["cpu"].ffmodel.get_weights())}
    over = {f"{name}.{k}": v for name, row in diff.items()
            for k, v in row.items()
            if (k in SEQ_PARITY_TOL and v > SEQ_PARITY_TOL[k])
            or (k == "beam_score" and v > SEQ_PARITY_TOL["loss"])
            or (k.endswith("_equal") and not v)}
    if over:
        raise RuntimeError(f"seq_parity: card vs CPU {over} "
                           f"(tolerance {SEQ_PARITY_TOL})")
    rec = {"phase": "seq_parity", "card": card, "dtype": "float32",
           "allow_tf32": False, "max_diff": diff,
           "tolerance": SEQ_PARITY_TOL,
           "compared": "NMT forward, losses and weights after 2 SGD steps "
                       "and greedy tokens; GPT decode-step logits, greedy "
                       "tokens of the cached and scan forms, the cached "
                       "beam; the Keras LSTM's epoch losses and weights "
                       "after fit"}
    emit(rec)
    return rec


# -- capture: the train step as one CUDA graph -------------------------------

# steps compared eager against captured from the same weights and batches
# (the captured run: one warm-up step, the capturing step, a replay), and
# the steps each side is then profiled over
CAPTURE_STEPS, CAPTURE_PROFILE_STEPS = 3, 3
# the fusion phase: steps whose losses are compared, then steps timed
FUSION_STEPS, FUSION_TIMED = 2, 5
# the hand-written kernels' names in a profile
KERNEL_TAGS = {"K1": "flash_fwd_kernel", "K2": "flash_bwd_dq_kernel",
               "K3": "flash_bwd_dkv_kernel", "K4": "paged_attention_kernel",
               "P1": "bn_apply_kernel"}
# the capture phase's paths: the kernels each must launch per step
CAPTURE_KERNELS = {"bert": {"K1": BERT["num_layers"],
                            "K2": BERT["num_layers"],
                            "K3": BERT["num_layers"]},
                   "resnet50": {"P1": sum(RESNET_BN.values())},
                   "vit_b16": {}}


def profile_steps(torch, run, steps: int, expect=None) -> dict:
    """torch.profiler over `steps` calls of run() (one train step each),
    after one call that the profiler traces and drops (a window's first
    records can go missing): per step the wall ms (to a synchronize),
    device busy ms (the union of the device events), device events and
    each hand-written kernel's launches; the device's idle share.  With
    `expect` ({kernel id: launches per step}) a window that counts
    otherwise is logged in PROFILER_DROPS and taken again, up to
    PROFILE_ATTEMPTS windows in all; the last one is returned."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(PROFILE_ATTEMPTS):
        traces = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1),
                     on_trace_ready=lambda p: traces.append(
                         list(p.events()))) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for i in range(steps):
                run()
                if i + 1 < steps:
                    prof.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        # device work only: not the "nccl:<op>" ranges beside each NCCL
        # kernel, nor the step annotations (ProfilerStep#) the schedule
        # lays over each step's kernels on the device timeline
        dev = [e for e in (traces[0] if traces else [])
               if "cuda" in str(e.device_type).lower()
               and not e.name.startswith(("nccl:", "ProfilerStep"))
               and not getattr(e, "is_user_annotation", False)]
        if not dev:
            raise RuntimeError("the profiler saw no device time")
        launches = {k: sum(tag in e.name for e in dev) / steps
                    for k, tag in KERNEL_TAGS.items()}
        if expect is None or all(launches[k] == expect.get(k, 0)
                                 for k in launches):
            break
        PROFILER_DROPS.append({"tag": "train step", "attempt": attempt + 1,
                               "launches_per_step": launches,
                               "expected": expect})
    busy_ms = device_busy_us(dev) / 1e3
    kinds = {}
    for e in dev:
        kind = next((k for k, tag in KERNEL_TAGS.items() if tag in e.name),
                    None) or _kernel_kind_mg(e.name)
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / (
            1e3 * steps)
    return {"steps": steps, "step_ms": wall_ms / steps,
            "device_busy_ms": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_events_per_step": len(dev) / steps,
            "device_ms_by_kind": kinds,
            "launches_per_step": launches, "attempts": attempt + 1,
            "_events": dev}


def _capture_side(torch, pk, fa, bk, build, batches, init, expect):
    """One side of a path's comparison: build (its step captured or
    eager), load `init` (weights and op state, or None: this side's own
    are the comparison's start), CAPTURE_STEPS train steps, then a
    profile of CAPTURE_PROFILE_STEPS more.  The batches are put on the
    card first, so that the steps time the step itself, not the copy of
    a pageable host array.  Returns (record, weights after the steps,
    the start)."""
    batches = [({k: torch.from_numpy(v).cuda() for k, v in inputs.items()},
                torch.from_numpy(labels).cuda())
               for inputs, labels in batches]
    ff = build()
    if init is None:
        init = (ff.get_weights(), ff.get_state())
    else:
        ff.set_weights(init[0])
        ff.set_state(init[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches(pk, fa, bk)
    before = capture_counts(ff)
    losses, step_s = [], []
    for inputs, labels in batches:
        t0 = time.perf_counter()
        losses.append(float(ff.train_step(inputs, labels)["loss"]))
        step_s.append(time.perf_counter() - t0)
    counted = counted_steps(ff, before, len(batches))
    launches = kernel_launches(pk, fa, bk)
    peak = torch.cuda.max_memory_allocated()
    weights = ff.get_weights()
    prof = profile_steps(torch, lambda: ff.train_step(*batches[-1]),
                         CAPTURE_PROFILE_STEPS, expect)
    prof.pop("_events")
    rec = {"losses": losses, "step_s": step_s, "counted_steps": counted,
           "counted_launches": launches, "peak_memory_gb": peak / 1e9,
           "profile": prof,
           "capture_status": dict(ff.executor.capture_status)}
    del ff
    gc.collect()
    torch.cuda.empty_cache()
    return rec, weights, init


def _capture_paths(torch):
    """{path: (build(capture), the batches)} of the capture phase: the
    train phase's BERT-base, the resnet phase's ResNet-50 and the vit
    phase's ViT-B/16 at dropout 0 (the comparison needs no random
    draw), each at its phase's batch, dtype and optimizer."""
    ResNetMods, ViTMods = resnet_modules(), vit_modules()
    x, y = bert_data(TRAIN_BATCH * CAPTURE_STEPS, seed=2)
    bert = [({"input": x[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]},
             y[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
            for i in range(CAPTURE_STEPS)]
    rng = np.random.default_rng(2)

    def images(b, px, classes):
        return [({"input": rng.standard_normal((b, 3, px, px),
                                               dtype=np.float32)},
                 rng.integers(0, classes, b).astype(np.int32))
                for _ in range(CAPTURE_STEPS)]

    def resnet(capture):
        torch.manual_seed(0)
        module = ResNetMods[1](classes=RESNET_CLASSES)
        return build_resnet(torch, module, RESNET_BATCH, RESNET_PX, "cuda",
                            "bfloat16", capture=capture)

    def vit(capture):
        torch.manual_seed(0)
        module = ViTMods[0](classes=VIT_CLASSES, dropout=0.0)
        return build_vit(module, VIT_BATCH, VIT_PX, "cuda", "bfloat16",
                         capture=capture)

    return {
        "bert": (lambda capture: build_bert_model(
            "cuda", BERT["num_layers"], TRAIN_BATCH, capture=capture), bert),
        "resnet50": (resnet, images(RESNET_BATCH, RESNET_PX,
                                    RESNET_CLASSES)),
        "vit_b16": (vit, images(VIT_BATCH, VIT_PX, VIT_CLASSES)),
    }


def phase_capture(torch, pk, fa, bk, card: str) -> dict:
    """Each one-card path eager and captured from the same weights and
    batches: losses and weights after CAPTURE_STEPS steps (PARITY_TOL),
    step ms, device busy, idle share, events and the kernels' launches
    per step (the captured side's from the profiler, which sees the
    kernels a replay launches, against what the capture counted), peak
    memory, capture_status; then the small ViT at dropout 0.1, captured,
    whose replays must draw fresh masks and whose learning rate, set to 0
    after the capture, must stop its weights."""
    paths = []
    faults = []
    for name, (build, batches) in _capture_paths(torch).items():
        want = CAPTURE_KERNELS[name]
        expect = {k: want.get(k, 0) for k in KERNEL_TAGS}
        eager, w_eager, init = _capture_side(
            torch, pk, fa, bk, lambda: build(False), batches, None, expect)
        graph, w_graph, _ = _capture_side(
            torch, pk, fa, bk, lambda: build(True), batches, init, expect)
        loss_err = _loss_err(graph["losses"], eager["losses"])
        wdiff, worst = _weights_diff(w_graph, w_eager)
        st = graph["capture_status"]
        for side, rec in (("eager", eager), ("graph", graph)):
            got = rec["profile"]["launches_per_step"]
            if got != expect:
                faults.append(f"{name} {side}: the profiler counted "
                              f"{got} launches per step, expected {expect}")
            counted = {k: v / max(1, rec["counted_steps"])
                       for k, v in rec["counted_launches"].items()}
            if counted != expect or not rec["counted_steps"]:
                faults.append(f"{name} {side}: the wrappers counted "
                              f"{rec['counted_launches']} over "
                              f"{rec['counted_steps']} steps")
        if st["mode"] != "graph" or st.get("replays", 0) < 1:
            faults.append(f"{name}: the step was not captured: {st}")
        elif {k: v for k, v in st["launches_at_capture"].items() if v} != {
                k: v for k, v in expect.items() if v}:
            faults.append(f"{name}: the capture counted "
                          f"{st['launches_at_capture']}, expected {want}")
        if not np.isfinite(eager["losses"] + graph["losses"]).all():
            faults.append(f"{name}: non-finite losses")
        if loss_err > PARITY_TOL["loss"] or wdiff > PARITY_TOL["weights"]:
            faults.append(f"{name}: captured against eager: losses "
                          f"{loss_err}, weights {wdiff} ({worst}) over "
                          f"{PARITY_TOL}")
        rec = {"phase": "capture", "path": name, "card": card,
               "steps": CAPTURE_STEPS, "eager": eager, "graph": graph,
               "loss_err": loss_err, "weights_diff": wdiff,
               "worst_weight": worst, "tolerance": PARITY_TOL,
               "kernels_per_step": want}
        emit(rec)
        paths.append(rec)
    rng_rec = _capture_rng(torch)
    emit(rng_rec)
    faults += rng_rec["faults"]
    if faults:
        raise RuntimeError("capture: " + "; ".join(faults))
    return {"phase": "capture", "paths": paths, "rng": rng_rec}


def _capture_rng(torch) -> dict:
    """The small ViT at dropout 0.1, captured: two calls (the warm-up and
    the capture), set_learning_rate(0), three replays on one batch.  The
    replays' losses must differ (each draws fresh masks from the
    registered generator) and the weights must not move (the update
    reads the learning rate from its device tensor)."""
    _, SmallViT = vit_modules()
    torch.manual_seed(3)
    ff = build_vit(SmallViT(dropout=0.1), 4, 32, "cuda", "float32")
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)
    first = [float(ff.train_step({"input": x}, y)["loss"]) for _ in range(2)]
    ff.set_learning_rate(0.0)
    before = ff.get_weights()
    replays = [float(ff.train_step({"input": x}, y)["loss"])
               for _ in range(3)]
    moved, at = _weights_diff(ff.get_weights(), before)
    st = ff.executor.capture_status
    faults = []
    if st["mode"] != "graph" or st["replays"] != 4:
        faults.append(f"rng: capture status {st}")
    if len(set(replays)) != len(replays):
        faults.append(f"rng: replays gave the same losses {replays}")
    if moved != 0.0:
        faults.append(f"rng: weights moved {moved} ({at}) at lr 0")
    return {"phase": "capture_rng", "model": "small ViT, dropout 0.1",
            "losses_before_lr0": first, "losses_replayed_lr0": replays,
            "weights_moved_at_lr0": moved, "replays": st.get("replays"),
            "faults": faults}


def phase_fusion(torch, fa, card: str) -> dict:
    """FFConfig.perform_fusion (--fusion): the BERT-base flagship of the
    train phase (its builder folds GELU into ffn1 already, so the pass
    finds nothing) and the vit phase's ViT-B/16 at its batch and dtype
    (bfloat16) from its weights, at dropout 0 (torch.fx imports each
    block's GELU as an op of its own, which the pass folds into fc1),
    each compiled with and without the pass from the same weights: op
    counts of the compiled graphs, FUSION_STEPS steps' losses
    (PARITY_TOL) and the step ms of FUSION_TIMED more (captured
    replays).  The small ViT's fold is a CPU test
    (tests/test_torch_fusion.py)."""
    steps = FUSION_STEPS
    out, faults = [], []
    x, y = bert_data(TRAIN_BATCH, seed=4)
    ViT, _ = vit_modules()
    rng = np.random.RandomState(4)
    xv = rng.randn(VIT_BATCH, 3, VIT_PX, VIT_PX).astype(np.float32)
    yv = rng.randint(0, VIT_CLASSES, VIT_BATCH).astype(np.int32)

    def vit(fusion):
        torch.manual_seed(0)
        return build_vit(ViT(classes=VIT_CLASSES, dropout=0.0), VIT_BATCH,
                         VIT_PX, "cuda", "bfloat16", fusion=fusion)

    cases = {
        "bert": (lambda fusion: build_bert_model(
            "cuda", BERT["num_layers"], TRAIN_BATCH, fusion=fusion), x, y),
        "vit_b16": (vit, xv, yv)}
    for name, (build, xs, ys) in cases.items():
        rec = {"path": name}
        init = None
        for fusion in (False, True):
            ff = build(fusion)
            if init is None:
                init = ff.get_weights()
            else:
                ff.set_weights(init)
            dev = ({"input": torch.from_numpy(xs).cuda()},
                   torch.from_numpy(ys).cuda())
            losses = [float(ff.train_step(*dev)["loss"])
                      for _ in range(steps)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FUSION_TIMED):
                ff.train_step(*dev)
            torch.cuda.synchronize()
            key = "fused" if fusion else "unfused"
            rec[key] = {"ops": len(ff.operators.ops), "losses": losses,
                        "activation_ops": sum(
                            op.op_type.value == "element_unary"
                            for op in ff.operators.ops),
                        "step_ms": (time.perf_counter() - t0) * 1e3
                        / FUSION_TIMED,
                        "capture": ff.executor.capture_status.get("mode")}
            del ff, dev
            torch.cuda.empty_cache()
        rec["loss_err"] = _loss_err(rec["fused"]["losses"],
                                    rec["unfused"]["losses"])
        if rec["loss_err"] > PARITY_TOL["loss"]:
            faults.append(f"{name}: fused losses {rec['fused']['losses']} "
                          f"against {rec['unfused']['losses']}")
        if name == "vit_b16" and not (
                rec["fused"]["ops"] < rec["unfused"]["ops"]):
            faults.append(f"{name}: the pass folded nothing: {rec}")
        out.append(rec)
    rec = {"phase": "fusion", "card": card, "steps": steps,
           "timed_steps": FUSION_TIMED, "cases": out,
           "tolerance": PARITY_TOL["loss"]}
    emit(rec)
    if faults:
        raise RuntimeError("fusion: " + "; ".join(faults))
    return rec


ALL_PHASES = ("kernels,serve,parity,profile,train,train_parity,"
              "train_profile,bn_kernels,resnet,resnet_parity,resnet_profile,"
              "vit,vit_parity,vit_profile,zoo,zoo_parity,zoo_profile,"
              "nmt,generate,keras,onnx,seq_parity,capture,fusion,search,"
              "multigpu")

# the search phase: the Unity search's budget, the devices it searches
# for (one HGX H100 node), the calibration's step windows and batch
# sizes (fitted on all but the last, which is held out and predicted
# within CAL_HELD_OUT_TOL of its measured step)
SEARCH_BUDGET = 20
SEARCH_DEVICES = 8
SEARCH_MACHINE = "hgx_h100_8"
CAL_ITERS, CAL_WINDOWS = 4, 2
CAL_BATCHES = (2, 4, TRAIN_BATCH)
CAL_HELD_OUT_TOL = 0.25


def search_config(cache_file: str, budget: int = SEARCH_BUDGET,
                  batch: int = TRAIN_BATCH, machine: str = SEARCH_MACHINE,
                  **kw):
    """The search phase's FFConfig: the train phase's BERT-base batch,
    ops timed on the card into `cache_file`, the HGX node file (or
    `machine`'s)."""
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.sim.machine_model import machine_file

    return FFConfig(batch_size=batch, device="cuda", seed=0,
                    search_budget=budget, search_calibrate=True,
                    op_cost_cache_file=cache_file,
                    machine_model_file=machine_file(machine), **kw)


def search_bert(cfg):
    """The train phase's BERT-base on `cfg` (at its batch size), not
    compiled."""
    from flexflow_tpu_torch import FFModel
    from flexflow_tpu_torch.models.transformer import build_bert

    ff = FFModel(cfg)
    build_bert(ff, batch_size=cfg.batch_size, seq_length=TRAIN_SEQ, **BERT)
    return ff


def cancelling_strategy():
    """A one-card strategy whose edge chain shards the first FFN's
    output two ways over its sequence dim and gathers it back:
    apply_strategy inserts the pair and compile cancels it, so the steps
    are the plain graph's."""
    from flexflow_tpu_torch.strategy import data_parallel_strategy

    s = data_parallel_strategy(1)
    s.edge_ops["ffn1_0.out0"] = [("repartition", {"dim": 1, "degree": 2}),
                                 ("combine", {"dim": 1, "degree": 2})]
    return s


def predicted_step(cfg, ff, machine, strategy) -> float:
    """The simulator's step seconds for `strategy` over ff's layer graph,
    with the search's simulator settings and the card's measured op
    costs (the cost cache the search wrote)."""
    from flexflow_tpu_torch.pcg.evaluator import IncrementalEvaluator
    from flexflow_tpu_torch.pcg.mcmc import make_search_simulator
    from flexflow_tpu_torch.sim.simulator import make_cost_model

    cm = make_cost_model(cfg, machine)
    res = IncrementalEvaluator(
        ff.layers, make_search_simulator(cfg, machine, cm)).evaluate(strategy)
    if res is None:
        raise RuntimeError(f"search: {strategy.to_json()} is illegal")
    return res.total_time


def phase_search(torch, fa, card: str, run_dir: str) -> dict:
    """The Unity search over one HGX H100 node, costed by op forwards
    timed on the card, then the searched one-card model trained against
    the unsearched one, and the overlap calibration."""
    import shutil
    import tempfile

    from flexflow_tpu_torch.sim import calibrate as cal
    from flexflow_tpu_torch.sim.machine_model import make_machine_model
    from flexflow_tpu_torch.sim.simulator import make_cost_model
    from flexflow_tpu_torch.pcg.search import unity_search
    from flexflow_tpu_torch.strategy import (Strategy, apply_strategy,
                                             data_parallel_strategy)

    tmp = tempfile.mkdtemp(prefix="ff_search_")
    try:
        cache = f"{tmp}/op_costs.json"  # fresh: every op timed anew
        cfg = search_config(cache)
        ff = search_bert(cfg)
        reset_flash_launches(fa)
        t0 = time.perf_counter()
        best = unity_search(ff, SEARCH_DEVICES)
        search_s = time.perf_counter() - t0
        search_launches = flash_launches(fa)
        stats = best.search_stats
        if search_launches["K1"] <= 0 or stats["measured_ops"] <= 0:
            raise RuntimeError(
                f"search: {stats['measured_ops']} ops measured, flash "
                f"launches {search_launches}: attention at seq "
                f"{TRAIN_SEQ} must be timed through K1")
        if best.total_devices != SEARCH_DEVICES:
            raise RuntimeError(f"search: a strategy for "
                               f"{best.total_devices} devices")
        path = f"{tmp}/strategy.json"
        best.save(path)
        best.save(f"{run_dir}/searched_strategy.json")  # multigpu trains it
        back = Strategy.load(path)
        if back.to_json() != best.to_json():
            raise RuntimeError("search: the strategy file did not load "
                               "back equal")
        machine8 = make_machine_model(cfg, SEARCH_DEVICES)
        dp8 = data_parallel_strategy(SEARCH_DEVICES)
        pred_best = predicted_step(cfg, ff, machine8, best)
        pred_dp8 = predicted_step(cfg, ff, machine8, dp8)
        del ff

        # one card: the searched compile, and a strategy whose edge
        # chain cancels, against the unsearched one
        x, y = bert_data(2 * TRAIN_BATCH, seed=1)
        losses = {}
        step_launches = {}
        strategies = {}
        for name, budget, strategy in (
                ("unsearched", 0, None), ("searched", SEARCH_BUDGET, None),
                ("cancelled", 0, cancelling_strategy())):
            m = search_bert(search_config(cache, budget=budget))
            reset_flash_launches(fa)
            m.compile(seed=0, strategy=strategy)
            if strategy is not None:
                inserted = [op.params.degree for op in
                            apply_strategy(m.layers, strategy).ops
                            if op.is_parallel_op() and op.params.degree > 1]
                left = [op.name for op in m.operators.ops
                        if op.is_parallel_op() and op.params.degree > 1]
                if inserted != [2, 2] or left:
                    raise RuntimeError(
                        f"search: the cancelling chain inserted {inserted} "
                        f"and left {left} in the compiled graph")
            losses[name] = [float(m.train_step(
                {"input": x[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]},
                y[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])["loss"])
                for i in range(2)]
            step_launches[name] = flash_launches(fa)
            strategies[name] = m.strategy.to_json()
            del m
            torch.cuda.empty_cache()
        diff = max(abs(a - b) / max(abs(a), 1e-12)
                   for name in ("searched", "cancelled")
                   for a, b in zip(losses[name], losses["unsearched"]))
        if not (all(np.isfinite(v).all() for v in losses.values())
                and diff <= PARITY_TOL["loss"]):
            raise RuntimeError(f"search: one-card losses {losses} differ "
                               f"by {diff} (tolerance {PARITY_TOL['loss']})")
        one = Strategy.from_json(strategies["searched"])

        # the overlap calibration: fitted on the one-card model at the
        # smaller batch sizes, then the simulator's prediction for the
        # held-out batch against its measured step
        machine1 = make_machine_model(cfg, 1)
        cm = make_cost_model(cfg, machine1)

        def builder(batch):
            return lambda: search_bert(search_config(cache, budget=0,
                                                     batch=batch))

        def make_inputs(_ff):
            b = _ff.config.batch_size
            return {"input": x[:b]}, y[:b]

        reset_flash_launches(fa)
        t0 = time.perf_counter()
        fit_batches = CAL_BATCHES[:-1]
        fit = cal.calibrate_overlap([builder(b) for b in fit_batches],
                                    [one] * len(fit_batches), machine1, cm,
                                    make_inputs, iters=CAL_ITERS,
                                    windows=CAL_WINDOWS)
        held = cal.calibrate_overlap([builder(CAL_BATCHES[-1])], [one],
                                     machine1, cm, make_inputs,
                                     iters=CAL_ITERS,
                                     windows=CAL_WINDOWS)["records"][0]
        cal_s = time.perf_counter() - t0
        cal_launches = flash_launches(fa)
        if min(cal_launches.values()) <= 0:
            raise RuntimeError(f"search: calibration launched "
                               f"{cal_launches}")
        held_pred = (fit["compute_scale"] * held[1]
                     + fit["comm_scale"] * held[2]
                     + fit["sync_scale"] * held[3])
        held_err = abs(held_pred - held[0]) / held[0]
        if not held_err <= CAL_HELD_OUT_TOL:
            raise RuntimeError(
                f"search: the calibration fitted on batches {fit_batches} "
                f"predicts {held_pred * 1e3} ms at batch {CAL_BATCHES[-1]}, "
                f"measured {held[0] * 1e3} ms: {held_err} over "
                f"{CAL_HELD_OUT_TOL}")
        torch.cuda.empty_cache()
        shutil.copy(cache, f"{run_dir}/op_costs.json")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: search_launches[k] + sum(v[k] for v in
                                            step_launches.values())
                + cal_launches[k] for k in search_launches}
    rec = {
        "phase": "search", "card": card,
        "model": dict(BERT, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      dtype="float32"),
        "machine": SEARCH_MACHINE, "devices": SEARCH_DEVICES,
        "budget": SEARCH_BUDGET,
        "search_s": search_s,
        "measured_ops": stats["measured_ops"],
        "unmeasurable_ops": stats["unmeasurable_ops"],
        "cost_calls": stats["cost_calls"],
        "measured_calls": stats["measured_calls"],
        "measured_share": stats["measured_share"],
        "scaled_calls": stats["scaled_calls"],
        "scaled_ops": stats["scaled_ops"],
        "strategy": json.loads(best.to_json()),
        "search_cost_s": best.search_cost,
        "predicted_step_ms": pred_best * 1e3,
        "predicted_dp8_step_ms": pred_dp8 * 1e3,
        "one_card_strategy": json.loads(strategies["searched"]),
        "cancelled_strategy": json.loads(strategies["cancelled"]),
        "losses": losses, "loss_rel_diff": diff,
        "loss_tolerance": PARITY_TOL["loss"],
        "calibration": {
            "fit_batches": list(fit_batches),
            "fit_measured_ms": [r[0] * 1e3 for r in fit["records"]],
            "fit_simulated_ms": [sum(r[1:]) * 1e3 for r in fit["records"]],
            "compute_scale": fit["compute_scale"],
            "fit_max_rel_error": fit["max_rel_error"],
            "held_out_batch": CAL_BATCHES[-1],
            "held_out_simulated_ms": sum(held[1:]) * 1e3,
            "held_out_predicted_ms": held_pred * 1e3,
            "held_out_measured_ms": held[0] * 1e3,
            "held_out_rel_error": held_err,
            "held_out_tolerance": CAL_HELD_OUT_TOL,
        },
        "calibrate_s": cal_s,
        "flash_launches_search": search_launches,
        "flash_launches_compile_and_steps": step_launches,
        "flash_launches_calibrate": cal_launches,
        "flash_launches": launches,
    }
    emit(rec)
    return rec


# the multigpu phase: BERT-base at the train phase's width, batch and
# sequence over groups of ranks, each leg held against the same model
# trained on one card (in this process) from the same weights and batches
MULTIGPU_STEPS = 2
MULTIGPU_TIMEOUT_S = 600
MULTIGPU_CNN = dict(batch=16, px=32)
# each leg against its one-card run, float32, TF32 off: the sharded
# step sums in other orders (the TP and ring partial sums, the grads'
# all-reduce over ranks) than the one-card step, and the ring runs K1-K3
# on 1024-key blocks merged through their LSE where one card runs them
# over 2048 keys (their float32 products are 3xTF32, 2^-22 dropped, so
# each block shape rounds its own way).  The losses are held as error
# over scale max(1, |loss|): the second step's loss is 7.26, after a
# first step that sends it from 0.69 (SGD at lr 0.01 on random
# features), and a weight 1e-6 apart moves it by ~1e-4 there.  Under
# Adam (alpha 1e-3) a weight whose grad is at rounding level can move
# by up to alpha either way; on the H100 the ZeRO-3 leg's weights read
# 1.11e-4 against one card and 4.8e-5 to 5.2e-5 against stage 0 (over
# NCCL on four cards and over gloo on one), while a skipped or misplaced
# update moves each weight by about alpha.  The limit sits between, and
# the record gives the one-card run's last-step move beside it: the
# reading a skipped second update would give, and how many weights'
# own moves the limit would see
MULTIGPU_TOL = {"loss": PARITY_TOL["loss"], "weights": PARITY_TOL["weights"],
                "adam_weights": 3e-4,
                "cnn_weights": RESNET_PARITY_TOL["weights"],
                "cnn_running_stats": RESNET_PARITY_TOL["running_stats"]}
MULTIGPU_LEGS = (
    {"name": "dp_tp", "ranks": 4, "strategy": ["bert_tp", 2],
     "optimizer": "sgd", "reference": "bert_sgd"},
    {"name": "dp_sp", "ranks": 4, "strategy": ["bert_sp", 2],
     "optimizer": "sgd", "reference": "bert_sgd"},
    {"name": "dp_zero3", "ranks": 4, "strategy": ["dp"], "zero": 3,
     "optimizer": "adam", "reference": "bert_adam"},
    # ZeRO-2: each grad reduce-scattered as the backward makes it
    {"name": "dp_zero2", "ranks": 4, "strategy": ["dp"], "zero": 2,
     "optimizer": "adam", "reference": "bert_adam"},
    {"name": "cnn_dp", "ranks": 4, "strategy": ["dp"], "optimizer": "sgd",
     "reference": "cnn"},
    {"name": "searched", "ranks": SEARCH_DEVICES, "strategy": ["file"],
     "optimizer": "sgd", "reference": "bert_sgd"},
    # pipelines, ["pipe", data, pipe, microbatches]: GPipe through the
    # executor's region
    {"name": "pp_dp", "ranks": 4, "strategy": ["pipe", 2, 2, 4],
     "optimizer": "sgd", "reference": "bert_sgd"},
    {"name": "pp4", "ranks": 4, "strategy": ["pipe", 1, 4, 4],
     "optimizer": "sgd", "reference": "bert_sgd"},
    {"name": "pp_dp_remat", "ranks": 4, "strategy": ["pipe", 2, 2, 4],
     "remat": True, "optimizer": "sgd", "reference": "bert_sgd"},
    # the demo transformer of parallel/pipeline.py under 1F1B and GPipe
    {"name": "pp_1f1b", "ranks": 4, "strategy": ["demo", 1, 4, 8],
     "optimizer": "sgd", "reference": "demo"},
    # the pipeline the search prices cheapest for 4 GPUs
    {"name": "pp_searched", "ranks": 4, "strategy": ["pipe_file"],
     "optimizer": "sgd", "reference": "bert_sgd"},
    # expert parallelism on the MoE encoder, ["moe", data, expert]:
    # whole experts under data 4; the experts split four ways with the
    # tokens replicated; data 2 x expert 2, where the view normalizer
    # puts the expert dim on the data axis (tokens and experts split over
    # it: the dispatch is a true all-to-all, the expert axis replicates)
    {"name": "moe_dp4", "ranks": 4, "strategy": ["moe", 4, 1],
     "optimizer": "sgd", "reference": "moe"},
    {"name": "ep4", "ranks": 4, "strategy": ["moe", 1, 4],
     "optimizer": "sgd", "reference": "moe"},
    {"name": "dp2_ep2", "ranks": 4, "strategy": ["moe", 2, 2],
     "optimizer": "sgd", "reference": "moe"},
    # what the Unity search writes for the encoder on 4 GPUs
    {"name": "moe_searched", "ranks": 4, "strategy": ["moe_file"],
     "optimizer": "sgd", "reference": "moe"},
    # factored per-op views, ["factored", attention channel, ffn1
    # channel] over {model0: 2, model1: 2}: attention heads on model1 +
    # model0, ffn1 on model1 (the form Unity's _mesh_variants writes for
    # tp 4)
    {"name": "factored_tp4", "ranks": 4, "strategy": ["factored", 4, 2],
     "optimizer": "sgd", "reference": "bert_sgd"},
    # two slices of 2 ranks (FFConfig(slices=2)): data 4 run as {slice:
    # 2, data: 2} with the hierarchical grad reduction (and once more
    # flat on the same mesh), ZeRO-1 over the intra-slice remainder,
    # and the Unity search's strategy for 2 nodes x 2 GPUs
    {"name": "slices2_dp4", "ranks": 4, "strategy": ["dp"], "slices": 2,
     "flat_baseline": True, "optimizer": "sgd", "reference": "bert_sgd"},
    {"name": "slices2_zero1", "ranks": 4, "strategy": ["dp"], "slices": 2,
     "zero": 1, "optimizer": "adam", "reference": "bert_adam"},
    {"name": "slices2_searched", "ranks": 4, "strategy": ["slices_file"],
     "slices": 2, "optimizer": "sgd", "reference": "bert_sgd"},
)
# the legs whose step must be captured under NCCL: each is run again in
# its group eager and captured from the same weights and batches
# (CAPTURE_STEPS steps, then CAPTURE_PROFILE_STEPS profiled); and the MoE
# leg whose plan has no blocker, whose legs run eager for their routing
# check: it is run so too
CAPTURE_LEGS = ("dp_tp", "dp_zero3", "slices2_dp4", "dp_zero2")
# ZeRO-2's device bytes once the backward has ended: beyond its grad
# shards the step holds its batch (12.58 MB a rank at data 4), loss and
# logits; below ZeRO-0's, stage 0 also holds ~24 MB that its backward
# allocated outside Python (the allocator's history on an H100); one
# bucket (parallel/zero.py BUCKET_BYTES, 25 MiB) covers either, where
# grads kept whole would be off by three quarters of BERT-base's 340 MB
ZERO2_MEMORY_TOL = 25 * 2 ** 20
CAPTURE_ATTEMPTS = ("ep4",)
# slices2_dp4's hierarchical weights against its flat run on the same
# mesh after the 2 steps, |hier - flat| <= atol + rtol |flat| per
# element: tests/test_topology.py:313's bar for the two reduction
# orders.  Stated before the first run on the card: the two forms sum
# the same 4 grads per element in other orders (~1e-7 relative per
# step), so a skipped or doubled sum between the slices reads ~1e-3
HIER_FLAT_TOL = {"rtol": 2e-5, "atol": 2e-6}
# the machine the slice legs are priced on: two HGX H100 nodes, cut to
# 2 GPUs a node (the legs' 4 ranks as 2 slices of 2)
SLICES_MACHINE = "hgx_h100_16"
# the four cards of a chip run sit in one NVSwitch box
SLICES_NOTE = ("the four cards sit in one NVSwitch box and the slices "
               "are its halves: the hierarchy's collectives run on "
               "NVLink, not InfiniBand, whose rates stay datasheet "
               "figures")
# the pipeline legs' GPUs, and K1-K3's shape at their one-row
# microbatches (batch 8 over data 2 and 4 microbatches)
PIPELINE_DEVICES = 4
PIPELINE_FLASH_SHAPE = (BERT["num_heads"], TRAIN_SEQ,
                        BERT["hidden_size"] // BERT["num_heads"])
# the demo at BERT-base widths, 2 classes, SGD at lr 0.01
DEMO = dict(layers=BERT["num_layers"], hidden=BERT["hidden_size"],
            ffn=BERT["intermediate_size"], num_heads=BERT["num_heads"],
            num_classes=BERT["num_classes"], lr=0.01)


# the expert-parallel legs: the encoder of upstream moe.cc:100-130
# (build_moe_encoder) at BERT-base widths, batch 8, seq 2048 (K1-K3 in
# every layer), with Switch-Base-8's 8 experts, moe.cc's top-2, capacity
# factor 2 and balance weight 0.04; each expert is one [768 -> 768] ReLU
# dense.  Its labels are one class of 2 per token
MOE = dict(hidden_size=BERT["hidden_size"], num_layers=BERT["num_layers"],
           num_heads=BERT["num_heads"], num_exp=8, num_select=2, alpha=2.0,
           lambda_bal=0.04, num_classes=BERT["num_classes"])
MOE_DEVICES = 4
# a token routed to other experts than on one card is a fault when the
# one-card gate probabilities that decide the differing choice (the
# first against the second, or the second against the third) lie more
# than this apart: a sharded GEMM at another M may round the gate
# differently, which can swap only near-ties.  A flip in a sequence that
# flipped at an earlier layer of the same step is recorded with that
# earlier flip and held to no gap: attention has carried the earlier
# token's changed output into it (on the card, dp2_ep2 flipped a token's
# second expert at layer 7 at a gap of 1.8e-6, and a token of the same
# sequence swapped its two experts at layer 11 at 1.25e-5)
MOE_FLIP_GAP = 1e-5
# each step's balance losses (their sum over the layers, ~0.04 each)
# against the one-card run's: global counts and mean probabilities agree
# to rounding (~1e-7) unless the counts are taken per rank or the loss
# is added once per expert-axis partial (off by a factor)
MOE_BALANCE_TOL = 1e-5


def _multigpu_optimizer(name: str):
    from flexflow_tpu_torch import AdamOptimizer, SGDOptimizer

    if name == "adam":
        return AdamOptimizer(alpha=1e-3)
    return SGDOptimizer(lr=0.01, weight_decay=1e-4)


def _multigpu_bert(device: str, optimizer: str, strategy=None, zero=0,
                   remat=False, compiled=True, slices=1, capture=True):
    """The train phase's BERT-base, batch 8, seq 2048, weights from seed
    0 (every rank draws the same global weights), over `slices` slices,
    the step captured unless `capture` is False (or a blocker keeps it
    eager); uncompiled, its layer graph alone."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert

    ff = FFModel(FFConfig(batch_size=TRAIN_BATCH, device=device, seed=0,
                          zero_stage=zero, remat=remat, slices=slices))
    build_bert(ff, batch_size=TRAIN_BATCH, seq_length=TRAIN_SEQ, **BERT)
    if compiled:
        ff.compile(optimizer=_multigpu_optimizer(optimizer),
                   strategy=strategy, seed=0)
        if not capture:
            keep_eager(ff)
    return ff


def _multigpu_moe(device: str, strategy=None, compiled=True, capture=False):
    """The MoE legs' encoder (MOE) at batch 8, seq 2048, SGD as the BERT
    legs, weights from seed 0; uncompiled, its layer graph alone.  Its
    step is eager unless `capture`: the legs' routing check
    (watch_routing) copies every step's expert ids to the host."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.moe import build_moe_encoder

    ff = FFModel(FFConfig(batch_size=TRAIN_BATCH, device=device, seed=0))
    build_moe_encoder(ff, batch_size=TRAIN_BATCH, seq_length=TRAIN_SEQ,
                      **MOE)
    if compiled:
        ff.compile(optimizer=_multigpu_optimizer("sgd"), strategy=strategy,
                   seed=0)
        if not capture:
            keep_eager(ff)
    return ff


def moe_data(n: int, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, TRAIN_SEQ, MOE["hidden_size"])).astype(
        np.float32)
    y = rng.randint(0, MOE["num_classes"], (n, TRAIN_SEQ)).astype(np.int32)
    return x, y


def moe_strategy(dp: int, ep: int):
    """Data dp x expert ep: the inputs split over data, ShardConfig(
    expert=ep) on every group_by and experts_dense."""
    from flexflow_tpu_torch.ops.op import ShardConfig
    from flexflow_tpu_torch.strategy import Strategy

    axes = {"data": dp} if dp > 1 else {}
    if ep > 1:
        axes["expert"] = ep
    s = Strategy(mesh_axes=axes)
    if dp > 1:
        s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
    if ep > 1:
        for i in range(MOE["num_layers"]):
            for kind in ("group_by", "experts_dense"):
                s.shard_configs[f"{kind}_{i}"] = ShardConfig(expert=ep)
    return s


def watch_routing(torch, ff, top3: bool) -> list:
    """Wrap every TopK and Aggregate of ff's compiled graph (on the
    instances) to append to the list returned, per call: ("topk", op
    name, first global row of this rank's rows, expert ids as numpy,
    and with top3 the three largest gate probabilities), ("aux", op
    name, the balance loss)."""
    seen = []
    ex = ff.executor
    for op in ff.operators.topo_order():
        kind = op.op_type.name
        if kind not in ("TOPK", "AGGREGATE"):
            continue
        start = 0
        if kind == "TOPK" and ex.mesh is not None:
            shape = op.outputs[1].shape.logical_shape
            start = ex.op_plans[op.guid].outs[1].local_index(
                shape, ex.mesh)[0].start
        fwd = op.forward

        def watched(ins, ws, _f=fwd, _op=op, _kind=kind, _start=start,
                    **kw):
            outs = _f(ins, ws, **kw)
            if _kind == "TOPK":
                probs = (torch.topk(ins[0].detach(), 3, dim=-1).values
                         .cpu().numpy() if top3 else None)
                seen.append(("topk", _op.name, _start,
                             outs[1].cpu().numpy(), probs))
            else:
                seen.append(("aux", _op.name,
                             float(_op._last_aux.detach())))
            return outs

        op.forward = watched
    return seen


def routing_arrays(seen: list, steps: int) -> dict:
    """The recorded routing as arrays: ids [steps, layers, rows, k],
    first rows [steps, layers], top3 [steps, layers, rows, 3] (when
    recorded), balance losses [steps, layers]."""
    topk = [r for r in seen if r[0] == "topk"]
    aux = [r[2] for r in seen if r[0] == "aux"]
    layers = len(topk) // steps
    out = {"ids": np.stack([r[3] for r in topk]).reshape(
               steps, layers, *topk[0][3].shape).astype(np.int16),
           "start": np.array([r[2] for r in topk]).reshape(steps, layers),
           "aux": np.array(aux).reshape(steps, layers)}
    if topk[0][4] is not None:
        out["top3"] = np.stack([r[4] for r in topk]).reshape(
            steps, layers, -1, 3)
    return out


def moe_flips(ids, want, top3, seq: int) -> list:
    """Tokens whose expert ids differ from the one-card run's, layer by
    layer: (layer, token, ids, one-card ids, gate gap, after), the gap
    being the smallest one-card margin p_j - p_(j+1) over the differing
    choices j, and `after` the first flip at an earlier layer in the
    same sequence of `seq` tokens, if any: attention carries that
    token's changed output to every token of its sequence, so such a
    flip follows from it, not from the rounding of its own gate."""
    out, first = [], {}
    for layer in range(ids.shape[0]):
        bad = np.nonzero((ids[layer] != want[layer]).any(axis=1))[0]
        here = []
        for tok in bad:
            diff = np.nonzero(ids[layer, tok] != want[layer, tok])[0]
            p = top3[layer, tok]
            gap = min(float(p[j] - p[j + 1]) for j in diff)
            here.append({"layer": layer, "token": int(tok),
                         "ids": ids[layer, tok].tolist(),
                         "one_card_ids": want[layer, tok].tolist(),
                         "gate_gap": gap,
                         "after": first.get(int(tok) // seq)})
        for f in here:
            first.setdefault(f["token"] // seq, [layer, f["token"]])
        out += here
    return out


def dropped_share(ids) -> float:
    """The share of (token, choice) pairs past their expert's capacity,
    over every layer of one step's global ids [layers, tokens, k]."""
    n, k = MOE["num_exp"], MOE["num_select"]
    cap = int(np.ceil(MOE["alpha"] * k * ids.shape[1] / n))
    dropped = sum(max(0, int(c) - cap) for layer in ids
                  for c in np.bincount(layer.reshape(-1), minlength=n))
    return dropped / ids.size


def _multigpu_cnn(torch, device: str):
    _, _, SmallResNet = resnet_modules()
    torch.manual_seed(1)
    return build_resnet(torch, SmallResNet(), MULTIGPU_CNN["batch"],
                        MULTIGPU_CNN["px"], device, "float32")


def pipeline_strategy(dp: int, pp: int, microbatches: int):
    """GPipe over `pp` stages with `microbatches` per data shard, data
    parallel over `dp`: the form of the Unity search's candidates."""
    from flexflow_tpu_torch.strategy import Strategy

    s = Strategy(mesh_axes={"data": dp, "pipe": pp} if dp > 1
                 else {"pipe": pp},
                 pipeline={"degree": pp, "num_microbatches": microbatches,
                           "axis": "pipe",
                           "dp_axis": "data" if dp > 1 else None})
    if dp > 1:
        s.edge_ops["__inputs__"] = [("repartition", {"dim": 0, "degree": dp})]
    return s


def factored_strategy(attn: int, ffn1: int):
    """BERT-base over {model0: 2, model1: 2}: every attention at channel
    `attn` and every first FFN at channel `ffn1`, the view normalizer
    factoring each degree onto the axes (4: model1 + model0, 2:
    model1)."""
    from flexflow_tpu_torch.ops.op import ShardConfig
    from flexflow_tpu_torch.strategy import Strategy

    s = Strategy(mesh_axes={"model0": 2, "model1": 2})
    for i in range(BERT["num_layers"]):
        s.shard_configs[f"attn_{i}"] = ShardConfig(channel=attn)
        s.shard_configs[f"ffn1_{i}"] = ShardConfig(channel=ffn1)
    return s


def _multigpu_strategy(leg, job):
    """The leg's Strategy (None for the demo, which has no graph)."""
    from flexflow_tpu_torch.models.transformer import (bert_sp_strategy,
                                                       bert_tp_strategy)
    from flexflow_tpu_torch.strategy import Strategy, data_parallel_strategy

    kind = leg["strategy"][0]
    if kind == "bert_tp":
        return bert_tp_strategy(leg["ranks"], tp=leg["strategy"][1])
    if kind == "bert_sp":
        return bert_sp_strategy(leg["ranks"], sp=leg["strategy"][1])
    if kind == "file":
        return Strategy.load(job["strategy_file"])
    if kind == "pipe":
        return pipeline_strategy(*leg["strategy"][1:])
    if kind == "pipe_file":
        return Strategy.load(job["pipeline_file"])
    if kind == "moe":
        return moe_strategy(*leg["strategy"][1:])
    if kind == "moe_file":
        return Strategy.load(job["moe_strategy_file"])
    if kind == "factored":
        return factored_strategy(*leg["strategy"][1:])
    if kind == "slices_file":
        return Strategy.load(job["slices_strategy_file"])
    if kind == "demo":
        return None
    return data_parallel_strategy(leg["ranks"])


def pipeline_launches(layers: int, stages: int, microbatches: int,
                      schedule: str = "gpipe", remat: bool = False) -> dict:
    """K1, K2 and K3 launches per rank per step of a pipelined stack of
    `layers` attention blocks.  GPipe keeps the lockstep schedule: every
    tick runs the stage's L/S blocks, the fill and drain ticks on zeros,
    and its backward every tick again: (L/S)(M+S-1) each (L*M on one
    stage), and K1 twice that under remat (the backward recomputes each
    block).  1F1B runs only the valid halves: M(L/S) forwards, each
    recomputed before its backward, so K1 2M(L/S) and K2, K3 M(L/S)."""
    per = layers // stages
    if schedule == "1f1b":
        return {"K1": 2 * microbatches * per, "K2": microbatches * per,
                "K3": microbatches * per}
    n = per * (microbatches + stages - 1)
    return {"K1": n * (2 if remat else 1), "K2": n, "K3": n}


def expected_launches(leg, strategy) -> dict:
    """K1-K3 launches per rank per step the leg must read."""
    kind = leg["strategy"][0]
    L = (MOE if leg["reference"] == "moe" else BERT)["num_layers"]
    if kind == "demo":
        _, _, pp, m = leg["strategy"]
        return pipeline_launches(L, pp, m, "1f1b")
    if strategy is not None and strategy.pipeline:
        p = strategy.pipeline
        return pipeline_launches(L, p["degree"], p["num_microbatches"],
                                 remat=leg.get("remat", False))
    # one launch each per layer, per ring block under sequence parallelism
    n = L * strategy.mesh_axes.get("seq", 1)
    return {"K1": n, "K2": n, "K3": n}


def _weights_diff(got: dict, want: dict):
    worst, at = 0.0, None
    for op, entries in want.items():
        for k, v in entries.items():
            d = float(np.abs(got[op][k] - v).max())
            if d > worst:
                worst, at = d, f"{op}.{k}"
    return worst, at


def _multigpu_leg(torch, dist, leg, job, rank):
    """One leg on this rank: compile under the leg's strategy, two timed
    train steps, launches, memory, and (rank 0) the gathered weights
    against the one-card run."""
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel import collectives

    npz = np.load(job["data"][leg["reference"]])
    data = {"x": npz["x"], "y": npz["y"]}
    if leg["reference"] == "demo":
        return _multigpu_demo_leg(torch, dist, fa, leg, job, rank, data)
    strategy = _multigpu_strategy(leg, job)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seen = None
    if leg["reference"] == "cnn":
        ff = _multigpu_cnn(torch, "cuda")
    elif leg["reference"] == "moe":
        ff = _multigpu_moe("cuda", strategy)
        seen = watch_routing(torch, ff, top3=False)
    else:
        ff = _multigpu_bert("cuda", leg["optimizer"], strategy,
                            leg.get("zero", 0), leg.get("remat", False),
                            slices=leg.get("slices", 1))
    compile_s = time.perf_counter() - t0
    b = MULTIGPU_CNN["batch"] if leg["reference"] == "cnn" else TRAIN_BATCH
    reset_leg_launches(fa, bk)
    collectives.traffic.clear()
    losses, step_s = [], []
    for i in range(MULTIGPU_STEPS):
        x, y = data["x"][i * b:(i + 1) * b], data["y"][i * b:(i + 1) * b]
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if i == 0:
            losses.append(float(ff.train_step({"input": x}, y)["loss"]))
        else:
            losses.append(_fit_step(ff, x, y, b))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    rec = {"rank": rank, "losses": losses, "step_s": step_s,
           "compile_s": compile_s,
           "launches_per_step": leg_launches(fa, bk, MULTIGPU_STEPS),
           "peak_memory_gb": peak / 1e9,
           "opt_state_bytes": ff.executor.opt_state_bytes(ff._opt_state),
           "zero_stage": ff.executor.zero_stage,
           "zero_fallback_leaves": ff.executor.zero_fallback_leaves(),
           "mesh": dict(ff.strategy.mesh_axes),
           # the mesh the step ran on (expanded under slices)
           "exec_mesh": dict(ff.executor.mesh.axis_sizes),
           "hier_axis": ff.executor.hier_axis,
           "wus_axis": ff.executor.wus_axis,
           # payload bytes per step this rank handed to collectives, by
           # the op class whose forward ran them (backward included)
           "collective_bytes_per_step": {
               f"{scope}.{kind}": v / MULTIGPU_STEPS
               for (scope, kind), v in collectives.traffic.items()}}
    if seen is not None:
        routing = routing_arrays(seen, MULTIGPU_STEPS)
        rec["routing_file"] = f"{job['out_dir']}/{leg['name']}_{rank}.npz"
        np.savez(rec["routing_file"], **routing)
        rec["expert_weight_bytes"] = expert_weight_bytes(ff)
        rec["balance_losses"] = routing["aux"].sum(axis=1).tolist()
    weights = ff.get_weights()
    state = ff.get_state() if leg["reference"] == "cnn" else None
    if leg.get("zero") == 2:
        rec["grad_memory"] = grad_memory(torch, ff, data["x"][:b],
                                         data["y"][:b])
    if rank == 0:
        want = np.load(job["data"][leg["reference"] + "_after"],
                       allow_pickle=True)["weights"].item()
        if "__pipeline__" in weights:
            # the stacked blocks unstacked onto the graph's block ops
            weights = _multigpu_bert("cuda", leg["optimizer"],
                                     compiled=False)._adapt_weight_layout(
                                         weights)
        rec["weights_diff"], rec["worst_weight"] = _weights_diff(weights,
                                                                 want)
        if state is not None:
            want_s = np.load(job["data"]["cnn_after"],
                             allow_pickle=True)["state"].item()
            rec["running_stats_diff"], _ = _weights_diff(state, want_s)
        if leg.get("zero") in (2, 3):
            rec["zero0"] = _multigpu_zero0(torch, dist, leg, job, data,
                                           weights)
    elif leg.get("zero") in (2, 3):
        rec["zero0"] = _multigpu_zero0(torch, dist, leg, job, data, None)
    if job.get("profile"):
        prof = _rank_profile(torch, ff, data["x"][:b], data["y"][:b])
        if rank == 0:
            rec["profile"] = prof
    st = ff.executor.capture_status
    rec["capture_status"] = {k: st[k] for k in (
        "mode", "blockers", "warmup_steps", "captures", "replays",
        "launches_at_capture", "traffic_at_capture") if k in st}
    rec["grad_bytes"] = dict(ff.executor.grad_bytes,
                             full=ff.executor.full_grad_bytes(ff._weights))
    del ff
    torch.cuda.empty_cache()
    if job.get("profile") and leg["name"] in CAPTURE_LEGS + CAPTURE_ATTEMPTS:
        rec["capture"] = _leg_capture_check(torch, dist, leg, job, data,
                                            rank)
    if leg.get("flat_baseline"):
        rec["flat"] = _multigpu_flat(torch, dist, leg, job, data,
                                     weights if rank == 0 else None, rank)
    return rec


def _leg_capture_check(torch, dist, leg, job, data, rank) -> dict:
    """The leg's BERT in its group eager and captured (NCCL), from the
    same weights and batches: CAPTURE_STEPS train steps (losses; the
    weights after them on rank 0), then CAPTURE_PROFILE_STEPS profiled
    (step ms, device busy, idle share, events and K1-K3 launches per
    step, and under ZeRO-3 how much of the prefetch's all-gathers ran
    beside compute)."""
    strategy = _multigpu_strategy(leg, job)
    b = TRAIN_BATCH
    batches = [(data["x"][(i % MULTIGPU_STEPS) * b:][:b],
                data["y"][(i % MULTIGPU_STEPS) * b:][:b])
               for i in range(CAPTURE_STEPS)]
    out, weights = {}, {}
    for mode in ("eager", "graph"):
        if leg["reference"] == "moe":
            ff = _multigpu_moe("cuda", strategy, capture=mode == "graph")
        else:
            ff = _multigpu_bert("cuda", leg["optimizer"], strategy,
                                leg.get("zero", 0),
                                slices=leg.get("slices", 1),
                                capture=mode == "graph")
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(ff.train_step({"input": x}, y)["loss"])
                  for x, y in batches]
        peak = torch.cuda.max_memory_allocated()
        weights[mode] = ff.get_weights()
        x, y = batches[-1]
        prof = profile_steps(torch, lambda: ff.train_step({"input": x}, y),
                             CAPTURE_PROFILE_STEPS,
                             expected_launches(leg, strategy))
        events = prof.pop("_events")
        if leg.get("zero") == 3:
            prof["all_gather"] = gather_overlap(events, CAPTURE_PROFILE_STEPS)
        st = ff.executor.capture_status
        out[mode] = {"losses": losses, "profile": prof,
                     "peak_memory_gb": peak / 1e9,
                     "capture_status": {k: st[k] for k in (
                         "mode", "blockers", "replays",
                         "launches_at_capture", "traffic_at_capture")
                         if k in st}}
        del ff
        torch.cuda.empty_cache()
    out["loss_err"] = _loss_err(out["graph"]["losses"],
                                out["eager"]["losses"])
    if rank == 0:
        out["weights_diff"], out["worst_weight"] = _weights_diff(
            weights["graph"], weights["eager"])
    return out


def gather_overlap(events, steps: int) -> dict:
    """Per step: the device ms of NCCL's all-gather kernels, and the
    share of it during which a compute kernel (no NCCL kernel, no copy
    or set) ran too."""
    def is_gather(name):
        low = name.lower()
        return "nccl" in low and "allgather" in low.replace("_", "")

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if "nccl" not in e.name.lower()
                   and "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower())
    union = []
    for a, b in spans:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    total = beside = 0.0
    for e in events:
        if not is_gather(e.name):
            continue
        a, b = e.time_range.start, e.time_range.end
        total += b - a
        beside += sum(max(0.0, min(b, v) - max(a, u)) for u, v in union)
    return {"ms_per_step": total / 1e3 / steps,
            "beside_compute_ms_per_step": beside / 1e3 / steps,
            "beside_compute_share": beside / total if total else None}


def reset_leg_launches(fa, bk) -> None:
    """Every kernel count a multigpu leg reports, set to 0."""
    reset_flash_launches(fa)
    bk.bn_apply.launches = 0


def leg_launches(fa, bk, steps: int) -> dict:
    """K1-K3 and P1 launches per step since reset_leg_launches."""
    return {k: v / steps for k, v in dict(
        flash_launches(fa), P1=bk.bn_apply.launches).items()}


def _demo_leg_schedule(torch, dist, fa, mesh, schedule, data, steps):
    """`steps` steps of the demo under `schedule` from the seed-0
    weights on this rank's part: losses, step seconds, launches per step,
    peak memory and the global weights after them."""
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk
    from flexflow_tpu_torch.parallel.collectives import all_gather
    from flexflow_tpu_torch.parallel.pipeline import \
        make_pipelined_transformer_step

    pp = mesh.size("pp")
    init_fn, step = make_pipelined_transformer_step(
        mesh, schedule=schedule, num_microbatches=data["m"], **DEMO)
    params = init_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_leg_launches(fa, bk)
    b = TRAIN_BATCH
    losses, step_s = [], []
    for i in range(steps):
        x = torch.tensor(data["x"][i * b:(i + 1) * b], device="cuda")
        y = torch.tensor(data["y"][i * b:(i + 1) * b, 0], device="cuda")
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        params, loss = step(params, x, y)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    launches = leg_launches(fa, bk, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    weights = {"blocks": {k: all_gather(v, 0, pp, mesh.group("pp")).cpu()
                          .numpy() for k, v in params["blocks"].items()},
               "head": {"head": params["head"]["head"].cpu().numpy()}}
    del params
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": step_s, "launches_per_step": launches,
            "peak_memory_gb": peak}, weights


def _multigpu_demo_leg(torch, dist, fa, leg, job, rank, data):
    """The demo transformer of parallel/pipeline.py at BERT-base widths
    over the group's pipe axis: 1F1B, then GPipe from the same weights
    and batches; each held against the demo trained on one card, and
    against each other."""
    from flexflow_tpu_torch.parallel.machine import make_mesh

    _, _, pp, m = leg["strategy"]
    mesh = make_mesh({"pp": pp}, torch.device("cuda",
                                              torch.cuda.current_device()))
    data = dict(data, m=m)
    t0 = time.perf_counter()
    rec, w_1f1b = _demo_leg_schedule(torch, dist, fa, mesh, "1f1b", data,
                                     MULTIGPU_STEPS)
    gpipe, w_gpipe = _demo_leg_schedule(torch, dist, fa, mesh, "gpipe", data,
                                        MULTIGPU_STEPS)
    rec.update({"rank": rank, "gpipe": gpipe, "mesh": {"pp": pp},
                "compile_s": time.perf_counter() - t0, "opt_state_bytes": 0,
                "zero_stage": 0, "zero_fallback_leaves": []})
    if rank == 0:
        want = np.load(job["data"]["demo_after"],
                       allow_pickle=True)["weights"].item()
        rec["weights_diff"], rec["worst_weight"] = _weights_diff(w_1f1b, want)
        gpipe["weights_diff"], gpipe["worst_weight"] = _weights_diff(w_gpipe,
                                                                     want)
        rec["schedules_weights_diff"], _ = _weights_diff(w_1f1b, w_gpipe)
    return rec


def _kernel_kind_mg(name: str) -> str:
    if "nccl" in name.lower():
        return "collectives"
    if "flash_" in name and "_kernel" in name:
        return "K1-K3"
    if any(t in name.lower() for t in ("gemm", "cutlass", "xmma", "sm90")):
        return "gemm"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copies"
    return "other"


def _rank_profile(torch, ff, x, y) -> dict:
    """One more train step under torch.profiler on this rank (after the
    checks, the ranks met at a barrier first: a rank that opens its
    window early would time its peers' lateness in its first
    collective): wall, device busy (the union of device events) and
    idle share, device ms by kind and the top kernels."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ff.train_step({"input": x}, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the "nccl:<op>" ranges the profiler records beside each NCCL
    # kernel would count the collective twice
    dev = [e for e in prof.events()
           if "cuda" in str(e.device_type).lower()
           and not e.name.startswith("nccl:")]
    if not dev:
        raise RuntimeError("multigpu: the profiler saw no device time")
    busy_ms = device_busy_us(dev) / 1e3
    kinds, by_name = {}, {}
    for e in dev:
        us = e.time_range.elapsed_us()
        kind = _kernel_kind_mg(e.name)
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_by_kind": kinds, "device_events": len(dev),
            "top_kernels": [{"name": n[:80], "ms": ms} for n, ms in top]}


def _fit_step(ff, x, y, b) -> float:
    """One step through fit over one batch (each rank loads its shard of
    it through the prefetching loader); its loss."""
    step, seen = ff.train_step, []

    def recording(inputs, labels):
        m = step(inputs, labels)
        seen.append(m["loss"])
        return m

    ff.train_step = recording
    try:
        ff.fit(x, y, batch_size=b, epochs=1, verbose=False)
    finally:
        del ff.train_step
    return float(seen[0])


def _multigpu_zero0(torch, dist, leg, job, data, weights3):
    """The ZeRO leg's group at stage 0, same weights and batches: the
    losses and the weights the ladder must reproduce (rank 0, given
    the leg's weights `weights3`); at a stage-2 leg, on every rank, the
    grad memory of one more step (`grad_memory`)."""
    ff = _multigpu_bert("cuda", leg["optimizer"], _multigpu_strategy(leg, job))
    losses = []
    for i in range(MULTIGPU_STEPS):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        losses.append(float(ff.train_step({"input": data["x"][sl]},
                                          data["y"][sl])["loss"]))
    weights0 = ff.get_weights()
    opt0 = ff.executor.opt_state_bytes(ff._opt_state)
    mem = (grad_memory(torch, ff, data["x"][:TRAIN_BATCH],
                       data["y"][:TRAIN_BATCH])
           if leg.get("zero") == 2 else None)
    del ff
    torch.cuda.empty_cache()
    if weights3 is None:
        return {"grad_memory": mem}
    diff, at = _weights_diff(weights3, weights0)
    return {"losses": losses, "weights_diff": diff, "worst_weight": at,
            "opt_state_bytes": opt0, "grad_memory": mem}


def grad_memory(torch, ff, x, y) -> dict:
    """Two more train_steps of ff, eager (a replay allocates nothing),
    the second as the allocator reads it: the device bytes allocated
    when the backward has ended (at the update's entry: the grads the
    step holds, its batch, loss and logits) and at the step's peak, each
    less those allocated before the step.  The first step makes what an
    eager step makes once and keeps (cuBLAS's 32 MiB workspace for each
    thread and stream, here the caller's and autograd's on the current
    stream, which a captured model's warm-up ran on a side stream)."""
    ex = ff.executor
    seen = []
    sync = ex._sync_and_update

    def reading(*a, **k):
        torch.cuda.synchronize()
        seen.append(torch.cuda.memory_allocated())
        return sync(*a, **k)

    with eager_steps(ff):
        ff.train_step({"input": x}, y)
        ex._sync_and_update = reading
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ff.train_step({"input": x}, y)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        finally:
            del ex._sync_and_update
    return {"after_backward": seen[0] - base, "peak": peak - base}


def _multigpu_flat(torch, dist, leg, job, data, weights_hier, rank):
    """The leg's group again on the same two-level mesh with the
    hierarchical reduction switched off (hier_axis None: an all-reduce
    over each axis, tests/test_topology.py:328-342's flat baseline), from
    the same weights and batches and by the same steps (train_step, then
    fit; a profiled third under NCCL): its losses, step seconds,
    collective bytes per step and, on rank 0, its profile and its
    weights against the hierarchical run's (HIER_FLAT_TOL)."""
    from flexflow_tpu_torch.parallel import collectives

    ff = _multigpu_bert("cuda", leg["optimizer"], _multigpu_strategy(leg, job),
                        leg.get("zero", 0), slices=leg.get("slices", 1))
    ff.executor.hier_axis = None
    collectives.traffic.clear()
    losses, step_s = [], []
    b = TRAIN_BATCH
    for i in range(MULTIGPU_STEPS):
        x, y = data["x"][i * b:(i + 1) * b], data["y"][i * b:(i + 1) * b]
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if i == 0:
            losses.append(float(ff.train_step({"input": x}, y)["loss"]))
        else:
            losses.append(_fit_step(ff, x, y, b))
        step_s.append(time.perf_counter() - t0)
    out = {"losses": losses, "step_s": step_s,
           "collective_bytes_per_step": {
               f"{scope}.{kind}": v / MULTIGPU_STEPS
               for (scope, kind), v in collectives.traffic.items()}}
    flat = ff.get_weights()
    if job.get("profile"):
        prof = _rank_profile(torch, ff, data["x"][:b], data["y"][:b])
        if rank == 0:
            out["profile"] = prof
    del ff
    torch.cuda.empty_cache()
    if weights_hier is not None:
        out.update(hier_flat_diff(weights_hier, flat))
    return out


def hier_flat_diff(hier: dict, flat: dict) -> dict:
    """The largest |hier - flat| and the largest excess of it over
    HIER_FLAT_TOL's rtol |flat| (within the limit when <= its atol)."""
    rtol = HIER_FLAT_TOL["rtol"]
    worst = excess = 0.0
    at = None
    for op, entries in flat.items():
        for k, v in entries.items():
            d = np.abs(hier[op][k] - v)
            e = float((d - rtol * np.abs(v)).max())
            worst = max(worst, float(d.max()))
            if at is None or e > excess:
                excess, at = e, f"{op}.{k}"
    return {"weights_diff": worst, "excess_over_rtol": excess,
            "worst_weight": at}


def _multigpu_rank(rank, world, cards, backend, port, job, out_dir):
    """A spawned rank: its card, the group, then every leg of the job."""
    import traceback

    import torch
    import torch.distributed as dist

    out = {"rank": rank}
    try:
        torch.cuda.set_device(rank % cards)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from flexflow_tpu_torch import distributed

        distributed.initialize(f"localhost:{port}", world, rank,
                               local_device_ids=[rank % cards],
                               backend=backend)
        out["legs"] = [_multigpu_leg(torch, dist, leg, job, rank)
                       for leg in job["legs"]]
        out["ok"] = True
    except Exception:  # reported to the parent, which fails the phase
        out["ok"] = False
        out["error"] = traceback.format_exc()
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    if out["ok"]:
        dist.destroy_process_group()


def _run_ranks(world, cards, job, out_dir):
    """Spawn `world` ranks (rank r on card r % cards; NCCL when every
    rank has a card of its own, else gloo, named); kill them all at
    MULTIGPU_TIMEOUT_S."""
    import multiprocessing as mp
    import socket

    backend = "nccl" if cards >= world else "gloo"
    # under NCCL rank 0 profiles a third step (after the checks); over
    # gloo a profile would time the host's staging
    job = dict(job, profile=backend == "nccl", out_dir=out_dir)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_multigpu_rank,
                         args=(r, world, cards, backend, port, job, out_dir))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + MULTIGPU_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    wall = time.perf_counter() - t0
    outs = []
    for r in range(world):
        path = Path(out_dir) / f"rank{r}.json"
        outs.append(json.loads(path.read_text()) if path.exists()
                    else {"rank": r, "ok": False,
                          "error": f"no result (exit {procs[r].exitcode})"})
    bad = [o for o in outs if not o["ok"]]
    if hung or bad:
        raise RuntimeError(
            f"multigpu: {world} ranks ({backend}, {cards} cards): hung "
            f"{hung}; failed {[o['rank'] for o in bad]}:\n"
            + (bad[0]["error"][-3000:] if bad else ""))
    return backend, wall, outs


def _one_card_demo(torch, x, y):
    """The demo transformer on this card as one stage (8 microbatches),
    two steps from the seed-0 weights: (losses, step seconds, weights
    before the last step, weights after)."""
    from flexflow_tpu_torch.parallel.pipeline import \
        make_pipelined_transformer_step

    init_fn, step = make_pipelined_transformer_step(
        None, num_microbatches=8, device="cuda", **DEMO)
    params = init_fn(0)

    def host():
        return {"blocks": {k: v.cpu().numpy()
                           for k, v in params["blocks"].items()},
                "head": {"head": params["head"]["head"].cpu().numpy()}}

    b = TRAIN_BATCH
    losses, step_s = [], []
    for i in range(MULTIGPU_STEPS):
        if i == MULTIGPU_STEPS - 1:
            before = host()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params,
                            torch.tensor(x[i * b:(i + 1) * b], device="cuda"),
                            torch.tensor(y[i * b:(i + 1) * b, 0],
                                         device="cuda"))
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    return losses, step_s, before, host()


def _one_card_reference(torch, name, tmp):
    """Two steps on this process's card: the losses and the weights (and
    the CNN's running statistics) after them, saved beside the batches."""
    if name == "demo":
        x, y = bert_data(TRAIN_BATCH * MULTIGPU_STEPS, seed=0)
        losses, step_s, before, weights = _one_card_demo(torch, x, y)
        data, after = f"{tmp}/{name}.npz", f"{tmp}/{name}_after.npz"
        np.savez(data, x=x, y=y)
        np.savez(after, weights=np.array(weights, dtype=object))
        torch.cuda.empty_cache()
        moves = {f"{op}.{k}": float(np.abs(v - before[op][k]).max())
                 for op, entries in weights.items()
                 for k, v in entries.items()}
        return ({"losses": losses, "step_s": step_s,
                 "last_step_moves": moves}, data, after)
    seen = None
    if name == "cnn":
        ff = _multigpu_cnn(torch, "cuda")
        b = MULTIGPU_CNN["batch"]
        rng = np.random.RandomState(1)
        x = rng.randn(b * MULTIGPU_STEPS, 3, MULTIGPU_CNN["px"],
                      MULTIGPU_CNN["px"]).astype(np.float32)
        y = rng.randint(0, 10, b * MULTIGPU_STEPS).astype(np.int32)
    elif name == "moe":
        ff = _multigpu_moe("cuda")
        b = TRAIN_BATCH
        x, y = moe_data(b * MULTIGPU_STEPS, seed=0)
        seen = watch_routing(torch, ff, top3=True)
    else:
        ff = _multigpu_bert("cuda", "adam" if name == "bert_adam" else "sgd")
        b = TRAIN_BATCH
        x, y = bert_data(b * MULTIGPU_STEPS, seed=0)
    losses, step_s = [], []
    for i in range(MULTIGPU_STEPS):
        if i == MULTIGPU_STEPS - 1:
            before = ff.get_weights()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(ff.train_step({"input": x[i * b:(i + 1) * b]},
                                          y[i * b:(i + 1) * b])["loss"]))
        step_s.append(time.perf_counter() - t0)
    weights = ff.get_weights()
    data, after = f"{tmp}/{name}.npz", f"{tmp}/{name}_after.npz"
    np.savez(data, x=x, y=y)
    np.savez(after, weights=np.array(weights, dtype=object),
             state=np.array(ff.get_state(), dtype=object))
    rec = {"losses": losses, "step_s": step_s}
    if seen is not None:
        routing = routing_arrays(seen, MULTIGPU_STEPS)
        np.savez(f"{tmp}/{name}_routing.npz", **routing)
        rec["routing_file"] = f"{tmp}/{name}_routing.npz"
        rec.update(expert_weight_bytes=expert_weight_bytes(ff),
                   balance_losses=routing["aux"].sum(axis=1).tolist(),
                   dropped_pair_share=[dropped_share(i)
                                       for i in routing["ids"]])
    del ff
    torch.cuda.empty_cache()
    # each weight's largest move in the last step: what a rank that
    # skipped that update would read against this run
    rec["last_step_moves"] = {
        f"{op}.{k}": float(np.abs(v - before[op][k]).max())
        for op, entries in weights.items() for k, v in entries.items()}
    return rec, data, after


def expert_weight_bytes(ff) -> int:
    """Bytes of the ExpertsDense weights this rank holds."""
    return sum(w.numel() * w.element_size()
               for op, entries in ff._weights.items()
               if op.startswith("experts_dense") for w in entries.values())


def search_moe(cfg):
    """The MoE legs' encoder on `cfg`, not compiled."""
    from flexflow_tpu_torch import FFModel
    from flexflow_tpu_torch.models.moe import build_moe_encoder

    ff = FFModel(cfg)
    build_moe_encoder(ff, batch_size=cfg.batch_size, seq_length=TRAIN_SEQ,
                      **MOE)
    return ff


def _moe_strategy_file(torch, run_dir) -> str:
    """The Unity search's strategy for the MoE encoder on MOE_DEVICES
    GPUs of hgx_h100_8.json, ops timed on the card, written to
    run_dir/moe_strategy.json."""
    from flexflow_tpu_torch.pcg.search import unity_search

    path = Path(run_dir) / "moe_strategy.json"
    cfg = search_config(str(Path(run_dir) / "op_costs.json"))
    unity_search(search_moe(cfg), MOE_DEVICES).save(str(path))
    torch.cuda.empty_cache()
    return str(path)


def _searched_strategy_file(torch, fa, run_dir) -> str:
    """The search phase's 8-GPU strategy file; without that phase, the
    same Unity search over hgx_h100_8.json, run here."""
    path = Path(run_dir) / "searched_strategy.json"
    if not path.exists():
        from flexflow_tpu_torch.pcg.search import unity_search

        cfg = search_config(str(Path(run_dir) / "op_costs.json"))
        unity_search(search_bert(cfg), SEARCH_DEVICES).save(str(path))
        torch.cuda.empty_cache()
    return str(path)


def _slices_strategy_file(torch, run_dir) -> dict:
    """The Unity search's strategy for BERT-base on 4 GPUs as 2 slices
    of 2 (FFConfig(slices=2) over SLICES_MACHINE's H100 rates: a
    SliceHierarchy of 2 nodes x 2 GPUs), ops timed on the card, written
    to run_dir/slices_strategy.json: the file, its placement and whether
    its reduction is hierarchical."""
    from flexflow_tpu_torch.pcg.search import unity_search

    path = Path(run_dir) / "slices_strategy.json"
    cfg = search_config(str(Path(run_dir) / "op_costs.json"),
                        machine=SLICES_MACHINE, slices=2)
    best = unity_search(search_bert(cfg), 4)
    best.save(str(path))
    torch.cuda.empty_cache()
    return {"file": str(path),
            "placement": best.search_stats.get("placement"),
            "hierarchical_reduction": best.search_stats.get(
                "hierarchical_reduction"),
            "strategy": json.loads(best.to_json())}


def event_prices(run_dir, strategy) -> dict:
    """The task-graph simulator's step ms for `strategy` over BERT-base
    on SLICES_MACHINE's H100 rates cut to 2 nodes of n/2 GPUs, priced
    on the switched GpuNodeModel and on the same nodes as a routed
    network (sim/network.py gpu_node_network), with the search's
    measured op costs."""
    from flexflow_tpu_torch.pcg.rewrite import cancel_all_inverse_parallel_ops
    from flexflow_tpu_torch.sim.machine_model import (GpuNodeModel,
                                                      machine_file)
    from flexflow_tpu_torch.sim.network import gpu_node_network
    from flexflow_tpu_torch.sim.simulator import make_cost_model
    from flexflow_tpu_torch.sim.taskgraph import TaskGraphSimulator
    from flexflow_tpu_torch.strategy import apply_strategy, assign_views

    cfg = search_config(str(Path(run_dir) / "op_costs.json"),
                        machine=SLICES_MACHINE)
    base = GpuNodeModel.from_file(machine_file(SLICES_MACHINE))
    node = GpuNodeModel(num_nodes=2,
                        gpus_per_node=strategy.total_devices // 2,
                        device=base.device(), nvlink_bw=base.nvlink_bw,
                        nvlink_lat=base.nvlink_lat, ib_bw=base.ib_bw,
                        ib_lat=base.ib_lat)
    g = cancel_all_inverse_parallel_ops(
        apply_strategy(search_bert(cfg).layers, strategy))
    assign_views(g, strategy.mesh_axes)
    out = {}
    for name, m in (("gpu_node_model", node),
                    ("networked", gpu_node_network(node))):
        res = TaskGraphSimulator(m, make_cost_model(cfg, m)).simulate(
            g, strategy.mesh_axes)
        out[name] = res.total_time * 1e3
    return out


def _multigpu_prediction(run_dir, leg, strategy) -> float:
    """The simulator's step for `strategy` on hgx_h100_8.json (for a
    slice leg, SLICES_MACHINE's rates as a SliceHierarchy of its
    slices), with the search's measured op costs."""
    from flexflow_tpu_torch.sim.machine_model import make_machine_model

    if leg.get("slices", 1) > 1:
        cfg = search_config(str(Path(run_dir) / "op_costs.json"),
                            machine=SLICES_MACHINE, slices=leg["slices"])
        return predicted_step(cfg, search_bert(cfg),
                              make_machine_model(cfg, strategy.total_devices),
                              strategy)
    cfg = search_config(str(Path(run_dir) / "op_costs.json"))
    build = search_moe if leg["reference"] == "moe" else search_bert
    return predicted_step(cfg, build(cfg),
                          make_machine_model(cfg, strategy.total_devices),
                          strategy)


def _pipeline_candidates(torch, run_dir) -> list:
    """Every pipeline the Unity search prices for BERT-base on
    PIPELINE_DEVICES GPUs of hgx_h100_8.json, with the search's measured
    op costs, cheapest first: its strategy and its analytic and
    event-simulated steps in ms.  The cheapest is written to
    run_dir/pipeline_strategy.json for the pp_searched leg."""
    from flexflow_tpu_torch.pcg.unity import make_unity_search

    cfg = search_config(str(Path(run_dir) / "op_costs.json"))
    search, cost_model = make_unity_search(search_bert(cfg),
                                           PIPELINE_DEVICES)
    cands = search.pipeline_candidates()
    cost_model.save_persistent()
    torch.cuda.empty_cache()
    if not cands:
        raise RuntimeError("multigpu: the search priced no pipeline for "
                           f"BERT-base on {PIPELINE_DEVICES} GPUs")
    cands[0][2].save(str(Path(run_dir) / "pipeline_strategy.json"))
    return [{"strategy": json.loads(st.to_json()),
             "predicted_step_ms": t * 1e3,
             "event_predicted_step_ms": None if e is None else e * 1e3}
            for t, e, st in cands]


def phase_multigpu(torch, fa, card: str, run_dir: str,
                   names=None) -> dict:
    """BERT-base data x tensor parallel, data x sequence parallel (ring
    attention through K1-K3), ZeRO-3 under Adam, the searched 8-GPU
    strategy, pipelines (data x pipe GPipe with and without remat, pipe
    4, the search's cheapest pipeline, the demo transformer under 1F1B
    and GPipe), a data-parallel CNN (P1 on every BatchNorm with the
    global batch's statistics), and the MoE encoder under data 4, expert
    4, data 2 x expert 2 and the search's 4-GPU strategy (routing flips,
    balance losses and expert-weight bytes checked), each over a group
    of ranks, each held against its one-card run; `names` picks some of
    the legs (and the searches only those legs need run)."""
    chosen = [leg for leg in MULTIGPU_LEGS
              if names is None or leg["name"] in names]
    kinds = {leg["strategy"][0] for leg in chosen}
    cards = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="ff_multigpu_")
    microbatch = None
    try:
        job = {"data": {}, "pipelines": None}
        if "file" in kinds:
            job["strategy_file"] = _searched_strategy_file(torch, fa, run_dir)
        if "moe_file" in kinds:
            job["moe_strategy_file"] = _moe_strategy_file(torch, run_dir)
        if "slices_file" in kinds:
            job["slices_search"] = _slices_strategy_file(torch, run_dir)
            job["slices_strategy_file"] = job["slices_search"]["file"]
        if kinds & {"pipe", "pipe_file"}:
            job["pipelines"] = _pipeline_candidates(torch, run_dir)
            job["pipeline_file"] = str(Path(run_dir) /
                                       "pipeline_strategy.json")
            # K1-K3 at the microbatch shape of the data x pipe legs (one
            # row of 2048 tokens, 12 heads)
            dev = torch.device("cuda")
            flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
            microbatch = flash_main_shape(
                torch, fa, torch.Generator(device=dev).manual_seed(0),
                torch.float32, dev, flush, shape=PIPELINE_FLASH_SHAPE)
            del flush
        refs = {}
        for name in sorted({leg["reference"] for leg in chosen}):
            refs[name], job["data"][name], job["data"][name + "_after"] = \
                _one_card_reference(torch, name, tmp)
        legs = []
        for world in sorted({leg["ranks"] for leg in chosen}):
            group = [leg for leg in chosen if leg["ranks"] == world]
            out_dir = tempfile.mkdtemp(dir=tmp)
            backend, wall, outs = _run_ranks(world, cards,
                                             dict(job, legs=group), out_dir)
            for i, leg in enumerate(group):
                legs.append(_multigpu_record(leg, [o["legs"][i] for o in outs],
                                             refs[leg["reference"]], backend,
                                             cards, wall, run_dir, job))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "multigpu", "card": card, "cards": cards,
           "steps": MULTIGPU_STEPS, "legs": legs,
           "tolerance": MULTIGPU_TOL,
           "model": dict(BERT, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         dtype="float32", allow_tf32=False),
           "cnn": dict(MULTIGPU_CNN, model="resnet_parity's SmallResNet"),
           "moe": dict(MOE, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       dtype="float32", allow_tf32=False,
                       flip_gap_limit=MOE_FLIP_GAP,
                       balance_tolerance=MOE_BALANCE_TOL),
           "demo": DEMO, "pipeline_candidates": job["pipelines"],
           "hier_flat_tolerance": HIER_FLAT_TOL,
           "flash_microbatch": None if microbatch is None else {
               "shape": list(PIPELINE_FLASH_SHAPE),
               **{k: microbatch[k] for k in (
                   "kernel_ms", "plain_ms", "library_ms", "share_of_bound",
                   "err_over_scale")},
               "bound_ms": {k: b["bound_ms"]
                            for k, b in microbatch["bounds"].items()}}}
    emit(rec)
    faults = [f for leg in legs for f in leg["faults"]]
    if faults:
        raise RuntimeError("multigpu: " + "; ".join(faults))
    return rec


def _loss_err(got, want) -> float:
    """Largest error of `got` against `want`, over max(1, |want|)."""
    return max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, want))


def _pipeline_prediction(strategy, job) -> dict:
    """The Unity search's price of a pipeline strategy: its candidate's
    analytic and event-simulated steps (job["pipelines"])."""
    key = (strategy.mesh_axes, strategy.pipeline)
    cand = next((c for c in job.get("pipelines", ())
                 if (c["strategy"]["mesh_axes"], c["strategy"]["pipeline"])
                 == key), None)
    if cand is None:
        return {"predicted_step_ms": None,
                "prediction_note": "not among the search's candidates"}
    return {"predicted_step_ms": cand["predicted_step_ms"],
            "event_predicted_step_ms": cand["event_predicted_step_ms"],
            "prediction_note": "the Unity search's GPipe terms for this "
                               "strategy (pcg/unity.py _pp_candidates) on "
                               f"{PIPELINE_DEVICES} GPUs of "
                               f"{SEARCH_MACHINE}.json with the measured "
                               "op costs; the event figure is the re-rank's"}


def _multigpu_record(leg, ranks, ref, backend, cards, wall, run_dir, job):
    """A leg's record from its ranks' reports, with the checks."""
    from flexflow_tpu_torch.strategy import Strategy

    r0 = ranks[0]
    name, world = leg["name"], leg["ranks"]
    faults = []
    loss_diff = _loss_err(r0["losses"], ref["losses"])
    if not (np.isfinite(r0["losses"]).all()
            and loss_diff <= MULTIGPU_TOL["loss"]):
        faults.append(f"{name}: losses {r0['losses']} against one card "
                      f"{ref['losses']}")
    if any(r["losses"] != r0["losses"] for r in ranks):
        faults.append(f"{name}: ranks report different losses")
    wtol = (MULTIGPU_TOL["adam_weights"] if leg["optimizer"] == "adam"
            else MULTIGPU_TOL["cnn_weights"] if leg["reference"] == "cnn"
            else MULTIGPU_TOL["weights"])
    if not r0["weights_diff"] <= wtol:
        faults.append(f"{name}: weights {r0['weights_diff']} apart "
                      f"({r0['worst_weight']}), tolerance {wtol}")
    moves = ref["last_step_moves"]
    skipped = max(moves.values())
    if not skipped > wtol:
        faults.append(f"{name}: the weight tolerance {wtol} would pass a "
                      f"skipped last update (it moves weights by at most "
                      f"{skipped})")
    strategy = want = None
    if leg["reference"] == "cnn":
        if not (r0["running_stats_diff"]
                <= MULTIGPU_TOL["cnn_running_stats"]):
            faults.append(f"{name}: running statistics "
                          f"{r0['running_stats_diff']} apart")
        for r in ranks:
            if r["launches_per_step"]["P1"] <= 0:
                faults.append(f"{name}: rank {r['rank']} launched no P1")
    else:
        strategy = _multigpu_strategy(leg, job)
        want = expected_launches(leg, strategy)
        for r in ranks:
            got = r["launches_per_step"]
            if any(got[k] != want[k] for k in want):
                faults.append(f"{name}: rank {r['rank']} launched {got} "
                              f"per step, expected {want}")
    if "gpipe" in r0:
        # the demo's GPipe run from the same weights: against one card
        # and against 1F1B
        g = r0["gpipe"]
        g_err = _loss_err(g["losses"], ref["losses"])
        if g_err > MULTIGPU_TOL["loss"] or not g["weights_diff"] <= wtol:
            faults.append(f"{name}: GPipe {g['losses']}, weights "
                          f"{g['weights_diff']} apart, against one card")
        if (_loss_err(r0["losses"], g["losses"]) > MULTIGPU_TOL["loss"]
                or not r0["schedules_weights_diff"] <= wtol):
            faults.append(f"{name}: 1F1B against GPipe: losses "
                          f"{r0['losses']} / {g['losses']}, weights "
                          f"{r0['schedules_weights_diff']} apart")
        _, _, pp, m = leg["strategy"]
        want_g = pipeline_launches(BERT["num_layers"], pp, m)
        for r in ranks:
            got = r["gpipe"]["launches_per_step"]
            if any(got[k] != want_g[k] for k in want_g):
                faults.append(f"{name}: rank {r['rank']}'s GPipe launched "
                              f"{r['gpipe']['launches_per_step']}, expected "
                              f"{want_g}")
    moe = (_moe_checks(name, ranks, ref, strategy, faults)
           if leg["reference"] == "moe" else None)
    if "zero0" in r0:
        # the ladder against stage 0 in the same group: the same sums,
        # reduce-scattered per weight instead of all-reduced by bucket
        z = r0["zero0"]
        dz = _loss_err(z["losses"], r0["losses"])
        if dz > MULTIGPU_TOL["loss"] or z["weights_diff"] > wtol:
            faults.append(f"{name}: ZeRO-{leg['zero']} against ZeRO-0 {z}")
    if leg.get("slices", 1) > 1:
        _slice_checks(leg, ranks, faults)
    cap = _capture_checks(leg, ranks, want, wtol, faults)
    step_s = [max(r["step_s"][i] for r in ranks)
              for i in range(MULTIGPU_STEPS)]
    rec = {
        "leg": name, "ranks": world, "cards": cards, "backend": backend,
        "strategy": leg["strategy"], "mesh": r0["mesh"],
        "optimizer": leg["optimizer"], "zero_stage": r0["zero_stage"],
        "losses": r0["losses"], "one_card_losses": ref["losses"],
        "max_loss_err_over_scale": loss_diff,
        "loss_tolerance": MULTIGPU_TOL["loss"],
        "max_weight_diff": r0["weights_diff"],
        "worst_weight": r0["worst_weight"], "weight_tolerance": wtol,
        "skipped_last_update_reads": skipped,
        "weights_whose_last_update_the_tolerance_sees": [
            sum(m > wtol for m in moves.values()), len(moves)],
        "launches_per_rank_per_step": [r["launches_per_step"]
                                       for r in ranks],
        "expected_launches_per_rank_per_step": want,
        "step_ms": [s * 1e3 for s in step_s],
        "step_ms_per_rank": [[s * 1e3 for s in r["step_s"]] for r in ranks],
        "one_card_step_ms": [s * 1e3 for s in ref["step_s"]],
        "peak_memory_gb_per_rank": [r["peak_memory_gb"] for r in ranks],
        "opt_state_bytes_per_rank": [r["opt_state_bytes"] for r in ranks],
        "zero_fallback_leaves": r0["zero_fallback_leaves"],
        "group_wall_s": wall, "faults": faults,
    }
    if leg.get("remat"):
        rec["remat"] = True
    if "capture_status" in r0:
        rec["capture_status"] = r0["capture_status"]
        rec["grad_bytes_per_rank"] = [r["grad_bytes"] for r in ranks]
    if leg.get("zero") == 2:
        rec["grad_memory_per_rank"] = [
            {"zero0": r["zero0"]["grad_memory"], "zero2": r["grad_memory"]}
            for r in ranks]
    if cap is not None:
        rec["capture"] = cap
    if moe is not None:
        rec["moe"] = moe
        rec["collective_bytes_per_step_rank0"] = r0[
            "collective_bytes_per_step"]
    if leg["reference"] == "cnn":
        rec["max_running_stats_diff"] = r0["running_stats_diff"]
    if "zero0" in r0:
        rec["zero0"] = r0["zero0"]
    if "gpipe" in r0:
        g = r0["gpipe"]
        rec["schedule"] = "1f1b"
        rec["schedules_max_weight_diff"] = r0["schedules_weights_diff"]
        rec["gpipe"] = {
            "losses": g["losses"],
            "max_loss_err_over_scale": _loss_err(g["losses"],
                                                 ref["losses"]),
            "max_weight_diff": g["weights_diff"],
            "step_ms": [max(r["gpipe"]["step_s"][i] for r in ranks) * 1e3
                        for i in range(MULTIGPU_STEPS)],
            "peak_memory_gb_per_rank": [r["gpipe"]["peak_memory_gb"]
                                        for r in ranks],
            "launches_per_rank_per_step": [r["gpipe"]["launches_per_step"]
                                           for r in ranks]}
    if "profile" in r0:
        rec["profile_rank0"] = r0["profile"]
    if leg.get("slices", 1) > 1 or leg["strategy"][0] == "factored":
        rec.update(exec_mesh=r0["exec_mesh"], hier_axis=r0["hier_axis"],
                   wus_axis=r0["wus_axis"],
                   collective_bytes_per_step_per_rank=[
                       r["collective_bytes_per_step"] for r in ranks])
    if leg.get("slices", 1) > 1:
        rec["slices"] = leg["slices"]
        rec["slices_note"] = SLICES_NOTE
        if "flat" in r0:
            f = r0["flat"]
            rec["flat"] = dict(
                f, step_ms=[max(r["flat"]["step_s"][i] for r in ranks) * 1e3
                            for i in range(MULTIGPU_STEPS)],
                collective_bytes_per_step_per_rank=[
                    r["flat"]["collective_bytes_per_step"] for r in ranks],
                hier_flat_tolerance=HIER_FLAT_TOL)
        if leg["strategy"][0] == "slices_file":
            rec["search"] = {k: job["slices_search"][k]
                             for k in ("placement", "hierarchical_reduction")}
    if strategy is not None and strategy.pipeline:
        rec.update(_pipeline_prediction(strategy, job))
        if leg.get("remat"):
            rec["prediction_note"] += "; the search prices no remat"
        if backend == "gloo":
            rec["prediction_note"] += (
                f"; {world} ranks share {cards} card(s) over gloo, so the "
                "measured step is no test of it")
        rec["pipeline"] = strategy.pipeline
    elif backend == "nccl" and leg["reference"] not in ("cnn", "demo"):
        strategy.zero_stage = leg.get("zero", strategy.zero_stage)
        rec["predicted_step_ms"] = _multigpu_prediction(
            run_dir, leg, strategy) * 1e3
        if leg.get("slices", 1) > 1:
            rec["event_predicted_step_ms"] = event_prices(run_dir, strategy)
    else:
        rec["predicted_step_ms"] = None
        rec["prediction_note"] = (
            f"{world} ranks share {cards} card(s) over gloo: every "
            "collective is staged through host memory, so the measured "
            "step is no test of the simulator's NVLink prediction"
            if backend == "gloo" else "the simulator has no CNN search"
            if leg["reference"] == "cnn" else
            "the demo is no FFModel graph: no search prices it")
    if leg["strategy"][0] in ("file", "moe_file", "slices_file"):
        rec["searched_strategy"] = json.loads(strategy.to_json())
    return rec


def _capture_checks(leg, ranks, want, wtol, faults):
    """ZeRO-2's grad memory against ZeRO-0's, and a capture leg's
    eager-against-captured run (its rank 0 record, with every rank's
    profile), into `faults`."""
    name, r0 = leg["name"], ranks[0]
    if leg.get("zero") == 2:
        # the device's reading once the backward has ended: stage 2
        # holds its shards (and the fallback leaves whole), as
        # ScatterBuckets counts them from their shapes, and little else;
        # stage 0 holds every whole grad, so at least the whole grads
        # less the shards more
        for r in ranks:
            g = r["grad_bytes"]
            two = r["grad_memory"]["after_backward"]
            beyond = two - g["after_backward"]
            if beyond > ZERO2_MEMORY_TOL:
                faults.append(
                    f"{name}: rank {r['rank']} held {beyond} bytes beyond "
                    f"its grad shards after the backward (limit "
                    f"{ZERO2_MEMORY_TOL})")
            freed = g["full"] - g["after_backward"]
            got = r["zero0"]["grad_memory"]["after_backward"] - two
            if got < freed - ZERO2_MEMORY_TOL:
                faults.append(
                    f"{name}: rank {r['rank']} held {got} bytes fewer than "
                    f"ZeRO-0 after the backward, not {freed} less at most "
                    f"{ZERO2_MEMORY_TOL}")
    if "capture" not in r0:
        return None
    cap = dict(r0["capture"])
    for r in ranks:
        c = r["capture"]
        if c["graph"]["capture_status"]["mode"] != "graph":
            faults.append(f"{name}: rank {r['rank']} did not capture: "
                          f"{c['graph']['capture_status']}")
        got = c["graph"]["profile"]["launches_per_step"]
        if any(got[k] != want[k] for k in want):
            faults.append(f"{name}: rank {r['rank']}'s replays launched "
                          f"{got} per step, expected {want}")
    if cap["loss_err"] > MULTIGPU_TOL["loss"] or not cap[
            "weights_diff"] <= wtol:
        faults.append(f"{name}: captured against eager: losses "
                      f"{cap['loss_err']}, weights {cap['weights_diff']} "
                      f"({cap['worst_weight']}), tolerance {wtol}")
    cap["profile_per_rank"] = [{m: r["capture"][m]["profile"]
                                for m in ("eager", "graph")} for r in ranks]
    return cap


def _slice_checks(leg, ranks, faults) -> None:
    """A slice leg's two-level mesh, hier_axis and wus_axis as
    FFConfig(slices) gives them (data 4 over 2 slices: {slice: 2, data:
    2}, the hierarchical reduction over data, or the ZeRO update over
    data), and slices2_dp4's flat run on the same mesh: its losses, and
    its weights within HIER_FLAT_TOL of the hierarchical ones."""
    name, r0 = leg["name"], ranks[0]
    if leg["strategy"][0] == "dp":
        zero = leg.get("zero", 0) >= 1
        want = ({"slice": 2, "data": 2}, None if zero else "data",
                "data" if zero else None)
        for r in ranks:
            got = (r["exec_mesh"], r["hier_axis"], r["wus_axis"])
            if got != want:
                faults.append(f"{name}: rank {r['rank']} ran mesh, "
                              f"hier_axis, wus_axis {got}, expected {want}")
    if not leg.get("flat_baseline"):
        return
    f = r0.get("flat")
    if f is None:
        faults.append(f"{name}: no flat run on the same mesh")
        return
    if _loss_err(f["losses"], r0["losses"]) > MULTIGPU_TOL["loss"]:
        faults.append(f"{name}: flat losses {f['losses']} against the "
                      f"hierarchical {r0['losses']}")
    if not f["excess_over_rtol"] <= HIER_FLAT_TOL["atol"]:
        faults.append(f"{name}: hierarchical and flat weights "
                      f"{f['weights_diff']} apart ({f['worst_weight']}), "
                      f"beyond {HIER_FLAT_TOL}")


MOE_SCOPES = ("TopK", "GroupBy", "ExpertsDense", "Aggregate",
              "AggregateSpec")


def expert_split(strategy) -> int:
    """How many ways the strategy splits the experts (ExpertsDense's
    degree: its own ShardConfig or GroupBy's)."""
    sc = strategy.shard_configs
    return max([sc[k].expert for k in ("group_by_0", "experts_dense_0")
                if k in sc] + [1])


def _moe_checks(name, ranks, ref, strategy, faults) -> dict:
    """A MoE leg's routing against the one-card run's (every token whose
    experts differ, with its gate gap; one above MOE_FLIP_GAP is a
    fault), its balance losses (MOE_BALANCE_TOL), its expert-weight
    bytes per rank (1/E of one card's where E splits the experts) and
    its dropped-pair share and MoE collective bytes."""
    want = np.load(ref["routing_file"])
    ids = np.zeros_like(want["ids"])
    for r in ranks:
        got = np.load(r["routing_file"])
        rows = got["ids"].shape[2]
        for st in range(ids.shape[0]):
            for layer in range(ids.shape[1]):
                a = int(got["start"][st, layer])
                ids[st, layer, a:a + rows] = got["ids"][st, layer]
    flips = [dict(f, step=st) for st in range(ids.shape[0])
             for f in moe_flips(ids[st], want["ids"][st], want["top3"][st],
                                TRAIN_SEQ)]
    own = [f for f in flips if f["after"] is None]
    big = [f for f in own if not f["gate_gap"] <= MOE_FLIP_GAP]
    if big:
        faults.append(f"{name}: {len(big)} routing flips at gate gaps "
                      f"above {MOE_FLIP_GAP}, first {big[0]}")
    bal_err = max(_loss_err(r["balance_losses"], ref["balance_losses"])
                  for r in ranks)
    if not bal_err <= MOE_BALANCE_TOL:
        faults.append(f"{name}: balance losses {ranks[0]['balance_losses']}"
                      f" against one card {ref['balance_losses']}")
    split = expert_split(strategy)
    per_rank = [r["expert_weight_bytes"] for r in ranks]
    if any(b * split != ref["expert_weight_bytes"] for b in per_rank):
        faults.append(f"{name}: expert weights {per_rank} bytes per rank, "
                      f"expected 1/{split} of {ref['expert_weight_bytes']}")
    moe_bytes = [{k: v for k, v in r["collective_bytes_per_step"].items()
                  if k.split(".")[0] in MOE_SCOPES} for r in ranks]
    return {"flips": flips[:20], "flip_count": len(flips),
            "max_flip_gate_gap": max([f["gate_gap"] for f in flips],
                                     default=None),
            "own_flip_count": len(own),
            "max_own_flip_gate_gap": max([f["gate_gap"] for f in own],
                                         default=None),
            "flip_gap_limit": MOE_FLIP_GAP,
            "balance_losses": ranks[0]["balance_losses"],
            "one_card_balance_losses": ref["balance_losses"],
            "max_balance_err_over_scale": bal_err,
            "balance_tolerance": MOE_BALANCE_TOL,
            "expert_split": split,
            "expert_weight_bytes_per_rank": per_rank,
            "one_card_expert_weight_bytes": ref["expert_weight_bytes"],
            "dropped_pair_share": [dropped_share(i) for i in ids],
            "one_card_dropped_pair_share": ref["dropped_pair_share"],
            "moe_collective_bytes_per_step": moe_bytes,
            "moe_collective_bytes_per_step_total": [sum(m.values())
                                                    for m in moe_bytes],
            "expert_axis": "expert" in strategy.mesh_axes or split > 1}


def kernel_line(kern, flash, bn, serve, train, resnet, card: str,
                onnx=None, search=None, multigpu=None, capture=None) -> dict:
    """The JSON line of every kernel whose phase ran: launches on the
    main paths (what the wrappers counted: under a captured step, the
    warm-up and the capturing step; the capture phase's profiler counts
    a replayed step's), agreement with the plain versions and the times
    of this run."""
    rows = []
    if bn is not None:
        main = bn["main"]
        rows.append({
            "name": "bn_apply",
            "id": "P1",
            "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/bn_apply.cu",
            "replaces": "scripts/resnet_bn_probe.py:28",
            "launches": resnet["bn_apply_launches"] if resnet else 0,
            "launches_per_counted_train_step": (
                resnet["bn_apply_launches_per_counted_step"]
                if resnet else None),
            "launches_per_replayed_train_step": _replayed_launches(
                capture, "resnet50", "P1"),
            "launches_onnx": onnx["p1_launches"] if onnx else None,
            "launches_multigpu_per_rank_per_step": _multigpu_launches(
                multigpu, "P1"),
            "launches_per_counted_train_step_onnx": (
                onnx["p1_launches_per_counted_step"] if onnx else None),
            "max_abs_err": max(c["max_abs_err"] for c in bn["cases"]),
            "max_err_over_scale_by_dtype": bn["worst"],
            "tolerance": BN_TOL,
            "shape": [main["m"], main["c"]], "dtype": main["dtype"],
            "variant": main["variant"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "share_of_bound": main["share_of_bound"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes the fused "
                            "apply; F.batch_norm (eval) times the variant "
                            "with neither residual nor ReLU: "
                            "library_ms_no_res_no_relu",
            "library_ms_no_res_no_relu": next(
                c["library_ms"] for c in bn["cases"]
                if c["dtype"] == main["dtype"] and c["variant"] == "none"
                and (c["m"], c["c"]) == (main["m"], main["c"])),
            "card": card,
        })
    if kern is None:
        return {"kernels": rows}
    rows.append({
        "name": "paged_attention",
        "id": "K4",
        "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/paged_attention.cu",
        "replaces": "flexflow_tpu/ops/pallas/paged_attention.py:99",
        "launches": serve["paged_attention_launches"] if serve else 0,
        "launches_per_decode_step": (serve["launches_per_forward"]
                                     if serve else None),
        "max_abs_err": max(kern["worst"].values()),
        "max_abs_err_by_dtype": kern["worst"],
        "tolerance": TOL,
        "ms": kern["kernel_ms"],
        "ms_source": "torch.profiler device duration",
        "event_ms": kern["event_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "share_of_bound": kern["share_of_bound"],
        "library_ms": kern["library_ms"],
        "split_pages": kern["split_pages"],
        "grid": kern["grid"],
        "card": card,
    })
    names = {"K1": ("flash_fwd", 78), "K2": ("flash_bwd_dq", 217),
             "K3": ("flash_bwd_dkv", 265)}
    f32, bf16 = flash["main"]["float32"], flash["main"]["bfloat16"]
    for kid, (name, line) in names.items():
        worst = flash["worst"][kid]
        bound = f32["bounds"][kid]
        rows.append({
            "name": name,
            "id": kid,
            "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"flexflow_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train["flash_launches"][kid] if train else 0,
            "launches_per_counted_train_step": (
                train["flash_launches_per_counted_step"][kid]
                if train else None),
            "launches_per_replayed_train_step": _replayed_launches(
                capture, "bert", kid),
            "launches_search": (search["flash_launches"][kid]
                                if search else None),
            "launches_multigpu_per_rank_per_step": _multigpu_launches(
                multigpu, kid),
            "max_abs_err": max(w[0] for w in worst.values()),
            "max_err_over_scale_by_dtype": {
                dt: w[1] for dt, w in worst.items()},
            "tolerance": FLASH_TOL,
            "ms": f32["kernel_ms"][kid],
            "plain_ms": f32["plain_ms"][kid],
            "bound_ms": bound["bound_ms"],
            # "operations" or "bytes"; the route beside it
            "bound_by": bound["bound_by"].split(",")[0],
            "bound_by_route": bound["bound_by"],
            "share_of_bound": f32["share_of_bound"][kid],
            "simt_bound_ms": bound["simt_bound_ms"],
            "tc_bound_ms": bound["tc_bound_ms"],
            "library_ms": f32["library_ms"][kid],
            "bfloat16_ms": bf16["kernel_ms"][kid],
            "bfloat16_bound_ms": bf16["bounds"][kid]["bound_ms"],
            "bfloat16_library_ms": bf16["library_ms"][kid],
            "card": card,
        })
    return {"kernels": rows}


def _replayed_launches(capture, path: str, kid: str):
    """Launches of kernel `kid` per replayed step of the capture phase's
    `path`, counted by the profiler."""
    if capture is None:
        return None
    rec = next((r for r in capture["paths"] if r["path"] == path), None)
    if rec is None:
        return None
    return rec["graph"]["profile"]["launches_per_step"].get(kid)


def _multigpu_launches(multigpu, kid):
    """{leg: launches of kernel `kid` per step on each rank}."""
    if multigpu is None:
        return None
    return {leg["leg"]: [r[kid] for r in leg["launches_per_rank_per_step"]]
            for leg in multigpu["legs"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="comma-separated subset of the phases")
    ap.add_argument("--legs", default=None,
                    help="comma-separated subset of the multigpu legs")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - set(ALL_PHASES.split(","))
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    legs = {leg["name"] for leg in MULTIGPU_LEGS}
    if args.legs is not None and set(args.legs.split(",")) - legs:
        ap.error(f"unknown legs {sorted(set(args.legs.split(',')) - legs)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.ops.kernels import bn_apply as bk
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk

    card = card_line()
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    paged_lib, flash_lib, bn_lib = _build.build(pk.SOURCE, fa.SOURCE,
                                                bk.SOURCE)
    build_s = time.perf_counter() - t0
    emit({"build": [paged_lib.name, flash_lib.name, bn_lib.name],
          "build_s": build_s,
          "note": "one nvcc per source, started together"})
    dev = torch.device("cuda")
    kern = flash = serve = train = bn = resnet = paged = onnx = None
    search = multigpu = capture = None
    # what one phase leaves for another: the searched strategy and the
    # op costs the search timed (the multigpu phase trains and prices it)
    run_dir = tempfile.mkdtemp(prefix="ff_smoke_")
    if "kernels" in phases:
        kern = phase_kernels(torch, pk, card, dev, paged_lib, build_s)
        flash = phase_flash_kernels(torch, fa, card, dev, flash_lib)
    if phases & {"serve", "parity", "profile"}:
        ff, weights = build_model("cuda")
        if "serve" in phases:
            serve = phase_serve(torch, pk, card, ff)
        if "parity" in phases:
            prompts = serve["prompts"] if serve else make_prompts()
            phase_parity(torch, card, ff, weights, prompts)
        if "profile" in phases:
            paged = phase_profile(torch, card, ff)
        del ff
    if phases & {"train", "train_profile"}:
        ff, xb, yb, train = phase_train(torch, fa, card)
        if "train_profile" in phases:
            phase_train_profile(torch, fa, card, ff, xb, yb)
        del ff
        torch.cuda.empty_cache()
    if "train_parity" in phases:
        phase_train_parity(torch, fa, card)
    if "bn_kernels" in phases:
        bn = phase_bn_kernels(torch, bk, card, dev)
        torch.cuda.empty_cache()
    if phases & {"resnet", "resnet_profile"}:
        ff, xb, yb, resnet = phase_resnet(torch, bk, card)
        if "resnet_profile" in phases:
            phase_resnet_profile(torch, card, ff, xb, yb)
        del ff
        torch.cuda.empty_cache()
    if "resnet_parity" in phases:
        phase_resnet_parity(torch, bk, card)
    if phases & {"vit", "vit_profile"}:
        ff, xb, yb, _ = phase_vit(torch, pk, fa, bk, card)
        if "vit_profile" in phases:
            phase_vit_profile(torch, card, ff, xb, yb)
        del ff
        torch.cuda.empty_cache()
    if "vit_parity" in phases:
        phase_vit_parity(torch, card)
    if "zoo" in phases:
        phase_zoo(torch, pk, fa, bk, card)
    if "zoo_parity" in phases:
        phase_zoo_parity(torch, card)
    if "zoo_profile" in phases:
        phase_zoo_profile(torch, card)
    if "nmt" in phases:
        phase_nmt(torch, pk, fa, bk, card)
    if "generate" in phases:
        phase_generate(torch, pk, fa, bk, card, paged)
    if "keras" in phases:
        phase_keras(torch, pk, fa, bk, card)
    if "onnx" in phases:
        onnx = phase_onnx(torch, pk, fa, bk, card)
    if "seq_parity" in phases:
        phase_seq_parity(torch, card)
    if "capture" in phases:
        capture = phase_capture(torch, pk, fa, bk, card)
    if "fusion" in phases:
        phase_fusion(torch, fa, card)
    if "search" in phases:
        search = phase_search(torch, fa, card, run_dir)
    if "multigpu" in phases:
        multigpu = phase_multigpu(
            torch, fa, card, run_dir,
            None if args.legs is None else set(args.legs.split(",")))
    shutil.rmtree(run_dir, ignore_errors=True)
    if kern is not None or bn is not None:
        emit(kernel_line(kern, flash, bn, serve, train, resnet, card, onnx,
                         search, multigpu, capture))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
