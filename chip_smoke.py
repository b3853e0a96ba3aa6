"""Smoke run of lemevit_tpu_torch on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the CUDA kernels from lemevit_tpu_torch/attn/csrc (and the probes'
from lemevit_tpu_torch/probes/csrc), prints what ptxas reported during
that build for the tensor-core kernels' sources (mhsa.cu, dca_attn.cu,
s_block.cu, dca_block.cu, c_block.cu, s_stage.cu and the three training
sources) and the probes' (ew_probe.cu, constructs.cu: every k_ew_probe
instance, k_scatter_add_probe, k_roll_rows_probe, k_fold_probe and both
k_erf_probe instances with no spill and no stack frame, or the script
fails), says whether PIL imports (and its version), and drives the port's
main paths, each with every kernel's launch count set to 0 just before it
and read just after:
  - serving: every inference block kernel held against its plain PyTorch
    version at the shapes of LeMeViT-Base at 224^2 (the C, S and D kernels
    also in bf16 against their order of work in PyTorch,
    *_block_tiles_plain, bit for bit over two runs, timed by CUDA events
    and by the profiler's device time; the C kernel's port launches read
    from the profile, none of block_common.cuh's chain, its attention
    beside SDPA's forward of the meta direction; also at a ragged N, with
    32 and 128 meta tokens, and D2 through the weight permutation), base's
    kernel path against its plain path, a bf16 batch of 64 served through
    cli.benchmark's inference function with a profile of one forward (the
    C, S and D blocks' kernels by name, block_common.cuh's chain in none),
    and cli.validate on synthetic data;
  - serving base on the slice's path (s_stage, cpe_in_kernel): the s_stage
    kernel (one persistent launch of the S block's tiles) held against its
    plain version and, bit for bit, against the chain of S block kernels at
    base's, lemevit_tiny's and UperNet's stage shapes, with and without
    CPEs, timed beside the chain; the three block kernels' cpe mode
    against their plain versions at base's shapes, timed beside the
    external CPE placement; base's slice logits against its plain path, a bf16 batch of 64 served
    beside the default path's img/s, a profile of one forward (one
    k_s_stage per S stage, no CPE convolution) and cli.validate;
  - training vit_tiny (all S blocks): the three S-block training kernels
    and the S inference kernel held against their plain versions at
    vit_tiny's shapes, one fp32 train step on the kernel path against the
    plain path, then cli.train on synthetic data (224^2, bf16, batch 64,
    configs/lemevit.yaml, 6 steps and one eval) and a profile of one train
    step; stage 0 (N = 3136) composes, its meta-token stream on the mhsa
    kernel;
  - training lemevit_tiny (C, D and S blocks): the inference kernels at its
    five shapes, its C, D and S training kernels (forward, MLP backward,
    attention backward) held against their plain versions, a D2 training
    block through the weight permutation, a C training block with 320 meta
    tokens (rows 14-15 phase by phase, and the block on the kernel path
    against its composition), one fp32 train step on the kernel path
    against the plain path, cli.train as above, cli.benchmark --bench
    train, and a profile of one train step;
  - real images (PIL must import): a JPEG folder written from a seed (8
    classes, 384 training images and 100 validation images of 256-512 px
    a side, a PNG and a greyscale JPEG among them), a UCM manifest tree
    and a zip with its map file; cli.train of lemevit_tiny on the folder
    (configs/lemevit.yaml: RandAugment m9, hflip, random resized crops; 4
    loader threads) with the synthetic run's launches per step;
    cli.validate of lemevit_base on the validation split (a ragged last
    batch of 36) on the default path and with --s-stage --cpe-in-kernel,
    each against --attn-backend torch (equal counts, the loss within 4 bf16
    steps), --real-labels, --dataset ucm and --dataset zipfolder; a
    real-data batch's host build time with 1 and 4 threads beside a
    synthetic one;
  - the packed and native data planes on the same JPEGs (the
    packed-native phase): whether the C++ compiler finds jpeglib.h and
    png.h (without them the native runs are skipped and said so; with
    them the native decode library must build), the folder packed at 256^2
    by cli.pack's pack_folder (its seconds, and whether through the native
    plane); cli.train of lemevit_tiny from the cache (--packed-data: the
    random resized crop, flip and RandAugment on the card) and on native
    decode (--native-decode, 4 threads), each with TINY_STEP's launches a
    step and its steady img/s beside the PIL runs' and the synthetic run's;
    the host's ms per batch of 64 for the cache, native decode on 1 and 4
    threads and PIL's; device_aug on a batch of 64 (256^2 to 224^2, two
    RandAugment layers) against its CPU run on the same draws (the crop
    and flip within 2e-3, each layer on the same input within 1e-2), timed
    by CUDA events with its kernels a call; cli.validate of lemevit_base
    --packed-data (resized to 248, centre 224) on the default and the
    slice's path, every image's logits against the plain path's;
  - the rest of the training recipe (the train-recipe phase): cli.train
    of lemevit_tiny with --aug-splits 3 --jsd-loss --aa augmix-m3-w3 (3
    splits of 64 views in one forward, every BatchNorm with per-split
    statistics) on synthetic data, with the clean-split eval (TINY_STEP's
    and TINY_EVAL's launches, one checkpoint whose three sets of stem
    statistics differ; img/s as clean images and as views, ms per step,
    peak memory) and on the JPEG folder with 4 worker processes (AugMix on
    the host), the host ms of a batch of 64 three-view samples, one bf16
    JSD step and one freeze_bn step on the kernel path against the plain
    path (freeze_bn's stem and downsample statistics bit for bit, the
    head's moved), and every --opt rule over lemevit_tiny's parameters on
    the card against a CPU copy (under 1e-5 of each tensor's largest
    value), RMSpropTF and Adagrad apart from torch.optim's classes; the
    phase's seconds;
  - at every training shape above and below (and in the CPE mode), the
    phases on the tensor-core kernels: row 9, lm_s_train_fwd (S blocks:
    k_qkv_wg, k_mhsa_tc with the log-sum-exp, k_tail_wg's training
    instance), rows 10-11, lm_s_attn_bwd (S blocks) and lm_mlp_bwd (every
    block kind) of train_tc.cuh, row 12, lm_dca_train_fwd (D blocks:
    k_qkv_wg, k_dca_tc + k_dca_merge with the log-sum-exps, k_tail_wg's
    training instance), row 13, lm_dca_attn_bwd (D blocks: k_qkv_wg,
    k_rowmm_wg, the cross-attention backward k_dca_bwd_tc and k_wgrad_tc,
    on row 12's o and log-sum-exps), row 14, lm_c_train_fwd (C blocks:
    k_qkv_wg with two widths, the c direction of k_dca_tc + k_dca_merge
    with the log-sum-exp, k_tail_wg's training instance), and row 15,
    lm_c_attn_bwd (C blocks: k_qkv_wg, k_rowmm_wg, the c direction of
    k_dca_bwd_tc and k_wgrad_tc, on row 14's o and log-sum-exp), phase by
    phase: fp32 against the plain phases at 1e-4,
    bf16 against their tile models (*_tiles_plain) within 2 bf16 steps of
    each tensor's largest element, every output bit for bit over two
    calls, the profiler's device time split by kernel with each phase's
    port launches read (never more than PORT_LAUNCHES; rows 12 and 14 also
    in their CPE mode) and no block_common.cuh tail or separate CPE pass in
    the forwards, and SDPA's forward (rows 9, 12, 14; both directions for
    row 12, the meta direction for row 14) or backward (rows 10, 13, 15
    likewise) on the same q, k, v (and dO) timed beside the attention
    tiles;
  - LeMeViT() with its constructor defaults (head_dim 64, 128 meta
    tokens) at 64^2 under attn_backend="auto": its blocks decline by shape
    and compose, a forward and a training step match "torch" with no
    kernel launched;
  - training lemevit_tiny on the slice's path (train_cpe_in_kernel: each
    block's 3x3 CPE inside its training kernels): the six C, D and S
    training kernels in their CPE mode held against their plain versions
    (the tap and bias gradients included) at lemevit_tiny's and base's
    training shapes, timed beside the external placement (F.conv2d and its
    autograd around the kernel without its CPE), the tap gradients bit for
    bit over two runs, one fp32 train step with the switch against the
    plain path, cli.train --train-cpe-in-kernel beside the default path's
    img/s and peak memory, cli.benchmark --bench train
    --train-cpe-in-kernel, and a profile of one train step (the same
    launches, no convolution for the 15 block CPEs);
  - multi-process training (the dist phase; parallel/, DDP with SyncBN
    inside core/layers.py::BatchNorm): cli.train of lemevit_tiny (224^2,
    bf16, 3 steps) in fresh processes, one rank in an NCCL group it opens
    (wrapped in DDP) against a process with no group (per-step losses
    within 1e-4, cuDNN deterministic in both, the same launches), and two
    ranks on the one card over gloo (NCCL refuses two ranks on one device)
    at B = 32 each, mixup, cutmix and DropPath off, against one process at
    B = 64 (per-step losses within the bf16 limit, both ranks' losses
    equal, rank 1 writing nothing; the gloo img/s crosses the host and is
    labelled so);
  - change detection (the cd phase): PNG pairs written from a seed (64
    train, 16 val at 256^2), cli.train_cd with
    configs/cd/bit_lemevit_small_cdd.yaml (BIT on lemevit_small, B = 16,
    bf16) for 4 steps and its eval, its launches by kernel per train step
    and per eval forward (every kernel of the path launched), pairs/s, the
    kernel path's loss on the first batch beside --attn-backend torch's on
    the same weights, one synthetic step of snunet, snunet_conc,
    siamunet_diff and BIT on resnet18, and cli.visualize_cd on the best
    checkpoint (one mask PNG per val pair);
  - oriented detection (the det phase): rows 1, 7, 8 and 9-11 held
    against their plain versions at Oriented R-CNN's shapes (dca_attn at
    N = 65536 / 16384, mhsa at N = 16 C = 320, the S kernels at N = 1024
    C = 384; B = 8), three 1500x1300 DOTA images written from a seed and
    tiled by cli.dota_split (tiles and shifted annotations checked against
    the originals), cli.train_det with configs/det/
    oriented_rcnn_lemevit_small_fpn_1x_dota10.yaml (1024^2, B = 8, bf16,
    rpn_nms_pre 2000) for 3 steps and its eval (mAP, B = 1), the launches
    by kernel per train step and per eval forward, steps/s, img/s, peak
    GiB, device ms, launches and busy share of a profiled step, the
    eval's ms per image, the kernel path's first-batch loss beside
    --attn-backend torch's on the same proposals, the port's leme_ops
    library loaded, then a
    step each with --tile on the originals and --format-only;
  - instance segmentation (the maskrcnn phase): rows 1, 7 and 9-11 held
    against their plain versions at Mask R-CNN's shapes (dca_attn at
    N = 16384 C = 96 and N = 4096 C = 192, the S kernels at N = 1024
    C = 320 and N = 256 C = 384; fp32 at B = 1, bf16 at B = 2), a COCO
    folder written from a seed (varied aspect ratios, polygons, an RLE, a
    crowd annotation, sparse category ids) with COCODataset's items
    checked against it, cli.train_maskrcnn with configs/coco/
    mask_rcnn_lemevit_small_fpn_1x_coco.yaml (512^2, B = 2, 80 classes,
    bf16, --sched step) for 3 steps and its eval (box and mask mAP,
    B = 1), the launches by kernel per train step and per eval forward,
    steps/s, img/s, peak GiB, the eval's ms per image, a profiled step,
    the kernel path's first-batch loss parts beside --attn-backend
    torch's on the same proposals; then one cli.train_seg step on a PNG
    folder written from a seed and cli.visualize_attn (lemevit_tiny, its
    maps from the kernel path against the plain path's);
  - segmentation (UperNet on lemevit_tiny, 512^2 crops, 512 head channels,
    6 classes): the kernels held
    against their plain versions and, in bf16, against their order of work
    in PyTorch (*_tiles_plain) (dca_attn at
    stages 1-2's shapes, at N = 1000 and with 128 meta tokens, through
    D2's aliasing and one backward, two runs bit for bit; mhsa at three
    shapes and at N = 200 and 1) beside SDPA's time on the same inputs,
    with the profiler's device time beside the events' time, the S
    kernels at stages 3-4's shapes (N = 1024, 256), the crop
    forward's kernel path against its plain path (fp32 at batch 1, bf16 at
    batch 8) with its launches, slide inference of a 1024^2 image (9
    windows), cli.train_seg on synthetic data (batch 8, bf16, 6 steps and
    a slide-inference eval) and a profile of one seg train step;
  - the toolchain probes (lemevit_tpu_torch/probes, built into their own
    library): the per-op probe (k_ew_probe over flat vectors,
    k_ew_probe_rows in ew.layout's row groups) held against its plain
    version for all 12 ops at K = 1 and at vpu_probe's K, and the K = 0
    copy exact, on each of its three (R, C) tiles x 64 (timed by events
    and the profiler beside the library call) and where the row layout
    changes (C = 8, 392, 2048 at 300 rows), the kernel's layout equal to
    ew.layout at every C, and the row roll at a shift past int32 bit for
    bit torch.roll's; then the probe path, python -m
    lemevit_tpu_torch.cli.probes --ew (each construct probe, erff against
    JAX's polynomial erf, the scatter with per-CTA partials meeting by
    global atomics (JAX's input exact, the tap input twice, 4096 random
    bins through the global branch, within 1e-6 of each bin's sum of |x|),
    16-byte row-shifted loads, the C = 320 fold (exact) and thread-block
    clusters of 1-16, against its plain version in its own process, each
    timed by events and by the profiler's device time of its kernel alone
    beside its library call's and the card's launch floor, the erf, the
    roll and the fold also at a size where the bytes set the pace, beside
    their bytes bound and the launch floor (erff within 1e-6 of
    fp64 and of its plain version at K = 1 and at the slope's K); the
    per-op slope table at the three
    shapes; the A/B rows of s_stage, the inference and the training CPE
    placements) in a fresh process whose counts start at 0 and which
    reports its launches, and the training paths' A/B row: vit_tiny and
    cli.train_seg with --train-cpe-in-kernel beside the default runs
    above, decided by each path's bare train step's device time with the
    switch off and on in alternating pairs.
Every phase prints one line and its seconds ([phase-seconds]); any
failure raises and exits non-zero. The script's total seconds are printed
before the last lines, which are a
JSON object of per-kernel numbers, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import csv
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from lemevit_tpu_torch.utils.profiling import (BF16_FLOPS, FP32_FLOPS,
                                               HBM_BYTES_PER_S, kernel_ms)

B_CHECK = 8          # batch of the fp32 kernel checks
B_MAIN = 64          # batch of the served and trained main paths (bf16)
M = 16               # meta tokens of every released variant
TRAIN_STEPS = 6             # steps of each cli.train run
REPO = Path(__file__).resolve().parent

# Base at 224^2: (kernel, N, C, launches per forward)
MAIN_SHAPES = [("c_block", 3136, 96, 2),
               ("dca_block", 3136, 96, 4), ("dca_block", 784, 192, 4),
               ("s_block", 196, 384, 18), ("s_block", 49, 512, 4)]
# base's blocks with the CPE in the kernel: (kernel, N, image width, C,
# launches per forward on the slice's path; its S blocks run in s_stage)
CPE_SHAPES = [("c_block", 3136, 56, 96, 2),
              ("dca_block", 3136, 56, 96, 4), ("dca_block", 784, 28, 192, 4),
              ("s_block", 196, 14, 384, 0), ("s_block", 49, 7, 512, 0)]
# launches per base forward on the slice's path
SLICE_FWD = {"c_block": 2, "dca_block": 8, "s_stage": 2}
# the S and D kernels on no main path, (kernel, N, C, M): a ragged N (past
# the attention tiles' 128 rows), and 32 and 128 meta tokens (LeMeViT's
# constructor default)
BLOCK_OFF_PATH = [("s_block", 200, 192, 16), ("s_block", 196, 384, 32),
                  ("s_block", 196, 384, 128), ("dca_block", 1000, 96, 16),
                  ("dca_block", 784, 192, 32), ("dca_block", 784, 192, 128)]
# CUDA kernels of one bf16 base forward by name: the C, S and D kernels'
# (block_tc.cuh, attn_tc.cuh) 2, 22 and 8 times; block_common.cuh's chain
# no more
BASE_FWD_KERNELS = {"k_block_tail": 0, "k_qkv_wg": 32, "k_mhsa_tc": 22,
                    "k_mhsa_tc_small": 22, "k_dca_tc": 10, "k_dca_merge": 10,
                    "k_tail_wg": 32}
# lemevit_tiny at 224^2: (kernel, N, C, launches per eval forward)
TINY_SHAPES = [("c_block", 3136, 64, 1),
               ("dca_block", 3136, 64, 2), ("dca_block", 784, 128, 2),
               ("s_block", 196, 192, 8), ("s_block", 49, 320, 2)]
# its training blocks: (kind, N, C, blocks); each block launches its
# forward, mlp_bwd and attention backward once per train step
TINY_TRAIN = [("c", 3136, 64, 1), ("dca", 3136, 64, 2), ("dca", 784, 128, 2),
              ("s", 196, 192, 8), ("s", 49, 320, 2)]
# the training kernels in their CPE mode: (kind, N, image width, C, blocks
# per lemevit_tiny step on the slice's path); base's C and D training
# shapes are timed too (no main path trains base)
TRAIN_CPE_SHAPES = [("c", 3136, 56, 64, 1), ("dca", 3136, 56, 64, 2),
                    ("dca", 784, 28, 128, 2), ("s", 196, 14, 192, 8),
                    ("s", 49, 7, 320, 2), ("c", 3136, 56, 96, 0),
                    ("dca", 3136, 56, 96, 0), ("dca", 784, 28, 192, 0)]
# the convolutions of one lemevit_tiny forward: stem 2, downsamples 3, the
# blocks' CPEs 15
TINY_CONVS, TINY_CPE_CONVS = 20, 15
# vit_tiny at 224^2, stages 1-3 (stage 0, N = 3136, composes as in the JAX
# package): S blocks, each launching s_block once per eval forward
VIT_TRAIN = [("s", 784, 192, 2), ("s", 196, 320, 4), ("s", 49, 384, 2)]
# UperNet on lemevit_tiny at 512^2 (cli.train_seg's defaults): batch, crop,
# head channels, classes; the fp32 checks' batch
SEG_B, SEG_CROP, SEG_CH, SEG_CLASSES, SEG_B_CHECK = 8, 512, 512, 6, 2
# s_stage: (stage, blocks, N, image width, C, fp32 batch, bf16 batch,
# launches per base forward on the slice's path)
STAGE_SHAPES = [("base stage 3", 18, 196, 14, 384, B_CHECK, B_MAIN, 1),
                ("base stage 4", 4, 49, 7, 512, B_CHECK, B_MAIN, 1),
                ("lemevit_tiny stage 3", 8, 196, 14, 192, B_CHECK, B_MAIN, 0),
                ("UperNet stage 3", 8, 1024, 32, 192, SEG_B_CHECK, SEG_B, 0)]
# stages 1-2 compose (N > 3136): each D block's attention is one dca_attn
# call, (N, C, blocks)
SEG_DCA = [(16384, 64, 2), (4096, 128, 2)]
# dca_attn's shapes on no main path, (N, C, blocks, M): a ragged last tile
# (1000 - 7 * 128 = 104 rows) and LeMeViT's default 128 meta tokens (eight
# tiles of 16)
DCA_OFF_PATH = [(1000, 64, 0, 16), (4096, 128, 0, 128)]
# stages 3-4 run the S kernels at new token counts, (kind, N, C, blocks)
SEG_S = [("s", 1024, 192, 8), ("s", 256, 320, 2)]
# mhsa: (N, C, fp32 batch, bf16 batch): vit_tiny's stage-0 meta stream,
# an S block that composes at N = 196 and at the kernel's largest N
MHSA_SHAPES = [(16, 96, B_CHECK, B_MAIN), (196, 320, B_CHECK, B_MAIN),
               (1024, 192, SEG_B_CHECK, SEG_B)]
# mhsa's ragged shapes: a last key and query tile of 8 rows, one token
MHSA_RAGGED = [(200, 192, B_CHECK, B_MAIN), (1, 96, B_CHECK, B_MAIN)]
# tolerance of the bf16 kernels against their order of work in PyTorch
# (mhsa_tiles_plain, dca_tiles_plain) on the same inputs, and, so that an
# output of small values (dca_attn's c_out, ~0.01) is held at its own
# scale, bf16 steps of each output's largest element: against the tile
# models and against the fp32 plain versions
TILES_TOL = 1e-2
TILES_STEPS = 2
PLAIN_STEPS = 4
BF16_STEP = 2.0 ** -7  # bf16's spacing at 1
TRAIN_PHASES = {"s": ("s_train_fwd", "mlp_bwd", "s_attn_bwd"),
                "dca": ("dca_train_fwd", "mlp_bwd", "dca_attn_bwd"),
                "c": ("c_train_fwd", "mlp_bwd", "c_attn_bwd")}
KERNELS = {
    "c_block": ("lemevit_tpu_torch/attn/csrc/c_block.cu",
                "lemevit_tpu/attn/pallas_block.py:1069"),
    "dca_block": ("lemevit_tpu_torch/attn/csrc/dca_block.cu",
                  "lemevit_tpu/attn/pallas_block.py:929"),
    "s_block": ("lemevit_tpu_torch/attn/csrc/s_block.cu",
                "lemevit_tpu/attn/pallas_block.py:1095"),
    "s_stage": ("lemevit_tpu_torch/attn/csrc/s_stage.cu",
                "lemevit_tpu/attn/pallas_block.py:1250"),
    "s_train_fwd": ("lemevit_tpu_torch/attn/csrc/s_train.cu",
                    "lemevit_tpu/attn/pallas_train.py:907"),
    "mlp_bwd": ("lemevit_tpu_torch/attn/csrc/s_train.cu",
                "lemevit_tpu/attn/pallas_train.py:559"),
    "s_attn_bwd": ("lemevit_tpu_torch/attn/csrc/s_train.cu",
                   "lemevit_tpu/attn/pallas_train.py:971"),
    "dca_train_fwd": ("lemevit_tpu_torch/attn/csrc/dca_train.cu",
                      "lemevit_tpu/attn/pallas_train.py:1095"),
    "dca_attn_bwd": ("lemevit_tpu_torch/attn/csrc/dca_train.cu",
                     "lemevit_tpu/attn/pallas_train.py:1156"),
    "c_train_fwd": ("lemevit_tpu_torch/attn/csrc/c_train.cu",
                    "lemevit_tpu/attn/pallas_train.py:1442"),
    "c_attn_bwd": ("lemevit_tpu_torch/attn/csrc/c_train.cu",
                   "lemevit_tpu/attn/pallas_train.py:1514"),
    "dca_attn": ("lemevit_tpu_torch/attn/csrc/dca_attn.cu",
                 "lemevit_tpu/attn/pallas_dca.py:185"),
    "mhsa": ("lemevit_tpu_torch/attn/csrc/mhsa.cu",
             "lemevit_tpu/attn/pallas_mhsa.py:95"),
}
# the probe kernels: the per-op probe per op (k_ew_probe<Op, K>) and the
# construct probes, by the construct probe (cli.probes' row) that runs them
PROBE_SRC = "lemevit_tpu_torch/probes/csrc/"
CONSTRUCT_KERNELS = {
    "erf_prim": ("erf_probe", "scripts/mosaic_probes.py:57"),
    "scatter": ("scatter_add_probe", "scripts/mosaic_probes.py:78"),
    "pltpu_roll": ("roll_rows_probe", "scripts/mosaic_probes.py:93"),
    "reshape_c320": ("fold_probe", "scripts/mosaic_probes.py:108"),
    # thread-block clusters (the construct of s_stage.cu's first design,
    # one cluster an image); no TPU kernel counterpart
    "cluster": ("cluster_probe", None),
}
# the construct probes that also time their kernel where bytes set the pace
LARGE_PROBES = ("erf_prim", "pltpu_roll", "reshape_c320")
# launches per train step and per eval forward of each trained model
VIT_STEP = {"s_train_fwd": 8, "mlp_bwd": 8, "s_attn_bwd": 8, "mhsa": 2}
VIT_EVAL = {"s_block": 8, "mhsa": 2}
TINY_STEP = {"c_train_fwd": 1, "c_attn_bwd": 1, "dca_train_fwd": 4,
             "dca_attn_bwd": 4, "s_train_fwd": 10, "s_attn_bwd": 10,
             "mlp_bwd": 15}
TINY_EVAL = {"c_block": 1, "dca_block": 4, "s_block": 10}
# UperNet: launches per crop forward and per train_seg step
SEG_CROP_FWD = {"dca_attn": 4, "s_block": 10}
SEG_STEP = {"dca_attn": 4, "s_train_fwd": 10, "mlp_bwd": 10,
            "s_attn_bwd": 10}
# tolerances of the training-kernel checks: outputs |err| <= tol (1 + |ref|),
# gradients |err| <= tol (max|ref| + |ref|) per tensor (a weight gradient
# sums B N products, so its error scales with the tensor, not the element)
TRAIN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() over iters back-to-back calls (CUDA
    events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms, what bounds it) on the H100 SXM data-sheet peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def counters() -> tuple:
    """Every kernel's launch count: the block kernels', the training
    kernels' and the attention-only kernels'."""
    from lemevit_tpu_torch.attn import dca, fused_block, fused_train, mhsa
    return (fused_block.LAUNCHES, fused_train.LAUNCHES, dca.LAUNCHES,
            mhsa.LAUNCHES)


def launch_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def launched_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a launch_counts() copy)."""
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def reset(*counts) -> None:
    for c in counts or counters():
        for k in c:
            c[k] = 0


def make_params(kind, ch, hidden, g):
    """Seeded O(1)-scale parameters of one block, torch Linear layout."""
    def lin(o, i):
        return [torch.randn(o, i, generator=g) * i ** -0.5,
                torch.randn(o, generator=g) * 0.1]

    def ln():
        return [1 + 0.1 * torch.randn(ch, generator=g),
                0.1 * torch.randn(ch, generator=g)]
    if kind == "c_block":
        p = ln() + lin(ch, ch) + lin(2 * ch, ch) + lin(ch, ch)
    elif kind == "dca_block":
        p = ln() + lin(3 * ch, ch) + lin(3 * ch, ch) + lin(ch, ch) + lin(ch, ch)
    else:
        p = ln() + lin(3 * ch, ch) + lin(ch, ch)
    return p + ln() + lin(hidden, ch) + lin(ch, hidden)


def work(kind, b, n, ch, hidden, n_params_bytes, elt, cpe=False, m=M):
    """(bytes, operations) one call must move and do with m meta tokens:
    each input read once, each output written once; multiply-adds counted
    as two; with ``cpe`` the 3x3 CPE's 9 multiply-adds per image-token
    element too."""
    if kind == "c_block":
        io = (b * n * ch + 2 * b * m * ch) * elt
        flops = 2 * b * (m * ch * ch + n * ch * 2 * ch + 2 * m * n * ch
                         + m * ch * ch + 2 * m * ch * hidden)
    elif kind == "dca_block":
        io = (2 * b * n * ch + 2 * b * m * ch) * elt
        rows = n + m
        flops = 2 * b * (rows * ch * 3 * ch + 4 * n * m * ch
                         + rows * ch * ch + 2 * rows * ch * hidden)
    else:
        io = (2 * b * n * ch + 2 * b * m * ch) * elt
        rows = n + m
        flops = 2 * b * (rows * ch * 3 * ch + 2 * (n * n + m * m) * ch
                         + rows * ch * ch + 2 * rows * ch * hidden)
    if cpe:
        flops += 18 * b * n * ch
    return io + n_params_bytes, flops


def train_work(phase, b, n, ch, elt=2, cpe=False):
    """(bytes, operations) of one training-kernel call at hidden = 4C:
    each input read once, each output written once (fp32 log-sum-exp rows
    and DropPath scales at 4 bytes); the operations include what the
    call's interface makes it recompute (qkv, q / kv, fc1). n is the image
    tokens the call sees (0 for the C block's meta-only MLP backward). With
    ``cpe`` (a forward or attention backward in its CPE mode) the taps and
    the bias are read (and their gradients written by the backward), and
    the 3x3 CPE's 9 multiply-adds per image-token element are done once in
    the forward and three times in the backward (its recomputation, the tap
    gradients, the transpose)."""
    nbytes, ops = _train_work(phase, b, n, ch, elt)
    if cpe:
        fwd = phase.endswith("_fwd")
        nbytes += 10 * ch * elt * (1 if fwd else 2)
        ops += 18 * b * n * ch * (1 if fwd else 3)
    return nbytes, ops


def cpe_pass_bytes(phase, b, n, ch, elt=2):
    """Bytes of a CPE-mode call's separate CPE passes (not part of its
    bound: each is an intermediate): k_cpe_rows reads and writes x (2 elt per
    element); the backward adds k_cpe_tap_grads (x and the fp32 du) and the
    transpose (du, dx)."""
    per = 2 * elt if phase.endswith("_fwd") else 2 * elt + 2 * (4 + elt)
    return per * b * n * ch


def _train_work(phase, b, n, ch, elt):
    rx, rc = b * n, b * M
    rows = rx + rc
    act = lambda r: r * ch * elt
    lse = lambda r: 4 * (ch // 32) * r
    dp = 4 * 4 * b
    w_mlp = 8 * ch * ch + 5 * ch
    if phase == "mlp_bwd":       # t1, dout -> dt1, dW1, db1, dW2, db2
        return 3 * act(rows) + 2 * w_mlp * elt + dp, 40 * rows * ch * ch
    kind, fwd = phase.split("_")[0], phase.endswith("_fwd")
    if kind == "c":              # q from the meta rows, kv from the image rows
        w = 4 * ch * ch + 4 * ch
        if fwd:                  # x, c -> c_out, t1c, o (+ lse)
            return (act(rx) + 4 * act(rc) + (w + w_mlp) * elt + lse(rc) + dp,
                    4 * rx * ch * ch + 20 * rc * ch * ch + 4 * b * M * n * ch)
        # x, c, dt1c, o, lse -> dxt, dc, dWq, dbq, dWkv, dbkv, dWp
        return (2 * act(rx) + 4 * act(rc) + 2 * w * elt + lse(rc) + dp,
                12 * rx * ch * ch + 10 * rc * ch * ch + 10 * b * M * n * ch)
    if kind == "s":              # both streams attend to themselves
        w, pairs = 4 * ch * ch + 4 * ch, b * (n * n + M * M)
    else:                        # each stream attends to the other
        w, pairs = 8 * ch * ch + 8 * ch, 2 * b * n * M
    if fwd:                      # x, c -> out, t1, o (+ lse)
        return (4 * act(rows) + (w + w_mlp) * elt + lse(rows) + dp,
                24 * rows * ch * ch + 4 * pairs * ch)
    # x, dt1, o, lse -> dx, the attention's weight gradients
    return (4 * act(rows) + 2 * w * elt + lse(rows) + dp,
            22 * rows * ch * ch + 10 * pairs * ch)


def max_err(got, want, tol, steps=None):
    """Max abs error; raises where |err| > tol (1 + |ref|) (unless tol is
    None), where steps is given also where |err| > steps bf16 steps of the
    tensor's largest |ref|, or where a value is not finite."""
    err = 0.0
    for a, r in zip(got, want):
        a, r = a.float(), r.float()
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        d = (a - r).abs()
        bad = 0 if tol is None else int((d > tol + tol * r.abs()).sum())
        if bad:
            raise AssertionError(f"{bad} elements beyond tol {tol}, "
                                 f"max abs err {d.max().item():.3g}")
        if steps is not None:
            scale = r.abs().max().item()
            if d.max().item() > steps * BF16_STEP * scale:
                raise AssertionError(
                    f"max abs err {d.max().item():.3g} beyond {steps} bf16 "
                    f"steps of the largest |ref| {scale:.3g}")
        err = max(err, d.max().item())
    return err


def max_grad_err(got, want, tol, names):
    """Max abs error over gradient tensors (or any whose elements' errors
    follow the tensor's scale); raises where |err| > tol (max|ref| + |ref|)
    within a tensor."""
    err = 0.0
    for a, r, name in zip(got, want, names):
        a = a.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} is not finite")
        d = (a - r).abs()
        lim = tol * (r.abs().max() + r.abs())
        if bool((d > lim).any()):
            raise AssertionError(f"{name}: max abs err "
                                 f"{d.max().item():.3g} beyond tol {tol} "
                                 f"of max |ref| {r.abs().max().item():.3g}")
        err = max(err, d.max().item())
    return err


def profile_call(fn, what: str, top: int = 16) -> dict:
    """Device time of one fn() by CUDA kernel name (torch.profiler), and
    the device's busy share of its wall time. Runs after a main path's
    launch counts are read, so it adds no counted launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only; a user annotation's range on the device (the
    # optimizer's step) spans kernels counted already
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        say("profile", f"{what}: no device time recorded: not measured")
        return {}
    by_name = {}  # launches of each kernel and calls of each host op
    for e in prof.key_averages():
        by_name[e.key] = by_name.get(e.key, 0) + e.count
    busy = sum(r[1] for r in rows)
    ours = sum(r[1] for r in rows if "lm::" in r[0])
    launches = sum(r[2] for r in rows)
    say("profile", f"{what}: {wall_ms:.2f} ms wall (profiled), {busy:.2f} "
        f"ms of device kernels ({100 * busy / wall_ms:.1f}% busy) in "
        f"{launches} launches, of which {ours:.2f} ms "
        f"({100 * ours / busy:.1f}%) in the port's kernels (lm::) and "
        f"{busy - ours:.2f} ms in PyTorch's")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        say("profile", f"{ms:8.3f} ms  {count:4d}x  {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy, "port_ms": ours,
            "launches": launches, "by_name": by_name,
            "ms_by_name": {key: ms for key, ms, _ in rows}}


def check_block_kernel(fb, kind, n, ch, per_fwd, dev, g, b_check=B_CHECK,
                       b_main=B_MAIN, img_w=0, m=M):
    """One inference block kernel at one shape, with m meta tokens: fp32 at
    b_check (rtol = atol = 1e-4), bf16 at b_main (3e-2 against fp32 on the
    same bf16-cast inputs), then times (CUDA events and, for the S and D
    kernels, the profiler's device time), bound and rate at b_main in
    bf16. The S and D kernels (block_tc.cuh) are also held in bf16 against
    their order of work in PyTorch (*_block_tiles_plain) on the same
    inputs, within TILES_STEPS bf16 steps of each output's largest element
    (x_out and c_out each at its own scale), and bit for bit over two
    runs. With img_w, the kernel's cpe mode: x before
    a seeded 3x3 CPE that the kernel applies, against the plain version
    (and the tile model) with cpe_plain, also timed in the external
    placement (cpe_plain's F.conv2d, then the kernel without its CPE)."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    wrappers = {"c_block": fb.c_block, "dca_block": fb.dca_block,
                "s_block": fb.s_block}
    plains = {"c_block": fb.c_block_plain, "dca_block": fb.dca_block_plain,
              "s_block": fb.s_block_plain}
    tiles = {"c_block": fb.c_block_tiles_plain,
             "dca_block": fb.dca_block_tiles_plain,
             "s_block": fb.s_block_tiles_plain}

    def call(fns, x, c, p, cpe=None):
        kw = {"num_heads": ch // 32}
        if kind == "dca_block":
            kw["scale_x"], kw["scale_c"] = dca_scales(n, m, ch)
        if cpe is not None:
            kw.update(cpe=cpe, img_w=img_w)
        out = fns[kind](x, c, p, **kw)
        return out if isinstance(out, tuple) else (out,)

    hidden = 4 * ch
    p32 = make_params(kind, ch, hidden, g)
    cpe32 = ([0.3 * torch.randn(9, ch, generator=g),
              0.1 * torch.randn(ch, generator=g)] if img_w else [])
    x = torch.randn(b_main, n, ch, generator=g)
    c = torch.randn(b_main, m, ch, generator=g)
    xs, cs = x[:b_check].to(dev), c[:b_check].to(dev)
    ps = [t.to(dev) for t in p32]
    cpes = [t.to(dev) for t in cpe32] or None
    err32 = max_err(call(wrappers, xs, cs, ps, cpes),
                    call(plains, xs, cs, ps, cpes), 1e-4)
    xb, cb = x.to(dev, torch.bfloat16), c.to(dev, torch.bfloat16)
    pb = [t.to(dev, torch.bfloat16) for t in p32]
    cpeb = [t.to(dev, torch.bfloat16) for t in cpe32] or None
    got = call(wrappers, xb, cb, pb, cpeb)
    want = call(plains, xb.float(), cb.float(), [t.float() for t in pb],
                cpeb and [t.float() for t in cpeb])
    err16 = max_err(got, want, 3e-2)
    extra, dev_ms = {}, None
    if kind in tiles:
        # by TILES_STEPS alone: the model rounds LN1, qkv, P, LN2 and each
        # hidden chunk where the kernel does, but a fp32 sum taken in
        # another order can flip one of those roundings, and an output that
        # cancels terms of the size of the largest then differs by a step
        # of those terms (the D2 check's parameters, 0.3 N(0, 1))
        err_t = max_err(got, call(tiles, xb, cb, pb, cpeb), None,
                        TILES_STEPS)
        if not all(torch.equal(a, b) for a, b in
                   zip(got, call(wrappers, xb, cb, pb, cpeb))):
            raise AssertionError(f"{kind} N={n} C={ch} M={m}: two bf16 runs "
                                 "differ")
        dev_ms = device_ms(lambda: call(wrappers, xb, cb, pb, cpeb))
        extra = dict(m=m, err_tiles_bf16=err_t, bitwise_repeatable=True,
                     kernel_ms=dev_ms)
        if kind == "c_block":  # its port kernels, the attention beside SDPA
            prof = profile_call(lambda: call(wrappers, xb, cb, pb, cpeb),
                                f"c_block N={n} C={ch} B={b_main}", top=8)
            attn_ms = sum(v for k, v in prof.get("ms_by_name", {}).items()
                          if "k_dca_" in k) or None  # none: dropped
            sdpa = sdpa_c_fwd_device_ms(xb, cb, pb, ch // 32)
            extra.update(port_launches_per_call=port_kernels(prof, kind),
                         attn_part_device_ms=attn_ms, sdpa_fwd_ms=sdpa[0],
                         sdpa_fwd_device_ms=sdpa[1])
            say("kernel", f"c_block N={n} C={ch}: the meta direction's "
                f"attention, device ms {fmt_ms(attn_ms)}; SDPA's forward on "
                f"the same q, k, v {sdpa[0]:.4f} ms (device "
                f"{fmt_ms(sdpa[1])})")
    del got, want
    ms = cuda_ms(lambda: call(wrappers, xb, cb, pb, cpeb))
    plain_ms = cuda_ms(lambda: call(plains, xb, cb, pb, cpeb))
    nbytes, flops = work(kind, b_main, n, ch, hidden,
                         sum(t.numel() for t in pb + (cpeb or [])) * 2, 2,
                         cpe=bool(img_w), m=m)
    t_bound, by = bound(nbytes, flops)
    row = dict(name=kind, n=n, c=ch, batch=b_main, per_forward=per_fwd,
               err_fp32=err32, err_bf16=err16, ms=ms, plain_ms=plain_ms,
               bound_ms=t_bound, bound_by=by, tflops=flops / ms / 1e9,
               **extra)
    what = "" if m == M else f" M={m}"
    if img_w:
        row.update(img_w=img_w, external_cpe_ms=cuda_ms(lambda: call(
            wrappers, fb.cpe_plain(xb, *cpeb, img_w), cb, pb)))
        what += (f" with its CPE ({n // img_w}x{img_w}; external conv + "
                 f"kernel {row['external_cpe_ms']:.3f} ms)")
    tiles_what = "" if not extra else (
        f", against the tile model {extra['err_tiles_bf16']:.2e}, two runs "
        f"equal; device {fmt_ms(dev_ms)} ms")
    say("kernel", f"{kind} N={n} C={ch}{what}: fp32 err {err32:.2e} "
        f"(B={b_check}), bf16 err {err16:.2e} (B={b_main}){tiles_what}; "
        f"{ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms; bound {t_bound:.4f} ms ({by}); "
        f"{row['tflops']:.1f} TFLOP/s")
    return row


def scaled_err(got, want) -> tuple:
    """(max abs error, the least tol with |err| <= tol (max|ref| + |ref|)
    at every element of each tensor, the largest max|ref|) over tensors;
    raises where a value is not finite."""
    err = need = scale = 0.0
    for a, r in zip(got, want):
        a, r = a.float(), r.float()
        if not torch.isfinite(a).all():
            raise AssertionError("kernel output is not finite")
        d = (a - r).abs()
        top = r.abs().max()
        need = max(need, (d / (top + r.abs())).max().item())
        err, scale = max(err, d.max().item()), max(scale, top.item())
    return err, need, scale


# s_stage runs the s_block kernels' own tiles as the work items of one
# persistent launch (csrc/s_stage.cu), so it equals the chain of
# s_block(cpe=...) kernels bit for bit, in bf16 and in fp32 (x rounded to
# the input type between blocks in both). In bf16 both are also held
# against s_stage_plain in fp32: x is rounded to bf16 between the blocks, so
# an element's error follows the tensor's scale (tol (max|ref| + |ref|)).
# s_stage_plain run in bf16 is read beside them as a lower-precision
# control, and the distance to s_stage_tiles_plain (the tile model, whose
# exponentials and sums run on other units than the card's) in bf16 steps
# of each output's largest element (readings: PERF.md, section 6).
STAGE_TOL = 3e-2


def same(a, b) -> bool:
    """Whether two tuples of tensors are equal bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_stage(fb, label, nb, n, img_w, ch, b_check, b_main, per_fwd, dev,
                g):
    """s_stage at one stage's shape, nb seeded blocks (proj and fc2 weights
    scaled by (2 nb)^-1/2 and CPE taps 0.1 N(0, 1), so x keeps its scale
    over the stage), with and without CPEs: fp32 at b_check against
    s_stage_plain (1e-4 (1 + |ref|)); bf16 at b_main on the same bf16-cast
    inputs; in both types bit for bit equal to the chain of
    s_block(cpe=...) kernels and to a second call; in bf16 the stage and
    the chain against s_stage_plain in fp32 (STAGE_TOL), beside
    s_stage_plain run in bf16 and the tile model's distance (read only).
    Then, with CPEs, the times at b_main in bf16 of the stage, the chain
    and the plain version (CUDA events, mean of 5), the stage's and the
    chain's device time (the profiler, 20 calls), and the bound summed over
    the blocks."""
    hidden = 4 * ch
    params, cpes = [], []
    for _ in range(nb):
        p = make_params("s_block", ch, hidden, g)
        p[4], p[10] = (t * (2 * nb) ** -0.5 for t in (p[4], p[10]))
        params.append(p)
        cpes.append([0.1 * torch.randn(9, ch, generator=g),
                     0.1 * torch.randn(ch, generator=g)])
    x = torch.randn(b_main, n, ch, generator=g)
    c = torch.randn(b_main, M, ch, generator=g)
    kw = dict(num_heads=ch // 32, img_w=img_w)

    def cast(dt, dtype=None):
        """(params, cpes) on the card in dt (then in dtype, if given)."""
        to = lambda ts: [t.to(dev, dt).to(dtype or dt) for t in ts]  # noqa
        return [to(p) for p in params], [to(q) for q in cpes]

    def chain(xs, cs, ps, cps):
        for j, p in enumerate(ps):
            xs, cs = fb.s_block(xs, cs, p, cpe=cps and cps[j], **kw)
        return xs, cs

    def steps(got, want) -> float:
        """The largest error in bf16 steps of each tensor's largest |ref|."""
        return max((a.float() - r.float()).abs().max().item()
                   / (BF16_STEP * r.float().abs().max().item())
                   for a, r in zip(got, want))

    errs = {}
    for use_cpe in (False, True):
        p32, c32 = cast(torch.float32)
        c32 = c32 if use_cpe else None
        xs, cs = x[:b_check].to(dev), c[:b_check].to(dev)
        got32 = fb.s_stage(xs, cs, p32, cpes=c32, **kw)
        e32 = max_err(got32, fb.s_stage_plain(xs, cs, p32, cpes=c32, **kw),
                      1e-4)
        if not (same(got32, fb.s_stage(xs, cs, p32, cpes=c32, **kw))
                and same(got32, chain(xs, cs, p32, c32))):
            raise AssertionError(f"s_stage {label} fp32: not bit for bit "
                                 "the s_block chain and a second call")
        pb, cpb = cast(torch.bfloat16)
        pf, cpf = cast(torch.bfloat16, torch.float32)
        cpb, cpf = (cpb, cpf) if use_cpe else (None, None)
        xb, cb = x.to(dev, torch.bfloat16), c.to(dev, torch.bfloat16)
        got = fb.s_stage(xb, cb, pb, cpes=cpb, **kw)
        by_chain = chain(xb, cb, pb, cpb)
        if not (same(got, by_chain)
                and same(got, fb.s_stage(xb, cb, pb, cpes=cpb, **kw))):
            raise AssertionError(f"s_stage {label} bf16: not bit for bit "
                                 "the s_block chain and a second call")
        want = fb.s_stage_plain(xb.float(), cb.float(), pf, cpes=cpf, **kw)
        control = fb.s_stage_plain(xb, cb, pb, cpes=cpb, **kw)
        tiles = fb.s_stage_tiles_plain(xb, cb, pb, cpes=cpb, **kw)
        # (max err, least tol, max|ref|) of each comparison
        r = dict(stage=scaled_err(got, want),
                 chain=scaled_err(by_chain, want),
                 control=scaled_err(control, want))
        errs[use_cpe] = (e32, r, steps(got, tiles))
        del got, want, by_chain, control, tiles
    ms = cuda_ms(lambda: fb.s_stage(xb, cb, pb, cpes=cpb, **kw), 5, 1)
    chain_ms = cuda_ms(lambda: chain(xb, cb, pb, cpb), 5, 1)
    plain_ms = cuda_ms(lambda: fb.s_stage_plain(xb, cb, pb, cpes=cpb, **kw),
                       5, 1)
    dev_ms = device_ms(lambda: fb.s_stage(xb, cb, pb, cpes=cpb, **kw))
    chain_dev_ms = device_ms(lambda: chain(xb, cb, pb, cpb))
    got_n = (b_main * (n + M)) * ch
    n_params = sum(t.numel() for p in pb + cpb for t in p)
    nbytes, flops = work("s_block", b_main, n, ch, hidden, n_params * 2, 2,
                         cpe=True)
    flops *= nb  # x and c cross device memory once; every block computes
    t_bound, by = bound(nbytes, flops)
    worst = {k: max(e[1][k][1] for e in errs.values())
             for k in ("stage", "chain", "control")}
    row = dict(name="s_stage", stage=label, blocks=nb, n=n, img_w=img_w,
               c=ch, batch=b_main, per_forward=per_fwd,
               err_fp32=max(e[0] for e in errs.values()),
               err_bf16=max(e[1]["stage"][0] for e in errs.values()),
               bitwise_chain=True, bitwise_repeatable=True,
               least_tol_bf16=worst,
               tiles_steps_bf16=max(e[2] for e in errs.values()),
               ms=ms, chain_ms=chain_ms, plain_ms=plain_ms,
               kernel_ms=dev_ms, chain_kernel_ms=chain_dev_ms,
               bound_ms=t_bound, bound_by=by, tflops=flops / ms / 1e9)
    say("stage", f"s_stage {label} ({nb} blocks, N={n} C={ch}): "
        + "; ".join(
            f"{'with' if k else 'no'} CPEs fp32 err {e[0]:.2e} "
            f"(B={b_check}); bf16 (B={b_main}, {got_n} elements, max|ref| "
            f"{e[1]['stage'][2]:.3g}) bit for bit the chain and a second "
            f"call (fp32 too), max err / least tol against fp32 "
            f"{e[1]['stage'][0]:.3g} / {e[1]['stage'][1]:.4f}, bf16 plain "
            f"control {e[1]['control'][0]:.3g} / "
            f"{e[1]['control'][1]:.4f}, tile model {e[2]:.2f} bf16 steps"
            for k, e in errs.items())
        + f" | {ms:.3f} ms (device {fmt_ms(dev_ms)}) vs chain of {nb} "
        f"s_block {chain_ms:.3f} ms (device {fmt_ms(chain_dev_ms)}), "
        f"plain {plain_ms:.3f} ms; bound {t_bound:.4f} ms ({by}); "
        f"{row['tflops']:.1f} TFLOP/s")
    for what in ("stage", "chain"):
        if worst[what] > STAGE_TOL:
            raise AssertionError(f"s_stage {label}: {what} needs tol "
                                 f"{worst[what]:.4f} (max|ref| + |ref|), "
                                 f"beyond {STAGE_TOL}")
    return row


# The bf16 kernel path of a model is held against its plain path in fp32 on
# the same bf16-rounded weights and input within PLAIN_STEPS bf16 steps of
# the largest logit, as the kernels are held against their fp32 plain
# versions; the plain path run in bf16 is read beside it as a control
# (readings: PERF.md, "PR 9").


def check_model_bf16(name: str, dev, g, batch: int = 8) -> dict:
    """One model's bf16 logits, kernel path and plain path, against the
    plain path in fp32 on the same bf16-rounded weights and input."""
    from lemevit_tpu_torch import create_model
    model = create_model(name, device=dev).eval()
    img = torch.randn(batch, 224, 224, 3, generator=g).to(dev,
                                                          torch.bfloat16)
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(prm.to(torch.bfloat16).float())
        model.set_attn_backend("torch")
        ref = model(img.float())
        model.to(torch.bfloat16)
        plain = model(img).float()
        model.set_attn_backend("cuda")
        fused = model(img).float()
    if fused.shape != ref.shape or not torch.isfinite(fused).all():
        raise AssertionError(f"{name} bf16 logits: not finite or misshapen")
    scale = ref.abs().max().item()
    err, ctrl = ((t - ref).abs().max().item() for t in (fused, plain))
    lim = PLAIN_STEPS * BF16_STEP * scale
    say("model", f"{name} 224 bf16 B={batch}: logits max abs err against "
        f"fp32 {err:.3g} (kernel path; limit {lim:.3g}, {PLAIN_STEPS} bf16 "
        f"steps of max|ref| {scale:.3g}), {ctrl:.3g} (plain path in bf16, "
        f"the control)")
    if not err <= lim:
        raise AssertionError(f"{name} bf16 logits: kernel path {err:.3g} "
                             f"from fp32, beyond {lim:.3g}")
    return dict(model=name, batch=batch, err=err, control_err=ctrl,
                max_ref=scale)


def train_inputs(ft, kind, b, n, ch, g, dev, dtype, m=M):
    """x, c (m meta tokens), the LN-folded parameter tuple of an "s", "dca"
    or "c" block, DropPath scales (keep 0.85) and upstream gradients,
    seeded, in ``dtype`` on ``dev``."""
    params = []
    for shape in ft._param_shapes(kind, ch, 4 * ch):
        params.append(torch.randn(shape, generator=g) * shape[-1] ** -0.5
                      if len(shape) == 2 else
                      torch.randn(shape, generator=g) * 0.1)
    x = torch.randn(b, n, ch, generator=g)
    c = torch.randn(b, m, ch, generator=g)
    dp = (torch.rand(4, b, generator=g) < 0.85).float() / 0.85
    gx = torch.randn(b, n, ch, generator=g)
    gc = torch.randn(b, m, ch, generator=g)
    cast = [t.to(dev, dtype) for t in (x, c, gx, gc, *params)]
    return cast[0], cast[1], cast[4:], dp.to(dev), cast[2], cast[3]


def run_train_block(fn, x, c, params, dp, gx, gc, kw):
    """Outputs and the gradients of x, c and every parameter of fn under
    upstream grads gx, gc (the C block's one output takes gc)."""
    ts = [t.detach().clone().requires_grad_() for t in (x, c, *params)]
    out = fn(ts[0], ts[1], ts[2:], dp, **kw)
    out = out if isinstance(out, tuple) else (out,)
    ups = [gx, gc] if len(out) == 2 else [gc]
    torch.autograd.backward(list(out), [u.to(o.dtype)
                                        for u, o in zip(ups, out)])
    return [o.float() for o in out], [t.grad.float() for t in ts]


def phase_calls(ft, kind, x, c, p, dp, gx, gc, kw):
    """{phase: (kernel call, plain call)} of one training block, each
    phase on the outputs of the one before (the C block's MLP backward on
    an empty image stream). kw may carry a CPE (cpe=, img_w=) for the
    forward and the attention backward."""
    w1, b1, w2 = p[-4], p[-3], p[-2]
    name = TRAIN_PHASES[kind]
    fwd = getattr(ft, name[0])(x, c, p, dp, **kw)
    if kind == "c":
        none = x[:, :0]
        mlp_args = (none, fwd[1], none, gc, dp, w1, b1, w2)
        mlp = ft.mlp_bwd(*mlp_args)
        wq, bq, wkv, bkv, wp = p[:5]
        attn_args = (x, c, mlp[1], dp, wq, bq, wkv, bkv, wp, fwd[2], fwd[3])
    else:
        mlp_args = (fwd[2], fwd[3], gx, gc, dp, w1, b1, w2)
        mlp = ft.mlp_bwd(*mlp_args)
        attn_w = p[:3] if kind == "s" else p[:5] + p[6:7]
        attn_args = (x, c, mlp[0], mlp[1], dp, *attn_w, *fwd[4:])
    return {
        name[0]: (lambda: getattr(ft, name[0])(x, c, p, dp, **kw),
                  lambda: getattr(ft, name[0] + "_plain")(x, c, p, dp, **kw)),
        "mlp_bwd": (lambda: ft.mlp_bwd(*mlp_args),
                    lambda: ft.mlp_bwd_plain(*mlp_args)),
        name[2]: (lambda: getattr(ft, name[2])(*attn_args, **kw),
                  lambda: getattr(ft, name[2] + "_plain")(*attn_args, **kw)),
    }


def check_train_kernels(ft, kind, n, ch, blocks, dev, g, profile=False,
                        b_check=B_CHECK, b_main=B_MAIN):
    """A training block (its three kernels under autograd) against its
    autograd composition: fp32 at b_check, bf16 at b_main against fp32 on
    the same bf16-cast inputs (TRAIN_TOL); then each kernel timed at
    b_main in bf16 beside its plain phase and its bound. The last four
    gradients (fc1, fc2) come from the MLP backward, the rest from the
    attention backward (which also carries the MLP's dt1 into dx / dc).
    With ``profile``, the attention backward's device time by kernel."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    kw = {"num_heads": ch // 32}
    if kind == "dca":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
    fused = getattr(ft, f"{kind}_block_train")
    plain = getattr(ft, f"{kind}_block_train_plain")
    fwd_name, _, bwd_name = TRAIN_PHASES[kind]
    errs = {}
    for dtype, b in ((torch.float32, b_check), (torch.bfloat16, b_main)):
        x, c, p, dp, gx, gc = train_inputs(ft, kind, b, n, ch, g, dev, dtype)
        got_o, got_g = run_train_block(fused, x, c, p, dp, gx, gc, kw)
        torch.cuda.synchronize()
        want_o, want_g = run_train_block(
            plain, x.float(), c.float(), [t.float() for t in p], dp,
            gx.float(), gc.float(), kw)
        otol, gtol = TRAIN_TOL[dtype]
        names = [f"grad {i}" for i in range(len(want_g))]
        errs[dtype] = {
            fwd_name: max_err(got_o, want_o, otol),
            "mlp_bwd": max_grad_err(got_g[-4:], want_g[-4:], gtol,
                                    names[-4:]),
            bwd_name: max_grad_err(got_g[:-4], want_g[:-4], gtol,
                                   names[:-4]),
            "scale": max(w.abs().max().item() for w in want_g)}
        del got_o, got_g, want_o, want_g
    # rows 9-15 against their tile models and plain phases, two calls
    tc_errs = check_bwd_tc(ft, kind, n, ch, dev, g, b_check, b_main)
    # times per kernel, bf16, b_main, on the inputs of the last check
    rows = []
    for name, (kern, plain_fn) in phase_calls(ft, kind, x, c, p, dp, gx, gc,
                                              kw).items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain_fn)
        n_seen = 0 if (kind == "c" and name == "mlp_bwd") else n
        t_bound, by = bound(*train_work(name, b_main, n_seen, ch))
        extra = {}
        if name in tc_errs:  # rows 9-15: device time, split by kernel
            prof = profile_call(kern, f"{name} {kind} N={n} C={ch} "
                                f"B={b_main}", top=10)
            port = port_kernels(prof, name)
            extra = dict(device_ms=device_ms(kern),
                         launches_per_call=prof.get("launches"),
                         port_launches_per_call=port,
                         err_fp32_phase=tc_errs[name][0],
                         err_tiles_bf16=tc_errs[name][1],
                         kernels_ms={k.split("(")[0]: v for k, v in
                                     prof.get("ms_by_name", {}).items()})
            if name in ATTN_PART:  # the attention's share beside SDPA's
                key, sdpa_key, what = ATTN_PART[name]
                attn_ms = sum(v for k, v in prof.get("ms_by_name",
                                                     {}).items()
                              if key in k) or None  # none: dropped
                if name == "s_train_fwd":
                    sdpa = sdpa_fwd_device_ms(ft, x, c, p, ch // 32)
                elif name == "dca_train_fwd":
                    sdpa = sdpa_dca_fwd_device_ms(ft, x, c, p, ch // 32,
                                                  kw["scale_x"],
                                                  kw["scale_c"])
                elif name == "dca_attn_bwd":
                    sdpa = sdpa_dca_bwd_device_ms(
                        ft, tc_phases(ft, kind, x, c, p, dp, gx, gc,
                                      kw)[name][0], ch // 32,
                        kw["scale_x"], kw["scale_c"])
                elif name == "c_train_fwd":
                    sdpa = sdpa_c_train_device_ms(ft, x, c, p, ch // 32)
                elif name == "c_attn_bwd":
                    sdpa = sdpa_c_train_device_ms(
                        ft, x, c, p, ch // 32, tc_phases(
                            ft, kind, x, c, p, dp, gx, gc, kw)[name][0])
                else:
                    mlp_out = phase_calls(ft, kind, x, c, p, dp, gx, gc,
                                          kw)["mlp_bwd"][0]()
                    sdpa = sdpa_bwd_device_ms(ft, x, c, p, dp, mlp_out[0],
                                              mlp_out[1], ch // 32)
                extra.update({"attn_part_device_ms": attn_ms,
                              f"{sdpa_key}_ms": sdpa[0],
                              f"{sdpa_key}_device_ms": sdpa[1]})
                way = "forward" if sdpa_key == "sdpa_fwd" else "backward"
                say("train-kernel", f"{name} N={n} C={ch}: {what}, device "
                    f"ms {fmt_ms(attn_ms)}; SDPA's {way} on the same inputs "
                    f"{sdpa[0]:.4f} ms (device {fmt_ms(sdpa[1])})")
        elif profile and name == bwd_name:
            profile_call(kern, f"{name} N={n} C={ch} B={b_main}", top=10)
        rows.append(dict(
            name=name, kind=kind, n=n, c=ch, batch=b_main, per_step=blocks,
            err_fp32=errs[torch.float32][name],
            err_bf16=errs[torch.bfloat16][name],
            grad_scale_bf16=errs[torch.bfloat16]["scale"], ms=ms,
            plain_ms=plain_ms, bound_ms=t_bound, bound_by=by, **extra))
    e32, e16 = errs[torch.float32], errs[torch.bfloat16]
    say("train-kernel", f"{kind} N={n} C={ch}: fp32 B={b_check} err out "
        f"{e32[fwd_name]:.2e}, grads {max(e32['mlp_bwd'], e32[bwd_name]):.2e}"
        f" of max {e32['scale']:.3g}; bf16 B={b_main} err out "
        f"{e16[fwd_name]:.2e}, "
        f"grads {max(e16['mlp_bwd'], e16[bwd_name]):.2e} of max "
        f"{e16['scale']:.3g} | " + "; ".join(
            f"{r['name']} {r['ms']:.4f} ms" + (
                f" (device {fmt_ms(r['device_ms'])})" if "device_ms" in r
                else "") + f" (plain {r['plain_ms']:.3f}, "
            f"bound {r['bound_ms']:.4f} {r['bound_by']})" for r in rows))
    return rows


def tc_phases(ft, kind, x, c, p, dp, gx, gc, kw, cpe=None):
    """{phase: (args, keywords)} of one block kind's phases on the
    tensor-core kernels, each on the kernel outputs of the phase before:
    row 9 (s_train_fwd) and row 10 (s_attn_bwd) at S, row 11 (mlp_bwd) at
    every kind (the C block's on its meta stream alone), rows 12
    (dca_train_fwd) and 13 (dca_attn_bwd, on row 12's o and log-sum-exps)
    at D, rows 14 (c_train_fwd) and 15 (c_attn_bwd, on row 14's o and
    log-sum-exp) at C. kw carries num_heads, the D scales and, with the CPE
    pair ``cpe``, img_w."""
    w1, b1, w2 = p[-4], p[-3], p[-2]
    pkw = dict(kw, cpe=cpe) if cpe is not None else dict(kw)
    fwd = getattr(ft, TRAIN_PHASES[kind][0])(x, c, p, dp, **pkw)
    if kind == "c":
        none = x[:, :0]
        mlp = (none, fwd[1], none, gc, dp, w1, b1, w2)
        dt1c = ft.mlp_bwd(*mlp)[1]
        return {"c_train_fwd": ((x, c, p, dp), pkw), "mlp_bwd": (mlp, {}),
                "c_attn_bwd": ((x, c, dt1c, dp, *p[:5], *fwd[2:]), pkw)}
    mlp = (fwd[2], fwd[3], gx, gc, dp, w1, b1, w2)
    dt1x, dt1c = ft.mlp_bwd(*mlp)[:2]
    if kind == "s":
        return {"s_train_fwd": ((x, c, p, dp), pkw), "mlp_bwd": (mlp, {}),
                "s_attn_bwd": ((x, c, dt1x, dt1c, dp, *p[:3], *fwd[4:]),
                               pkw)}
    return {"dca_train_fwd": ((x, c, p, dp), pkw), "mlp_bwd": (mlp, {}),
            "dca_attn_bwd": ((x, c, dt1x, dt1c, dp, *p[:5], p[6],
                              *fwd[4:]), pkw)}


def check_bwd_tc(ft, kind, n, ch, dev, g, b_check=B_CHECK, b_main=B_MAIN,
                 img_w=0, m=M):
    """Rows 9-15 (lm_s_train_fwd, lm_s_attn_bwd at S, lm_mlp_bwd at every
    block kind, lm_dca_train_fwd, lm_dca_attn_bwd at D, lm_c_train_fwd,
    lm_c_attn_bwd at C; with img_w in their cpe mode)
    phase by phase: fp32 at b_check against the plain phases (TRAIN_TOL:
    1e-4 of (max|ref| + |ref|) per tensor), bf16 at b_main against their
    tile models (*_tiles_plain) within TILES_STEPS bf16 steps of each
    tensor's largest element, and every output bit for bit over two bf16
    calls; m meta tokens. Returns {phase: (fp32 err, bf16 err against the
    tile model)}."""
    kw = {"num_heads": ch // 32}
    if kind == "dca":
        from lemevit_tpu_torch.attn.reference import dca_scales
        kw["scale_x"], kw["scale_c"] = dca_scales(n, m, ch)
    if img_w:
        kw["img_w"] = img_w
    errs = {}
    for dtype, b in ((torch.float32, b_check), (torch.bfloat16, b_main)):
        x, c, p, dp, gx, gc = train_inputs(ft, kind, b, n, ch, g, dev, dtype,
                                           m)
        cpe = cpe_inputs(ch, g, dev, dtype) if img_w else None
        phases = tc_phases(ft, kind, x, c, p, dp, gx, gc, kw, cpe)
        for name, (args, pkw) in phases.items():
            got = [t for t in getattr(ft, name)(*args, **pkw)
                   if t is not None and t.numel()]
            again = [t for t in getattr(ft, name)(*args, **pkw)
                     if t is not None and t.numel()]
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise AssertionError(f"{name} {kind} N={n} C={ch} {dtype}: "
                                     "two calls differ")
            if dtype == torch.float32:
                ref = getattr(ft, name + "_plain")(*args, **pkw)
                names = [f"{name} out {i}" for i in range(len(got))]
                err = max_grad_err(
                    got, [t.float() for t in ref if t is not None
                          and t.numel()], TRAIN_TOL[dtype][1], names)
                errs[name] = [err]
            else:
                ref = getattr(ft, name + "_tiles_plain")(*args, **pkw)
                errs[name].append(max_err(
                    got, [t for t in ref if t is not None and t.numel()],
                    None, TILES_STEPS))
        del x, c, p, gx, gc, phases
    say("bwd-tc", f"{kind} N={n} C={ch}{f' cpe {img_w} wide' if img_w else ''}"
        f"{f' M={m}' if m != M else ''}: " + "; ".join(
            f"{name} fp32 B={b_check} err {e[0]:.2e} (plain), bf16 "
            f"B={b_main} err {e[1]:.2e} (tile model, {TILES_STEPS} steps)"
            for name, e in errs.items()) + "; two calls bit for bit")
    return errs


def _heads(u, heads):
    """(B, n, C) -> (B, heads, n, C / heads), contiguous."""
    return u.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()


def _qkv_rows(ft, t, w, bias):
    """q, k, v of one stream as k_qkv_wg computes them (LN1 rounded, the
    product in fp32 + bias, rounded)."""
    dt = t.dtype
    return (ft._norm(t).to(dt).float() @ w.float().t()
            + bias.float()).to(dt).chunk(3, -1)


def sdpa_fwd_device_ms(ft, x, c, p, heads) -> tuple:
    """(events ms, device ms) of SDPA's forward (PyTorch's fused kernel) on
    row 9's attention inputs, both streams' q, k, v; for this table
    only."""
    qkvs = [[_heads(u, heads) for u in _qkv_rows(ft, t, p[0], p[1])]
            for t in (x, c)]

    def run():
        for q, k, v in qkvs:
            F.scaled_dot_product_attention(q, k, v)
    return cuda_ms(run), device_ms(run)


def sdpa_dca_fwd_device_ms(ft, x, c, p, heads, scale_x, scale_c) -> tuple:
    """(events ms, device ms) of SDPA's forward on row 12's attention
    inputs: the x direction (q1 over k2 / v2, scale_x) and the c direction
    (q2 over k1 / v1, scale_c), q, k, v rounded as k_qkv_wg rounds them;
    for this table only."""
    q1, k1, v1 = (_heads(u, heads) for u in _qkv_rows(ft, x, p[0], p[1]))
    q2, k2, v2 = (_heads(u, heads) for u in _qkv_rows(ft, c, p[2], p[3]))

    def run():
        F.scaled_dot_product_attention(q1, k2, v2, scale=scale_x)
        F.scaled_dot_product_attention(q2, k1, v1, scale=scale_c)
    return cuda_ms(run), device_ms(run)


def sdpa_c_fwd_device_ms(x, c, p, heads) -> tuple:
    """(events ms, device ms) of SDPA's forward on the C block's attention
    inputs: the meta queries over the image keys, q = LN1(c) Wq^T + bq and
    k, v = LN1(x) Wkv^T + bkv rounded as k_qkv_wg rounds them; for this
    table only."""
    def rows(t, w, bias):
        a = F.layer_norm(t.float(), t.shape[-1:], p[0].float(), p[1].float(),
                         1e-6).to(t.dtype).float()
        return (a @ w.float().t() + bias.float()).to(t.dtype)
    q = _heads(rows(c, p[2], p[3]), heads)
    k, v = (_heads(u, heads) for u in rows(x, p[4], p[5]).chunk(2, -1))

    def run():
        F.scaled_dot_product_attention(q, k, v)
    return cuda_ms(run), device_ms(run)


def sdpa_c_train_device_ms(ft, x, c, p, heads, bwd_args=None) -> tuple:
    """(events ms, device ms) of SDPA's forward (or, given row 15's
    arguments ``bwd_args``, its backward) on rows 14-15's attention inputs:
    the meta queries over the image keys, q = LN1(c) Wq'^T + bq' and k, v =
    LN1(x) Wkv'^T + bkv' (and dO = s1c dt1c Wp) rounded as the kernels
    round them; for this table only."""
    def rows(t, w, bias):
        return (ft._norm(t).to(t.dtype).float() @ w.float().t()
                + bias.float()).to(t.dtype)
    q = _heads(rows(c, p[0], p[1]), heads)
    k, v = (_heads(u, heads) for u in rows(x, p[2], p[3]).chunk(2, -1))
    if bwd_args is None:
        def run():
            F.scaled_dot_product_attention(q, k, v)
        return cuda_ms(run), device_ms(run)
    dt1c, dp = bwd_args[2], bwd_args[3]
    ins = [u.requires_grad_() for u in (q, k, v)]
    out = F.scaled_dot_product_attention(*ins)
    d_o = _heads((ft._dproj(dp[2], dt1c).float() @ p[4].float()).to(
        dt1c.dtype), heads)

    def run():
        torch.autograd.grad(out, ins, d_o, retain_graph=True)
    return cuda_ms(run), device_ms(run)


def sdpa_bwd_device_ms(ft, x, c, p, dp, dt1x, dt1c, heads) -> tuple:
    """(events ms, device ms) of SDPA's backward (PyTorch's fused kernel)
    on row 10's attention inputs: both streams' q, k, v recomputed and dO =
    s1 dt1 Wp, rounded as the kernels round them; for this table only."""
    grads = []
    for t, dt1, s1 in ((x, dt1x, dp[0]), (c, dt1c, dp[2])):
        q, k, v = (_heads(u, heads).requires_grad_()
                   for u in _qkv_rows(ft, t, p[0], p[1]))
        d_o = (ft._dproj(s1, dt1).float() @ p[2].float()).to(t.dtype)
        out = F.scaled_dot_product_attention(q, k, v)
        grads.append((out, (q, k, v), _heads(d_o, heads)))

    def run():
        for out, ins, d_o in grads:
            torch.autograd.grad(out, ins, d_o, retain_graph=True)
    return cuda_ms(run), device_ms(run)


def sdpa_dca_bwd_device_ms(ft, args, heads, scale_x, scale_c) -> tuple:
    """(events ms, device ms) of SDPA's backward on row 13's attention
    inputs: the x direction (q1 over k2 / v2, scale_x) and the c direction
    (q2 over k1 / v1, scale_c), q, k, v and dO = s1 dt1 Wp rounded as the
    kernels round them; for this table only."""
    x, c, dt1x, dt1c, dp, wqkv1, bqkv1, wqkv2, bqkv2, wpx, wpc = args[:11]
    q1, k1, v1 = _qkv_rows(ft, x, wqkv1, bqkv1)
    q2, k2, v2 = _qkv_rows(ft, c, wqkv2, bqkv2)
    grads = []
    for q, k, v, s1, dt1, wp, sc in ((q1, k2, v2, dp[0], dt1x, wpx, scale_x),
                                     (q2, k1, v1, dp[2], dt1c, wpc,
                                      scale_c)):
        ins = [_heads(u, heads).requires_grad_() for u in (q, k, v)]
        d_o = (ft._dproj(s1, dt1).float() @ wp.float()).to(dt1.dtype)
        out = F.scaled_dot_product_attention(*ins, scale=sc)
        grads.append((out, ins, _heads(d_o, heads)))

    def run():
        for out, ins, d_o in grads:
            torch.autograd.grad(out, ins, d_o, retain_graph=True)
    return cuda_ms(run), device_ms(run)


def cpe_inputs(ch, g, dev, dtype):
    """Seeded 3x3 CPE taps (9, C) and bias (C,)."""
    return [(0.3 * torch.randn(9, ch, generator=g)).to(dev, dtype),
            (0.1 * torch.randn(ch, generator=g)).to(dev, dtype)]


def check_train_cpe(ft, fb, kind, n, img_w, ch, blocks, dev, g,
                    profile=False, b_check=B_CHECK, b_main=B_MAIN):
    """A training block in its CPE mode (pre-CPE x, a seeded 3x3 CPE inside
    the kernels) against its autograd composition with the same CPE: fp32
    at b_check, bf16 at b_main against fp32 on the same bf16-cast inputs
    (TRAIN_TOL), the tap and bias gradients among the attention backward's;
    dtaps and dbias of two attention-backward runs compared bit for bit;
    then the forward and the attention backward timed at b_main in bf16
    ("CPE in") beside their plain phases and the external placement ("ext":
    cpe_plain's F.conv2d, and in the backward its autograd, around the
    kernel without its CPE). With ``profile``, the attention backward's
    device time by kernel."""
    from lemevit_tpu_torch.attn.reference import dca_scales
    kw = {"num_heads": ch // 32}
    if kind == "dca":
        kw["scale_x"], kw["scale_c"] = dca_scales(n, M, ch)
    ckw = dict(kw, img_w=img_w)
    fused = getattr(ft, f"{kind}_block_train")
    plain = getattr(ft, f"{kind}_block_train_plain")

    def with_cpe(fn):  # the CPE's taps and bias lead the parameter list
        return lambda x_, c_, ps, dp_, **k: fn(x_, c_, ps[2:], dp_,
                                               cpe=ps[:2], **k)
    fwd_name, _, bwd_name = TRAIN_PHASES[kind]
    errs = {}
    for dtype, b in ((torch.float32, b_check), (torch.bfloat16, b_main)):
        x, c, p, dp, gx, gc = train_inputs(ft, kind, b, n, ch, g, dev, dtype)
        cpe = cpe_inputs(ch, g, dev, dtype)
        reset()
        got_o, got_g = run_train_block(with_cpe(fused), x, c, cpe + p, dp,
                                       gx, gc, ckw)
        torch.cuda.synchronize()
        expect_launches(launch_counts(), {fwd_name: 1, "mlp_bwd": 1,
                                          bwd_name: 1},
                        f"{kind} block with its CPE")
        want_o, want_g = run_train_block(
            with_cpe(plain), x.float(), c.float(),
            [t.float() for t in cpe + p], dp, gx.float(), gc.float(), ckw)
        otol, gtol = TRAIN_TOL[dtype]
        names = ["dx", "dc", "dtaps", "dbias"] + [
            f"grad {i}" for i in range(len(p))]
        errs[dtype] = {
            fwd_name: max_err(got_o, want_o, otol),
            "mlp_bwd": max_grad_err(got_g[-4:], want_g[-4:], gtol,
                                    names[-4:]),
            bwd_name: max_grad_err(got_g[:-4], want_g[:-4], gtol,
                                   names[:-4]),
            "cpe": max_grad_err(got_g[2:4], want_g[2:4], gtol,
                                names[2:4]),
            "scale": max(w.abs().max().item() for w in want_g)}
        del got_o, got_g, want_o, want_g
    check_bwd_tc(ft, kind, n, ch, dev, g, b_check, b_main, img_w=img_w)
    # bf16, b_main, on the inputs of the last check
    calls = phase_calls(ft, kind, x, c, p, dp, gx, gc, dict(ckw, cpe=cpe))
    first, second = calls[bwd_name][0](), calls[bwd_name][0]()
    repeatable = all(torch.equal(a, b) for a, b in zip(first[-2:],
                                                      second[-2:]))
    if not repeatable:
        raise AssertionError(f"{kind} N={n} C={ch}: dtaps / dbias differ "
                             "between two runs")
    del first, second
    xr = x.detach().clone().requires_grad_()
    cr = [t.detach().clone().requires_grad_() for t in cpe]
    y = fb.cpe_plain(xr, *cr, img_w)
    ext = phase_calls(ft, kind, y.detach(), c, p, dp, gx, gc, kw)
    fwd_kernel = getattr(ft, fwd_name)
    ext_ms = {
        fwd_name: cuda_ms(lambda: fwd_kernel(fb.cpe_plain(x, *cpe, img_w), c,
                                             p, dp, **kw)),
        bwd_name: cuda_ms(lambda: (ext[bwd_name][0](), torch.autograd.grad(
            y, [xr, *cr], gx, retain_graph=True)))}
    if profile:
        profile_call(calls[bwd_name][0], f"{bwd_name} with its CPE N={n} "
                     f"C={ch} B={b_main}", top=12)
    port = None
    if fwd_name in ("dca_train_fwd", "c_train_fwd"):  # rows 12, 14: as
        # many launches as without
        port = port_kernels(profile_call(
            calls[fwd_name][0], f"{fwd_name} with its CPE N={n} C={ch} "
            f"B={b_main}", top=8), fwd_name)
    rows = []
    for name in (fwd_name, bwd_name):
        kern, plain_fn = calls[name]
        t_bound, by = bound(*train_work(name, b_main, n, ch, cpe=True))
        rows.append(dict(
            name=name, kind=kind, n=n, img_w=img_w, c=ch, batch=b_main,
            per_step=blocks, err_fp32=errs[torch.float32][name],
            err_bf16=errs[torch.bfloat16][name],
            cpe_grad_err_fp32=errs[torch.float32]["cpe"],
            cpe_grad_err_bf16=errs[torch.bfloat16]["cpe"],
            grad_scale_bf16=errs[torch.bfloat16]["scale"],
            ms=cuda_ms(kern), plain_ms=cuda_ms(plain_fn),
            external_cpe_ms=ext_ms[name], bound_ms=t_bound, bound_by=by,
            dtaps_bitwise_repeatable=repeatable,
            **({"port_launches_per_call": port} if name == fwd_name
               and port is not None else {})))
    e32, e16 = errs[torch.float32], errs[torch.bfloat16]
    pass_ms = {name: cpe_pass_bytes(name, b_main, n, ch) / HBM_BYTES_PER_S
               * 1e3 for name in (fwd_name, bwd_name)}
    say("train-cpe", f"{kind} N={n} ({n // img_w}x{img_w}) C={ch}: fp32 "
        f"B={b_check} err out {e32[fwd_name]:.2e}, grads "
        f"{max(e32['mlp_bwd'], e32[bwd_name]):.2e} (dtaps/dbias "
        f"{e32['cpe']:.2e}) of max {e32['scale']:.3g}; bf16 B={b_main} err "
        f"out {e16[fwd_name]:.2e}, grads "
        f"{max(e16['mlp_bwd'], e16[bwd_name]):.2e} (dtaps/dbias "
        f"{e16['cpe']:.2e}) of max {e16['scale']:.3g}; dtaps bitwise "
        "repeatable | " + "; ".join(
            f"{r['name']} CPE in {r['ms']:.3f} ms (ext "
            f"{r['external_cpe_ms']:.3f}, plain {r['plain_ms']:.3f}, bound "
            f"{r['bound_ms']:.4f} {r['bound_by']}, CPE passes' bytes "
            f"{pass_ms[r['name']]:.4f})" for r in rows))
    return rows


def check_c_train_meta(ft, dev, g, m=320, n=3136, ch=64, b=8):
    """The C block with m meta tokens (past the 256 meta rows a CTA of
    k_dca_tc and k_dca_bwd_tc stages at a time; the C block takes any M):
    rows 14-15 phase by phase as check_bwd_tc holds them, then a bf16 C
    training block on the kernel path (one launch of each phase) against
    its autograd composition in fp32 on the same bf16 inputs
    (TRAIN_TOL)."""
    check_bwd_tc(ft, "c", n, ch, dev, g, b_check=2, b_main=b, m=m)
    kw = {"num_heads": ch // 32}
    x, c, p, dp, gx, gc = train_inputs(ft, "c", b, n, ch, g, dev,
                                       torch.bfloat16, m)
    reset()
    got_o, got_g = run_train_block(ft.c_block_train, x, c, p, dp, gx, gc, kw)
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {"c_train_fwd": 1, "mlp_bwd": 1,
                                      "c_attn_bwd": 1}, f"C block, M={m}")
    want_o, want_g = run_train_block(
        ft.c_block_train_plain, x.float(), c.float(), [t.float() for t in p],
        dp, gx.float(), gc.float(), kw)
    otol, gtol = TRAIN_TOL[torch.bfloat16]
    err_o = max_err(got_o, want_o, otol)
    err_g = max_grad_err(got_g, want_g, gtol,
                         [f"grad {i}" for i in range(len(want_g))])
    say("train-kernel", f"c N={n} C={ch} M={m} bf16 B={b}: the kernel path "
        f"against the fp32 composition, err out {err_o:.2e}, grads "
        f"{err_g:.2e} (tol {otol:g} / {gtol:g})")


def check_d2_train_block(ft, dev, g):
    """A train-mode D2 block (lemevit_tiny_v2's stage 1: N = 3136, C = 96)
    through the D training kernels by the weight permutation, against its
    own composition with the same DropPath scales: outputs 1e-4, the
    gradients of x, c and every parameter 1e-3 of their largest element."""
    from lemevit_tpu_torch.models.lemevit import LeMeBlock
    blk = LeMeBlock(96, 3, "D2", drop_path=0.15).to(dev).train()
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g).to(dev) * 0.3)
    x = torch.randn(B_CHECK, 56, 56, 96, generator=g).to(dev)
    c = torch.randn(B_CHECK, M, 96, generator=g).to(dev)
    dp = (torch.rand(4, B_CHECK, generator=g) < 0.85).float().to(dev) / 0.85
    runs = []
    before = dict(ft.LAUNCHES)
    for backend in ("cuda", "torch"):
        blk.attn_backend = backend
        blk.zero_grad(set_to_none=True)
        xs, cs = x.clone().requires_grad_(), c.clone().requires_grad_()
        xo, co = blk(xs, cs, dp)
        (xo.square().mean() + co.square().mean()).backward()
        runs.append(([xo.detach(), co.detach()],
                     [xs.grad, cs.grad] + [q.grad for q in blk.parameters()]))
        if backend == "cuda":
            launched = {k: ft.LAUNCHES[k] - before[k] for k in before
                        if ft.LAUNCHES[k] != before[k]}
    if launched != {"dca_train_fwd": 1, "mlp_bwd": 1, "dca_attn_bwd": 1}:
        raise AssertionError(f"D2 train block launches {launched}")
    e_out = max_err(runs[0][0], runs[1][0], 1e-4)
    names = ["x", "c"] + [n for n, _ in blk.named_parameters()]
    e_grad = 0.0
    for a, b, name in zip(runs[0][1], runs[1][1], names):
        d = (a - b).abs().max().item()
        if not d <= 1e-3 * b.abs().max().item() + 1e-6:
            raise AssertionError(f"D2 gradient {name}: {d:.3g}")
        e_grad = max(e_grad, d / (b.abs().max().item() + 1e-12))
    say("train-kernel", f"D2 permutation N=3136 C=96 fp32 B=8: out err "
        f"{e_out:.2e}; gradients within {e_grad:.2e} of their largest "
        f"element (limit 1e-3); launches {launched}")


def check_defaults_model(dev):
    """LeMeViT() with its constructor defaults (head_dim 64, 128 meta
    tokens) at 64^2, fp32, B=2, under attn_backend="auto": every block
    declines by shape (fused_block.block_takes, fused_train.train_takes)
    and composes, as the JAX package's kernels return None there, so a
    forward and one training step run with no kernel launched and match
    attn_backend="torch" (logits within 1e-4 of (max|ref| + |ref|), each
    gradient within 1e-4 of its largest element + 1e-6: a conv bias before
    a BatchNorm has a gradient of ~1e-8, all rounding)."""
    from lemevit_tpu_torch.models.lemevit import LeMeViT
    torch.manual_seed(0)
    auto = LeMeViT(num_classes=10).to(dev)
    plain = copy.deepcopy(auto)
    plain.set_attn_backend("torch")
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator()
                    .manual_seed(9)).to(dev)
    out = []
    reset()
    for m in (auto, plain):
        m.train()
        m(x).square().mean().backward()
        m.eval()
        with torch.no_grad():
            out.append((m(x), [q.grad for q in m.parameters()]))
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {}, "LeMeViT() under auto")
    err = max_grad_err([out[0][0]], [out[1][0]], 1e-4, ["logits"])
    worst = 0.0  # the largest gradient error as a share of its limit
    for (pname, _), a, b in zip(plain.named_parameters(), out[0][1],
                                out[1][1]):
        if b is None:
            continue
        lim = 1e-4 * b.abs().max().item() + 1e-6
        d = (a - b).abs().max().item()
        if not d <= lim:
            raise AssertionError(f"LeMeViT() gradient of {pname}: max abs "
                                 f"err {d:.3g} beyond {lim:.3g}")
        worst = max(worst, d / lim)
    say("defaults", f"LeMeViT() head_dim 64, 128 meta tokens, 64^2 fp32 "
        f"B=2 under auto: composes (no kernel launched); logits err "
        f"{err:.2e}; gradients within {100 * worst:.1f}% of their limits "
        f"(1e-4 max|ref| + 1e-6) against attn_backend=torch")


def check_train_step(dev, name, expect, **model_kw):
    """One fp32 train step's loss and gradients of ``name`` (with
    ``model_kw``) at 224^2, B=2, drop-path 0.15 with the same masks: the
    kernel path against --attn-backend torch. Limits: loss 1e-4 abs; each
    parameter's gradient (pos_embed's among them) max |err| <= 1e-3
    max|ref| + 1e-6."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.steps import cross_entropy_loss
    kern = create_model(name, device=dev, drop_path_rate=0.15,
                        **model_kw).train()
    plain = copy.deepcopy(kern)
    plain.set_attn_backend("torch")
    g = torch.Generator().manual_seed(3)
    img = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (2,), generator=g).to(dev)
    before = launch_counts()
    losses = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device=dev).manual_seed(11))
        loss = cross_entropy_loss(m(img), labels)
        loss.backward()
        losses.append(loss.item())
    launched = launched_since(before)
    if launched != expect:
        raise AssertionError(f"{name} train step launches {launched}, "
                             f"expected {expect}")
    if not abs(losses[0] - losses[1]) <= 1e-4:
        raise AssertionError(f"{name} train-step loss {losses[0]} vs plain "
                             f"{losses[1]}")
    worst = 0.0  # the largest error as a share of its limit
    for (pname, a), b in zip(kern.named_parameters(), plain.parameters()):
        d = (a.grad - b.grad).abs().max().item()
        scale = b.grad.abs().max().item()
        if not d <= 1e-3 * scale + 1e-6:
            raise AssertionError(f"gradient of {pname}: max abs err {d:.3g} "
                                 f"of max {scale:.3g}")
        worst = max(worst, d / (1e-3 * scale + 1e-6))
    what = "".join(f", {k}={v}" for k, v in model_kw.items())
    say("train-step", f"{name}{what} 224 fp32 B=2: loss {losses[0]:.6f} vs "
        f"plain "
        f"{losses[1]:.6f} (|diff| {abs(losses[0] - losses[1]):.2e}, limit "
        f"1e-4); gradients within {100 * worst:.1f}% of their limits "
        f"(1e-3 max|ref| + 1e-6); launches {launched}")


def train_main_path(model, per_step, per_eval, flags=(), data_dir=None,
                    val_batches=2, steps=TRAIN_STEPS, keep_state=False,
                    data_flags=None):
    """cli.train on synthetic data, on the image folder ``data_dir``
    (--dataset imagefolder, 4 loader threads unless ``flags`` ask for
    worker processes), or on what ``data_flags`` name (a packed cache):
    ``model``, 224^2, bf16,
    B=64, the reference recipe (configs/lemevit.yaml: RandAugment m9,
    hflip and random resized crops on real images; mixup, cutmix, erasing,
    smoothing, drop-path 0.15, EMA), 1 epoch of ``steps`` steps and one
    eval of the live and EMA models over ``val_batches`` whole batches,
    with the extra CLI ``flags``, its launch counts set to 0 just before
    and read just after. Returns (launches, result); the result's
    "log_times" are the wall times of the logged steps (events.jsonl), and
    with ``keep_state`` its "state_dict" the checkpoint's model state."""
    from lemevit_tpu_torch.cli import train as train_cli
    data = (list(data_flags) if data_flags else
            ["--synthetic"] if data_dir is None else
            ["--dataset", "imagefolder", "--data-dir", str(data_dir),
             "--workers", "4"])
    with tempfile.TemporaryDirectory() as out:
        reset()
        torch.cuda.reset_peak_memory_stats()
        res = train_cli.main([
            *data, "--model", model, "--img-size", "224",
            "--batch-size", str(B_MAIN),
            "--config", str(REPO / "configs" / "lemevit.yaml"),
            "--epochs", "1", "--steps-per-epoch", str(steps),
            "--output", out, *flags])
        launches = launch_counts()
        with open(Path(out) / model / "events.jsonl") as f:
            res["log_times"] = [json.loads(line)["time"] for line in f]
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(Path(out) / model / "summary.csv") as f:
            rows = list(csv.DictReader(f))
        if list(rows[0]) != train_cli.SUMMARY_FIELDS or len(rows) != 1:
            raise AssertionError(f"summary.csv: {rows}")
        ckpts = list((Path(out) / model / "checkpoints").glob(
            "checkpoint-*.pth"))
        if keep_state and ckpts:
            res["state_dict"] = torch.load(
                ckpts[0], map_location="cpu", weights_only=True)["state_dict"]
    eval_fwds = val_batches * 2  # live and EMA model
    want = {k: per_step.get(k, 0) * steps
            + per_eval.get(k, 0) * eval_fwds for k in launches}
    expect_launches(launches, want, f"{model} ({steps} steps, "
                    f"{eval_fwds} eval forwards)")
    loss = res["train_loss"]
    if not (loss == loss and abs(loss) < 1e3) or res["steps"] != steps \
            or len(ckpts) != 1:
        raise AssertionError(f"train: {res}, checkpoints {ckpts}")
    say("train", f"{model} {' '.join(data_flags or ())} {' '.join(flags)}"
        f" 224 bf16 B={B_MAIN}"
        f"{'' if data_dir is None else ', JPEG folder'}: "
        f"{res['steps']} steps, "
        f"loss {loss:.4f}, {res['samples_per_sec']:.2f} img/s"
        + (f" ({res['views_per_sec']:.2f} views/s)"
           if "views_per_sec" in res else "") + ", "
        f"{res['step_ms']:.2f} ms/step (steps 2-{steps}), peak "
        f"{res['peak_gib']:.2f} GiB allocated; eval top1 "
        f"{res['best_top1']:.3f}; launches per step " + ", ".join(
            f"{k} {v}" for k, v in per_step.items())
        + "; per eval forward " + ", ".join(
            f"{k} {v}" for k, v in per_eval.items()))
    return launches, res


def profile_train_step(dev, name, **model_kw):
    """torch.profiler table of one bf16 B=64 train step of ``name`` (with
    ``model_kw``)."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from lemevit_tpu_torch.train.state import ModelEma, TrainState
    from lemevit_tpu_torch.train.steps import train_step
    model = create_model(name, device=dev, drop_path_rate=0.15, **model_kw)
    model.set_generator(torch.Generator(device=dev).manual_seed(0))
    state = TrainState(model, build_optimizer(model), build_lr_schedule(),
                       ModelEma(model, 0.996))
    g = torch.Generator().manual_seed(5)
    img = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (B_MAIN,), generator=g).to(dev)
    return profile_call(lambda: train_step(state, img, labels,
                                           autocast_dtype=torch.bfloat16),
                        f"one {name} train step"
                        + "".join(f", {k}={v}" for k, v in model_kw.items()))


def profile_eval_forward(dev, name: str, batch: int = B_MAIN) -> dict:
    """torch.profiler table of one bf16 eval forward of ``name`` at 224^2
    (the S and D block kernels' share of a served or evaluated model)."""
    from lemevit_tpu_torch import create_model
    model = create_model(name, device=dev, dtype=torch.bfloat16).eval()
    x = torch.randn(batch, 224, 224, 3, generator=torch.Generator()
                    .manual_seed(7)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        return profile_call(lambda: model(x), f"one {name} eval forward "
                            f"(bf16, B={batch})", top=8)


def host_batch_ms(dataset=None, threads: int = 1, n: int = 3, procs: int = 0,
                  spec=None) -> float:
    """Host ms per training batch of B_MAIN images at 224^2 as cli.train's
    loader builds them with ``threads`` producer threads, or ``procs``
    spawned workers that build the dataset from ``spec`` (on the host, no
    copy to the card): the steady pace, the time from the producers' first
    round of batches (one each; it holds their start-up) to n batches
    later, over n. The dataset is synthetic unless given."""
    from lemevit_tpu_torch.data.datasets import SyntheticDataset
    from lemevit_tpu_torch.data.loader import create_loader
    first = procs or threads
    ds = (SyntheticDataset(num_samples=(first + n) * B_MAIN, image_size=224)
          if dataset is None else dataset)
    loader = create_loader(ds, B_MAIN, is_training=True, num_threads=threads,
                           num_procs=procs, dataset_spec=spec)
    it = iter(loader)
    for _ in range(first):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    ms = (time.perf_counter() - t0) / n * 1e3
    it.close()
    return ms


# the real-data phase's image folder: REAL_CLASSES classes, REAL_TRAIN_STEPS
# + REAL_SPARE whole batches to train on and REAL_VAL validation images (a
# ragged last batch of REAL_VAL % B_MAIN), sides drawn from REAL_SIDES.
# cli.train trains REAL_TRAIN_STEPS steps of that epoch and logs every
# REAL_LOG; its steady img/s is read over the last REAL_WINDOW of them: a
# dozen steps after the first, and while the producers still build (the
# REAL_SPARE batches are more than 4 producers' queues and the device
# prefetch hold, 4 * (PREFETCH + 1) + DEVICE_PREFETCH = 14)
REAL_CLASSES = 8
REAL_VAL = 100
REAL_SIDES = (256, 512)
REAL_AA = "rand-m9-mstd0.5-inc1"  # configs/lemevit.yaml's aa
REAL_LOG = 4
REAL_TRAIN_STEPS = 6 * REAL_LOG + 1  # logged at steps 0, 4, ..., 24
REAL_WINDOW = 3 * REAL_LOG
REAL_SPARE = 16


def real_picture(rs, h: int, w: int):
    """A PIL RGB picture: smooth colour fields (upsampled noise) with
    fine noise on top, so that JPEG coding and the augmentations do real
    work."""
    from PIL import Image
    import numpy as np
    small = rs.randint(0, 256, (h // 32 + 2, w // 32 + 2, 3), np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC),
                     np.int16)
    img = img + rs.randint(-12, 13, img.shape)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def write_real_data(root: Path, seed: int = 0) -> dict:
    """Write, with PIL, from ``seed`` (each image from its own generator,
    eight at a time): a class-per-directory JPEG folder (train/:
    (REAL_TRAIN_STEPS + REAL_SPARE) * B_MAIN images over REAL_CLASSES
    classes;
    validation/: REAL_VAL images; mixed sizes within REAL_SIDES; one PNG
    and one greyscale JPEG among them); a UCM-form manifest tree (all_img/
    and valid_labels_55.txt) and a zip with its map file (validation.zip,
    validation_map.txt), each of 2 images a class; and a ReaL-labels JSON
    for validation/ (each image's class and the next). Returns the paths
    and counts."""
    import zipfile
    import numpy as np
    counts = {"train": (REAL_TRAIN_STEPS + REAL_SPARE) * B_MAIN,
              "validation": REAL_VAL}

    def write(job) -> Path:
        s, split, k = job
        rs = np.random.RandomState([seed, s, k])
        d = root / "folder" / split / f"class{k % REAL_CLASSES}"
        h, w = (int(v) for v in rs.randint(REAL_SIDES[0],
                                           REAL_SIDES[1] + 1, 2))
        img = real_picture(rs, h, w)
        path = d / f"{split}_{k:05d}.{'png' if k == 1 else 'jpg'}"
        if k == 2:
            img = img.convert("L")
        img.save(path, **({} if k == 1 else {"quality": 90}))
        return path

    jobs = [(s, split, k) for s, (split, total) in enumerate(counts.items())
            for k in range(total)]
    for split in counts:
        for c in range(REAL_CLASSES):
            (root / "folder" / split / f"class{c}").mkdir(parents=True)
    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(write, jobs))
    val = [(p, k % REAL_CLASSES) for (_, split, k), p in zip(jobs, paths)
           if split == "validation" and p.suffix == ".jpg"]
    real = {p.name: [c, (c + 1) % REAL_CLASSES] for p, c in val}
    small = [(p, f"{p.parent.name}/{p.name}", c) for p, c in val
             if int(p.stem.split("_")[1]) < 2 * REAL_CLASSES]
    ucm = root / "ucm"
    (ucm / "all_img").mkdir(parents=True)
    (root / "zip").mkdir()
    with zipfile.ZipFile(root / "zip" / "validation.zip", "w") as zf:
        for path, inner, _ in small:
            (ucm / "all_img" / path.name).write_bytes(path.read_bytes())
            zf.write(path, inner)
    (ucm / "valid_labels_55.txt").write_text(
        "".join(f"{p.name} {c}\n" for p, _, c in small))
    (root / "zip" / "validation_map.txt").write_text(
        "".join(f"{inner}\t{c}\n" for _, inner, c in small))
    (root / "real.json").write_text(json.dumps(real))
    return {"folder": root / "folder", "ucm": ucm, "zip": root / "zip",
            "real": root / "real.json", "small": len(small), **counts}


def validate_real(folder: Path, flags=(), data_flags=None) -> tuple:
    """cli.validate of lemevit_base (bf16, B_MAIN) on ``folder``'s
    validation split decoded by PIL (or on what ``data_flags`` name: a
    packed cache) with
    ``flags``, its launch counts set to 0 just before
    and read just after, then the same with --attn-backend torch. Raises
    unless the counts are equal, the losses agree within PLAIN_STEPS bf16
    steps of the plain path's, and every image's logits agree with the
    plain path's within 2 * PLAIN_STEPS bf16 steps of their largest
    element: each bf16 path is held within PLAIN_STEPS of fp32
    (check_model_bf16), so two that pass lie within twice that of each
    other, while logits that carry nothing of the image (uniform, or
    another image's) are off by about the largest logit. Returns
    (launches, kernel result, plain result, logits check)."""
    from lemevit_tpu_torch.cli import validate
    argv = ["--model", "lemevit_base",
            *(data_flags or ("--data-dir", str(folder),
                             "--no-native-decode")),
            "--batch-size", str(B_MAIN), *flags]
    logits = ([], [])
    reset()
    got = validate.validate(validate.build_parser().parse_args(argv),
                            logits[0])
    launches = launch_counts()
    plain = validate.validate(validate.build_parser().parse_args(
        argv + ["--attn-backend", "torch"]), logits[1])
    out, ref = (torch.cat(t).cpu() for t in logits)
    if out.shape != (REAL_VAL, 1000) or ref.shape != out.shape or \
            not torch.isfinite(out).all():
        raise AssertionError(f"validate {' '.join(flags)} logits: "
                             f"{tuple(out.shape)}, {tuple(ref.shape)}")
    scale = ref.abs().max().item()
    lim = 2 * PLAIN_STEPS * BF16_STEP * scale
    diff = (out - ref).abs()
    last = REAL_VAL - REAL_VAL % B_MAIN
    check = {"err": diff.max().item(), "last_batch_err":
             diff[last:].max().item(), "limit": lim, "max_ref": scale,
             "argmax_equal": int((out.argmax(-1) == ref.argmax(-1)).sum())}
    loss_lim = PLAIN_STEPS * BF16_STEP * max(1.0, abs(plain["loss"]))
    if got["count"] != plain["count"] or not check["err"] <= lim or not (
            abs(got["loss"] - plain["loss"]) <= loss_lim):
        raise AssertionError(f"validate {' '.join(flags)} on images: "
                             f"{got}, logits {check}, against the plain "
                             f"path {plain}")
    return launches, got, plain, check


def steady_rate(res: dict) -> dict:
    """A REAL_TRAIN_STEPS cli.train run's img/s over its last REAL_WINDOW
    steps (events.jsonl's times, logged every REAL_LOG), its ms per step
    over each REAL_LOG steps after step 0, and cli.train's own rate."""
    times = res["log_times"]
    if len(times) != REAL_TRAIN_STEPS // REAL_LOG + 1:
        raise AssertionError(f"cli.train logged {len(times)} steps")
    return {"img_per_s": REAL_WINDOW * B_MAIN / (
                times[-1] - times[-1 - REAL_WINDOW // REAL_LOG]),
            "ms_per_step_by_log": [1e3 * (b - a) / REAL_LOG for a, b
                                   in zip(times, times[1:])],
            "cli_train_img_per_s_steps_2_on": res["samples_per_sec"]}


def real_data_phase(smi: str, synthetic_train: dict, root: Path) -> dict:
    """The classification data plane on real images, decoded by PIL
    (--no-native-decode; packed_native_phase runs the other planes): write
    the data, train
    lemevit_tiny on the folder through cli.train (TINY_STEP's launches per
    step, as on synthetic data) for REAL_TRAIN_STEPS steps with 4 loader
    threads and with 4 worker processes, its img/s read over the steady
    window; validate lemevit_base on its validation split
    (a ragged last batch) on the default and the slice's path, each image's
    logits against the plain path's; validate with ReaL labels, the UCM
    tree and the zip; time a real-data batch's host build with 1 and 4
    threads and 4 worker processes beside a synthetic one. The data is
    written under ``root`` (write_real_data) and left there. Fails if PIL
    does not import."""
    import PIL  # noqa: F401  (no fallback to synthetic data)
    from lemevit_tpu_torch.cli import validate
    from lemevit_tpu_torch.data.spawn import DatasetSpec
    t0 = time.time()
    data = write_real_data(root)
    t_write = time.time() - t0
    trained = {}
    # the process run skips the eval: each pass of a process loader
    # spawns its workers anew, twice for the live and EMA models
    for name, flags, val_batches in (
            ("4_threads", (), REAL_VAL // B_MAIN),
            ("4_procs", ("--worker-procs", "4", "--eval-interval", "2"),
             0)):
        _, res = train_main_path(
            "lemevit_tiny", TINY_STEP, TINY_EVAL,
            data_dir=data["folder"], val_batches=val_batches,
            steps=REAL_TRAIN_STEPS,
            flags=("--log-interval", str(REAL_LOG), "--no-native-decode",
                   *flags))
        trained[name] = steady_rate(res)
    n_fwd = 1 + -(-REAL_VAL // B_MAIN)  # the warm-up and each batch
    paths = {}
    for name, flags, per_fwd in (
            ("default", (), {"c_block": 2, "dca_block": 8,
                             "s_block": 22}),
            ("slice", ("--s-stage", "--cpe-in-kernel"), SLICE_FWD)):
        launches, got, plain, check = validate_real(data["folder"],
                                                    flags)
        expect_launches(launches, {k: v * n_fwd
                                   for k, v in per_fwd.items()},
                        f"validate {name} path on {REAL_VAL} images "
                        f"({n_fwd} forwards)")
        if got["count"] != REAL_VAL:
            raise AssertionError(f"validate counted {got['count']} of "
                                 f"{REAL_VAL} images")
        paths[name] = {"loss": got["loss"], "plain_loss": plain["loss"],
                       "top1": got["top1"], "count": got["count"],
                       "img_per_s": got["samples_per_sec"],
                       "logits": check}
        say("real-validate", f"lemevit_base {name} path bf16 B={B_MAIN} "
            f"on {REAL_VAL} JPEGs (last batch {REAL_VAL % B_MAIN}): "
            f"logits max abs err against the plain path {check['err']:.4g}"
            f" (last batch {check['last_batch_err']:.4g}; limit "
            f"{check['limit']:.4g}, {2 * PLAIN_STEPS} bf16 steps of "
            f"max|ref| {check['max_ref']:.4g}), argmax equal on "
            f"{check['argmax_equal']} of {REAL_VAL}; loss {got['loss']} "
            f"vs {plain['loss']}, {got['samples_per_sec']} img/s; "
            f"launches per forward " + ", ".join(
                f"{k} {launches[k] // n_fwd}" for k in per_fwd)
            + f" ({smi})")
    tiny = ["--model", "lemevit_tiny", "--batch-size", str(B_MAIN),
            "--no-native-decode"]
    real = validate.main([*tiny, "--data-dir", str(data["folder"]),
                          "--real-labels", str(data["real"])])
    ucm = validate.main([*tiny, "--data-dir", str(data["ucm"]),
                         "--dataset", "ucm", "--split", "valid"])
    zipped = validate.main([*tiny, "--data-dir", str(data["zip"]),
                            "--dataset", "zipfolder"])
    if not (0 <= real.get("real_top1", -1) <= 100
            and real["count"] == REAL_VAL
            and ucm["count"] == zipped["count"] == data["small"]
            and abs(ucm["loss"] - zipped["loss"]) <= 1e-3):
        raise AssertionError(f"ReaL / ucm / zipfolder: {real}, {ucm}, "
                             f"{zipped}")
    say("real-validate", f"lemevit_tiny --real-labels: real_top1 "
        f"{real['real_top1']} over {real['count']}; --dataset ucm "
        f"{ucm['count']} images, loss {ucm['loss']}; --dataset "
        f"zipfolder {zipped['count']}, loss {zipped['loss']}")
    spec = DatasetSpec("lemevit_tpu_torch.data.spawn:build_split_dataset",
                       dict(dataset="imagefolder",
                            data_dir=str(data["folder"]), split="train",
                            auto_augment=REAL_AA))
    train_ds = spec.build()
    host = {"synthetic_1_thread": host_batch_ms(),
            "real_1_thread": host_batch_ms(train_ds, 1, 4),
            "real_4_threads": host_batch_ms(train_ds, 4, 12),
            "real_4_procs": host_batch_ms(train_ds, n=12, procs=4,
                                          spec=spec)}
    summary = {
        "model": "lemevit_tiny", "batch": B_MAIN, "dtype": "bf16",
        "train": trained, "steps": REAL_TRAIN_STEPS,
        "window_steps": REAL_WINDOW,
        "synthetic_train_img_per_s": synthetic_train["samples_per_sec"],
        "host_batch_ms": host, "validate": paths,
        "write_s": t_write, "phase_s": time.time() - t0, "card": smi}
    say("real-data", f"cli.train lemevit_tiny on JPEGs over steps "
        f"{REAL_TRAIN_STEPS - REAL_WINDOW}-{REAL_TRAIN_STEPS - 1}: " + "; ".join(
            f"{name.replace('_', ' ')} {t['img_per_s']:.2f} img/s (ms per "
            f"step over each {REAL_LOG} steps: " + ", ".join(
                f"{v:.1f}" for v in t["ms_per_step_by_log"]) + ")"
            for name, t in trained.items())
        + f"; synthetic in this run: "
        f"{synthetic_train['samples_per_sec']:.2f} img/s; host ms per "
        f"batch of {B_MAIN}: synthetic {host['synthetic_1_thread']:.1f}, "
        f"real {host['real_1_thread']:.1f} (1 thread), "
        f"{host['real_4_threads']:.1f} (4 threads), "
        f"{host['real_4_procs']:.1f} (4 processes) ({smi})")
    say("real-data-summary", json.dumps(summary))
    return summary


# the packed and native data planes (cli.pack's cache at PACK_PX with the
# device augmentation, and the C++ decode); device_aug held against its CPU
# run on the same draws: the crop and flip within AUG_CROP_TOL, each
# RandAugment layer, on the same input, within AUG_LAYER_TOL (the CPU tests'
# limits against the JAX function)
PACK_PX = 256
AUG_CROP_TOL = 2e-3
AUG_LAYER_TOL = 1e-2
NATIVE_HEADERS = ("jpeglib.h", "png.h")


def missing_native_headers() -> dict:
    """The headers of data/csrc/leme_data.cpp that the native library's
    build (native_decode.build_error) did not find, each with the
    compiler's line that says so: the run cannot install them. {} when
    the library loads; RuntimeError, quoting the build, when it failed for
    another reason."""
    from lemevit_tpu_torch.data import native_decode
    err = native_decode.build_error()
    if err is None:
        return {}
    missing = {h: line.strip() for h in NATIVE_HEADERS
               for line in err.splitlines()
               if f"{h}: No such file" in line}
    if not missing:
        native_decode.require()  # raises, quoting the build
    return missing


def host_syncs(fn) -> int:
    """How many times fn() made the host wait on the card: the warnings of
    torch.cuda.set_sync_debug_mode("warn") (a copy from pageable memory,
    .item(), a sizing read, ...)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def check_device_aug(dev, packed_split: str, smi: str) -> dict:
    """data/device_aug.py on a batch of B_MAIN packed squares (PACK_PX^2 to
    224^2, REAL_AA): the card against its CPU run on the same draws, stage
    by stage on the same input (the crop and flip within AUG_CROP_TOL,
    each RandAugment layer within AUG_LAYER_TOL); the times the draws and
    the apply make the host wait on the card (host_syncs; the apply must
    not), and with ra_layer's constants made anew each call; ms per batch
    by CUDA events for the apply, cached and not (in the order cached,
    uncached, uncached, cached), and for the call (the draws included);
    the kernels one call launches (profiler)."""
    import numpy as np
    from lemevit_tpu_torch.data import device_aug
    from lemevit_tpu_torch.data.device_aug import (AugDraws, DeviceAug,
                                                   layer_consts, ra_layer)
    from lemevit_tpu_torch.data.packed import PackedDataset
    ds = PackedDataset(packed_split)
    x_cpu = torch.from_numpy(np.stack([ds[i][0] for i in range(B_MAIN)]))
    x = x_cpu.to(dev)
    aug = DeviceAug(224, auto_augment=REAL_AA)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = aug.draw(gen, B_MAIN, dev)
    host = AugDraws(*(t.cpu() for t in draws[:4]),
                    tuple(tuple(t.cpu() for t in lay)
                          for lay in draws.layers))
    crop = DeviceAug(224, auto_augment=None)
    want = crop.apply(x_cpu, host._replace(layers=()))
    errs = {"crop_flip": (crop.apply(x, draws._replace(layers=())).cpu()
                          - want).abs().max().item()}
    ra = aug.ra
    for i, (lay, lay_cpu) in enumerate(zip(draws.layers, host.layers)):
        got = ra_layer(want.to(dev), *lay, ra["magnitude"], ra["mag_std"])
        want = ra_layer(want, *lay_cpu, ra["magnitude"], ra["mag_std"])
        errs[f"layer_{i}"] = (got.cpu() - want).abs().max().item()
    out = aug.apply(x, draws)
    if out.shape != (B_MAIN, 224, 224, 3) or not torch.isfinite(out).all() \
            or not (out.min() >= 0 and out.max() <= 255):
        raise AssertionError(f"device_aug output {tuple(out.shape)}")
    if not (errs["crop_flip"] <= AUG_CROP_TOL and all(
            v <= AUG_LAYER_TOL for k, v in errs.items() if k != "crop_flip")):
        raise AssertionError(f"device_aug card against CPU: {errs}")
    def uncached():  # every layer makes its constants anew
        device_aug.layer_consts = layer_consts.__wrapped__
        try:
            return aug.apply(x, draws)
        finally:
            device_aug.layer_consts = layer_consts

    applies = {"cached": lambda: aug.apply(x, draws), "uncached": uncached}
    syncs = {"draw": host_syncs(lambda: aug.draw(gen, B_MAIN, dev)),
             **{f"apply_{k}": host_syncs(f) for k, f in applies.items()}}
    if syncs["apply_cached"]:
        raise AssertionError(f"device_aug's apply waited on the card "
                             f"{syncs['apply_cached']} times")
    timed = {k: [] for k in applies}
    for k in ("cached", "uncached", "uncached", "cached"):
        timed[k].append(cuda_ms(applies[k], iters=50))
    res = {"max_abs_err": errs, "apply_ms": sum(timed["cached"]) / 2,
           "apply_ms_runs": timed, "call_ms": cuda_ms(lambda: aug(gen, x)),
           "host_syncs": syncs,
           "launches": profile_call(lambda: aug(gen, x),
                                    "one device_aug call", top=6).get(
               "launches")}
    runs = {k: ", ".join(f"{v:.3f}" for v in t) for k, t in timed.items()}
    say("device-aug", f"{B_MAIN} x {PACK_PX}^2 -> 224^2 {REAL_AA}: "
        f"{res['apply_ms']:.3f} ms apply ({runs['cached']}; with "
        f"ra_layer's constants made anew each call, as before they were "
        f"cached: {runs['uncached']}), "
        f"{res['call_ms']:.3f} ms with the draws (CUDA events), "
        f"{res['launches']} kernels a call; host waits on the card: "
        f"{syncs['draw']} in the draws, {syncs['apply_cached']} in the "
        f"apply ({syncs['apply_uncached']} uncached); card vs "
        f"CPU on the same draws: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items())
        + f" (limits {AUG_CROP_TOL:g} / {AUG_LAYER_TOL:g}) ({smi})")
    return res


def packed_native_phase(smi: str, synthetic_train: dict, real: dict,
                        root: Path, dev) -> dict:
    """The packed and native data planes on real_data_phase's JPEGs under
    ``root``: pack the folder at PACK_PX with cli.pack's pack_folder (the
    native plane where it builds); train lemevit_tiny from the cache
    (--packed-data: RRC, flip and RandAugment on the card) and on native
    decode (--native-decode, 4 threads), TINY_STEP's launches a step, img/s
    read as real_data_phase reads it; the host's ms per batch of B_MAIN
    for the cache and for native decode on 1 and 4 threads (PIL's from
    real_data_phase's run); device_aug against its CPU run and timed;
    cli.validate of lemevit_base --packed-data on the default and the
    slice's path, each image's logits against the plain path's. Without
    jpeglib.h or png.h the native runs are skipped and said so; with them,
    a library that does not build fails the run."""
    from lemevit_tpu_torch.data import native_decode
    from lemevit_tpu_torch.data.packed import PackedDataset, pack_folder
    from lemevit_tpu_torch.data.spawn import DatasetSpec
    t0 = time.time()
    missing = missing_native_headers()
    if missing:
        say("packed-native", f"no {' / '.join(missing)} on this machine "
            f"({'; '.join(missing.values())}): packing through PIL, the "
            f"native runs skipped")
    folder, packed = root / "folder", root / "packed"
    t_pack = {}
    for split in ("train", "validation"):
        t1 = time.time()
        meta = pack_folder(str(folder / split), str(packed / split),
                           px=PACK_PX, log_every=0)
        t_pack[split] = {"s": time.time() - t1, "n": meta["n"]}
    say("pack", f"{t_pack['train']['n']} + {t_pack['validation']['n']} "
        f"images at {PACK_PX}^2 in {t_pack['train']['s']:.2f} + "
        f"{t_pack['validation']['s']:.2f} s, "
        + ("through the native plane" if native_decode.available() else
           "through PIL") + f" (1 thread) ({smi})")
    launches, trained = {}, {}
    runs = [("packed", {"data_flags": ("--packed-data", str(packed))})]
    if not missing:
        runs.append(("native_4_threads", {
            "data_dir": folder, "flags": ("--native-decode",)}))
    for name, kw in runs:
        launches[name], res = train_main_path(
            "lemevit_tiny", TINY_STEP, TINY_EVAL,
            val_batches=REAL_VAL // B_MAIN, steps=REAL_TRAIN_STEPS,
            flags=("--log-interval", str(REAL_LOG), *kw.pop("flags", ())),
            **kw)
        trained[name] = steady_rate(res)
    host = {"packed_1_thread": host_batch_ms(
        PackedDataset(str(packed / "train")), 1, 8)}
    if not missing:
        spec = DatasetSpec(
            "lemevit_tpu_torch.data.spawn:build_split_dataset",
            dict(dataset="imagefolder", data_dir=str(folder), split="train",
                 auto_augment=REAL_AA, native=True))
        native_ds = spec.build()
        host.update(native_1_thread=host_batch_ms(native_ds, 1, 4),
                    native_4_threads=host_batch_ms(native_ds, 4, 12))
    host.update({f"pil_{k[5:]}": v for k, v in real["host_batch_ms"].items()
                 if k.startswith("real_") and "thread" in k})
    aug = check_device_aug(dev, str(packed / "train"), smi)
    paths = {}
    n_fwd = 1 + -(-REAL_VAL // B_MAIN)  # the warm-up and each batch
    for name, flags, per_fwd in (
            ("default", (), {"c_block": 2, "dca_block": 8, "s_block": 22}),
            ("slice", ("--s-stage", "--cpe-in-kernel"), SLICE_FWD)):
        got_launches, got, plain, check = validate_real(
            packed, flags, data_flags=("--packed-data", str(packed)))
        expect_launches(got_launches, {k: v * n_fwd
                                       for k, v in per_fwd.items()},
                        f"validate --packed-data {name} path on "
                        f"{REAL_VAL} images ({n_fwd} forwards)")
        if got["count"] != REAL_VAL:
            raise AssertionError(f"validate --packed-data counted "
                                 f"{got['count']} of {REAL_VAL}")
        launches[f"validate_{name}"] = got_launches
        paths[name] = {"loss": got["loss"], "plain_loss": plain["loss"],
                       "top1": got["top1"], "img_per_s":
                       got["samples_per_sec"], "logits": check}
        say("packed-validate", f"lemevit_base {name} path bf16 B={B_MAIN} "
            f"--packed-data ({PACK_PX}^2 resized to 248, centre 224) on "
            f"{REAL_VAL} images: logits max abs err against the plain path "
            f"{check['err']:.4g} (last batch {check['last_batch_err']:.4g};"
            f" limit {check['limit']:.4g}), argmax equal on "
            f"{check['argmax_equal']} of {REAL_VAL}; loss {got['loss']} vs "
            f"{plain['loss']}, {got['samples_per_sec']} img/s ({smi})")
    summary = {
        "model": "lemevit_tiny", "batch": B_MAIN, "dtype": "bf16",
        "pack_px": PACK_PX, "pack": t_pack,
        "native_plane": native_decode.available(),
        "missing_headers": missing, "train": trained,
        "steps": REAL_TRAIN_STEPS, "window_steps": REAL_WINDOW,
        "pil_train": real["train"],
        "synthetic_train_img_per_s": synthetic_train["samples_per_sec"],
        "host_batch_ms": host, "device_aug": aug, "validate": paths,
        "phase_s": time.time() - t0, "card": smi}
    say("packed-native", f"cli.train lemevit_tiny over steps "
        f"{REAL_TRAIN_STEPS - REAL_WINDOW}-{REAL_TRAIN_STEPS - 1}: " + "; ".join(
            f"{k.replace('_', ' ')} {t['img_per_s']:.2f} img/s"
            for k, t in trained.items())
        + "; PIL in this run: " + ", ".join(
            f"{k.replace('_', ' ')} {t['img_per_s']:.2f}"
            for k, t in real["train"].items())
        + f"; synthetic {synthetic_train['samples_per_sec']:.2f} img/s; "
        f"host ms per batch of {B_MAIN}: " + ", ".join(
            f"{k.replace('_', ' ')} {v:.1f}" for k, v in host.items())
        + f"; device_aug {aug['apply_ms']:.3f} ms a batch; phase "
        f"{summary['phase_s']:.1f} s ({smi})")
    say("packed-native-summary", json.dumps(summary))
    summary["launches"] = launches
    return summary


# the training recipe's other half: AugMix splits with the JSD loss and
# split BatchNorm (3 splits of B_MAIN views each on the main path), every
# --opt rule, and freeze_bn
JSD_SPLITS = 3
JSD_FLAGS = ("--aug-splits", str(JSD_SPLITS), "--jsd-loss",
             "--aa", "augmix-m3-w3")
JSD_REAL_STEPS = 6
B_RECIPE_CHECK = 16  # views per split of the kernel-vs-plain JSD step
OPT_UPDATES = 3
OPT_CLIP = 1.0
OPT_TOL = 1e-5
STEM_BN = "downsample_layers.0.1"
# the BatchNorms freeze_bn keeps in eval mode (lemevit_tiny: the stem's two
# and the three downsamples'; stage 0 is a C stage and keeps resolution)
FROZEN_BN = ("downsample_layers.0.1.", "downsample_layers.0.4.",
             "downsample_layers.2.1.", "downsample_layers.3.1.",
             "downsample_layers.4.1.")


def recipe_inputs(dev, b, g):
    img = torch.randn(JSD_SPLITS, b, 224, 224, 3, generator=g).to(dev)
    labels = torch.randint(0, 1000, (b,), generator=g).to(dev)
    return img, F.one_hot(labels, 1000).float() * 0.9 + 0.1 / 1000


def check_jsd_step(dev) -> dict:
    """One bf16 JSD step (train/steps.py::jsd_train_step) of lemevit_tiny
    at 224^2 on JSD_SPLITS splits of B_RECIPE_CHECK views, drop-path 0.15
    with the same masks, every BatchNorm in split mode: the kernel path
    against --attn-backend torch. Limits: loss and gradient norm within
    PLAIN_STEPS bf16 steps of the plain path's; the kernel path launches
    one TINY_STEP (one forward over the S B views); its splits' stem
    statistics part."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.optim import build_optimizer
    from lemevit_tpu_torch.train.state import TrainState
    from lemevit_tpu_torch.train.steps import (jsd_train_step,
                                               stack_batch_stats)
    kern = create_model("lemevit_tiny", device=dev, drop_path_rate=0.15)
    stack_batch_stats(kern, JSD_SPLITS)
    plain = copy.deepcopy(kern)
    plain.set_attn_backend("torch")
    img, targets = recipe_inputs(dev, B_RECIPE_CHECK,
                                 torch.Generator().manual_seed(13))
    got = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device=dev).manual_seed(11))
        state = TrainState(m, build_optimizer(m), lambda u: 1e-3)
        before = launch_counts()
        out = jsd_train_step(state, img, targets,
                             autocast_dtype=torch.bfloat16)
        got.append({k: v.item() for k, v in out.items()})
        if m is kern:
            expect_launches(launched_since(before), TINY_STEP,
                            "one JSD step of lemevit_tiny")
    errs = {}
    for k in ("loss", "grad_norm"):
        errs[k] = abs(got[0][k] - got[1][k])
        lim = PLAIN_STEPS * BF16_STEP * abs(got[1][k])
        if not (math.isfinite(got[0][k]) and errs[k] <= lim):
            raise AssertionError(f"JSD step {k}: kernel path {got[0][k]} vs "
                                 f"plain {got[1][k]} (limit {lim:.3g})")
    stem = kern.downsample_layers[0][1].running_mean
    if torch.equal(stem[0], stem[1]) or torch.equal(stem[1], stem[2]):
        raise AssertionError("JSD step: the splits' stem statistics agree")
    say("recipe-jsd-step", f"lemevit_tiny 224 bf16 {JSD_SPLITS}x"
        f"{B_RECIPE_CHECK} views: loss {got[0]['loss']:.6f} vs plain "
        f"{got[1]['loss']:.6f}, grad norm {got[0]['grad_norm']:.6f} vs "
        f"{got[1]['grad_norm']:.6f} (limits {PLAIN_STEPS} bf16 steps of "
        f"the plain values); launches {TINY_STEP}")
    return {"kernel": got[0], "plain": got[1], "abs_err": errs}


def check_optimizers(dev) -> dict:
    """Every --opt rule on lemevit_tiny's full parameter set: OPT_UPDATES
    updates from the same weights and gradients (through apply_gradients:
    a warmup LR, weight decay 0.05, a clip at OPT_CLIP, the plateau scale
    0.5 from the second update on) on the card and on a CPU copy, by the
    same port code; the largest difference as a share of its tensor's
    largest value must stay under OPT_TOL (fp32). RMSpropTF and Adagrad
    must also leave torch.optim.RMSprop's and Adagrad's results on the
    same inputs (by more than a tenth of their largest update)."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train import optim
    from lemevit_tpu_torch.train.state import TrainState
    from lemevit_tpu_torch.train.steps import apply_gradients
    base = create_model("lemevit_tiny", device="cpu")
    g = torch.Generator().manual_seed(17)
    grads = [[torch.randn(p.shape, generator=g) * 1e-2
              for p in base.parameters()] for _ in range(OPT_UPDATES)]
    p0 = [p.detach().clone() for p in base.parameters()]
    # warmup over the first two updates from 1e-6, then cosine
    sched = optim.build_lr_schedule(steps_per_epoch=2, epochs=10,
                                    warmup_epochs=1)

    def run(device, make):
        model = copy.deepcopy(base).to(device)
        state = TrainState(model, make(model), sched, clip_grad=OPT_CLIP)
        params = list(model.parameters())
        for i, gs in enumerate(grads):
            if i == 1:
                optim.set_plateau_scale(state.optimizer, 0.5)
            apply_gradients(state, params,
                            [t.to(device, copy=True) for t in gs])
        return [p.detach().cpu() for p in params]

    def share(a, b, ref):
        """max over tensors of max|a - b| / max|ref|."""
        return max(((x - y).abs().max() / r.abs().max().clamp_min(1e-30))
                   .item() for x, y, r in zip(a, b, ref))

    rows = {}
    for name in optim.OPTIMIZERS:
        def make(m, name=name):
            return optim.build_optimizer(m, opt=name)
        card, cpu = run(dev, make), run("cpu", make)
        steps = [c - p for c, p in zip(cpu, p0)]
        rows[name] = {"max_rel_diff": share(card, cpu, cpu),
                      "max_diff_per_update": share(card, cpu, steps)}
        if not rows[name]["max_rel_diff"] <= OPT_TOL:
            raise AssertionError(f"--opt {name}: card vs CPU {rows[name]}")
        torch_cls = {"rmsprop": lambda m: torch.optim.RMSprop(
            optim.param_groups(m.named_parameters(), 0.05), lr=0.0,
            alpha=0.9, eps=1e-8, momentum=0.9),
            "adagrad": lambda m: torch.optim.Adagrad(
                optim.param_groups(m.named_parameters(), 0.05), lr=0.0,
                eps=1e-8)}.get(name)
        if torch_cls is not None:
            other = run(dev, torch_cls)
            rows[name]["torch_class_diff_per_update"] = share(
                other, card, [c - p for c, p in zip(card, p0)])
            if not rows[name]["torch_class_diff_per_update"] > 0.1:
                raise AssertionError(f"--opt {name} matches the torch class")
    say("recipe-optim", f"lemevit_tiny, {OPT_UPDATES} updates (warmup LR, "
        f"wd 0.05, clip {OPT_CLIP}, plateau 0.5 from update 2), card vs CPU,"
        f" max |diff| / max|param| (limit {OPT_TOL}): " + ", ".join(
            f"{k} {v['max_rel_diff']:.2e}" for k, v in rows.items())
        + "; torch.optim's RMSprop / Adagrad differ by " + ", ".join(
            f"{v['torch_class_diff_per_update']:.3g}" for v in rows.values()
            if "torch_class_diff_per_update" in v)
        + " of the port's largest update")
    return rows


def check_freeze_bn(dev) -> dict:
    """One bf16 train step of lemevit_tiny with freeze_bn=True at 224^2,
    B_RECIPE_CHECK images, through the training kernels (TINY_STEP's
    launches): the stem's and the downsamples' BatchNorm buffers bit for
    bit as they were, the head's moved; the loss within PLAIN_STEPS bf16
    steps of --attn-backend torch's."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.train.optim import build_optimizer
    from lemevit_tpu_torch.train.state import TrainState
    from lemevit_tpu_torch.train.steps import train_step
    kern = create_model("lemevit_tiny", device=dev, drop_path_rate=0.15,
                        freeze_bn=True)
    plain = copy.deepcopy(kern)
    plain.set_attn_backend("torch")
    img, targets = recipe_inputs(dev, B_RECIPE_CHECK,
                                 torch.Generator().manual_seed(19))
    img = img[0]
    before = {n: b.clone() for n, b in kern.named_buffers()}
    losses = []
    for m in (kern, plain):
        m.set_generator(torch.Generator(device=dev).manual_seed(11))
        state = TrainState(m, build_optimizer(m), lambda u: 1e-3)
        counts = launch_counts()
        losses.append(train_step(state, img, targets,
                                 autocast_dtype=torch.bfloat16)["loss"]
                      .item())
        if m is kern:
            expect_launches(launched_since(counts), TINY_STEP,
                            "one freeze_bn step of lemevit_tiny")
    for n, b in kern.named_buffers():
        frozen = n.startswith(FROZEN_BN)
        if frozen != torch.equal(b, before[n]):
            what = "moved" if frozen else "stayed"
            raise AssertionError(f"freeze_bn: {n} {what}")
    lim = PLAIN_STEPS * BF16_STEP * abs(losses[1])
    if not abs(losses[0] - losses[1]) <= lim:
        raise AssertionError(f"freeze_bn loss {losses[0]} vs plain "
                             f"{losses[1]} (limit {lim:.3g})")
    say("recipe-freeze-bn", f"lemevit_tiny 224 bf16 B={B_RECIPE_CHECK}: "
        f"the {len(FROZEN_BN)} stem and downsample BatchNorms' buffers bit "
        f"for bit, the head's moved; loss {losses[0]:.6f} vs plain "
        f"{losses[1]:.6f} (limit {lim:.3g}); launches {TINY_STEP}")
    return {"loss": losses[0], "plain_loss": losses[1]}


def train_recipe_phase(smi: str, synthetic_train: dict, folder: Path,
                       dev) -> dict:
    """The rest of the training recipe on the card: cli.train of
    lemevit_tiny with --aug-splits 3 --jsd-loss --aa augmix-m3-w3 on
    synthetic data (TRAIN_STEPS steps and the clean-split eval; TINY_STEP
    and TINY_EVAL launches; the checkpoint's three sets of stem statistics
    must differ) and on the JPEG folder ``folder`` with 4 worker processes
    (AugMix on the host), the host ms of a batch of B_MAIN three-view
    samples, one JSD step and one freeze_bn step against the plain path,
    and every --opt rule card against CPU."""
    from lemevit_tpu_torch.data.spawn import DatasetSpec
    t0 = time.time()
    _, syn = train_main_path("lemevit_tiny", TINY_STEP, TINY_EVAL,
                             flags=JSD_FLAGS, keep_state=True)
    stem = syn.pop("state_dict")[f"{STEM_BN}.running_mean"]
    if stem.shape[0] != JSD_SPLITS or any(
            torch.equal(stem[i], stem[j]) for i in range(JSD_SPLITS)
            for j in range(i)):
        raise AssertionError(f"aug-splits stem statistics: {stem}")
    say("recipe-splits", f"stem BN running mean per split (mean over "
        f"{stem.shape[1]} channels; first 3): " + "; ".join(
            f"split {i} {stem[i].mean().item():.6g} "
            f"{[round(v, 6) for v in stem[i, :3].tolist()]}"
            for i in range(JSD_SPLITS)))
    _, real = train_main_path(
        "lemevit_tiny", TINY_STEP, TINY_EVAL, data_dir=folder,
        val_batches=0, steps=JSD_REAL_STEPS,
        flags=(*JSD_FLAGS, "--worker-procs", "4", "--eval-interval", "2"))
    spec = DatasetSpec("lemevit_tpu_torch.data.spawn:build_split_dataset",
                       dict(dataset="imagefolder", data_dir=str(folder),
                            split="train", auto_augment="augmix-m3-w3",
                            aug_splits=JSD_SPLITS))
    host = {"real_1_thread": host_batch_ms(spec.build(), 1, 2),
            "real_4_procs": host_batch_ms(spec.build(), n=8, procs=4,
                                          spec=spec)}
    step = check_jsd_step(dev)
    opts = check_optimizers(dev)
    frozen = check_freeze_bn(dev)
    summary = {
        "model": "lemevit_tiny", "splits": JSD_SPLITS, "batch": B_MAIN,
        "dtype": "bf16",
        "synthetic": {k: syn[k] for k in ("samples_per_sec", "views_per_sec",
                                          "step_ms", "peak_gib",
                                          "best_top1")},
        "jpeg_4_procs": {k: real[k] for k in ("samples_per_sec",
                                              "views_per_sec", "step_ms",
                                              "peak_gib")},
        "single_view_synthetic_img_per_s": synthetic_train["samples_per_sec"],
        "host_batch_ms_3_views": host, "jsd_step": step,
        "optimizers": opts, "freeze_bn": frozen,
        "phase_s": time.time() - t0, "card": smi}
    say("train-recipe", f"AugMix/JSD lemevit_tiny {JSD_SPLITS} x {B_MAIN}: "
        f"synthetic {syn['samples_per_sec']:.2f} img/s "
        f"({syn['views_per_sec']:.2f} views/s, {syn['step_ms']:.1f} "
        f"ms/step, peak {syn['peak_gib']:.2f} GiB; single-view "
        f"{synthetic_train['samples_per_sec']:.2f} img/s in this run); "
        f"JPEGs on 4 processes {real['samples_per_sec']:.2f} img/s; host ms "
        f"per batch of {B_MAIN} three-view samples {host['real_1_thread']:.1f}"
        f" (1 thread), {host['real_4_procs']:.1f} (4 processes); phase "
        f"{summary['phase_s']:.1f} s ({smi})")
    say("train-recipe-summary", json.dumps(summary))
    return summary


def attn_work(name, b, n, ch, elt=2, m=M):
    """(bytes, operations) of one attention-only call: each input read
    once, each output written once, multiply-adds counted as two. dca_attn:
    q1, k1, v1, x_out (B, N, C) and q2, k2, v2, c_out (B, m, C); two
    products of B N m C per direction. mhsa: q, k, v, out (B, N, C); two
    products of B N^2 C."""
    if name == "dca_attn":
        return 4 * b * (n + m) * ch * elt, 8 * b * n * m * ch
    return 4 * b * n * ch * elt, 4 * b * n * n * ch


def sdpa_ms(groups) -> tuple:
    """Times of F.scaled_dot_product_attention over each (q, k, v, scale)
    of ``groups``, in (B, H, L, d) layout (copied into it beforehand): the
    library's time for the same attention, for the table only, as (CUDA
    events ms, the profiler's device ms)."""
    lib = [(*[t.unflatten(-1, (t.shape[-1] // 32, 32)).transpose(1, 2)
              .contiguous() for t in qkv], scale) for *qkv, scale in groups]

    def run():
        for q, k, v, scale in lib:
            F.scaled_dot_product_attention(q, k, v, scale=scale)
    return cuda_ms(run), device_ms(run)


def check_dca_attn(n, ch, blocks, dev, g, m=M, b_check=SEG_B_CHECK,
                   b_main=SEG_B):
    """dca_attn with m meta tokens at one of UperNet's stage 1-2 shapes (or
    of DCA_OFF_PATH, or BIT's CD_DCA) against dca_plain, on column views of
    projection outputs as the D module passes them: fp32 at b_check (1e-4),
    bf16 at b_main (3e-2 and PLAIN_STEPS against fp32 on the same bf16-cast
    inputs, TILES_TOL and TILES_STEPS against dca_tiles_plain on the same
    bf16 inputs), two bf16 runs bit for bit equal; D2's dca(q, q, v1, k, k,
    v2) on qv / kv views in fp32, its outputs and, through the Function
    (kernel forward, plain backward), the gradients of both projections
    against plain autograd (1e-4 of each one's largest element); then
    times at b_main in bf16 (CUDA events and the profiler's device time)
    beside the plain version and SDPA's two calls."""
    from lemevit_tpu_torch.attn import dca as dm
    from lemevit_tpu_torch.attn.reference import dca_scales
    sx, sc = dca_scales(n, m, ch)
    kw = dict(scale_x=sx, scale_c=sc, num_heads=ch // 32)

    def views(b, dtype, parts=3):
        lin1 = torch.randn(b, n, parts * ch, generator=g).to(dev, dtype)
        lin2 = torch.randn(b, m, parts * ch, generator=g).to(dev, dtype)
        return lin1, lin2

    l1, l2 = views(b_check, torch.float32)
    a32 = (*l1.split(ch, -1), *l2.split(ch, -1))
    err32 = max_err(dm.dca_kernel(*a32, **kw), dm.dca_plain(*a32, **kw),
                    1e-4)
    l1, l2 = views(b_main, torch.bfloat16)
    a16 = (*l1.split(ch, -1), *l2.split(ch, -1))
    got = dm.dca_kernel(*a16, **kw)
    err16 = max_err(got, dm.dca_plain(*[t.float() for t in a16], **kw),
                    3e-2, PLAIN_STEPS)
    err_tiles = max_err(got, dm.dca_tiles_plain(*a16, **kw), TILES_TOL,
                        TILES_STEPS)
    if not all(torch.equal(a, b) for a, b in
               zip(got, dm.dca_kernel(*a16, **kw))):
        raise AssertionError(f"dca_attn N={n}: two runs differ")

    # D2: q and k passed twice, one backward through the Function
    lin1, lin2 = (t.requires_grad_() for t in views(b_check,
                                                    torch.float32, 2))
    wx = torch.randn(b_check, n, ch, generator=g).to(dev)
    wc = torch.randn(b_check, m, ch, generator=g).to(dev)

    def run(fn):
        lin1.grad = lin2.grad = None
        q, v1 = lin1.split(ch, -1)
        k, v2 = lin2.split(ch, -1)
        xo, co = fn(q, q, v1, k, k, v2, **kw)
        ((xo * wx).sum() + (co * wc).sum()).backward()
        return [xo.detach(), co.detach()], [lin1.grad, lin2.grad]
    def function(*args, scale_x, scale_c, num_heads):
        # the Function itself where the JAX package declines N (ragged)
        return dm._Dca.apply(*args, scale_x, scale_c, num_heads)
    before = launch_counts()
    got_o, got_g = run(dm.dca if dm.pick_tile(n) else function)
    if launched_since(before) != {"dca_attn": 1}:
        raise AssertionError(f"dca D2 launches {launched_since(before)}")
    want_o, want_g = run(dm.dca_plain)
    err_d2 = max(max_err(got_o, want_o, 1e-4),
                 max_grad_err(got_g, want_g, 1e-4, ["dqv", "dkv"]))
    del lin1, lin2, got_g, want_g

    ms = cuda_ms(lambda: dm.dca_kernel(*a16, **kw))
    dev_ms = device_ms(lambda: dm.dca_kernel(*a16, **kw))
    # one call's two launches (the tiles, the merge) by name
    profile_call(lambda: dm.dca_kernel(*a16, **kw), f"dca_attn N={n}",
                 top=2)
    plain_ms = cuda_ms(lambda: dm.dca_plain(*a16, **kw))
    lib_ms, lib_dev = sdpa_ms([(a16[0], a16[4], a16[5], sx),
                      (a16[3], a16[1], a16[2], sc)])
    t_bound, by = bound(*attn_work("dca_attn", b_main, n, ch, m=m))
    row = dict(name="dca_attn", n=n, c=ch, m=m, batch=b_main,
               per_step=blocks, tile=dm.TILE[torch.bfloat16],
               err_fp32=err32, err_bf16=err16, err_tiles_bf16=err_tiles,
               err_d2_fp32=err_d2, ms=ms, kernel_ms=dev_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_kernel_ms=lib_dev,
               bound_ms=t_bound, bound_by=by)
    say("attn-kernel", f"dca_attn N={n} C={ch} M={m}: fp32 err {err32:.2e} "
        f"(B={b_check}), bf16 err {err16:.2e} (B={b_main}), against "
        f"dca_tiles_plain {err_tiles:.2e}, two runs equal; D2 aliasing "
        f"out / grads err {err_d2:.2e}; {ms:.4f} ms (device "
        f"{fmt_ms(dev_ms)}) vs plain {plain_ms:.4f} ms, SDPA x2 "
        f"{lib_ms:.4f} ms (device "
        f"{fmt_ms(lib_dev)}); bound "
        f"{t_bound:.4f} ms ({by})")
    return row


def check_mhsa(n, ch, b_check, b_main, dev, g):
    """mhsa at one shape against mhsa_plain, on column views of a qkv
    projection: fp32 at b_check (1e-4), bf16 at b_main (3e-2 and
    PLAIN_STEPS against fp32 on the same bf16-cast inputs, TILES_TOL and
    TILES_STEPS against mhsa_tiles_plain on the same bf16 inputs); then times at b_main in bf16 (CUDA events and
    the profiler's device time) beside the plain version and one SDPA
    call."""
    from lemevit_tpu_torch.attn import mhsa as mm
    kw = dict(scale=32 ** -0.5, num_heads=ch // 32)
    errs = []
    for b, dtype, tol, steps in ((b_check, torch.float32, 1e-4, None),
                                 (b_main, torch.bfloat16, 3e-2, PLAIN_STEPS)):
        qkv = torch.randn(b, n, 3 * ch, generator=g).to(dev, dtype)
        args = qkv.split(ch, -1)
        got = mm.mhsa_kernel(*args, **kw)
        errs.append(max_err([got], [mm.mhsa_plain(
            *[t.float() for t in args], **kw)], tol, steps))
    err_tiles = max_err([got], [mm.mhsa_tiles_plain(*args, **kw)],
                        TILES_TOL, TILES_STEPS)
    ms = cuda_ms(lambda: mm.mhsa_kernel(*args, **kw))
    dev_ms = device_ms(lambda: mm.mhsa_kernel(*args, **kw))
    plain_ms = cuda_ms(lambda: mm.mhsa_plain(*args, **kw))
    lib_ms, lib_dev = sdpa_ms([(*args, kw["scale"])])
    t_bound, by = bound(*attn_work("mhsa", b_main, n, ch))
    say("attn-kernel", f"mhsa N={n} C={ch}: fp32 err {errs[0]:.2e} "
        f"(B={b_check}), bf16 err {errs[1]:.2e} (B={b_main}), against "
        f"mhsa_tiles_plain {err_tiles:.2e}; {ms:.4f} ms (device "
        f"{fmt_ms(dev_ms)}) vs plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
        f"(device {fmt_ms(lib_dev)}); bound {t_bound:.4f} ms ({by})")
    return dict(name="mhsa", n=n, c=ch, batch=b_main, err_fp32=errs[0],
                err_bf16=errs[1], err_tiles_bf16=err_tiles, ms=ms,
                kernel_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_kernel_ms=lib_dev, bound_ms=t_bound, bound_by=by)


def device_ms(fn) -> float | None:
    """The profiler's device ms per call of fn() over 20 calls
    (utils/profiling.py::kernel_ms), asked twice where the first trace
    records no device time; None if neither does."""
    ms = kernel_ms(fn, iters=20, warm=3)
    return ms if ms is not None else kernel_ms(fn, iters=20, warm=3)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def ptxas_report(log: str, nvcc: str) -> str:
    """What ptxas printed for each kernel of one source (``-Xptxas -v``:
    registers, shared memory, stack frame, spills), one kernel per line,
    names demangled by ``cu++filt`` where it exists beside ``nvcc``."""
    rows, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("Used" in line or "spill" in line):
            rows.append((name, line.split("info    :")[-1].strip()))
    names = sorted({n for n, _ in rows})
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if names and os.path.isfile(filt):
        plain = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True).stdout.split(
                                   "\n")
        if len(plain) >= len(names):
            rename = dict(zip(names, plain))
            rows = [(rename[n], what) for n, what in rows]
    return "\n".join(f"{n}: {what}" for n, what in rows)


PTXAS_SOURCES = ("mhsa.cu", "dca_attn.cu", "s_block.cu", "dca_block.cu",
                 "c_block.cu", "s_stage.cu", "s_train.cu", "dca_train.cu",
                 "c_train.cu")
# the probe sources, and their kernels (by a part of their name) with the
# count of instances each must show, none with a spill or a stack frame
PROBE_PTXAS = {"ew_probe.cu": {"k_ew_probe": 229},
               "constructs.cu": {"k_scatter_add_probe": 2,
                                 "k_roll_rows_probe": 1, "k_fold_probe": 1,
                                 "k_erf_probe": 2}}


def kernels_ptxas() -> dict:
    """What ptxas reported (registers, shared memory, spills) for the
    tensor-core kernels' sources and the probes' (PROBE_PTXAS) while the
    two libraries were built (``_build.ptxas_log``: the build's own
    ``-Xptxas -v``, so nothing compiles twice). s_block.cu's and
    dca_block.cu's report keeps the kernels they launch: block_tc.cuh's and
    attn_tc.cuh's."""
    from lemevit_tpu_torch import probes
    from lemevit_tpu_torch.attn import _build
    nvcc = _build.find_nvcc()
    logs = {**_build.ptxas_log(), **_build.ptxas_log(probes.CSRC,
                                                     probes.STEM)}
    out = {src: ptxas_report(logs[src], nvcc)
           for src in (*PTXAS_SOURCES, *PROBE_PTXAS)}
    for src in ("s_block.cu", "dca_block.cu", "c_block.cu", "s_train.cu",
                "dca_train.cu", "c_train.cu"):
        out[src] = "\n".join(
            line for line in out[src].splitlines()
            if any(k in line for k in ("_tc", "_wg", "k_dca_merge")))
    return out


def check_probe_ptxas(ptxas: dict) -> dict:
    """Raise unless each kernel of PROBE_PTXAS shows its count of instances,
    each with 0 bytes of stack frame, spill stores and spill loads; per
    source and kernel, the instances and their largest register count."""
    summary = {}
    for src, kernels in PROBE_PTXAS.items():
        summary[src] = {}
        for kernel, count in kernels.items():
            lines = [ln for ln in ptxas[src].splitlines() if kernel in ln]
            frames = [ln for ln in lines if "stack frame" in ln]
            regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                    if "Used " in ln]
            bad = [ln for ln in frames
                   if any(int(n) for n in re.findall(r"(\d+) bytes", ln))]
            if bad or len(frames) != count or len(regs) != count:
                raise AssertionError(
                    f"ptxas {src}: {kernel} spills or has a stack frame, or "
                    f"shows {len(regs)} instances, not {count}: "
                    f"{(bad or lines)[:4]}")
            summary[src][kernel] = {"instances": count,
                                    "max_registers": max(regs),
                                    "spill_or_stack": 0}
    return summary


def profile_kernels(fn, what: str, want: dict) -> tuple:
    """(profile_call's table of fn(), the launches of each kernel of
    ``want`` in it), the table showing every kernel of ``want`` exactly as
    often. The profiler can leave the first kernels of a window out of its
    table (PERF.md section 7), so a table short of ``want`` is taken again,
    up to three times in all; a count above ``want`` raises at once, as
    does a table still short after the third."""
    for _ in range(3):
        prof = profile_call(fn, what)
        if not prof:
            raise AssertionError("the profiler recorded no device time")
        got = {k: kernel_count(prof, k) for k in want}
        if any(got[k] > want[k] for k in want):
            raise AssertionError(f"{what}: kernels {got}, expected {want}")
        if got == want:
            return prof, got
        say("profile", f"{what}: the table holds {got}, short of {want} "
            "(kernels dropped by the profiler); profiled again")
    raise AssertionError(f"{what}: kernels {got} in three tables, expected "
                         f"{want}")


def kernel_count(prof: dict, name: str) -> int:
    """Launches of the CUDA kernel ``name`` (a template's instances
    summed) in a profile_call table."""
    return sum(v for k, v in prof["by_name"].items()
               if f"{name}<" in k or k.endswith(name))


# the attention kernels of rows 9, 10 and 12-15 by name, the SDPA call
# timed beside them (forward, or backward of the same q, k, v and dO; both
# directions for rows 12 and 13, the meta direction for rows 14 and 15) and
# what the line calls them
ATTN_PART = {"s_train_fwd": ("k_mhsa_tc", "sdpa_fwd", "the attention tiles"),
             "s_attn_bwd": ("k_attn_bwd_", "sdpa_bwd", "the attention tiles"),
             "dca_train_fwd": ("k_dca_", "sdpa_fwd",
                               "the attention of both directions"),
             "dca_attn_bwd": ("k_dca_bwd_", "sdpa_bwd",
                              "the attention backward of both directions"),
             "c_train_fwd": ("k_dca_", "sdpa_fwd",
                             "the attention of the meta direction"),
             "c_attn_bwd": ("k_dca_bwd_", "sdpa_bwd",
                            "the attention backward of the meta direction")}
# the port's kernel launches of one call of each phase (and of the C
# block) on the tensor-core kernels, counted from the sources, with or
# without the CPE where the phase's count does not change with it, and the
# kernels that must not run in them: block_common.cuh's tail (the S / D
# tails past C = 512) and the separate CPE pass the forwards' k_qkv_wg
# replaced. The profiler may drop a kernel from its table (PERF.md section
# 6), so a count short of PORT_LAUNCHES is reported, not raised; a count
# past it or a retired kernel in the table raises.
PORT_LAUNCHES = {"s_train_fwd": 4, "mlp_bwd": 3, "s_attn_bwd": 8,
                 "dca_train_fwd": 4, "dca_attn_bwd": 9, "c_block": 4,
                 "c_train_fwd": 4, "c_attn_bwd": 9}
RETIRED = {"s_train_fwd": ("k_block_tail",),
           "dca_train_fwd": ("k_block_tail", "k_cpe_rows"),
           "c_train_fwd": ("k_block_tail", "k_cpe_rows"),
           "c_block": ("k_block_tail",)}


def port_kernels(prof: dict, name: str) -> int | None:
    """The port's kernel launches (lm::) in one profiled call of phase
    ``name``; raises where they exceed PORT_LAUNCHES[name] or where a
    kernel of RETIRED[name] ran, says so where the table holds fewer.
    None where the profiler recorded nothing."""
    if not prof:
        return None
    ours = {k: v for k, v in prof["by_name"].items() if "lm::" in k}
    got = sum(ours.values())
    old = [k for k in ours for r in RETIRED.get(name, ())
           if f"::{r}<" in k]
    if old or got > PORT_LAUNCHES[name]:
        raise AssertionError(f"{name}: {got} port kernel launches a call "
                             f"(expected {PORT_LAUNCHES[name]}), retired "
                             f"kernels {old}")
    if got < PORT_LAUNCHES[name]:
        say("profile", f"{name}: the table holds {got} of the call's "
            f"{PORT_LAUNCHES[name]} port kernel launches (the profiler "
            "dropped the rest)")
    return got


def expect_launches(launched: dict, want: dict, what: str) -> None:
    """Raise unless exactly the kernels of ``want`` launched, as often."""
    got = {k: v for k, v in launched.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def seg_serving(dev, g) -> dict:
    """UperNet's crop forward (eval, 512^2), kernel path against plain
    path: fp32 logits at batch 1 (1e-3 of max(1, max |ref|)) and bf16
    (autocast) at SEG_B against the plain path in fp32 (max abs error over
    max |ref| at most 5e-2, argmax agreement at least 0.99), launches per
    crop forward; crop-forward img/s at SEG_B in bf16; then slide
    inference of a 1024^2 image (9 windows) at batch 1 in bf16, its
    launches and ms per image."""
    from lemevit_tpu_torch.tasks.upernet import create_upernet, slide_inference
    model = create_upernet("lemevit_tiny", SEG_CLASSES, channels=SEG_CH,
                           device=dev, seed=0).eval()
    bf16 = lambda: torch.autocast("cuda", dtype=torch.bfloat16)  # noqa: E731
    img1 = torch.randn(1, SEG_CROP, SEG_CROP, 3, generator=g).to(dev)
    img8 = torch.randn(SEG_B, SEG_CROP, SEG_CROP, 3, generator=g).to(dev)
    with torch.inference_mode():
        reset()
        fused = model(img1)
        expect_launches(launch_counts(), SEG_CROP_FWD, "UperNet crop fwd")
        with bf16():
            got = model(img8)
        model.backbone.set_attn_backend("torch")
        plain = model(img1)
        want = model(img8)
        model.backbone.set_attn_backend("auto")
    err32 = (fused - plain).abs().max().item()
    lim = 1e-3 * max(1.0, plain.abs().max().item())
    rel16 = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if not (fused.shape == (1, SEG_CROP, SEG_CROP, SEG_CLASSES)
            and torch.isfinite(got).all() and err32 <= lim
            and rel16 <= 5e-2 and agree >= 0.99):
        raise AssertionError(f"UperNet kernel vs plain: fp32 {err32:.3g} "
                             f"(limit {lim:.3g}), bf16 {rel16:.3g} of max "
                             f"|ref|, argmax agreement {agree:.4f}")
    del fused, plain, got, want
    with torch.inference_mode(), bf16():
        for _ in range(2):
            model(img8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            model(img8)
        torch.cuda.synchronize()
        crop_s = (time.perf_counter() - t0) / 5
        crop_prof = profile_call(lambda: model(img8),
                                 f"one UperNet crop forward (bf16, B={SEG_B})",
                                 top=8)
    big = torch.randn(1, 2 * SEG_CROP, 2 * SEG_CROP, 3, generator=g).to(dev)

    def slide():
        with torch.inference_mode(), bf16():
            return slide_inference(model, big, SEG_CLASSES,
                                   crop_size=SEG_CROP, stride=384)
    slide()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    out = slide()
    torch.cuda.synchronize()
    slide_ms = (time.perf_counter() - t0) * 1e3
    slide_launches = launch_counts()
    expect_launches(slide_launches, {k: 9 * v for k, v in
                                     SEG_CROP_FWD.items()}, "slide")
    if out.shape != (1, 2 * SEG_CROP, 2 * SEG_CROP, SEG_CLASSES) \
            or not torch.isfinite(out).all():
        raise AssertionError("slide inference logits")
    res = {"fp32_err": err32, "bf16_rel_err": rel16, "argmax_agree": agree,
           "crop_img_per_s": SEG_B / crop_s, "crop_ms": crop_s * 1e3,
           "crop_device_ms": crop_prof.get("device_ms"),
           "slide_ms_per_1024_image": slide_ms}
    say("seg-serve", f"UperNet lemevit_tiny {SEG_CROP}^2 crop forward: "
        f"kernel vs plain fp32 B=1 err {err32:.2e} (limit {lim:.2e}); "
        f"bf16 B={SEG_B} err {rel16:.2e} of max |ref|, argmax agreement "
        f"{agree:.4f}; launches per crop "
        + ", ".join(f"{k} {v}" for k, v in SEG_CROP_FWD.items())
        + f"; bf16 B={SEG_B} {res['crop_img_per_s']:.2f} img/s "
        f"({res['crop_ms']:.2f} ms); slide inference 1024^2 (9 windows) "
        f"{slide_ms:.2f} ms per image")
    return res


def seg_main_path(flags=()) -> tuple:
    """cli.train_seg on synthetic data with its defaults (lemevit_tiny,
    512^2, batch 8, bf16) and the extra CLI ``flags``, 6 steps and one
    slide-inference eval of the 8 validation images, its launch counts set
    to 0 just before and read just after. Returns (launches, result)."""
    from lemevit_tpu_torch.cli import train_seg
    steps = TRAIN_STEPS
    with tempfile.TemporaryDirectory() as out:
        reset()
        res = train_seg.main(["--synthetic", "--iters", str(steps),
                              "--eval-interval", str(steps), "--output",
                              out, *flags])
        launches = launch_counts()
        ckpts = list((Path(out) / "checkpoints").glob("checkpoint-*.pth"))
    windows = SEG_B  # 8 validation images of one 512^2 window each
    want = {k: v * steps for k, v in SEG_STEP.items()}
    for k, v in SEG_CROP_FWD.items():
        want[k] = want.get(k, 0) + v * windows
    expect_launches(launches, want, f"train_seg ({steps} steps, {windows} "
                    "eval windows)")
    m = res["final_metrics"]
    if not (res["steps"] == steps and len(ckpts) == 1
            and abs(res["loss"]) < 1e3 and set(m) == {"mIoU", "OA", "mF1"}
            and all(0 <= v <= 100 for v in m.values())):
        raise AssertionError(f"train_seg: {res}, checkpoints {ckpts}")
    say("train-seg", f"UperNet lemevit_tiny {' '.join(flags)} {SEG_CROP}^2 "
        f"bf16 B={SEG_B}: "
        f"{steps} steps, loss {res['loss']:.4f}, "
        f"{res['samples_per_sec']:.2f} img/s, {res['step_ms']:.2f} ms/step "
        f"(steps 2-{steps}), peak {res['peak_gib']:.2f} GiB allocated; eval "
        + json.dumps({k: round(v, 3) for k, v in m.items()})
        + "; launches per step " + ", ".join(
            f"{k} {v}" for k, v in SEG_STEP.items()))
    return launches, res


def profile_seg_step(dev) -> dict:
    """torch.profiler table of one bf16 SEG_B UperNet train step."""
    from lemevit_tpu_torch.cli.train_seg import seg_train_step
    from lemevit_tpu_torch.tasks.upernet import create_upernet
    model = create_upernet("lemevit_tiny", SEG_CLASSES, channels=SEG_CH,
                           device=dev, seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, weight_decay=0.05)
    g = torch.Generator().manual_seed(6)
    img = torch.randint(0, 256, (SEG_B, SEG_CROP, SEG_CROP, 3), generator=g,
                        dtype=torch.uint8).to(dev)
    mask = torch.randint(0, SEG_CLASSES, (SEG_B, SEG_CROP, SEG_CROP),
                         generator=g).to(dev)
    return profile_call(lambda: seg_train_step(
        model, opt, 1e-4, img, mask, autocast_dtype=torch.bfloat16),
        "one UperNet train step")


def serve_slice(dev, g, default_res, prof_default) -> tuple:
    """Base at 224^2 on the slice's path (s_stage, cpe_in_kernel): fp32
    logits at B=2 against the plain path (1e-3) with SLICE_FWD's launches;
    the main path, a bf16 batch of B_MAIN through cli.benchmark's inference
    function, its launch counts set to 0 just before and read just after;
    a profile of one forward, which must show one k_s_stage launch per S
    stage and 32 fewer convolutions (the blocks' CPEs) than the default
    path's profile; cli.validate --s-stage --cpe-in-kernel. Returns (main
    path launches, result)."""
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.cli import benchmark, validate
    kw = dict(s_stage=True, cpe_in_kernel=True)
    model = create_model("lemevit_base", device=dev, **kw).eval()
    img = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    with torch.no_grad():
        reset()
        fused = model(img)
        expect_launches(launch_counts(), SLICE_FWD, "base slice forward")
        model.set_attn_backend("torch")
        plain = model(img)
    err = (fused - plain).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"base slice logits vs plain path {err:.3g}")
    del model

    args = benchmark.build_parser().parse_args(
        ["--model", "lemevit_base", "--batch-size", str(B_MAIN),
         "--num-warm-iter", "2", "--num-bench-iter", "10", "--s-stage",
         "--cpe-in-kernel"])
    model = create_model("lemevit_base", device=dev, dtype=torch.bfloat16,
                         **kw).eval()
    x = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    reset()
    res, logits = benchmark.run_inference(args, model, x)
    launches = launch_counts()
    n_fwd = args.num_warm_iter + args.num_bench_iter
    expect_launches(launches, {k: v * n_fwd for k, v in SLICE_FWD.items()},
                    f"lemevit_base slice path, {n_fwd} forwards")
    if logits.shape != (B_MAIN, 1000) or not torch.isfinite(logits).all():
        raise AssertionError("slice-path logits are not finite (64, 1000)")
    say("serve-slice", f"lemevit_base 224 bf16 B={B_MAIN} with s_stage and "
        f"the CPE in the kernels: {res['samples_per_sec']} img/s, "
        f"{res['step_time']} ms/step (default path in this run: "
        f"{default_res['samples_per_sec']} img/s, "
        f"{default_res['step_time']} ms); fp32 B=2 logits vs plain path "
        f"{err:.2e} (limit 1e-3); launches per forward " + ", ".join(
            f"{k} {launches[k] // n_fwd}" for k in SLICE_FWD))
    with torch.inference_mode():
        prof, got = profile_kernels(lambda: model(x),
                                    "one forward on the slice path",
                                    {"k_s_stage": SLICE_FWD["s_stage"]})
    del model
    stages = got["k_s_stage"]
    convs = [p["by_name"].get("aten::conv2d", 0)
             for p in (prof_default, prof)]
    if convs[0] - convs[1] != 32:
        raise AssertionError(f"slice profile: {stages} k_s_stage launches, "
                             f"{convs[1]} convolutions against the default "
                             f"path's {convs[0]}")
    say("serve-slice", f"profile: {stages} k_s_stage launches (one per S "
        f"stage), {convs[1]} convolutions (the default path: {convs[0]}, "
        "its 32 CPEs among them)")
    vres = validate.main(["--model", "lemevit_base", "--synthetic",
                          "--batch-size", str(B_MAIN), "--max-batches", "2",
                          "--s-stage", "--cpe-in-kernel"])
    if not (vres["loss"] > 0 and vres["samples_per_sec"] > 0):
        raise AssertionError(f"validate slice: {vres}")
    say("validate", "--s-stage --cpe-in-kernel " + json.dumps(vres))
    return launches, {"img_per_s": res["samples_per_sec"],
                      "ms_per_forward": res["step_time"],
                      "default_img_per_s": default_res["samples_per_sec"],
                      "fp32_logits_err": err,
                      "device_ms_per_forward": prof["device_ms"],
                      "profiled_wall_ms": prof["wall_ms"],
                      "convolutions": convs[1]}


# (rows, C) where ew.layout's (G, V) differs from the three tiles': one
# vector in a group of 8 lanes (C = 8, (8, 1)), 8 lanes of 7 slots, the
# last in one lane (392, (8, 7)), 32 lanes of 8 full slots (2048, (32,
# 8)); 300 rows, so the last CTA of either kernel is partial
EW_LAYOUT_SHAPES = ((300, 8), (300, 392), (300, 2048))


def pil_status() -> str:
    """Whether PIL imports, and its version: the port's image decoding
    (data/datasets.py, data/transforms.py)."""
    try:
        import PIL
    except ImportError as e:
        return f"PIL does not import: {e}"
    return f"PIL {PIL.__version__} imports"


# a shift past int32: a ctypes int would keep its low 32 bits (57 rows)
ROLL_SHIFT_PAST_INT32 = 2 ** 32 + 57


def check_roll_shift(dev) -> None:
    """k_roll_rows_probe on the probe's input at ROLL_SHIFT_PAST_INT32
    rows, bit for bit torch.roll's."""
    from lemevit_tpu_torch.probes import constructs
    x = constructs.roll_input(dev)
    shift = ROLL_SHIFT_PAST_INT32
    if not torch.equal(constructs.roll_rows_probe(x, shift),
                       torch.roll(x, shift, 0)):
        raise AssertionError(f"roll_rows_probe by {shift} rows differs "
                             "from torch.roll")
    say("probe", f"roll_rows_probe {tuple(x.shape)} by {shift} rows "
        f"({shift % x.shape[0]} mod {x.shape[0]}): bit for bit torch.roll")


def check_ew_probes(dev) -> list:
    """k_ew_probe against ew_probe_plain for every op at K = 1 and at
    vpu_probe's K (within ew.max_ulps bf16 steps, ew.ATOL near zero), and
    the K = 0 copy exact, on each of vpu_probe's three (R, C) tiles x 64 and
    at EW_LAYOUT_SHAPES; the kernel's (G, V) equal to ew.layout at every C.
    On the three tiles each op is timed at K = 1 (CUDA events and the
    profiler's device time) beside its plain version, the one PyTorch call
    computing it where there is one (both ways), and its bound. One row per
    op and tile."""
    from lemevit_tpu_torch.probes import ew
    wrong = [c for c in range(8, ew.MAX_COLS + 1, 8)
             if ew.kernel_layout(c) != ew.layout(c)]
    if wrong:
        raise AssertionError(f"lm_ew_layout differs from ew.layout at C = "
                             f"{wrong[:8]}")
    rows = []
    for r, c in ew.SHAPES + EW_LAYOUT_SHAPES:
        x = ew.probe_input(r, c, dev)
        if (r, c) in EW_LAYOUT_SHAPES:
            x = x[:r]  # a few hundred rows
        if not torch.equal(ew.ew_probe(x, "fma", 0), x):
            raise AssertionError(f"ew_probe K=0 {tuple(x.shape)}: not a "
                                 "copy")
        for op in ew.OPS:
            k = ew.jax_k(op)
            got1, want1 = ew.ew_probe(x, op, 1), ew.ew_probe_plain(x, op, 1)
            m1 = ew.mismatches(got1, want1, 1)
            mk = ew.mismatches(ew.ew_probe(x, op, k),
                               ew.ew_probe_plain(x, op, k), k)
            if m1["bad"] or mk["bad"]:
                raise AssertionError(f"ew_probe {op} {tuple(x.shape)}: K=1 "
                                     f"{m1}, K={k} {mk}")
            if (r, c) in EW_LAYOUT_SHAPES:
                continue
            lib = ew.LIBRARY.get(op)
            t_bytes = ew.pass_bytes(*x.shape) / HBM_BYTES_PER_S * 1e3
            t_ops = x.numel() * ew.OP_FLOPS[op] / FP32_FLOPS * 1e3
            rows.append({
                "name": f"ew_probe.{op}", "shape": list(x.shape),
                "layout": list(ew.layout(c)) if op in ew.ROW_OPS else None,
                "max_ulp_k1": m1["max_ulp"], f"max_ulp_k{k}": mk["max_ulp"],
                "err_bf16": (got1.float() - want1.float()).abs().max().item(),
                "ms": cuda_ms(lambda: ew.ew_probe(x, op, 1), 30),
                "kernel_ms": device_ms(lambda: ew.ew_probe(x, op, 1)),
                "plain_ms": cuda_ms(lambda: ew.ew_probe_plain(x, op, 1), 30),
                "library_ms": cuda_ms(lambda: lib(x), 30) if lib else None,
                "library_kernel_ms": device_ms(lambda: lib(x)) if lib
                else None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            q = rows[-1]
            say("probe", f"ew_probe {op} {x.shape[0]}x{c} bf16: K=1 "
                f"{q['max_ulp_k1']} / K={k} {mk['max_ulp']} bf16 steps from "
                f"plain (limits {ew.max_ulps(1)} / {ew.max_ulps(k)}); K=1 "
                f"{q['ms']:.4f} ms, device {fmt_ms(q['kernel_ms'])} (plain "
                f"{q['plain_ms']:.4f}, library "
                f"{fmt_ms(q['library_ms']) if lib else 'none'}, device "
                f"{fmt_ms(q['library_kernel_ms']) if lib else 'none'}, "
                f"bound {q['bound_ms']:.4f} {q['bound_by']})")
    say("probe", f"ew_probe at {EW_LAYOUT_SHAPES} (layouts "
        f"{[ew.layout(c) for _, c in EW_LAYOUT_SHAPES]}): every op within "
        "its limits, K=0 exact; lm_ew_layout == ew.layout at every C")
    return rows


def probes_main_path() -> dict:
    """The probe path, ``python -m lemevit_tpu_torch.cli.probes --ew
    --train-paths none`` (the training paths' A/B row is built here from
    this script's own runs), in a fresh process: its kernel counts start at
    0 and its JSON reports every launch it made. Returns that JSON."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "HOPPER_PROBES.json"
        proc = subprocess.run(
            [sys.executable, "-m", "lemevit_tpu_torch.cli.probes", "--ew",
             "--train-paths", "none", "--out", str(out)], cwd=REPO,
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"cli.probes exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        table = json.loads(out.read_text())
    for name, (kernel, _) in CONSTRUCT_KERNELS.items():
        row = table[name]
        if not (row["ok"] and row["route"] == "cuda"
                and row["verdict"].startswith(("keep", "FLIP"))):
            raise AssertionError(f"cli.probes {name}: {row}")
        say("probe", f"{name}: {row['verdict']}; {row['ms']:.4f} ms, "
            f"device {fmt_ms(row['kernel_ms'])} (plain "
            f"{row['plain_ms']:.4f}, library {fmt_ms(row['library_ms'])}, "
            f"device {fmt_ms(row['library_kernel_ms'])}, bound "
            f"{row['bound_ms']:.6f}, launch floor "
            f"{fmt_ms(row.get('launch_floor_ms'))})")
        if "large" in row:  # where the bytes set the pace
            big = row["large"]
            say("probe", f"{name} at {big['shape']}: {big['ms']:.4f} ms, "
                f"device {fmt_ms(big['kernel_ms'])} (library "
                f"{fmt_ms(big['library_ms'])}, device "
                f"{fmt_ms(big['library_kernel_ms'])}, bound "
                f"{big['bound_ms']:.6f}, launch floor "
                f"{fmt_ms(big.get('launch_floor_ms'))})")
    if not all("large" in table[name] for name in LARGE_PROBES):
        raise AssertionError(f"cli.probes: no large-size row of "
                             f"{LARGE_PROBES}")
    say("probe", f"launch floor (a one-element fill, device): "
        f"{fmt_ms(table['launch_floor_ms'])} ms")
    missing = [k for k in ["erf_probe", "scatter_add_probe",
                           "roll_rows_probe", "fold_probe", "cluster_probe"]
               + [f"ew_probe.{op}" for op in table["ew"][0]["us_per_pass"]]
               if not table["launches"].get(k)]
    if missing or len(table["ew"]) != 3:
        raise AssertionError(f"cli.probes: no launch of {missing}, "
                             f"{len(table['ew'])} slope rows")
    return table


def kernel_entry(name, rows, launches, weight_key, **extra):
    """The per-kernel JSON entry: launch-weighted means over the main
    path's shapes."""
    src, replaces = KERNELS[name]
    w = sum(r[weight_key] for r in rows)

    def mean(key):
        return sum(r[key] * r[weight_key] for r in rows) / w
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["err_bf16"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": max(rows, key=lambda r: r["bound_ms"]
                        * r[weight_key])["bound_by"],
        "library_ms": (mean("library_ms") if all("library_ms" in r
                                                 for r in rows) else None),
        "shapes": strip(rows), **extra}


def strip(rows):
    """Shape rows without their kernel name, for the JSON line."""
    return [{k: v for k, v in r.items() if k != "name"} for r in rows]


# the dist phase: cli.train of lemevit_tiny in fresh processes, one rank
# over NCCL (a group that the process opens itself) against no group, and
# two ranks over gloo on the one card against one process at their global
# batch, with two planted faults that the comparison must see
DIST_STEPS = 3
DIST_TOL = 1e-4               # check_train_step's loss limit (NCCL, 1 rank)
DIST_GLOO_TOL = TRAIN_TOL[torch.bfloat16][0]  # 2 ranks against 1, bf16
# the two-rank run's final state against one process's, in units of the
# one process's own move from the initial weights (dist_drift): sound,
# the parameters read 1.6e-2 and the statistics 4.0e-4; with SyncBN
# reducing nothing 8.3e-2 and 5.0e-2, without the gradient all-reduce
# 0.46 and 1.1e-3 (NVIDIA H100 80GB HBM3, 700 W)
DIST_DRIFT_TOL = {"params": 0.05, "stats": 5e-3}
# planted into the two-rank run: BatchNorm statistics per rank (SyncBN
# reducing nothing), DDP's gradient all-reduce left out
DIST_FAULTS = ("gloo-localbn", "gloo-noreduce")
DIST_SCRIPT = r"""
import json, os, sys
import torch
import torch.distributed as dist
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
from lemevit_tpu_torch.attn import dca, fused_block, fused_train, mhsa
from lemevit_tpu_torch.cli import train
from lemevit_tpu_torch.parallel.distributed import init_distributed
mode = sys.argv[1]
if mode == "nccl":
    dist.init_process_group(
        "nccl", init_method="tcp://localhost:" + os.environ["MASTER_PORT"],
        rank=0, world_size=1)
elif mode.startswith("gloo"):
    init_distributed("cuda", backend="gloo")
if mode == "gloo-localbn":  # planted fault: no SyncBN
    from lemevit_tpu_torch.core import layers
    layers.group_active = lambda: False
elif mode == "gloo-noreduce":  # planted fault: no gradient all-reduce
    import torch.nn.parallel as tnp

    def local(state, bucket):
        fut = torch.futures.Future()
        fut.set_result(bucket.buffer())
        return fut

    class LocalDDP(tnp.DistributedDataParallel):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.register_comm_hook(None, local)
    tnp.DistributedDataParallel = LocalDDP
res = train.main(json.loads(sys.argv[2]))
out = {k: res.get(k) for k in ("train_loss", "processes", "ddp",
                               "samples_per_sec", "step_ms")}
out["backend"] = dist.get_backend() if dist.is_initialized() else None
out["launches"] = {k: v for c in (fused_block.LAUNCHES, fused_train.LAUNCHES,
                                  dca.LAUNCHES, mhsa.LAUNCHES)
                   for k, v in c.items() if v}
print("RESULT " + json.dumps(out), flush=True)
if dist.is_initialized():
    dist.destroy_process_group()
"""


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_runs(jobs: list) -> list:
    """cli.train for each (mode, argv, ranks) of ``jobs``, all started at
    once, each rank a fresh process with its own --output (``mode``
    "plain": no process group; "nccl": one rank in a group it opens;
    "gloo" and DIST_FAULTS: RANK / WORLD_SIZE set, every rank on card 0).
    Returns for each job, for each rank: {"result": its RESULT dict,
    "events": its events.jsonl rows or None, "state": its last checkpoint's
    state_dict or None}; the outputs are removed."""
    import shutil
    procs, outs = [], []
    for mode, argv, ranks in jobs:
        port = str(free_port())
        for r in range(ranks):
            out = tempfile.mkdtemp(prefix=f"dist_{mode}_{r}_")
            outs.append(out)
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                       LOCAL_RANK="0", MASTER_ADDR="localhost",
                       MASTER_PORT=port)
            if mode == "plain":
                for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
                    env.pop(k)
            procs.append((mode, r, subprocess.Popen(
                [sys.executable, "-c", DIST_SCRIPT, mode,
                 json.dumps(argv + ["--output", out])], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    try:
        logs = [p.communicate(timeout=600)[0] for _, _, p in procs]
    finally:
        for _, _, p in procs:
            p.kill()
    runs = []
    for (mode, r, p), log, out in zip(procs, logs, outs):
        found = [line for line in log.splitlines()
                 if line.startswith("RESULT ")]
        if p.returncode != 0 or not found:
            raise AssertionError(f"dist {mode} rank {r} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
        run = Path(out) / "lemevit_tiny"
        events = state = None
        if (run / "events.jsonl").exists():
            events = [json.loads(line) for line in open(run
                                                         / "events.jsonl")]
            ckpt = json.load(open(run / "checkpoints"
                                  / "checkpoints.json"))[0]["path"]
            state = torch.load(ckpt, map_location="cpu",
                               weights_only=True)["state_dict"]
        runs.append({"result": json.loads(found[-1][7:]), "events": events,
                     "state": state})
        shutil.rmtree(out)
    by_job, at = [], 0
    for _, _, ranks in jobs:
        by_job.append(runs[at:at + ranks])
        at += ranks
    return by_job


def dist_drift(got: dict, want: dict, init: dict) -> dict:
    """How far a run ended from the reference run, in units of the
    reference run's own move from the same initial weights: "params",
    |got - want| / |want - init| over all parameters at once (L2 norms; a
    conv bias before a BatchNorm has no gradient but rounding noise, which
    Adam scales up to full steps, so no single parameter is read alone),
    and "stats", the largest of that ratio over the BatchNorm
    statistics."""
    num = den = worst = 0.0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        d = (got[k].double() - w.double()).norm().item()
        move = (w.double() - init[k].double()).norm().item()
        if k.endswith(("running_mean", "running_var")):
            if move > 0:
                worst = max(worst, d / move)
        else:
            num, den = num + d * d, den + move * move
    return {"params": math.sqrt(num / den), "stats": worst}


def dist_phase(smi: str, folder: Path) -> dict:
    """Multi-process cli.train of lemevit_tiny at 224^2, bf16, on the JPEG
    folder ``folder`` (configs/lemevit.yaml: RandAugment, flips and random
    resized crops, drawn per sample), DIST_STEPS steps, no eval, from one
    initial checkpoint, with mixup, cutmix, erasing and DropPath off (the
    row order of a global batch differs between one and two processes, and
    these draw per row), each run in fresh processes, against one plain
    process (no group) at B = 64, cuDNN deterministic in all:
      - one rank over NCCL (the process opens the group; init_distributed
        is a no-op at one process), B = 64: wrapped in DDP (SyncBN inside
        the BatchNorms), its per-step losses within DIST_TOL of the plain
        process's, the same launches;
      - two ranks over gloo (NCCL refuses two ranks on one card) at B = 32
        each: both exit 0, report the same loss, rank 1 writes nothing,
        rank 0's per-step losses are within DIST_GLOO_TOL of the plain
        process's and its final state within DIST_DRIFT_TOL of the plain
        process's (dist_drift; its img/s crosses the host through gloo and
        says nothing of NCCL's);
      - the two-rank run again with each of DIST_FAULTS planted (side by
        side with the sound one): each must end beyond one of the
        DIST_DRIFT_TOL limits."""
    from lemevit_tpu_torch import create_model
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        init = create_model("lemevit_tiny", device="cpu", seed=0)
        init_path = Path(tmp) / "init.pth"
        torch.save({"state_dict": init.state_dict()}, init_path)
        init = init.state_dict()
        base = ["--dataset", "imagefolder", "--data-dir", str(folder),
                "--workers", "4", "--no-native-decode",
                "--model", "lemevit_tiny", "--img-size", "224",
                "--config", str(REPO / "configs" / "lemevit.yaml"),
                "--initial-checkpoint", str(init_path),
                "--epochs", "1", "--steps-per-epoch", str(DIST_STEPS),
                "--eval-interval", "2", "--log-interval", "1",
                "--mixup", "0", "--cutmix", "0", "--reprob", "0",
                "--drop-path", "0"]
        one = base + ["--batch-size", str(B_MAIN)]
        half = base + ["--batch-size", str(B_MAIN // 2)]
        [nccl], = dist_runs([("nccl", one, 1)])
        [plain], = dist_runs([("plain", one, 1)])
        (r0, r1), *faults = dist_runs([("gloo", half, 2)] + [
            (mode, half, 2) for mode in DIST_FAULTS])
    losses = {k: [e["loss"] for e in run["events"]]
              for k, run in (("nccl", nccl), ("plain", plain),
                             ("gloo", r0))}
    if not (nccl["result"]["ddp"] and nccl["result"]["backend"] == "nccl"
            and nccl["result"]["processes"] == 1
            and not plain["result"]["ddp"]):
        raise AssertionError(f"dist: nccl run {nccl['result']}, plain run "
                             f"{plain['result']}")
    d1 = max(abs(a - b) for a, b in zip(losses["nccl"], losses["plain"]))
    if len(losses["nccl"]) != DIST_STEPS or not d1 <= DIST_TOL:
        raise AssertionError(f"dist: NCCL losses {losses['nccl']} against "
                             f"plain {losses['plain']}")
    if nccl["result"]["launches"] != plain["result"]["launches"]:
        raise AssertionError(f"dist: launches {nccl['result']['launches']} "
                             f"against {plain['result']['launches']}")
    say("dist", f"1 rank over NCCL in DDP, lemevit_tiny 224 bf16 B={B_MAIN},"
        f" JPEG folder, {DIST_STEPS} steps: losses {losses['nccl']} against "
        f"the plain process's {losses['plain']} (max |diff| {d1:.2e}, limit "
        f"{DIST_TOL}); {nccl['result']['samples_per_sec']:.2f} img/s against "
        f"{plain['result']['samples_per_sec']:.2f}; launches "
        f"{nccl['result']['launches']} ({smi})")

    def reading(rank0, rank1) -> dict:
        gn = [e["grad_norm"] for e in rank0["events"]]
        gn_plain = [e["grad_norm"] for e in plain["events"]]
        return {"loss_diff": max(abs(e["loss"] - b) for e, b in
                                 zip(rank0["events"], losses["plain"])),
                "grad_norm_0_rel": abs(gn[0] - gn_plain[0]) / gn_plain[0],
                "drift": dist_drift(rank0["state"], plain["state"], init),
                "rank1_wrote": rank1["events"] is not None}
    sound = reading(r0, r1)
    res0, res1 = r0["result"], r1["result"]
    if not (res0["ddp"] and res0["backend"] == "gloo"
            and res0["processes"] == 2 and not sound["rank1_wrote"]
            and res0["train_loss"] == res1["train_loss"]):
        raise AssertionError(f"dist gloo: rank 0 {res0}, rank 1 {res1} "
                             f"(rank 1 wrote: {sound['rank1_wrote']})")
    planted = {mode: reading(*ranks)
               for mode, ranks in zip(DIST_FAULTS, faults)}

    def drift(r):
        return ", ".join(f"{k} {v:.3e}" for k, v in r["drift"].items())
    say("dist", f"2 ranks over gloo on one card, B={B_MAIN // 2} each: "
        f"losses {losses['gloo']} (both ranks' mean {res0['train_loss']:.6f})"
        f" against one process at B={B_MAIN} {losses['plain']} (max |diff| "
        f"{sound['loss_diff']:.2e}, limit {DIST_GLOO_TOL}); final-state "
        f"drift {drift(sound)} (limits {DIST_DRIFT_TOL}), step-0 grad norm "
        f"rel. diff {sound['grad_norm_0_rel']:.2e}; planted faults: "
        + "; ".join(f"{m}: drift {drift(r)}, loss diff "
                    f"{r['loss_diff']:.2e}, step-0 grad norm rel. diff "
                    f"{r['grad_norm_0_rel']:.2e}"
                    for m, r in planted.items())
        + f"; {res0['samples_per_sec']:.2f} img/s over gloo (through the "
        f"host, beside the fault runs; not NCCL's rate) against "
        f"{plain['result']['samples_per_sec']:.2f}; phase "
        f"{time.time() - t0:.0f} s")
    within = {m: all(r["drift"][k] <= lim
                     for k, lim in DIST_DRIFT_TOL.items())
              for m, r in [("gloo", sound), *planted.items()]}
    if len(losses["gloo"]) != DIST_STEPS or not (
            sound["loss_diff"] <= DIST_GLOO_TOL and within["gloo"]):
        raise AssertionError(f"dist gloo: losses {losses['gloo']} against "
                             f"one process {losses['plain']}, {sound}")
    unseen = [m for m in DIST_FAULTS if within[m]]
    if unseen:
        raise AssertionError(f"dist: planted faults {unseen} end within "
                             f"{DIST_DRIFT_TOL} of one process: {planted}")
    return {"nccl_launches": nccl["result"]["launches"],
            "nccl_img_per_s": nccl["result"]["samples_per_sec"],
            "plain_img_per_s": plain["result"]["samples_per_sec"],
            "nccl_loss_diff": d1, "gloo": sound, "planted": planted,
            "gloo_img_per_s": res0["samples_per_sec"],
            "seconds": time.time() - t0}


# the cd phase: BIT on lemevit_small at 256^2 (configs/cd)
CD_PX, CD_TRAIN, CD_VAL, CD_B = 256, 64, 16, 16
CD_STEPS = CD_TRAIN // CD_B
CD_LOSS_TOL = 3e-2  # bf16 kernel path's loss against --attn-backend torch
# the kernels' shapes on it, each backbone call at CD_B (two a step):
# stage 1's D blocks compose (N 4096 > 3136), each attention one dca_attn
# call, (N, C, launches per step); stage 2's D and stage 3's S blocks
# take the block kernels, (kernel, N, C, launches per eval forward of a
# pair) and (kind, N, C, blocks run per train step); stage 4 is not run
# (BIT reads stage 3's map); the fp32 checks' batch
CD_DCA_SHAPES = [(4096, 96, 4)]
CD_BLOCK_SHAPES = [("dca_block", 1024, 192, 4), ("s_block", 256, 320, 12)]
CD_TRAIN_SHAPES = [("dca", 1024, 192, 4), ("s", 256, 320, 12)]
CD_B_CHECK = 4
# launches per train step and per eval forward of a pair
CD_STEP = {"dca_attn": 4, "dca_train_fwd": 4, "dca_attn_bwd": 4,
           "s_train_fwd": 12, "s_attn_bwd": 12, "mlp_bwd": 16}
CD_EVAL = {"dca_attn": 4, "dca_block": 4, "s_block": 12}


def write_cd_pairs(root: Path, seed: int = 0) -> None:
    """{train,val}/{A,B,OUT}/<i>.png: CD_TRAIN / CD_VAL pairs of smooth
    random pictures at CD_PX^2, B with a changed rectangle, OUT 255 there."""
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    for split, n in (("train", CD_TRAIN), ("val", CD_VAL)):
        for sub in ("A", "B", "OUT"):
            (root / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            small = rs.randint(0, 256, (CD_PX // 8, CD_PX // 8, 3), np.uint8)
            a = np.asarray(Image.fromarray(small).resize(
                (CD_PX, CD_PX), Image.BILINEAR))
            b, m = a.copy(), np.zeros((CD_PX, CD_PX), np.uint8)
            y, x, h, w = (int(v) for v in rs.randint(0, CD_PX // 2, 4))
            b[y:y + h + 8, x:x + w + 8] = 255 - b[y:y + h + 8, x:x + w + 8]
            m[y:y + h + 8, x:x + w + 8] = 255
            for sub, arr in (("A", a), ("B", b), ("OUT", m)):
                Image.fromarray(arr).save(root / split / sub / f"{i:03d}.png")


def cd_phase(smi: str, dev, fb, ft, g) -> tuple:
    """Change detection through cli.train_cd. First each kernel of the
    path against its plain version at the path's shapes (CD_DCA_SHAPES,
    CD_BLOCK_SHAPES, CD_TRAIN_SHAPES: fp32 at CD_B_CHECK, bf16 at CD_B,
    forward and backward, each check's own tolerances). Then PNG pairs
    written from a seed (CD_TRAIN train / CD_VAL val at 256^2), configs/cd/
    bit_lemevit_small_cdd.yaml (BIT on lemevit_small, B = 16, dec_depth 8,
    token_len 4, bf16) for 1 epoch of CD_STEPS steps and its eval, the
    launches by kernel per train step (the run's minus its eval's, counted
    by an --eval-only run of the same split) and per eval forward (each
    CD_STEP and CD_EVAL exactly), pairs/s; as a smoke check, the loss of
    the kernel path on the first batch beside --attn-backend torch on the
    same weights (within CD_LOSS_TOL); one synthetic step of each other
    head and of BIT on resnet18; cli.visualize_cd on the best checkpoint
    (one PNG per val pair). Nothing here catches its own failure. Returns
    (the phase's numbers, the shape rows by kernel)."""
    from lemevit_tpu_torch.cli import train_cd, visualize_cd
    from lemevit_tpu_torch.core.layers import set_generator
    from lemevit_tpu_torch.data.datasets import CDPairDataset
    t0 = time.time()
    rows = [check_dca_attn(n, ch, per_step, dev, g, b_check=CD_B_CHECK,
                           b_main=CD_B) for n, ch, per_step in CD_DCA_SHAPES]
    rows += [check_block_kernel(fb, kind, n, ch, per_fwd, dev, g,
                                b_check=CD_B_CHECK, b_main=CD_B)
             for kind, n, ch, per_fwd in CD_BLOCK_SHAPES]
    for kind, n, ch, blocks in CD_TRAIN_SHAPES:
        rows += check_train_kernels(ft, kind, n, ch, blocks, dev, g,
                                    b_check=CD_B_CHECK, b_main=CD_B)
    shape_rows = {}
    for r in rows:
        shape_rows.setdefault(r["name"], []).append(r)
    cfg = str(REPO / "configs" / "cd" / "bit_lemevit_small_cdd.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_cd_pairs(root / "data")
        data = ["--data-dir", str(root / "data"), "--workers", "4"]
        reset()
        res = train_cd.main(["--config", cfg, *data, "--epochs", "1",
                             "--steps-per-epoch", str(CD_STEPS),
                             "--output", str(root / "run")])
        run_launches = launch_counts()
        best = json.load(open(root / "run" / "checkpoints"
                              / "checkpoints.json"))[0]["path"]
        reset()
        ev = train_cd.main(["--config", cfg, *data, "--eval-only", best,
                            "--output", str(root / "eval")])
        eval_launches = launch_counts()
        n_eval = -(-CD_VAL // CD_B)
        per_step = {k: (run_launches[k] - eval_launches[k]) / CD_STEPS
                    for k in run_launches
                    if run_launches[k] - eval_launches[k]}
        per_eval = {k: v / n_eval for k, v in eval_launches.items() if v}
        if per_step != CD_STEP or per_eval != CD_EVAL:
            raise AssertionError(f"cd: launches per train step {per_step} "
                                 f"(expected {CD_STEP}), per eval forward "
                                 f"{per_eval} (expected {CD_EVAL})")
        if not (res["steps"] == CD_STEPS and res["loss"] == res["loss"]
                and abs(ev["f1"] - res["best_f1"]) < 1e-9):
            raise AssertionError(f"cd: run {res}, eval-only {ev}")
        say("cd", f"BIT lemevit_small {CD_PX} bf16 B={CD_B}: {CD_STEPS} "
            f"steps, loss {res['loss']:.4f}, {res['pairs_per_sec']:.2f} "
            f"pairs/s, {res['step_ms']:.2f} ms/step (steps 2-{CD_STEPS}); "
            f"eval {json.dumps(res['final_metrics'])}; launches per train "
            f"step {json.dumps(per_step)}; per eval forward "
            f"{json.dumps(per_eval)} ({smi})")

        # the kernel path's loss against the plain path, same weights
        args = train_cd.build_parser().parse_args(
            ["--backbone", "lemevit_small", "--dec-depth", "8"])
        ds = CDPairDataset(str(root / "data"), "train")
        batch = {k: v.to(dev) for k, v in train_cd._collate(
            [ds[i] for i in range(CD_B)]).items()}
        losses = []
        for backend in ("auto", "torch"):
            args.attn_backend = backend
            model = train_cd.build_model(args, dev).train()
            before = launch_counts()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                logits = model(train_cd.normalize_pair(batch["a"]),
                               train_cd.normalize_pair(batch["b"]))
            losses.append(train_cd.cd_loss(logits, batch["mask"]).item())
            fwd = launched_since(before)
            if (backend == "torch") == bool(fwd):
                raise AssertionError(f"cd: {backend} forward launched {fwd}")
            del model
        d = abs(losses[0] - losses[1])
        if not d <= CD_LOSS_TOL:
            raise AssertionError(f"cd: kernel-path loss {losses[0]} against "
                                 f"plain {losses[1]}")
        say("cd", f"first batch, train-mode bf16 forward: loss {losses[0]:.6f}"
            f" on the kernel path against {losses[1]:.6f} with "
            f"--attn-backend torch (|diff| {d:.2e}, limit {CD_LOSS_TOL}; a "
            f"smoke check: the kernels are held at this path's shapes "
            f"above)")
        t1 = time.perf_counter()
        train_cd._collate([ds[i] for i in range(CD_B)])
        host_ms = (time.perf_counter() - t1) * 1e3
        args.attn_backend = "auto"
        model = train_cd.build_model(args, dev)
        set_generator(model, torch.Generator(device=dev))
        opt = torch.optim.AdamW(model.parameters(), lr=0.0,
                                weight_decay=0.01)
        prof = profile_call(lambda: train_cd.cd_train_step(
            model, opt, 0.0, batch, "ce", torch.bfloat16),
            f"one BIT lemevit_small train step (B={CD_B} pairs)")
        del model, opt
        if not prof:
            raise AssertionError("cd: the profiler recorded no device time")
        say("cd", f"host: {host_ms:.1f} ms to read and collate {CD_B} PNG "
            f"pairs on one thread")

        others = {}
        for name, flags in (("snunet", ["--head", "snunet"]),
                            ("snunet_conc", ["--head", "snunet_conc"]),
                            ("siamunet_diff", ["--head", "siamunet_diff"]),
                            ("bit_resnet18", ["--backbone", "resnet18"])):
            r = train_cd.main(["--synthetic", *flags, "--epochs", "1",
                               "--steps-per-epoch", "1", "--output",
                               str(root / name)])
            if not (r["steps"] == 1 and r["loss"] == r["loss"]):
                raise AssertionError(f"cd {name}: {r}")
            others[name] = r["loss"]
        say("cd", "one synthetic step each (256^2, B=16): " + ", ".join(
            f"{k} loss {v:.4f}" for k, v in others.items()))

        vis = root / "vis"
        n = visualize_cd.main(["--checkpoint", best, "--data-dir",
                               str(root / "data"), "--split", "val",
                               "--backbone", "lemevit_small", "--out",
                               str(vis)])
        pngs = sorted(p.name for p in vis.glob("*.png"))
        if n != CD_VAL or pngs != CDPairDataset(str(root / "data"),
                                                "val").names:
            raise AssertionError(f"visualize_cd wrote {pngs}")
        say("cd", f"visualize_cd: {n} masks; phase "
            f"{time.time() - t0:.0f} s")
    return {"per_step": per_step, "per_eval": per_eval,
            "pairs_per_sec": res["pairs_per_sec"], "step_ms": res["step_ms"],
            "loss_vs_plain": d, "host_batch_ms": host_ms,
            "device_ms_per_step": prof["device_ms"],
            "launches_per_step": prof["launches"],
            "device_busy_share": prof["device_ms"] / prof["wall_ms"],
            "port_kernel_share": prof["port_ms"] / prof["device_ms"],
            "seconds": time.time() - t0}, shape_rows


# the det phase: Oriented R-CNN on lemevit_small at 1024^2 (configs/det)
DET_CFG = "oriented_rcnn_lemevit_small_fpn_1x_dota10.yaml"
DET_ORIG = (1500, 1300)  # original images, (w, h): 4 windows of 1024 each
DET_IMAGES = (("train", "P9001"), ("train", "P9002"), ("val", "P9003"))
DET_TILES = {"train": 8, "val": 4}
DET_STEPS = 3
DET_B_CHECK = 2
# bf16 kernel path's first-batch loss and each of its parts against
# --attn-backend torch's, the plain path given the kernel path's
# proposals (cd_phase's limit): proposals come from top-k and NMS
# decisions over near-equal scores, which bf16 rounding flips, and the RoI
# losses of two proposal sets differ by far more than the features do
DET_LOSS_TOL = 3e-2
# the kernels' shapes on it: stages 1-2 (N = 65536 C = 96, N = 16384
# C = 192, M = 16, D blocks beyond 3136) compose with each attention one
# dca_attn call; stage 3 (N = 4096 C = 320) composes, its meta stream
# (N = 16) on mhsa; stage 4 (N = 1024 C = 384) takes the S kernels;
# (N, C, launches per forward)
DET_DCA_SHAPES = [(65536, 96, 2), (16384, 192, 2)]
DET_MHSA_SHAPE = (16, 320, 6)
DET_S_SHAPE = (1024, 384, 2)
# launches per train step (B = 8) and per eval forward (B = 1)
DET_STEP = {"dca_attn": 4, "mhsa": 6, "s_train_fwd": 2, "s_attn_bwd": 2,
            "mlp_bwd": 2}
DET_EVAL = {"dca_attn": 4, "mhsa": 6, "s_block": 2}


def write_det_data(root: Path, seed: int = 0) -> dict:
    """Original-size DOTA images (DET_ORIG) of DET_IMAGES under
    root/{split}/{images,annfiles}: a smooth random picture with filled
    rotated rectangles of the DOTA classes, ten of them inside the area
    every 1024^2 window covers, and their polygons (DOTA's two header
    lines first). Returns {stem: (picture, polygons (K, 8), class names)}."""
    import numpy as np
    from PIL import Image, ImageDraw
    from lemevit_tpu_torch.tasks.dota import DOTA10_CLASSES
    rs = np.random.RandomState(seed)
    w, h = DET_ORIG
    out = {}
    for split, stem in DET_IMAGES:
        for sub in ("images", "annfiles"):
            (root / split / sub).mkdir(parents=True, exist_ok=True)
        small = rs.randint(0, 256, (h // 16, w // 16, 3), np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        draw = ImageDraw.Draw(img)
        polys, names = [], []
        for i in range(16):
            inner = i < 10  # inside [476, 1024] x [276, 1024]
            cx = rs.uniform(540, 960) if inner else rs.uniform(60, w - 60)
            cy = rs.uniform(340, 960) if inner else rs.uniform(60, h - 60)
            bw, bh, t = rs.uniform(20, 80), rs.uniform(12, 50), rs.uniform(
                -1.4, 1.4)
            c, sn = np.cos(t), np.sin(t)
            quad = [(cx + dx * c - dy * sn, cy + dx * sn + dy * c)
                    for dx, dy in ((-bw / 2, -bh / 2), (bw / 2, -bh / 2),
                                   (bw / 2, bh / 2), (-bw / 2, bh / 2))]
            draw.polygon(quad, fill=tuple(int(v) for v in
                                          rs.randint(0, 256, 3)))
            polys.append(np.asarray(quad).reshape(8))
            names.append(DOTA10_CLASSES[rs.randint(0, len(DOTA10_CLASSES))])
        img.save(root / split / "images" / f"{stem}.png")
        lines = ["imagesource:GoogleEarth", "gsd:0.146"] + [
            " ".join(f"{v:.1f}" for v in p) + f" {n} 0"
            for p, n in zip(polys, names)]
        (root / split / "annfiles" / f"{stem}.txt").write_text(
            "\n".join(lines) + "\n")
        out[stem] = (np.asarray(img), np.round(np.stack(polys), 1), names)
    return out


def check_det_tiles(tiles: Path, originals: dict) -> int:
    """cli.dota_split's tiles against the originals: each tile the
    original's window (padded where it runs off), each annotation line an
    original polygon shifted by the tile's offset (within the files' 0.1
    rounding) with its class. Returns the objects checked."""
    import numpy as np
    from PIL import Image
    from lemevit_tpu_torch.data.dota_split import parse_tile_name
    n_obj = 0
    for split, n in DET_TILES.items():
        names = sorted((tiles / split / "images").iterdir())
        if len(names) != n:
            raise AssertionError(f"dota_split: {len(names)} {split} tiles, "
                                 f"expected {n}")
        for f in names:
            stem, _, x0, y0 = parse_tile_name(f.stem)
            img, polys, classes = originals[stem]
            tile = np.asarray(Image.open(f).convert("RGB"))
            crop = img[y0:y0 + 1024, x0:x0 + 1024]
            if not np.array_equal(tile[:crop.shape[0], :crop.shape[1]],
                                  crop):
                raise AssertionError(f"dota_split: tile {f.name} pixels")
            for line in (tiles / split / "annfiles" / f"{f.stem}.txt"
                         ).read_text().splitlines():
                parts = line.split()
                p = np.asarray(parts[:8], float)
                p[0::2] += x0
                p[1::2] += y0
                d = np.abs(polys - p).max(1)
                j = int(d.argmin())
                if d[j] > 0.11 or classes[j] != parts[8]:
                    raise AssertionError(f"dota_split: {f.name}: {line}")
                n_obj += 1
    return n_obj


def det_phase(smi: str, dev, fb, ft, g) -> tuple:
    """Oriented detection through cli.dota_split and cli.train_det. First
    each kernel of the path against its plain version at the path's
    shapes (DET_DCA_SHAPES, DET_MHSA_SHAPE, DET_S_SHAPE: fp32 at
    DET_B_CHECK, bf16 at the config's B = 8, forward and backward, each
    check's own tolerances). Then three original-size images written from
    a seed (DET_ORIG, rotated rectangles of the DOTA classes) tiled by
    cli.dota_split at 1024^2 (gap 200, every window kept: DET_TILES) and
    checked against the originals; cli.train_det with configs/det/
    DET_CFG (Oriented R-CNN on lemevit_small, 1024^2, B = 8, FPN 256,
    rpn_nms_pre 2000, 15 classes, bf16, --sched step, clip 35) for 1 epoch
    of DET_STEPS steps and its eval (VOC mAP over the 4 val tiles at
    B = 1), steps/s, img/s and peak GiB; the launches by kernel of one
    train step and one eval forward (DET_STEP, DET_EVAL exactly, and the
    run's launches their sum over its steps and eval forwards); the
    kernel path's first-batch loss and its parts beside --attn-backend
    torch's on the same weights and proposals (DET_LOSS_TOL); a profile
    of one train step; the eval's
    ms per image; the port's leme_ops library loaded (the eval's rotated
    IoU in C++); then cli.train_det --tile on the originals (the eval
    merges the tiles' detections) and --format-only (the DOTA submission
    files), a step each. Nothing here catches its own failure. Returns
    (the phase's numbers, the shape rows by kernel)."""
    import numpy as np
    from lemevit_tpu_torch.cli import dota_split, train_det
    from lemevit_tpu_torch.data.detection import (DOTADataset,
                                                  detection_collate)
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.ops import native
    from lemevit_tpu_torch.tasks.detection_train import detection_loss
    from lemevit_tpu_torch.utils.parser import parse_args_with_config
    t0 = time.time()
    rows = [check_dca_attn(n, ch, per_fwd, dev, g, b_check=DET_B_CHECK,
                           b_main=8) for n, ch, per_fwd in DET_DCA_SHAPES]
    n, ch, per_fwd = DET_MHSA_SHAPE
    rows.append(check_mhsa(n, ch, DET_B_CHECK, 8, dev, g))
    rows[-1]["per_step"] = per_fwd
    n, ch, per_fwd = DET_S_SHAPE
    rows.append(check_block_kernel(fb, "s_block", n, ch, per_fwd, dev, g,
                                   b_check=DET_B_CHECK, b_main=8))
    rows += check_train_kernels(ft, "s", n, ch, per_fwd, dev, g,
                                b_check=DET_B_CHECK, b_main=8)
    shape_rows = {}
    for r in rows:
        shape_rows.setdefault(r["name"], []).append(r)
    t_kernels = time.time() - t0
    cfg = str(REPO / "configs" / "det" / DET_CFG)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        originals = write_det_data(root / "orig")
        split = dota_split.main(["--src", str(root / "orig"), "--dst",
                                 str(root / "tiles"), "--keep-empty"])
        if split != DET_TILES:
            raise AssertionError(f"dota_split: {split}")
        n_obj = check_det_tiles(root / "tiles", originals)
        say("det", f"cli.dota_split: {DET_ORIG[0]}x{DET_ORIG[1]} originals "
            f"-> {json.dumps(split)} tiles of 1024^2, {n_obj} shifted "
            f"objects checked against the originals")

        data = ["--data-dir", str(root / "tiles"), "--workers", "4"]
        torch.cuda.reset_peak_memory_stats()
        reset()
        res = train_det.main(["--config", cfg, *data, "--epochs", "1",
                              "--steps-per-epoch", str(DET_STEPS),
                              "--output", str(root / "run")])
        run_launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if not (res["steps"] == DET_STEPS and math.isfinite(res["loss"])
                and 0.0 <= res["best_mAP"] <= 1.0):
            raise AssertionError(f"det: run {res}")
        if not native.available():
            raise AssertionError(f"det: leme_ops did not load: "
                                 f"{native.build_error()}")

        # one train step and one eval forward by themselves: the launches
        args, _ = parse_args_with_config(train_det.build_parser(),
                                         ["--config", cfg])
        ds = DOTADataset(str(root / "tiles"), "train")
        batch = {k: v.to(dev) for k, v in detection_collate(
            [ds[i] for i in range(args.batch_size)]).items()}
        val = DOTADataset(str(root / "tiles"), "val")
        model = train_det.build_model(args, dev)
        opt = torch.optim.AdamW(model.parameters(), lr=0.0,
                                weight_decay=args.weight_decay)
        reset()
        train_det.det_train_step(model, opt, 0.0, batch, args.num_classes,
                                 args.clip_grad, torch.bfloat16)
        per_step = {k: v for k, v in launch_counts().items() if v}
        img = torch.from_numpy(np.array(val[0][0])).to(dev)
        reset()
        train_det.predict(model, img, torch.bfloat16)
        per_eval = {k: v for k, v in launch_counts().items() if v}
        run_sum = {k: DET_STEPS * per_step.get(k, 0)
                   + len(val) * per_eval.get(k, 0)
                   for k in set(per_step) | set(per_eval)}
        if (per_step != DET_STEP or per_eval != DET_EVAL
                or {k: v for k, v in run_launches.items() if v} != run_sum):
            raise AssertionError(
                f"det: launches per train step {per_step} (expected "
                f"{DET_STEP}), per eval forward {per_eval} (expected "
                f"{DET_EVAL}); the run's {run_launches} against {run_sum}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(len(val)):
            train_det.predict(model, torch.from_numpy(np.array(val[i][0]))
                              .to(dev), torch.bfloat16)
        eval_ms = (time.perf_counter() - t1) * 1e3 / len(val)
        prof = profile_call(lambda: train_det.det_train_step(
            model, opt, 0.0, batch, args.num_classes, args.clip_grad,
            torch.bfloat16), f"one det train step (B={args.batch_size}, "
            f"1024^2, bf16)")
        if not prof:
            raise AssertionError("det: the profiler recorded no device time")
        del model, opt
        say("det", f"Oriented R-CNN lemevit_small 1024^2 bf16 "
            f"B={args.batch_size}: {DET_STEPS} steps, loss {res['loss']:.4f} "
            f"{json.dumps({k: round(v, 4) for k, v in res['parts'].items()})}"
            f", {1e3 / res['step_ms']:.3f} steps/s, {res['img_per_sec']:.2f} "
            f"img/s, {res['step_ms']:.2f} ms/step (steps 2-{DET_STEPS}), peak "
            f"{peak_gib:.2f} GiB; device {prof['device_ms']:.2f} ms a step "
            f"in {prof['launches']} launches, "
            f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy; eval "
            f"{eval_ms:.1f} ms per image (B=1), mAP "
            f"{res['final_metrics']['mAP']:.4f} over {len(val)} val tiles; "
            f"launches per train step {json.dumps(per_step)}, per eval "
            f"forward {json.dumps(per_eval)}; {native.version()} ({smi})")

        # the kernel path's loss against the plain path, same weights, the
        # plain path on the kernel path's proposals; the plain path's own
        # proposals' loss beside them, for the record
        losses, proposals = [], None
        for backend in ("auto", "torch", "torch"):
            args.attn_backend = backend
            model = train_det.build_model(args, dev).train()
            before = launch_counts()
            with torch.no_grad(), torch.autocast("cuda",
                                                 dtype=torch.bfloat16):
                out = model(normalize(batch["image"]),
                            proposals if len(losses) == 1 else None)
            total, parts = detection_loss(
                out, batch["gt_obbs"], batch["gt_labels"], batch["gt_mask"],
                args.num_classes)
            losses.append({"total": total.item(),
                           **{k: v.item() for k, v in parts.items()}})
            proposals = out["proposals"]
            fwd = launched_since(before)
            if (backend == "torch") == bool(fwd):
                raise AssertionError(f"det: {backend} forward launched {fwd}")
            del model, out
        diffs = {k: abs(losses[0][k] - losses[1][k]) for k in losses[0]}
        if not max(diffs.values()) <= DET_LOSS_TOL:
            raise AssertionError(f"det: kernel-path losses {losses[0]} "
                                 f"against plain {losses[1]} on the same "
                                 f"proposals")
        d_total = diffs["total"]
        say("det", f"first batch, train-mode bf16 forward: loss "
            f"{json.dumps({k: round(v, 6) for k, v in losses[0].items()})} "
            f"on the kernel path against "
            f"{json.dumps({k: round(v, 6) for k, v in losses[1].items()})} "
            f"with --attn-backend torch on the same proposals (largest "
            f"|diff| {max(diffs.values()):.2e}, limit {DET_LOSS_TOL}); "
            f"--attn-backend torch on its own proposals: total "
            f"{losses[2]['total']:.6f}")

        # original-size images: --tile (the merge) and --format-only
        one = ["--epochs", "1", "--steps-per-epoch", "1"]
        tile = train_det.main(["--config", cfg, "--data-dir",
                               str(root / "orig"), "--tile", "--workers",
                               "4", *one, "--output", str(root / "tile")])
        if not (tile["steps"] == 1 and 0.0 <= tile["best_mAP"] <= 1.0):
            raise AssertionError(f"det --tile: {tile}")
        fmt = train_det.main(["--config", cfg, *data, *one, "--format-only",
                              "--output", str(root / "fmt")])
        sub = sorted((root / "fmt" / "submission").iterdir())
        ids = {line.split()[0] for f in sub
               for line in f.read_text().splitlines()}
        # the non-tiled eval names its images by their index
        if fmt["best_mAP"] != -1.0 or len(sub) != 15 or not ids <= {
                str(i) for i in range(len(val))}:
            raise AssertionError(f"det --format-only: {fmt}, {sub}, {ids}")
        say("det", f"--tile on the originals: mAP "
            f"{tile['final_metrics']['mAP']:.4f} over the merged val image; "
            f"--format-only: {len(sub)} Task1 files, "
            f"{sum(len(f.read_text().splitlines()) for f in sub)} lines; "
            f"phase {time.time() - t0:.0f} s (kernel checks "
            f"{t_kernels:.0f} s; {smi})")
    return {"per_step": per_step, "per_eval": per_eval,
            "steps_per_sec": 1e3 / res["step_ms"],
            "img_per_sec": res["img_per_sec"], "step_ms": res["step_ms"],
            "peak_gib": peak_gib, "loss": res["loss"], "mAP":
            res["final_metrics"]["mAP"], "eval_ms_per_image": eval_ms,
            "loss_vs_plain": d_total, "loss_parts_vs_plain": diffs,
            "plain_own_proposals_loss": losses[2]["total"],
            "device_ms_per_step": prof["device_ms"],
            "launches_per_step": prof["launches"],
            "device_busy_share": prof["device_ms"] / prof["wall_ms"],
            "port_kernel_share": prof["port_ms"] / prof["device_ms"],
            "tile_mAP": tile["final_metrics"]["mAP"],
            "seconds": time.time() - t0}, shape_rows


# the maskrcnn phase: Mask R-CNN on lemevit_small at 512^2 (configs/coco)
MR_CFG = "mask_rcnn_lemevit_small_fpn_1x_coco.yaml"
# COCO's 80 sparse category ids (1..90 without the ten unused ones)
COCO_IDS = [i for i in range(1, 91)
            if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
# (w, h) of the written images: varied aspect ratios, 6 train and 4 val
MR_TRAIN = ((640, 480), (500, 375), (427, 640), (612, 612), (640, 360),
            (333, 500))
MR_VAL = ((640, 427), (480, 640), (550, 550), (640, 300))
MR_STEPS = 3
MR_B_CHECK = 1
# the bf16 kernel path's first-batch loss parts against --attn-backend
# torch's on the same weights and proposals (det_phase's limit)
MR_LOSS_TOL = 3e-2
# the kernels' shapes on it: stage 0 (C, N = 16384) composes; stages 1-2
# (D, N = 16384 C = 96, N = 4096 C = 192, M = 16) compose with each
# attention one dca_attn call; stages 3-4 (S, N = 1024 C = 320 in 6
# blocks, N = 256 C = 384 in 2) take the S kernels whole;
# (N, C, launches per forward)
MR_DCA_SHAPES = [(16384, 96, 2), (4096, 192, 2)]
MR_S_SHAPES = [(1024, 320, 6), (256, 384, 2)]
# launches per train step (B = 2) and per eval forward (B = 1)
MR_STEP = {"dca_attn": 4, "s_train_fwd": 8, "s_attn_bwd": 8, "mlp_bwd": 8}
MR_EVAL = {"dca_attn": 4, "s_block": 8}


def write_coco(root: Path, seed: int = 0) -> dict:
    """A COCO-format folder under root (train2017/, val2017/,
    annotations/instances_{split}.json) from a seed: smooth random
    pictures of MR_TRAIN / MR_VAL sizes with 3-5 filled polygons each
    (their polygon annotations, bbox the polygon's extent), the first
    train image's last object as an uncompressed RLE instead, one crowd
    annotation on the second train image, the 80 sparse COCO category
    ids (the RLE checked to decode to its polygon's mask). Returns
    {split: the written annotation dict}."""
    import numpy as np
    from PIL import Image, ImageDraw
    from lemevit_tpu_torch.data.coco import decode_rle, rasterize_polygons
    rs = np.random.RandomState(seed)
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    out = {}
    for split, sizes in (("train2017", MR_TRAIN), ("val2017", MR_VAL)):
        (root / split).mkdir(exist_ok=True)
        images, anns = [], []
        for i, (w, h) in enumerate(sizes):
            small = rs.randint(0, 256, (h // 16, w // 16, 3), np.uint8)
            img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
            draw = ImageDraw.Draw(img)
            img_id = 1000 * (split == "val2017") + 7 * i + 3
            n_obj = rs.randint(3, 6)
            for j in range(n_obj):
                cx, cy = rs.uniform(0.2 * w, 0.8 * w), rs.uniform(0.2 * h,
                                                                  0.8 * h)
                r = rs.uniform(0.05, 0.2) * min(w, h)
                ang = np.sort(rs.uniform(0, 2 * np.pi, 6))
                poly = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                                -1)
                draw.polygon([tuple(p) for p in poly],
                             fill=tuple(int(v) for v in rs.randint(0, 256, 3)))
                x0, y0 = poly.min(0)
                x1, y1 = poly.max(0)
                ann = {"id": len(anns) + 1, "image_id": img_id,
                       "category_id": int(COCO_IDS[rs.randint(80)]),
                       "iscrowd": 0,
                       "bbox": [float(x0), float(y0), float(x1 - x0),
                                float(y1 - y0)],
                       "segmentation": [[float(v) for v in poly.ravel()]]}
                if split == "train2017" and i == 0 and j == n_obj - 1:
                    m = rasterize_polygons(ann["segmentation"], h, w)
                    flat = m.T.ravel()  # column-major runs, 0s first
                    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
                    bounds = np.concatenate([[0], change, [flat.size]])
                    counts = np.diff(bounds).tolist()
                    if flat[0]:
                        counts = [0] + counts
                    ann["segmentation"] = {"counts": counts, "size": [h, w]}
                    if not (decode_rle(ann["segmentation"], h, w) == m).all():
                        raise AssertionError("coco: the RLE does not decode "
                                             "to its polygon")
                anns.append(ann)
            if split == "train2017" and i == 1:
                anns.append({"id": len(anns) + 1, "image_id": img_id,
                             "category_id": COCO_IDS[0], "iscrowd": 1,
                             "bbox": [0.0, 0.0, 40.0, 40.0],
                             "segmentation": [[0, 0, 40, 0, 40, 40, 0, 40]]})
            name = f"{img_id:012d}.jpg"
            img.save(root / split / name, quality=95)
            images.append({"id": img_id, "file_name": name, "width": w,
                           "height": h})
        cats = [{"id": c, "name": f"class{c}"} for c in COCO_IDS]
        out[split] = {"images": images, "annotations": anns,
                      "categories": cats[::-1]}
        with open(root / "annotations" / f"instances_{split}.json",
                  "w") as f:
            json.dump(out[split], f)
    return out


def check_coco_items(root: Path, written: dict, size: int) -> int:
    """COCODataset's items against the written annotations: the images in
    id order, padded at the bottom and right; one box, label and mask per
    non-crowd annotation (the box the bbox times the scale, the label the
    category's rank among the sparse ids, the mask inside the image's
    resized area); returns the objects checked."""
    import numpy as np
    from lemevit_tpu_torch.data.coco import COCODataset
    n_obj = 0
    for split, ann in written.items():
        ds = COCODataset(str(root), split, img_size=size)
        ids = sorted(im["id"] for im in ann["images"])
        if ds.ids != ids or ds.cat_to_label != {
                c: i for i, c in enumerate(COCO_IDS)}:
            raise AssertionError(f"coco {split}: ids {ds.ids}")
        for k, img_id in enumerate(ids):
            img, boxes, labels, masks = ds[k]
            info = ds.images[img_id]
            objs = [a for a in ann["annotations"]
                    if a["image_id"] == img_id and not a["iscrowd"]]
            scale = size / max(info["width"], info["height"])
            nh, nw = (round(info["height"] * scale),
                      round(info["width"] * scale))
            want = np.float32([[x, y, x + w, y + h] for x, y, w, h in
                               (a["bbox"] for a in objs)]) * scale
            if not (img.shape == (size, size, 3) and len(boxes) == len(objs)
                    and np.allclose(boxes, want, rtol=1e-5)
                    and [int(v) for v in labels] == [
                        COCO_IDS.index(a["category_id"]) for a in objs]
                    and masks.shape == (len(objs), size, size)
                    and not img[nh:].any() and not img[:, nw:].any()
                    and all(m[:nh, :nw].any() and not m[nh:].any()
                            and not m[:, nw:].any() for m in masks)):
                raise AssertionError(f"coco {split} item {k}: {boxes}, "
                                     f"{labels}, {objs}")
            n_obj += len(objs)
    return n_obj


def maskrcnn_phase(smi: str, dev, fb, ft, g) -> tuple:
    """Instance segmentation through cli.train_maskrcnn. First each kernel
    of the path against its plain version at the path's shapes
    (MR_DCA_SHAPES, MR_S_SHAPES: fp32 at MR_B_CHECK, bf16 at the config's
    B = 2, forward and backward, each check's own tolerances). Then a
    COCO-format folder written from a seed (write_coco: 6 train and 4 val
    images of varied aspect ratios, polygons, an uncompressed RLE, a crowd
    annotation, the sparse category ids) and COCODataset's items held
    against it; cli.train_maskrcnn with configs/coco/MR_CFG (Mask R-CNN on
    lemevit_small, 512^2, B = 2, 80 classes, 128 proposals, FPN 256, bf16,
    --sched step) for 1 epoch of MR_STEPS steps and its eval (box and mask
    mAP over the val images at B = 1), steps/s, img/s, peak GiB, the
    eval's ms per image; the launches by kernel of one train step and one
    eval forward (MR_STEP, MR_EVAL exactly, and the run's launches their
    sum); the kernel path's first-batch loss and its five parts beside
    --attn-backend torch's on the same weights and proposals (the batch's
    gt boxes first among them, so that the RoI and mask terms have
    positives; MR_LOSS_TOL); a profile of one train step. Nothing here
    catches its own failure. Returns (the phase's numbers, the shape rows
    by kernel)."""
    import numpy as np
    from lemevit_tpu_torch.cli import train_maskrcnn
    from lemevit_tpu_torch.data.coco import COCODataset, instance_collate
    from lemevit_tpu_torch.data.transforms import normalize
    from lemevit_tpu_torch.tasks.mask_rcnn import mask_rcnn_loss
    from lemevit_tpu_torch.utils.parser import parse_args_with_config
    t0 = time.time()
    rows = [check_dca_attn(n, ch, per_fwd, dev, g, b_check=MR_B_CHECK,
                           b_main=2) for n, ch, per_fwd in MR_DCA_SHAPES]
    for n, ch, per_fwd in MR_S_SHAPES:
        rows.append(check_block_kernel(fb, "s_block", n, ch, per_fwd, dev, g,
                                       b_check=MR_B_CHECK, b_main=2))
        rows += check_train_kernels(ft, "s", n, ch, per_fwd, dev, g,
                                    b_check=MR_B_CHECK, b_main=2)
    shape_rows = {}
    for r in rows:
        shape_rows.setdefault(r["name"], []).append(r)
    t_kernels = time.time() - t0
    cfg = str(REPO / "configs" / "coco" / MR_CFG)
    args, _ = parse_args_with_config(train_maskrcnn.build_parser(),
                                     ["--config", cfg])
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        written = write_coco(root / "coco")
        n_obj = check_coco_items(root / "coco", written, args.img_size)
        say("maskrcnn", f"COCO folder: {len(MR_TRAIN)} train and "
            f"{len(MR_VAL)} val images, {n_obj} objects of COCODataset "
            f"checked against the written annotations (polygons, one RLE, "
            f"one crowd skipped, 80 sparse category ids)")

        torch.cuda.reset_peak_memory_stats()
        reset()
        res = train_maskrcnn.main([
            "--config", cfg, "--data-dir", str(root / "coco"),
            "--workers", "2", "--epochs", "1", "--steps-per-epoch",
            str(MR_STEPS), "--output", str(root / "run")])
        run_launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        m = res["metrics"]
        if not (res["steps"] == MR_STEPS and math.isfinite(res["loss"])
                and 0.0 <= res["best_mask_mAP"] <= 1.0
                and 0.0 <= m["mAP"] <= 1.0 and 0.0 <= m["mask_mAP"] <= 1.0):
            raise AssertionError(f"maskrcnn: run {res}")

        # one train step and one eval forward by themselves: the launches
        train = COCODataset(str(root / "coco"), "train2017",
                            img_size=args.img_size)
        val = COCODataset(str(root / "coco"), "val2017",
                          img_size=args.img_size)
        batch = {k: v.to(dev) for k, v in instance_collate(
            [train[i] for i in range(args.batch_size)],
            max_boxes=args.max_boxes).items()}
        model = train_maskrcnn.build_model(args, dev)
        opt = torch.optim.AdamW(model.parameters(), lr=0.0,
                                weight_decay=args.weight_decay)
        reset()
        train_maskrcnn.maskrcnn_train_step(model, opt, 0.0, batch,
                                           args.num_classes, args.clip_grad,
                                           torch.bfloat16)
        per_step = {k: v for k, v in launch_counts().items() if v}
        img = torch.from_numpy(np.array(val[0][0])).to(dev)
        reset()
        train_maskrcnn.predict(model, img, torch.bfloat16)
        per_eval = {k: v for k, v in launch_counts().items() if v}
        run_sum = {k: MR_STEPS * per_step.get(k, 0)
                   + len(val) * per_eval.get(k, 0)
                   for k in set(per_step) | set(per_eval)}
        if (per_step != MR_STEP or per_eval != MR_EVAL
                or {k: v for k, v in run_launches.items() if v} != run_sum):
            raise AssertionError(
                f"maskrcnn: launches per train step {per_step} (expected "
                f"{MR_STEP}), per eval forward {per_eval} (expected "
                f"{MR_EVAL}); the run's {run_launches} against {run_sum}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(len(val)):
            train_maskrcnn.predict(model, torch.from_numpy(np.array(
                val[i][0])).to(dev), torch.bfloat16)
        eval_ms = (time.perf_counter() - t1) * 1e3 / len(val)
        prof = profile_call(lambda: train_maskrcnn.maskrcnn_train_step(
            model, opt, 0.0, batch, args.num_classes, args.clip_grad,
            torch.bfloat16), f"one Mask R-CNN train step (B="
            f"{args.batch_size}, 512^2, bf16)")
        if not prof:
            raise AssertionError("maskrcnn: the profiler recorded no device "
                                 "time")
        del model, opt
        say("maskrcnn", f"Mask R-CNN lemevit_small 512^2 bf16 "
            f"B={args.batch_size}: {MR_STEPS} steps, loss {res['loss']:.4f} "
            f"{json.dumps({k: round(v, 4) for k, v in res['parts'].items()})}"
            f", {1e3 / res['step_ms']:.3f} steps/s, {res['img_per_sec']:.2f} "
            f"img/s, {res['step_ms']:.2f} ms/step (steps 2-{MR_STEPS}), peak "
            f"{peak_gib:.2f} GiB; device {prof['device_ms']:.2f} ms a step "
            f"in {prof['launches']} launches, "
            f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}% busy, "
            f"{100 * prof['port_ms'] / prof['device_ms']:.1f}% in the "
            f"port's kernels; eval {eval_ms:.1f} ms per image (B=1), box "
            f"mAP {m['mAP']:.4f}, mask mAP {m['mask_mAP']:.4f} over "
            f"{len(val)} val images; launches per train step "
            f"{json.dumps(per_step)}, per eval forward "
            f"{json.dumps(per_eval)} ({smi})")

        # the kernel path's loss against the plain path, same weights, on
        # the same proposals: the kernel path's own, the batch's valid gt
        # boxes in their first rows (RoI and mask positives)
        losses, proposals = [], None
        for backend in ("auto", "torch"):
            args.attn_backend = backend
            model = train_maskrcnn.build_model(args, dev).train()
            before = launch_counts()
            with torch.no_grad(), torch.autocast("cuda",
                                                 dtype=torch.bfloat16):
                if proposals is None:
                    own = model(normalize(batch["image"]))["proposals"]
                    proposals = own.clone()
                    for i in range(len(proposals)):
                        gt = batch["gt_boxes"][i][batch["gt_valid"][i]]
                        proposals[i, :len(gt)] = gt
                out = model(normalize(batch["image"]), proposals)
            total, parts = mask_rcnn_loss(
                out, batch["gt_boxes"], batch["gt_labels"],
                batch["gt_masks"], batch["gt_valid"], args.num_classes)
            losses.append({"total": total.item(),
                           **{k: v.item() for k, v in parts.items()}})
            fwd = launched_since(before)
            if (backend == "torch") == bool(fwd):
                raise AssertionError(f"maskrcnn: {backend} forward "
                                     f"launched {fwd}")
            del model, out
        diffs = {k: abs(losses[0][k] - losses[1][k]) for k in losses[0]}
        if not (max(diffs.values()) <= MR_LOSS_TOL
                and min(losses[0]["roi_reg"], losses[0]["mask"]) > 0):
            raise AssertionError(f"maskrcnn: kernel-path losses {losses[0]} "
                                 f"against plain {losses[1]} on the same "
                                 f"proposals")
        say("maskrcnn", f"first batch, train-mode bf16 forward: loss "
            f"{json.dumps({k: round(v, 6) for k, v in losses[0].items()})} "
            f"on the kernel path against "
            f"{json.dumps({k: round(v, 6) for k, v in losses[1].items()})} "
            f"with --attn-backend torch on the same proposals (largest "
            f"|diff| {max(diffs.values()):.2e}, limit {MR_LOSS_TOL}); phase "
            f"{time.time() - t0:.0f} s (kernel checks {t_kernels:.0f} s)")
    return {"per_step": per_step, "per_eval": per_eval,
            "steps_per_sec": 1e3 / res["step_ms"],
            "img_per_sec": res["img_per_sec"], "step_ms": res["step_ms"],
            "peak_gib": peak_gib, "loss": res["loss"], "box_mAP": m["mAP"],
            "mask_mAP": m["mask_mAP"], "eval_ms_per_image": eval_ms,
            "loss_parts_vs_plain": diffs,
            "device_ms_per_step": prof["device_ms"],
            "launches_per_step": prof["launches"],
            "device_busy_share": prof["device_ms"] / prof["wall_ms"],
            "port_kernel_share": prof["port_ms"] / prof["device_ms"],
            "seconds": time.time() - t0}, shape_rows


# cli.train_seg on files: 8 train PNGs of varied sizes, 2 val PNGs of one
# 512^2 window each
SEG_FILES = {"train": ((400, 300), (640, 512), (512, 700), (300, 300),
                       (800, 600), (512, 512), (350, 620), (600, 450)),
             "val": ((512, 512), (512, 512))}


def seg_files_step(smi: str) -> dict:
    """One step of cli.train_seg with its defaults (UperNet on
    lemevit_tiny, 512^2 crops, B = 8, bf16) on an
    {train,val}/{images,labels} PNG folder written from a seed (labels
    with values past the classes and 255, --ignore-index 255), and its
    slide-inference eval of the two val images: the launches the step and
    the eval windows' forwards (SEG_STEP + 2 SEG_CROP_FWD), a finite loss,
    metrics in range, a checkpoint."""
    import numpy as np
    from PIL import Image
    from lemevit_tpu_torch.cli import train_seg
    rs = np.random.RandomState(3)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for split, sizes in SEG_FILES.items():
            for sub in ("images", "labels"):
                (root / split / sub).mkdir(parents=True)
            for i, (w, h) in enumerate(sizes):
                small = rs.randint(0, 256, (h // 8, w // 8, 3), np.uint8)
                Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                    root / split / "images" / f"{i:03d}.png")
                lbl = np.kron(rs.randint(0, SEG_CLASSES + 1,
                                         (h // 16 + 1, w // 16 + 1)),
                              np.ones((16, 16), np.int64))[:h, :w]
                lbl[rs.rand(h, w) < 0.05] = 255
                Image.fromarray(lbl.astype(np.uint8), "L").save(
                    root / split / "labels" / f"{i:03d}.png")
        reset()
        res = train_seg.main(["--data-dir", str(root), "--iters", "1",
                              "--eval-interval", "1", "--ignore-index",
                              "255", "--output", str(root / "run")])
        launches = {k: v for k, v in launch_counts().items() if v}
        ckpts = list((root / "run" / "checkpoints").glob("*.pth"))
    want = {k: v + 2 * SEG_CROP_FWD.get(k, 0) for k, v in SEG_STEP.items()}
    want.update({k: 2 * v for k, v in SEG_CROP_FWD.items() if k not in want})
    m = res["final_metrics"]
    if not (launches == want and res["steps"] == 1 and len(ckpts) == 1
            and math.isfinite(res["loss"])
            and all(0 <= v <= 100 for v in m.values())):
        raise AssertionError(f"train_seg on files: {res}, launches "
                             f"{launches} (expected {want}), {ckpts}")
    say("seg-files", f"cli.train_seg on a PNG folder (8 train images of "
        f"varied sizes, 2 val, --ignore-index 255), one step: loss "
        f"{res['loss']:.4f}, eval {json.dumps({k: round(v, 3) for k, v in m.items()})}"
        f", launches {json.dumps(launches)} ({smi})")
    return {"loss": res["loss"], "metrics": m, "launches": launches}


VIS_TOL = 1e-3  # the maps of the kernel path's block inputs against plain


def visualize_attn_run(smi: str, dev) -> dict:
    """cli.visualize_attn on the card: lemevit_tiny (seed 0) at 224^2, its
    stage-1 block 0, on a picture written from a seed: 17 PNGs of the
    image's size, and the launches of one eval forward (TINY_EVAL); then
    the maps it draws from the kernel path's block inputs against those
    of --attn-backend torch's forward (VIS_TOL)."""
    import numpy as np
    from PIL import Image
    from lemevit_tpu_torch.cli import visualize_attn
    from lemevit_tpu_torch.data.transforms import normalize
    rs = np.random.RandomState(4)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        Image.fromarray(rs.randint(0, 256, (20, 30, 3), np.uint8)).resize(
            (300, 200), Image.BILINEAR).save(root / "img.png")
        reset()
        res = visualize_attn.main(["--image", str(root / "img.png"),
                                   "--out", str(root / "vis")])
        launches = {k: v for k, v in launch_counts().items() if v}
        sizes = {Image.open(p).size for p in res["paths"]}
        if not (len(res["paths"]) == M + 1 and sizes == {(224, 224)}
                and launches == TINY_EVAL):
            raise AssertionError(f"visualize_attn: {res}, sizes {sizes}, "
                                 f"launches {launches}")
    from lemevit_tpu_torch import create_model
    model = create_model("lemevit_tiny", num_classes=1000, device=dev).eval()
    x = normalize(torch.randint(0, 256, (1, 224, 224, 3), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(5)
                                ).to(dev))
    maps = []
    for backend in ("auto", "torch"):
        model.set_attn_backend(backend)
        maps.append(visualize_attn.attention_maps(model, x, 1, 0, 32)[:2])
    err = max((a - b).abs().max().item() for a, b in zip(*maps))
    if not err <= VIS_TOL:
        raise AssertionError(f"visualize_attn: kernel path's maps {err:.3g} "
                             f"from the plain path's")
    say("visualize-attn", f"lemevit_tiny 224 stage 1 block 0: "
        f"{len(res['paths'])} PNGs, launches {json.dumps(launches)}; the "
        f"maps from the kernel path's block inputs within {err:.2e} of the "
        f"plain path's (limit {VIS_TOL}; {smi})")
    return {"pngs": len(res["paths"]), "launches": launches, "map_err": err}



def main() -> None:
    t_start = time.time()
    phase_s = {}
    t_lap = [t_start]

    def lap(name):
        """Print and keep the seconds since the last lap."""
        now = time.time()
        phase_s[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
        say("phase-seconds", f"{name}: {phase_s[name]} s")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        sys.exit(1)
    from lemevit_tpu_torch import create_model
    from lemevit_tpu_torch.attn import _build
    from lemevit_tpu_torch.attn import fused_block as fb
    from lemevit_tpu_torch.attn import fused_train as ft
    from lemevit_tpu_torch.attn.reference import dca_scales
    from lemevit_tpu_torch.cli import benchmark, validate
    from lemevit_tpu_torch.models.lemevit import LeMeBlock
    from lemevit_tpu_torch import probes
    from lemevit_tpu_torch.cli import probes as probes_cli
    from lemevit_tpu_torch.probes import ew

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind_name = torch.cuda.get_device_name(0)
    say("card", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {kind_name} x{torch.cuda.device_count()}")
    say("card", pil_status())

    # 2. build the model kernels and, beside them, the probes' library
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        built = [pool.submit(_build.build), pool.submit(probes.build)]
        lib_path, probe_path = [f.result() for f in built]
    _build.library()
    probes.library()
    say("build", f"{lib_path.name} and {probe_path.name} in "
        f"{time.time() - t0:.1f} s")
    # what ptxas printed during that build
    ptxas = kernels_ptxas()
    for src, report in ptxas.items():
        for line in report.splitlines():
            say("ptxas", f"{src}: {line}")
    probe_ptxas = check_probe_ptxas(ptxas)
    say("ptxas", f"probes: {json.dumps(probe_ptxas)}")
    lap("build")

    # 3. inference kernels against their plain versions
    g = torch.Generator().manual_seed(0)
    shape_rows = [check_block_kernel(fb, kind, n, ch, per_fwd, dev, g)
                  for kind, n, ch, per_fwd in MAIN_SHAPES]
    off_rows = [check_block_kernel(fb, kind, n, ch, 0, dev, g, m=m)
                for kind, n, ch, m in BLOCK_OFF_PATH]

    # D2 reaches the D kernel through the weight permutation
    blk = LeMeBlock(96, 3, "D2").to(dev).eval()
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g).to(dev) * 0.3)
        xd = torch.randn(B_CHECK, 56, 56, 96, generator=g).to(dev)
        cd = torch.randn(B_CHECK, M, 96, generator=g).to(dev)
        blk.attn_backend = "cuda"
        got = blk(xd, cd)
        blk.attn_backend = "torch"
        want = blk(xd, cd)
        # the kernel in bf16 on the permuted weights against its tile model
        pd = [t.to(torch.bfloat16) for t in blk.fused_params()]
        kw = dict(num_heads=3, scale_x=dca_scales(3136, M, 96)[0],
                  scale_c=dca_scales(3136, M, 96)[1])
        xb = xd.reshape(B_CHECK, 3136, 96).to(torch.bfloat16)
        cb = cd.to(torch.bfloat16)
        err_d2 = max_err(fb.dca_block(xb, cb, pd, **kw),
                         fb.dca_block_tiles_plain(xb, cb, pd, **kw),
                         None, TILES_STEPS)
    say("kernel", f"dca_block D2 permutation N=3136 C=96: fp32 err "
        f"{max_err(got, want, 1e-4):.2e}; bf16 against the tile model "
        f"{err_d2:.2e}")

    # 4. the model: kernel path against plain path (fp32, B=2)
    model = create_model("lemevit_base", device=dev).eval()
    img = torch.randn(2, 224, 224, 3, generator=g).to(dev)
    with torch.no_grad():
        fused = model(img)
        model.set_attn_backend("torch")
        plain = model(img)
    err = (fused - plain).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"base logits: kernel vs plain path {err:.3g}")
    say("model", f"lemevit_base 224 fp32 B=2: kernel vs plain logits max "
        f"abs err {err:.2e} (limit 1e-3)")
    del model
    for name in ("lemevit_base", "lemevit_tiny"):
        check_model_bf16(name, dev, g)

    # the serving main path: bf16 B=64 through cli.benchmark's inference
    args = benchmark.build_parser().parse_args(
        ["--model", "lemevit_base", "--batch-size", str(B_MAIN),
         "--num-warm-iter", "2", "--num-bench-iter", "10"])
    model = create_model("lemevit_base", device=dev,
                         dtype=torch.bfloat16).eval()
    x = torch.randn(B_MAIN, 224, 224, 3, generator=g).to(dev)
    reset()
    res, logits = benchmark.run_inference(args, model, x)
    launches = launch_counts()
    n_fwd = args.num_warm_iter + args.num_bench_iter
    expect = {"c_block": 2, "dca_block": 8, "s_block": 22}
    expect_launches(launches, {k: per * n_fwd for k, per in expect.items()},
                    f"lemevit_base, {n_fwd} forwards")
    if logits.shape != (B_MAIN, 1000) or not torch.isfinite(logits).all():
        raise AssertionError("main-path logits are not finite (64, 1000)")
    say("serve", f"lemevit_base 224 bf16 B={B_MAIN}: "
        f"{res['samples_per_sec']} img/s, {res['step_time']} ms/step; "
        f"launches per forward " + ", ".join(
            f"{k} {launches[k] // n_fwd}" for k in expect))
    with torch.inference_mode():
        prof_default, fwd_kernels = profile_kernels(
            lambda: model(x), "one forward", BASE_FWD_KERNELS)
    del model
    say("serve", "profile: kernels per forward " + json.dumps(fwd_kernels))

    # 5. validate on synthetic data
    vres = validate.main(["--model", "lemevit_base", "--synthetic",
                          "--batch-size", str(B_MAIN), "--max-batches", "2"])
    if not (vres["loss"] > 0 and vres["samples_per_sec"] > 0):
        raise AssertionError(f"validate: {vres}")
    say("validate", json.dumps(vres))
    lap("serve")

    # 5b. the slice's path: s_stage and the blocks' in-kernel CPE against
    #     their plain versions, then base served through them
    stage_rows = [check_stage(fb, *shape, dev, g) for shape in STAGE_SHAPES]
    cpe_rows = [check_block_kernel(fb, kind, n, ch, per_fwd, dev, g,
                                   img_w=w)
                for kind, n, w, ch, per_fwd in CPE_SHAPES]
    slice_launches, slice_res = serve_slice(dev, g, res, prof_default)
    lap("serve-slice")

    # 6. training vit_tiny (all S): the inference and training kernels at
    #    its shapes, one step against the plain path, then its main path and
    #    a profile of one train step
    vit_eval_rows = [check_block_kernel(fb, "s_block", n, ch, blocks, dev, g)
                     for _, n, ch, blocks in VIT_TRAIN]
    vit_rows = []
    for kind, n, ch, blocks in VIT_TRAIN:
        vit_rows += check_train_kernels(ft, kind, n, ch, blocks, dev, g)
    check_train_step(dev, "vit_tiny", VIT_STEP)
    vit_launches, vit_res = train_main_path("vit_tiny", VIT_STEP, VIT_EVAL)
    profile_train_step(dev, "vit_tiny")
    vit_fwd = profile_eval_forward(dev, "vit_tiny")
    lap("train-vit_tiny")

    # 7. training lemevit_tiny (C, D, S): inference kernels at its shapes,
    #    its training kernels, a D2 block, one step against the plain path,
    #    then its main path, cli.benchmark --bench train and a profile
    tiny_rows = [check_block_kernel(fb, kind, n, ch, per_fwd, dev, g)
                 for kind, n, ch, per_fwd in TINY_SHAPES]
    train_rows = []
    for kind, n, ch, blocks in TINY_TRAIN:
        train_rows += check_train_kernels(ft, kind, n, ch, blocks, dev, g,
                                          profile=n == 3136)
    check_d2_train_block(ft, dev, g)
    check_c_train_meta(ft, dev, g)
    check_defaults_model(dev)
    check_train_step(dev, "lemevit_tiny", TINY_STEP)
    tiny_launches, tiny_res = train_main_path("lemevit_tiny", TINY_STEP,
                                              TINY_EVAL)
    tiny_fwd = profile_eval_forward(dev, "lemevit_tiny")
    bres = benchmark.main(["--model", "lemevit_tiny", "--bench", "train",
                           "--batch-size", str(B_MAIN),
                           "--num-bench-iter", "5"])
    tr = bres["train"]
    say("bench-train", f"lemevit_tiny 224 bf16 B={tr['batch_size']}: "
        f"{tr['samples_per_sec']} img/s, step {tr['step_time']} ms, fwd "
        f"{tr['fwd_time']} ms, bwd+opt {tr['bwd_opt_time']} ms")
    prof = profile_train_step(dev, "lemevit_tiny")
    lap("train-lemevit_tiny")

    # 7b. the slice's path: lemevit_tiny trained with each block's 3x3 CPE
    #     inside its training kernels
    cpe_train_rows = []
    for kind, n, w, ch, blocks in TRAIN_CPE_SHAPES:
        cpe_train_rows += check_train_cpe(ft, fb, kind, n, w, ch, blocks, dev,
                                          g, profile=(n, ch) == (3136, 64))
    check_train_step(dev, "lemevit_tiny", TINY_STEP, train_cpe_in_kernel=True)
    slice_train_launches, slice_train_res = train_main_path(
        "lemevit_tiny", TINY_STEP, TINY_EVAL, ["--train-cpe-in-kernel"])
    sres = benchmark.main(["--model", "lemevit_tiny", "--bench", "train",
                           "--batch-size", str(B_MAIN),
                           "--num-bench-iter", "5", "--train-cpe-in-kernel"])
    st = sres["train"]
    say("bench-train", f"lemevit_tiny --train-cpe-in-kernel 224 bf16 "
        f"B={st['batch_size']}: {st['samples_per_sec']} img/s, step "
        f"{st['step_time']} ms, fwd {st['fwd_time']} ms, bwd+opt "
        f"{st['bwd_opt_time']} ms (default path: {tr['samples_per_sec']} "
        f"img/s, step {tr['step_time']} ms)")
    reset()
    slice_prof = profile_train_step(dev, "lemevit_tiny",
                                    train_cpe_in_kernel=True)
    # profile_call runs the step twice (a warm-up and the profiled one)
    expect_launches(launch_counts(), {k: 2 * v for k, v in TINY_STEP.items()},
                    "two profiled lemevit_tiny steps with the CPE inside")
    if not prof or not slice_prof:
        raise AssertionError("the profiler recorded no device time")
    convs = [pr["by_name"].get("aten::conv2d", 0) for pr in (prof,
                                                             slice_prof)]
    per = convs[0] // TINY_CONVS
    if not (per >= 1 and convs[0] == TINY_CONVS * per
            and convs[1] == (TINY_CONVS - TINY_CPE_CONVS) * per):
        raise AssertionError(f"slice train profile: {convs[1]} convolutions "
                             f"against the default path's {convs[0]}")
    say("train-slice", f"profile: {convs[1]} aten::conv2d calls (the default "
        f"path: {convs[0]}, its {TINY_CPE_CONVS} block CPEs among them); "
        f"cli.train {slice_train_res['samples_per_sec']:.2f} img/s, peak "
        f"{slice_train_res['peak_gib']:.2f} GiB (default path in this run: "
        f"{tiny_res['samples_per_sec']:.2f} img/s, "
        f"{tiny_res['peak_gib']:.2f} GiB)")
    say("train-summary", json.dumps({
        "model": "lemevit_tiny", "batch": B_MAIN, "dtype": "bf16",
        "img_per_s": tiny_res["samples_per_sec"],
        "ms_per_step": tiny_res["step_ms"],
        "peak_gib": tiny_res["peak_gib"],
        "bench_train_step_ms": tr["step_time"],
        "host_batch_build_ms": host_batch_ms(),  # synthetic, 1 thread
        "device_ms_per_step": prof.get("device_ms"),
        "launches_per_step": prof.get("launches"),
        # device time over the same profiled step's wall time
        "device_busy_share": (prof["device_ms"] / prof["wall_ms"]
                              if prof else None),
        "port_kernel_share": (prof["port_ms"] / prof["device_ms"]
                              if prof else None),
        "slice": {
            "flags": "--train-cpe-in-kernel",
            "img_per_s": slice_train_res["samples_per_sec"],
            "ms_per_step": slice_train_res["step_ms"],
            "peak_gib": slice_train_res["peak_gib"],
            "bench_train_step_ms": st["step_time"],
            "device_ms_per_step": slice_prof["device_ms"],
            "launches_per_step": slice_prof["launches"],
            "device_busy_share": (slice_prof["device_ms"]
                                  / slice_prof["wall_ms"]),
            "port_kernel_share": (slice_prof["port_ms"]
                                  / slice_prof["device_ms"]),
            "conv2d_calls": convs[1]}}))

    # 7c. real images: lemevit_tiny trained from a JPEG folder, lemevit_base
    #     validated on its ragged validation split (default and slice
    #     paths against the plain path), ReaL labels, a UCM tree and a zip;
    #     then the rest of the training recipe on the same folder
    lap("train-slice")
    with tempfile.TemporaryDirectory() as real_root:
        real = real_data_phase(smi, tiny_res, Path(real_root))
        lap("real-data")
        # 7c'. the packed and native data planes on the same JPEGs: the
        #      cache with the augmentation on the card, the C++ decode
        data_planes = packed_native_phase(smi, tiny_res, real,
                                          Path(real_root), dev)
        lap("packed-native")
        # 7d. AugMix splits with the JSD loss and split BatchNorm (synthetic
        #     and JPEG), a JSD step and a freeze_bn step against the plain
        #     path, every --opt rule card against CPU
        train_recipe_phase(smi, tiny_res, Path(real_root) / "folder", dev)
        lap("train-recipe")
        # 7e. multi-process cli.train (DDP, SyncBN in the BatchNorms) on
        #     the same JPEGs: one rank over NCCL against no group, two
        #     ranks over gloo against one process at their global batch,
        #     and the two ranks with a fault planted
        dist_res = dist_phase(smi, Path(real_root) / "folder")
        lap("dist")
    # 7f. change detection: BIT on lemevit_small at 256^2, its kernels
    #     against their plain versions at its shapes, then cli.train_cd
    #     (launches by kernel, pairs/s, kernel against plain loss), the
    #     other heads, cli.visualize_cd
    cd_res, cd_rows = cd_phase(smi, dev, fb, ft, g)
    lap("cd")
    # 7g. oriented detection: Oriented R-CNN on lemevit_small at 1024^2,
    #     its kernels against their plain versions at its shapes, then
    #     cli.dota_split and cli.train_det (launches by kernel, steps/s,
    #     kernel against plain loss, the eval's mAP, --tile, --format-only)
    det_res, det_rows = det_phase(smi, dev, fb, ft, g)
    lap("det")
    # 7h. instance segmentation: Mask R-CNN on lemevit_small at 512^2, its
    #     kernels against their plain versions at its shapes, then a COCO
    #     folder and cli.train_maskrcnn (launches by kernel, steps/s, box
    #     and mask mAP, kernel against plain loss on the same proposals)
    mr_res, mr_rows = maskrcnn_phase(smi, dev, fb, ft, g)
    lap("maskrcnn")
    # 7i. cli.train_seg on a PNG folder and cli.visualize_attn
    seg_files = seg_files_step(smi)
    vis_res = visualize_attn_run(smi, dev)
    lap("seg-files-vis")

    # 8. segmentation, UperNet on lemevit_tiny at 512^2: the attention-only
    #    kernels (dca_attn at stages 1-2's shapes, mhsa at its three) and
    #    the S kernels at stages 3-4's, the crop forward and slide
    #    inference, then its main path cli.train_seg and a profile
    dca_rows = [check_dca_attn(n, ch, blocks, dev, g)
                for n, ch, blocks in SEG_DCA] + [
        check_dca_attn(n, ch, blocks, dev, g, m=m)
        for n, ch, blocks, m in DCA_OFF_PATH]
    mhsa_rows = [check_mhsa(n, ch, bc, bm, dev, g)
                 for n, ch, bc, bm in MHSA_SHAPES + MHSA_RAGGED]
    for row in mhsa_rows:
        # only N = 16 runs on a main path (vit_tiny)
        row["per_step"] = VIT_STEP["mhsa"] if row["n"] == 16 else 0
    seg_eval_rows = [check_block_kernel(fb, "s_block", n, ch, blocks, dev, g,
                                        b_check=SEG_B_CHECK, b_main=SEG_B)
                     for _, n, ch, blocks in SEG_S]
    seg_train_rows = []
    for kind, n, ch, blocks in SEG_S:
        seg_train_rows += check_train_kernels(
            ft, kind, n, ch, blocks, dev, g, b_check=SEG_B_CHECK,
            b_main=SEG_B)
    serve = seg_serving(dev, g)
    seg_launches, seg_res = seg_main_path()
    seg_prof = profile_seg_step(dev)
    say("seg-summary", json.dumps({
        "model": "UperNet lemevit_tiny", "crop": SEG_CROP, "batch": SEG_B,
        "dtype": "bf16", "train_img_per_s": seg_res["samples_per_sec"],
        "train_ms_per_step": seg_res["step_ms"],
        "train_peak_gib": seg_res["peak_gib"],
        "final_metrics": seg_res["final_metrics"], **serve,
        "device_ms_per_step": seg_prof.get("device_ms"),
        "launches_per_step": seg_prof.get("launches"),
        "device_busy_share": (seg_prof["device_ms"] / seg_prof["wall_ms"]
                              if seg_prof else None),
        "port_kernel_share": (seg_prof["port_ms"] / seg_prof["device_ms"]
                              if seg_prof else None)}))
    lap("seg")

    # 8b. the probes: the per-op kernel against its plain version here,
    #     then the probe path (cli.probes: each construct probe against
    #     its plain version, timed, in a process of its own) and the
    #     training paths' A/B row, the CLI runs of lemevit_tiny, vit_tiny
    #     and train_seg reused from above, decided by the bare steps'
    #     device time in alternating pairs
    ew_rows = check_ew_probes(dev)
    check_roll_shift(dev)
    t0 = time.time()
    table = probes_main_path()
    say("probes", f"cli.probes --ew in {time.time() - t0:.0f} s, launches "
        + json.dumps(table["launches"]))
    for row in table["ew"]:
        say("ew-slope", ew.format_row(row))
    _, vit_sw = train_main_path("vit_tiny", VIT_STEP, VIT_EVAL,
                                ["--train-cpe-in-kernel"])
    _, seg_sw = seg_main_path(["--train-cpe-in-kernel"])

    def ab(res):
        return {"img_per_s": res["samples_per_sec"],
                "ms_per_step": res["step_ms"], "peak_gib": res["peak_gib"]}
    table["pb_train_paths"] = {
        name: probes_cli.train_path_row(
            ab(default), ab(switch), probes_cli.step_device_ms(name, dev))
        for name, default, switch in (
            ("lemevit_tiny", tiny_res, slice_train_res),
            ("vit_tiny", vit_res, vit_sw), ("train_seg", seg_res, seg_sw))}
    say("probes-ab", json.dumps({
        k: (v["verdict"] if "verdict" in v else
            {kk: vv["verdict"] for kk, vv in v.items()})
        for k, v in table.items()
        if isinstance(v, dict) and k not in ("launches",)}))
    say("probes-train-paths", json.dumps(table["pb_train_paths"]))
    lap("probes")

    # 9. per-kernel numbers: per-launch means over each main path's mix
    kernels = []

    def plane_launches(name):
        """This kernel's launches on each run of the data planes' phase."""
        return {run: counts[name] for run, counts in
                data_planes["launches"].items() if counts.get(name)}
    for name in ("c_block", "dca_block", "s_block"):
        kernels.append(kernel_entry(
            name, [r for r in shape_rows if r["name"] == name],
            launches[name], "per_forward",
            cpe_shapes=strip(r for r in cpe_rows if r["name"] == name),
            off_path_shapes=strip(r for r in off_rows if r["name"] == name),
            ptxas=ptxas.get(KERNELS[name][0].rsplit("/", 1)[1]),
            slice_launches=slice_launches[name],
            tiny_shapes=strip(r for r in tiny_rows if r["name"] == name),
            tiny_train_eval_launches=tiny_launches[name],
            **({"vit_tiny_train_eval_launches": vit_launches[name],
                "vit_tiny_shapes": strip(vit_eval_rows),
                "seg_train_eval_launches": seg_launches[name],
                "seg_shapes": strip(seg_eval_rows)}
               if name == "s_block" else {}),
            data_plane_launches=plane_launches(name),
            eval_forward_device_ms={
                "lemevit_base": prof_default["device_ms"],
                "lemevit_tiny": tiny_fwd.get("device_ms"),
                "vit_tiny": vit_fwd.get("device_ms"),
                "upernet_crop_b8": serve.get("crop_device_ms")}))
    for name in KERNELS:
        if name in fb.LAUNCHES or name in ("dca_attn", "mhsa"):
            continue
        extra = {}
        if name in VIT_STEP:
            extra = dict(vit_tiny_launches=vit_launches[name],
                         vit_tiny_shapes=strip(r for r in vit_rows
                                               if r["name"] == name))
        if name in SEG_STEP:
            extra.update(seg_launches=seg_launches[name],
                         seg_shapes=strip(r for r in seg_train_rows
                                          if r["name"] == name))
        extra.update(slice_launches=slice_train_launches[name],
                     data_plane_launches=plane_launches(name))
        if name != "mlp_bwd":
            extra["cpe_shapes"] = strip(r for r in cpe_train_rows
                                        if r["name"] == name)
        kernels.append(kernel_entry(
            name, [r for r in train_rows if r["name"] == name],
            tiny_launches[name], "per_step", **extra))
    kernels.append(kernel_entry(
        "s_stage", [r for r in stage_rows if r["per_forward"]],
        slice_launches["s_stage"], "per_forward",
        data_plane_launches=plane_launches("s_stage"),
        other_shapes=strip(r for r in stage_rows if not r["per_forward"]),
        slice_serving=slice_res, ptxas=ptxas["s_stage.cu"]))
    kernels.append(kernel_entry(
        "dca_attn", dca_rows, seg_launches["dca_attn"], "per_step",
        per_crop_forward=SEG_CROP_FWD["dca_attn"],
        ptxas=ptxas["dca_attn.cu"]))
    kernels.append(kernel_entry(
        "mhsa", mhsa_rows, vit_launches["mhsa"], "per_step",
        vit_tiny_per_eval_forward=VIT_EVAL["mhsa"],
        ptxas=ptxas["mhsa.cu"]))
    slopes = {f"{r['r']}x{r['c']}": r["us_per_pass"] for r in table["ew"]}
    for op in ew.OPS:
        # the slope table launches each shape alike: plain means over them
        rows = [r for r in ew_rows if r["name"] == f"ew_probe.{op}"]

        def mean(key):
            if any(r[key] is None for r in rows):
                return None
            return sum(r[key] for r in rows) / len(rows)
        kernels.append({
            "name": f"ew_probe.{op}", "route": "cuda",
            "source": PROBE_SRC + "ew_probe.cu",
            "replaces": "scripts/vpu_probe.py:59",
            "launches": table["launches"][f"ew_probe.{op}"],
            "max_abs_err": max(r["err_bf16"] for r in rows),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": mean("library_ms"),
            "kernel_ms": mean("kernel_ms"),
            "library_kernel_ms": mean("library_kernel_ms"),
            "shapes": strip(rows),
            "ptxas": probe_ptxas["ew_probe.cu"]["k_ew_probe"],
            "us_per_pass_per_tile": {shape: per[op]
                                     for shape, per in slopes.items()}})
    for name, (kernel, replaces) in CONSTRUCT_KERNELS.items():
        row = table[name]  # cli.probes' row: run, checked and timed there
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": PROBE_SRC + "constructs.cu", "replaces": replaces,
            "launches": table["launches"][kernel],
            "max_abs_err": row.get("err_vs_plain", row["err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": row["library_ms"], "verdict": row["verdict"],
            **({"ptxas": probe_ptxas["constructs.cu"][f"k_{kernel}"]}
               if f"k_{kernel}" in probe_ptxas["constructs.cu"] else {}),
            "probe": {k: v for k, v in row.items()
                      if k not in ("ms", "plain_ms", "bound_ms",
                                   "library_ms", "verdict", "route",
                                   "launches")}})
    # this slice's paths: each kernel's launches on them
    for k in kernels:
        if k["name"] in launch_counts():
            k["cd_launches_per_train_step"] = cd_res["per_step"].get(
                k["name"], 0)
            k["cd_launches_per_eval_forward"] = cd_res["per_eval"].get(
                k["name"], 0)
            k["dist_nccl_launches"] = dist_res["nccl_launches"].get(
                k["name"], 0)
        if k["name"] in cd_rows:
            k["cd_shapes"] = strip(cd_rows[k["name"]])
        if k["name"] in launch_counts():
            k["det_launches_per_train_step"] = det_res["per_step"].get(
                k["name"], 0)
            k["det_launches_per_eval_forward"] = det_res["per_eval"].get(
                k["name"], 0)
        if k["name"] in det_rows:
            k["det_shapes"] = strip(det_rows[k["name"]])
        if k["name"] in launch_counts():
            k["maskrcnn_launches_per_train_step"] = mr_res["per_step"].get(
                k["name"], 0)
            k["maskrcnn_launches_per_eval_forward"] = mr_res[
                "per_eval"].get(k["name"], 0)
        if k["name"] in mr_rows:
            k["maskrcnn_shapes"] = strip(mr_rows[k["name"]])
    say("dist-cd-summary", json.dumps({"dist": dist_res, "cd": cd_res}))
    say("det-summary", json.dumps(det_res))
    say("maskrcnn-summary", json.dumps({"maskrcnn": mr_res,
                                        "seg_files": seg_files,
                                        "visualize_attn": vis_res}))
    lap("summary")
    say("phase-seconds", json.dumps(phase_s))
    say("done", f"{time.time() - t_start:.0f} s")
    print(f"kernels: {json.dumps([k['name'] for k in kernels])}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
